"""Causal self-attention: dense reference and the flash-attention kernels.

Counterpart of `llm_qat_tpu/ops/attention.py`. Three Pallas kernels are
replaced by hand-written CUDA kernels in `csrc/flash_attention.cu`, each
with its plain PyTorch version beside it:
- `flash_attention` (serving prefill, float32) replaces `_flash_kernel`;
  plain version `flash_attention_plain`;
- `flash_fwd_lse` (training forward, also writes the log-sum-exp rows)
  replaces `_flash_fwd_kernel`; plain version `flash_fwd_lse_plain`. It
  launches the same templated forward kernel as `flash_attention`;
- `flash_bwd` (training backward) replaces `_flash_bwd_kernel`; plain
  version `flash_bwd_plain`. With bf16 operands at head_dim 64 it launches
  TMA-fed wgmma kernels, otherwise tiled float32 kernels (`flash_bwd_plan`
  picks).
`flash_attention_trainable` joins the last two in an `autograd.Function`,
and `causal_attention` dispatches between it and the dense reference.

A wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. Each counts its launches in `<fn>.launches`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build

NEG_INF = -1e30


def causal_attention_reference(q, k, v, *, mask=None):
    """Dense causal attention (numerics reference).

    q,k,v: (B, H, T, D). Scores in float32, scaled by 1/sqrt(D), causal
    mask, float32 softmax, probabilities cast to v's dtype. `mask`
    optionally adds a (B, T) padding mask (1 = keep).
    """
    T, D = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(D)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    scores = torch.where(causal[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    if mask is not None:
        keep = mask[:, None, None, :].to(torch.bool)
        scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


# Below this length the dense path runs under `attention_impl="auto"`, as in
# the JAX package, so that "auto" selects the same path in both packages.
# The card's own dense-vs-flash times are measured by chip_smoke.py.
FLASH_MIN_T = 1024


def flash_supported(T: int, D: int, mask) -> bool:
    """The JAX flash kernels' shape rule (no mask, T % 128 == 0, head_dim 64
    or 128). The port's kernels also take a ragged T; the rule stays so that
    both packages pick the same path."""
    return mask is None and T % 128 == 0 and D in (64, 128)


def causal_attention(q, k, v, *, mask=None, use_flash=False):
    """Dispatch: the trainable flash path when `use_flash` and the shape
    allows it, the dense reference otherwise."""
    T, D = q.shape[2], q.shape[3]
    if use_flash and flash_supported(T, D, mask):
        return flash_attention_trainable(q, k, v)
    return causal_attention_reference(q, k, v, mask=mask)


def flash_attention_plain(q, k, v):
    """Plain PyTorch version of the flash kernel: the dense causal softmax
    in float32 (`causal_attention_reference`), any T."""
    return causal_attention_reference(q, k, v)


def flash_attention(q, k, v):
    """Causal flash attention forward. q,k,v: (B, H, T, D) float32, any T.

    CPU tensors take `flash_attention_plain`. CUDA tensors launch the
    kernel (one block per (b·h, 64-row q tile); it streams the K/V tiles up
    to the causal limit with a float32 online softmax and masks the ragged
    tail itself) or raise. Counts its launches in `flash_attention.launches`.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    B, H, T, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"flash_attention: {name} must be a float32 CUDA "
                             f"tensor; got {t.dtype} on {t.device}")
        if t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"with shape {tuple(q.shape)}")
    if D not in (64, 128):
        raise ValueError(f"flash_attention: head_dim must be 64 or 128; got {D}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    rc = lib.flash_attention_fwd_f32(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B * H, T, D,
        1.0 / math.sqrt(D), _build.stream(q))
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Trainable flash attention: forward with log-sum-exp, and backward
# ---------------------------------------------------------------------------


def _causal_scores(q, k):
    """float32 scores q·kᵀ·scale, -1e30 above the diagonal."""
    T, D = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * (1.0 / math.sqrt(D))
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))
    return torch.where(causal, s, torch.full_like(s, NEG_INF)), causal


def flash_fwd_lse_plain(q, k, v):
    """Plain version of kernel #5: the dense float32 softmax with the
    kernel's casts. q,k,v: (B, H, T, D). Returns o in q's dtype and
    lse = m + log(max(l, 1e-30)), (B, H, T, 1) float32. P is rounded to v's
    dtype before P·V; the row sum takes the float32 P."""
    s, _ = _causal_scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(torch.float32),
                     v.to(torch.float32)) / den
    return o.to(q.dtype), m + torch.log(den)


def flash_bwd_plain(q, k, v, o, lse, do):
    """Plain version of kernel #6: the JAX backward's formulas over the
    whole T×T. D = rowsum(dO∘O); P = exp(s − lse) (causal); dV = Pᵀ·dO;
    dP = dO·Vᵀ; dS = P∘(dP − D); dQ = dS·K·scale; dK = dSᵀ·Q·scale. P and
    dS are rounded to the operand dtype before their products; the outputs
    are in q's dtype."""
    cdt, f32 = q.dtype, torch.float32
    scale = 1.0 / math.sqrt(q.shape[3])
    do = do.to(cdt)
    dvec = (do.to(f32) * o.to(f32)).sum(dim=-1, keepdim=True)
    s, causal = _causal_scores(q, k)
    p = torch.where(causal, torch.exp(s - lse), torch.zeros_like(s))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(cdt).to(f32), do.to(f32))
    dp = torch.einsum("bhqd,bhkd->bhqk", do.to(f32), v.to(f32))
    ds = (p * (dp - dvec)).to(cdt).to(f32)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f32)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f32)) * scale
    return dq.to(cdt), dk.to(cdt), dv.to(cdt)


def _check_operands(what, named, like):
    """Device, dtype, shape and contiguity of the flash training operands."""
    if like.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: operands must be float32 or bfloat16; "
                         f"got {like.dtype}")
    for name, t in named:
        if t.device.type != "cuda" or t.dtype != like.dtype:
            raise ValueError(f"{what}: {name} must be a {like.dtype} CUDA "
                             f"tensor; got {t.dtype} on {t.device}")
        if t.shape != like.shape or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous with shape "
                             f"{tuple(like.shape)}")
    if like.shape[3] not in (64, 128):
        raise ValueError(f"{what}: head_dim must be 64 or 128; got "
                         f"{like.shape[3]}")


def flash_fwd_lse(q, k, v):
    """Causal flash forward with log-sum-exp (kernel #5). q,k,v: (B, H, T, D)
    float32 or bf16, any T. Returns (o in q's dtype, lse (B, H, T, 1)
    float32). CPU tensors take `flash_fwd_lse_plain`; CUDA tensors launch
    the kernel or raise."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v)
    _check_operands("flash_fwd_lse", (("q", q), ("k", k), ("v", v)), q)
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((B, H, T, 1), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention")
    rc = lib.flash_fwd_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B * H, T, D, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
        _build.stream(q))
    _build.check(lib, rc, "flash_fwd_lse")
    flash_fwd_lse.launches += 1
    return o, lse


flash_fwd_lse.launches = 0


# Kernel #6's wgmma kernels: a block owns BWD_TILE rows (two warpgroups of
# 64) and streams tiles of 64 rows.
BWD_TILE = 128


class FlashBwdPlan(NamedTuple):
    """How `flash_bwd` runs kernel #6 on the card. route: "wgmma" (bf16
    operands at head_dim 64: the TMA-fed tensor-core kernels) or "simt"
    (float32 operands, which wgmma has no exact product for, and bf16 at
    head_dim 128: the tiled float32 kernels). t_pad: rows of each head's
    padded LSE and D rows (wgmma)."""
    route: str
    t_pad: int


def flash_bwd_plan(dtype, T: int, D: int) -> FlashBwdPlan:
    """The plan of kernel #6 for operands of `dtype`, T rows, head_dim D."""
    route = "wgmma" if dtype == torch.bfloat16 and D == 64 else "simt"
    return FlashBwdPlan(route, -(-T // BWD_TILE) * BWD_TILE)


def flash_bwd(q, k, v, o, lse, do):
    """Causal flash backward (kernel #6): (dq, dk, dv) in q's dtype from the
    forward's q, k, v, o, lse and the output cotangent do. CPU tensors take
    `flash_bwd_plain`; CUDA tensors launch the kernels `flash_bwd_plan`
    names (three CUDA kernels: D = rowsum(dO∘O), then dK/dV per k tile,
    then dQ per q tile; no atomics, so repeat calls are bit-equal) or
    raise."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do)
    _check_operands("flash_bwd", (("q", q), ("k", k), ("v", v), ("o", o),
                                  ("do", do)), q)
    B, H, T, D = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (B, H, T, 1) or not lse.is_contiguous()):
        raise ValueError(f"flash_bwd: lse must be a contiguous float32 CUDA "
                         f"tensor of shape {(B, H, T, 1)}")
    plan = flash_bwd_plan(q.dtype, T, D)
    lib = _build.load("flash_attention")
    out = tuple(torch.empty_like(q) for _ in range(3))
    if plan.route == "wgmma":
        # TMA reads rows from 16-byte aligned addresses
        q, k, v, o, do = (t if t.data_ptr() % 16 == 0 else t.clone()
                          for t in (q, k, v, o, do))
        aux = torch.empty((2, B * H, plan.t_pad), dtype=torch.float32, device=q.device)
        rc = lib.flash_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), aux.data_ptr(), *(t.data_ptr() for t in out),
            B * H, T, plan.t_pad, 1.0 / math.sqrt(D), _build.stream(q))
    else:
        dvec = torch.empty((B * H * T,), dtype=torch.float32, device=q.device)
        rc = lib.flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dvec.data_ptr(), *(t.data_ptr() for t in out),
            B * H, T, D, int(q.dtype == torch.bfloat16), 1.0 / math.sqrt(D),
            _build.stream(q))
    _build.check(lib, rc, "flash_bwd")
    flash_bwd.launches += 1
    return out


flash_bwd.launches = 0


class _FlashTrainable(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return flash_bwd(*ctx.saved_tensors, g.contiguous())


def flash_attention_trainable(q, k, v):
    """Causal flash attention with a flash backward. q,k,v: (B, H, T, D) in
    the operand dtype; the output is in q's dtype, and the cotangent arrives
    in it too (the AMP cast's backward), as in the JAX package. The forward
    saves (q, k, v, o, lse); the backward recomputes P from lse."""
    return _FlashTrainable.apply(q, k, v)
