"""Causal self-attention: dense reference and the flash-attention kernels.

Counterpart of `llm_qat_tpu/ops/attention.py`. Three Pallas kernels are
replaced by hand-written CUDA kernels in `csrc/flash_attention.cu`, each
with its plain PyTorch version beside it:
- `flash_attention` (serving prefill) replaces `_flash_kernel`; plain
  version `flash_attention_plain`;
- `flash_fwd_lse` (training forward, also writes the log-sum-exp rows)
  replaces `_flash_fwd_kernel`; plain version `flash_fwd_lse_plain`;
- `flash_bwd` (training backward) replaces `_flash_bwd_kernel`; plain
  version `flash_bwd_plain`.
Both forwards are one kernel each route: with bf16 operands at head_dim 64
the TMA-fed wgmma forward, otherwise the tiled float32 SIMT forward
(`flash_route` picks, for the backward too); `flash_attention` runs it
without the log-sum-exp rows. Both round P to v's dtype at the running
maximum of the JAX kernel's k-blocks (`flash_blocks`, `jax_block_k`), as
the JAX kernels do. `flash_attention_trainable` joins the last two in an
`autograd.Function`, and `causal_attention` dispatches between it and the
dense reference.

A wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. Each counts its launches in `<fn>.launches`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import _build
from .sharded import local_call

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


def flash_blocks(T: int) -> tuple:
    """(block_q, block_k) of the JAX flash kernels for T (a multiple of
    128), as `llm_qat_tpu/ops/attention.py::flash_blocks` picks them: 128
    keys up to T = 256, 256 keys above it where 256 divides T, else 128."""
    if T <= 256:
        bq, bk = 128, 128
    elif T <= 512:
        bq, bk = 128, 256
    else:
        bq, bk = 256, 256
    if T % bk:
        bk = 128
    if T % bq:
        bq = 128
    return bq, bk


def jax_block_k(T: int) -> int:
    """The JAX kernels' k-block for a length T: `flash_blocks` of T padded
    to a multiple of 128, as the JAX serving prefill pads a ragged prompt
    (and the trainable path's T is such a multiple already). The JAX
    kernels round P at each k-block's running maximum, so the block sets
    the numbers."""
    return flash_blocks(-(-T // 128) * 128)[1]


def causal_attention(q, k, v, *, mask=None, use_flash=False):
    """Dispatch: the trainable flash path when `use_flash` and the shape
    allows it, the dense reference otherwise. Without a mask the dense path
    keeps DTensor operands' batch and head shards local (`local_call`):
    DTensor's einsum would flatten (B, H), which two shards forbid."""
    T, D = q.shape[2], q.shape[3]
    if use_flash and flash_supported(T, D, mask):
        return flash_attention_trainable(q, k, v)
    if mask is None:
        return local_call(causal_attention_reference, (q, k, v), local_dims=(0, 1))
    return causal_attention_reference(q, k, v, mask=mask)


def _flash_loop(q, k, v, block_k):
    """The JAX flash forward's loop in float32 over k-blocks of `block_k`
    keys (the last may be short): per block s = q·kᵀ·scale (causal),
    m = max(m, the block's max), p = exp(s − m), l = l·α + Σp (p
    unrounded), acc = acc·α + (p rounded to v's dtype)·v, α = exp(m_old −
    m). Returns (acc, l clamped to 1e-30, m), float32."""
    B, H, T, D = q.shape
    f32 = torch.float32
    qf, kf, vf = q.to(f32), k.to(f32), v.to(f32)
    scale = 1.0 / math.sqrt(D)
    m = torch.full((B, H, T, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, T, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, T, D), dtype=f32, device=q.device)
    rows = torch.arange(T, device=q.device)[:, None]
    for k0 in range(0, T, block_k):
        k1 = min(k0 + block_k, T)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k1]) * scale
        s = torch.where(rows >= torch.arange(k0, k1, device=q.device)[None], s,
                        torch.full_like(s, NEG_INF))
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_cur)
        alpha = torch.exp(m - m_cur)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(f32),
                                         vf[:, :, k0:k1])
        m = m_cur
    return acc, torch.clamp(l, min=1e-30), m


def flash_attention_plain(q, k, v):
    """Plain PyTorch version of kernel #2: the JAX kernel's loop written out
    in float32 (`_flash_loop` over the JAX k-blocks for T, `jax_block_k`),
    P rounded to v's dtype at each k-block's running max. q,k,v: (B, H, T,
    D) float32 or bf16, any T. Returns q's dtype."""
    acc, l, _ = _flash_loop(q, k, v, jax_block_k(q.shape[2]))
    return (acc / l).to(q.dtype)


def flash_attention(q, k, v):
    """Causal flash attention forward (kernel #2). q,k,v: (B, H, T, D)
    float32 or bf16 (all one dtype), any T; returns q's dtype. P is rounded
    to v's dtype at the running max of each JAX k-block for T
    (`jax_block_k`).

    CPU tensors take `flash_attention_plain`. CUDA tensors launch one kernel
    (`flash_route`'s: the wgmma forward for bf16 at head_dim 64, otherwise
    the SIMT forward, each without the log-sum-exp rows; each output row is
    written by one block, which masks the ragged tail itself) or raise.
    Counts its launches in `flash_attention.launches`, and by route in
    `flash_attention.route_launches`. DTensor operands run on their local
    shards (`sharded.local_call`: batch and heads stay sharded, the rest
    is gathered first).
    """
    return local_call(_flash_attention_local, (q, k, v), local_dims=(0, 1))


def _flash_attention_local(q, k, v):
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v)
    o, route = _launch_fwd("flash_attention", q, k, v, None)
    flash_attention.launches += 1
    flash_attention.route_launches[route] += 1
    return o


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "simt": 0}


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
    """Plain version of kernel #5: the JAX kernel's loop written out in
    float32 (`_flash_loop` over the JAX k-blocks for T, `jax_block_k`; P
    rounded to v's dtype at each k-block's running max). q,k,v: (B, H, T,
    D). Returns o in q's dtype and lse = m + log(max(l, 1e-30)), (B, H, T,
    1) float32."""
    acc, l, m = _flash_loop(q, k, v, jax_block_k(q.shape[2]))
    return (acc / l).to(q.dtype), m + torch.log(l)


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


def flash_route(dtype, D: int) -> str:
    """The kernels #2, #5 and #6 run on the card for operands of `dtype` at
    head_dim D: "wgmma" (bf16 at head_dim 64, every GPT-2 size: the TMA-fed
    tensor-core kernels) or "simt" (float32 operands, which wgmma has no
    exact product for, and bf16 at head_dim 128: the tiled float32
    kernels). One rule for all three, so that the forwards and the backward
    change route together."""
    return "wgmma" if dtype == torch.bfloat16 and D == 64 else "simt"


def _launch_fwd(what, q, k, v, lse):
    """(o, route) from one launch of the forward kernel `flash_route` names,
    over the JAX k-blocks for T (`jax_block_k`), after checking the
    operands; raises on a CUDA error. lse: a (B, H, T, 1) float32 tensor to
    write, or None."""
    _check_operands(what, (("q", q), ("k", k), ("v", v)), q)
    B, H, T, D = q.shape
    o = torch.empty_like(q)
    lse_ptr = None if lse is None else lse.data_ptr()
    lib = _build.load("flash_attention")
    scale, block_k, route = 1.0 / math.sqrt(D), jax_block_k(T), flash_route(q.dtype, D)
    if route == "wgmma":
        # TMA reads rows from 16-byte aligned addresses
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
        rc = lib.flash_forward_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                     lse_ptr, B * H, T, block_k, scale, _build.stream(q))
    else:
        rc = lib.flash_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                               lse_ptr, B * H, T, D, int(q.dtype == torch.bfloat16),
                               block_k, scale, _build.stream(q))
    _build.check(lib, rc, what)
    return o, route


def flash_fwd_lse(q, k, v):
    """Causal flash forward with log-sum-exp (kernel #5). q,k,v: (B, H, T, D)
    float32 or bf16, any T. Returns (o in q's dtype, lse (B, H, T, 1)
    float32). P is rounded to v's dtype at the running max of each JAX
    k-block for T (`jax_block_k`; `flash_blocks(T)[1]` at the trainable
    path's T, a multiple of 128, as in JAX). CPU tensors take
    `flash_fwd_lse_plain`; CUDA tensors launch the kernel `flash_route`
    names (one launch; each output row written by one block, so repeat
    calls are bit-equal) or raise. Counts its launches as `flash_attention`
    does."""
    if q.device.type == "cpu":
        return flash_fwd_lse_plain(q, k, v)
    lse = torch.empty(q.shape[:3] + (1,), dtype=torch.float32, device=q.device)
    o, route = _launch_fwd("flash_fwd_lse", q, k, v, lse)
    flash_fwd_lse.launches += 1
    flash_fwd_lse.route_launches[route] += 1
    return o, lse


flash_fwd_lse.launches = 0
flash_fwd_lse.route_launches = {"wgmma": 0, "simt": 0}


# Kernel #6's wgmma kernels: a block owns BWD_TILE rows (two warpgroups of
# 64) and streams tiles of 64 rows.
BWD_TILE = 128


class FlashBwdPlan(NamedTuple):
    """How `flash_bwd` runs kernel #6 on the card. route: `flash_route`'s.
    t_pad: rows of each head's padded LSE and D rows (wgmma)."""
    route: str
    t_pad: int


def flash_bwd_plan(dtype, T: int, D: int) -> FlashBwdPlan:
    """The plan of kernel #6 for operands of `dtype`, T rows, head_dim D."""
    return FlashBwdPlan(flash_route(dtype, D), -(-T // BWD_TILE) * BWD_TILE)


def flash_bwd(q, k, v, o, lse, do):
    """Causal flash backward (kernel #6): (dq, dk, dv) in q's dtype from the
    forward's q, k, v, o, lse and the output cotangent do. CPU tensors take
    `flash_bwd_plain`; CUDA tensors launch the kernels `flash_bwd_plan`
    names (three CUDA kernels: D = rowsum(dO∘O), then dK/dV per k tile,
    then dQ per q tile; no atomics, so repeat calls are bit-equal) or
    raise. Counts its launches, and by route, as `flash_fwd_lse` does."""
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
    flash_bwd.route_launches[plan.route] += 1
    return out


flash_bwd.launches = 0
flash_bwd.route_launches = {"wgmma": 0, "simt": 0}


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
    takes JAX's k-block for T (`jax_block_k`), as `causal_attention` does in
    JAX; it saves (q, k, v, o, lse), and the backward recomputes P from
    lse. DTensor operands run on their local shards, as in
    `flash_attention`."""
    return local_call(_FlashTrainable.apply, (q, k, v), local_dims=(0, 1))
