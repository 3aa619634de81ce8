"""Causal self-attention: dense reference and the flash-attention kernel.

Counterpart of `llm_qat_tpu/ops/attention.py`. `flash_attention` replaces
the Pallas `_flash_kernel` (`llm_qat_tpu/ops/attention.py::_flash_kernel`)
with the hand-written CUDA kernel in `csrc/flash_attention.cu`; its plain
PyTorch version, `flash_attention_plain`, sits beside it. The serving
prefill passes float32 q/k/v, so the kernel takes float32 operands and
computes in float32 (no TF32).
"""

from __future__ import annotations

import math

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
        1.0 / math.sqrt(D), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
