"""Quantized KV-cache storage (the KV axis of the W-A-KV bit configurations).

Counterpart of `llm_qat_tpu/ops/kv_cache.py`. Cache rows are stored as int8
codes with one float32 scale per (batch, head, position) row, written at
append time and dequantized on read: symmetric per-row quantization, scale =
max|row| / 127, code = round(x / scale) (`torch.round` rounds half to even,
as `jnp.round` does, so the codes are the JAX package's bit for bit).

Plain PyTorch: the JAX module has no Pallas kernel. `append_rows` writes
into the cache in place, as the port's other caches are updated, and
returns it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..device import resolve_device

NEG_INF = -1e30


class QuantizedKV(NamedTuple):
    """int8 codes + per-row scales for one cache (K or V)."""

    codes: torch.Tensor  # (B, H, T, D) int8
    scales: torch.Tensor  # (B, H, T, 1) float32


def init_quantized_kv(batch: int, n_head: int, max_len: int, head_dim: int,
                      device=None) -> QuantizedKV:
    dev = resolve_device(device)
    return QuantizedKV(
        codes=torch.zeros((batch, n_head, max_len, head_dim), dtype=torch.int8,
                          device=dev),
        scales=torch.zeros((batch, n_head, max_len, 1), dtype=torch.float32,
                           device=dev),
    )


def quantize_rows(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., S, D) → (int8 codes, float32 scales (..., S, 1))."""
    xf = x.to(torch.float32)
    amax = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8)
    scale = amax / 127.0
    codes = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return codes, scale


def clamped_start(start, size: int, extent: int) -> int:
    """The start `lax.dynamic_update_slice` uses: clamped so that a slice of
    `size` fits in `extent`."""
    return max(0, min(int(start), extent - size))


def append_rows(cache: QuantizedKV, new, start) -> QuantizedKV:
    """Write new (B, H, S, D) rows at position `start` (clamped so that the
    rows fit, as the JAX update slice clamps), in place."""
    codes, scales = quantize_rows(new)
    S = codes.shape[2]
    s0 = clamped_start(start, S, cache.codes.shape[2])
    cache.codes[:, :, s0:s0 + S] = codes
    cache.scales[:, :, s0:s0 + S] = scales
    return cache


def dequantize(cache: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    return (cache.codes.to(torch.float32) * cache.scales).to(dtype)


def attention_with_quantized_kv(q, k_cache: QuantizedKV, v_cache: QuantizedKV,
                                start, t_len, n_positions: int):
    """Causal attention over quantized caches for q (B, H, S, D).

    The JAX order: scores on the raw K codes, then the K row scales, then
    1/sqrt(D); on the value side the probabilities are scaled by the V row
    scales before the product with the codes. Equal to
    dequantize-then-attend up to float32 rounding."""
    B, H, S, D = q.shape
    T_max = k_cache.codes.shape[2]
    sm_scale = 1.0 / math.sqrt(D)
    f32 = torch.float32

    kf = k_cache.codes.to(f32)
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(f32), kf)
    scores = scores * k_cache.scales[..., 0][:, :, None, :] * sm_scale

    dev = q.device
    start, t_len = int(start), int(t_len)
    q_pos = start + torch.arange(S, device=dev)[:, None]
    k_pos = torch.arange(T_max, device=dev)[None, :]
    valid = k_pos <= torch.clamp(q_pos, max=start + t_len - 1)
    scores = torch.where(valid[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)

    # out = P @ (codes * scales) == (P * scalesᵀ) @ codes
    pw = probs * v_cache.scales[..., 0][:, :, None, :]
    out = torch.einsum("bhst,bhtd->bhsd", pw, v_cache.codes.to(f32))
    return out.to(q.dtype)
