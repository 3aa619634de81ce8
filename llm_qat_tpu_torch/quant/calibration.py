"""Quantizer calibration (counterpart of `llm_qat_tpu/quant/calibration.py`).

A pure fold over batches: `init_stats` / `update_stats` build a `QuantStats`
of running min/max, and `finalize` turns it into `(scale, zero_point)` with
the reference's formulas. `fold_stats` folds a batch whose min/max the
model's stat-collecting forward already took (the calibration manager's
input quantizers). Per-channel keeps `channel_dim` and reduces every
other axis (keepdims); per-tensor reduces all of them. `dynamic_scale_flat`
is the conditional-free inline calibration of the LoRA banks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..device import resolve_device
from .functional import KIND_LOG


class QuantStats(NamedTuple):
    """Running min/max statistics and the number of batches folded in."""

    running_min: torch.Tensor
    running_max: torch.Tensor
    count: torch.Tensor  # int32 scalar


def reduction_axes(ndim: int, channel_dim: Optional[int]) -> tuple:
    """Axes to reduce for stat collection.

    `channel_dim=None` → per-tensor (reduce all axes). Otherwise reduce every
    axis except `channel_dim` (negative dims allowed).
    """
    if channel_dim is None:
        return tuple(range(ndim))
    actual = channel_dim if channel_dim >= 0 else ndim + channel_dim
    return tuple(d for d in range(ndim) if d != actual)


def batch_min_max(x, axes: Sequence[int], kind: int, eps: float = 1e-5):
    """Per-batch (min, max) with keepdims, in the quantizer's stat domain:
    plain min/max for minmax, min/max of log2(max(|x|, eps)) for log."""
    x = x.to(torch.float32)
    if kind == KIND_LOG:
        x = torch.log2(torch.clamp(x.abs(), min=eps))
    axes = tuple(axes)
    return _amin(x, axes), _amax(x, axes)


def init_stats(shape=(), device=None) -> QuantStats:
    """Empty stats; the first `update_stats` overwrites min/max entirely.
    On the card unless `device` says otherwise (`resolve_device`)."""
    device = resolve_device(device)
    return QuantStats(
        running_min=torch.full(shape, float("inf"), device=device),
        running_max=torch.full(shape, float("-inf"), device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def fold_stats(stats: QuantStats, bmin, bmax) -> QuantStats:
    """Fold one batch's (min, max), already in the stat domain, into the
    running stats."""
    return QuantStats(
        running_min=torch.minimum(stats.running_min, bmin),
        running_max=torch.maximum(stats.running_max, bmax),
        count=stats.count + 1,
    )


def update_stats(stats: QuantStats, x, channel_dim: Optional[int], kind: int,
                 eps: float = 1e-5) -> QuantStats:
    """Fold one batch into the running stats."""
    return fold_stats(stats, *batch_min_max(
        x, reduction_axes(x.ndim, channel_dim), kind, eps))


def finalize(stats: QuantStats, num_bits, kind: int, symmetric: bool = True,
             eps: float = 1e-5):
    """(scale, zero_point) from collected stats, shaped like the stats.

    log: zero_point = log_min, scale = log_range = log_max - log_min;
    minmax symmetric: scale = max(|min|, |max|, eps) / (2^(b-1) - 1), zp 0;
    minmax asymmetric: scale = max(max - min, eps) / (2^b - 1),
    zp = round(-min / scale).
    """
    rmin, rmax = stats.running_min, stats.running_max
    b = torch.as_tensor(num_bits, dtype=torch.float32, device=rmin.device)
    if kind == KIND_LOG:
        return rmax - rmin, rmin
    if symmetric:
        abs_max = torch.clamp(torch.maximum(rmin.abs(), rmax.abs()), min=eps)
        scale = abs_max / (torch.exp2(b - 1.0) - 1.0)
        return scale, torch.zeros_like(scale)
    scale = torch.clamp(rmax - rmin, min=eps) / (torch.exp2(b) - 1.0)
    return scale, torch.round(-rmin / scale)


def calibrate_tensor(x, num_bits, kind: int, channel_dim: Optional[int] = None,
                     symmetric: bool = True, eps: float = 1e-5):
    """One-shot calibration of one tensor (one stat pass, then finalize)."""
    stats = update_stats(init_stats(device=x.device), x, channel_dim, kind, eps)
    return finalize(stats, num_bits, kind, symmetric, eps)


def _amin(x, axes):
    return torch.amin(x, dim=axes, keepdim=True) if axes else x


def _amax(x, axes):
    return torch.amax(x, dim=axes, keepdim=True) if axes else x


def dynamic_scale_flat(x, bits, kind, channel_dim: Optional[int],
                       symmetric: bool = True, eps: float = 1e-5,
                       batch_dims: int = 0):
    """Inline (per-forward) quantizer calibration with tensor bits/kind.

    Both stat domains are computed from one pass over `x` and selected
    elementwise by `kind`: symmetric minmax abs-max scale, or log
    (range, min). Returns (scale, zero_point) with keepdims shapes.
    `batch_dims` leading axes are kept, as `jax.vmap` over them would.
    """
    axes = tuple(a + batch_dims
                 for a in reduction_axes(x.ndim - batch_dims, channel_dim))
    xf = x.to(torch.float32)
    bits = torch.as_tensor(bits, dtype=torch.float32, device=x.device)
    mn = _amin(xf, axes)
    mx = _amax(xf, axes)
    if symmetric:
        abs_max = torch.clamp(torch.maximum(mn.abs(), mx.abs()), min=eps)
        mm_scale = abs_max / (torch.exp2(bits - 1.0) - 1.0)
        mm_zp = torch.zeros_like(mm_scale)
    else:
        rng_val = torch.clamp(mx - mn, min=eps)
        mm_scale = rng_val / (torch.exp2(bits) - 1.0)
        mm_zp = torch.round(-mn / mm_scale)
    la = torch.log2(torch.clamp(xf.abs(), min=eps))
    lmn = _amin(la, axes)
    lmx = _amax(la, axes)
    is_log = torch.as_tensor(kind, device=x.device).to(torch.int32) == KIND_LOG
    return (
        torch.where(is_log, lmx - lmn, mm_scale),
        torch.where(is_log, lmn, mm_zp),
    )
