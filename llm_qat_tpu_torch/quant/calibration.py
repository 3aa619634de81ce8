"""Quantizer calibration helpers (counterpart of `llm_qat_tpu/quant/calibration.py`).

Only what the flat `sp_linear` forward needs is ported: `reduction_axes`
and the conditional-free inline calibration `dynamic_scale_flat`. The
running-stats fold (`update_stats`/`finalize`/`calibrate_tensor`) comes with
the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from .functional import KIND_LOG


def reduction_axes(ndim: int, channel_dim: Optional[int]) -> tuple:
    """Axes to reduce for stat collection.

    `channel_dim=None` → per-tensor (reduce all axes). Otherwise reduce every
    axis except `channel_dim` (negative dims allowed).
    """
    if channel_dim is None:
        return tuple(range(ndim))
    actual = channel_dim if channel_dim >= 0 else ndim + channel_dim
    return tuple(d for d in range(ndim) if d != actual)


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
