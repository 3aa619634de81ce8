"""Calibration runtime: fills the per-precision quantizer scale banks.

Counterpart of `llm_qat_tpu/train/calibration_manager.py`:
- weight quantizers are calibrated from the frozen base weights, one
  reduction pass per precision over the stacked (L, in, out) weights;
- input quantizers from N forward batches at the target precision with LoRA
  disabled and input quantizers passing through; the per-layer min/max
  stats are folded across batches and finalized into the (L, P, ch) banks.

Per-tensor mode reduces the collected per-channel stats to scalars. The
functions return a new top-level dict and leave the input dict's banks
untouched.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from ..models.config import SPModelConfig
from ..models.sp_model import PrecTables, prec_tables, sp_forward
from ..quant.functional import KIND_LOG, KIND_MINMAX

LINEAR_NAMES = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


def _kind(q, bits):
    return KIND_LOG if q.kind_name(bits) == "log" else KIND_MINMAX


def _minmax_scale(mn, mx, bits: float, symmetric: bool, eps: float):
    if symmetric:
        abs_max = torch.clamp(torch.maximum(mn.abs(), mx.abs()), min=eps)
        scale = abs_max / (2.0 ** (bits - 1.0) - 1.0)
        return scale, torch.zeros_like(scale)
    rng_val = torch.clamp(mx - mn, min=eps)
    scale = rng_val / (2.0 ** bits - 1.0)
    return scale, torch.round(-mn / scale)


def _weight_scale_for(w, bits: float, kind: int, per_channel: bool,
                      symmetric: bool, eps: float):
    """Scale/zp for stacked weights w: (L, d_in, d_out), channel = d_out."""
    axes = (1,) if per_channel else (1, 2)
    if kind == KIND_LOG:
        la = torch.log2(torch.clamp(w.abs(), min=eps))
        mn = torch.amin(la, dim=axes)
        return torch.amax(la, dim=axes) - mn, mn  # scale=log_range, zp=log_min
    return _minmax_scale(torch.amin(w, dim=axes), torch.amax(w, dim=axes),
                         bits, symmetric, eps)


def _copy_blocks(params):
    out = dict(params)
    out["blocks"] = {k: dict(v) for k, v in params["blocks"].items()}
    return out


def calibrate_weight_quantizers(params, cfg: SPModelConfig):
    """Fill every wq_scale/wq_zp bank slot from the current base weights."""
    q = cfg.quant
    out = _copy_blocks(params)
    for name in LINEAR_NAMES:
        lin = out["blocks"][name]
        wq_scale = lin["wq_scale"].clone()  # (L, P, ch)
        wq_zp = lin["wq_zp"].clone()
        for p_idx, bits in enumerate(q.bit_widths):
            if bits >= 32:
                continue
            scale, zp = _weight_scale_for(lin["w"], float(bits), _kind(q, bits),
                                          q.per_channel, q.symmetric, q.eps)
            if not q.per_channel:
                scale, zp = scale[:, None], zp[:, None]
            wq_scale[:, p_idx] = scale
            wq_zp[:, p_idx] = zp
        lin["wq_scale"], lin["wq_zp"] = wq_scale, wq_zp
    return out


@torch.no_grad()
def _collect_input_stats(params, cfg: SPModelConfig, tables: PrecTables,
                         prec_idx: int, batches: Sequence[torch.Tensor]):
    """Fold input stats over calibration batches at one precision."""
    agg = None
    dev = params["wte"].device
    for ids in batches:
        stats = sp_forward(params, torch.as_tensor(ids, device=dev), prec_idx,
                           cfg, tables=tables, calibration_mode=True,
                           collect_stats=True, input_passthrough=True)["stats"]
        if agg is None:
            agg = stats
            continue
        agg = {
            name: {
                "mm_min": torch.minimum(agg[name]["mm_min"], stats[name]["mm_min"]),
                "mm_max": torch.maximum(agg[name]["mm_max"], stats[name]["mm_max"]),
                "lg_min": torch.minimum(agg[name]["lg_min"], stats[name]["lg_min"]),
                "lg_max": torch.maximum(agg[name]["lg_max"], stats[name]["lg_max"]),
            }
            for name in agg
        }
    return agg


def _finalize_input_scales(s, bits: float, kind: int, symmetric: bool,
                           eps: float):
    """Stats dict {mm_min, mm_max, lg_min, lg_max} (L, ch) → (scale, zp)."""
    if kind == KIND_LOG:
        return s["lg_max"] - s["lg_min"], s["lg_min"]
    return _minmax_scale(s["mm_min"], s["mm_max"], bits, symmetric, eps)


def calibrate_input_quantizers(params, cfg: SPModelConfig,
                               batches: Sequence[torch.Tensor],
                               precisions: Optional[Iterable[int]] = None,
                               tables: Optional[PrecTables] = None):
    """Calibrate input-quantizer banks for the given student bit-widths
    (weight quantization active, LoRA disabled, inputs passing through)."""
    q = cfg.quant
    if tables is None:
        tables = prec_tables(q, params["wte"].device)
    if precisions is None:
        precisions = q.student_bits
    for bits in precisions:
        if bits >= 32:
            continue
        p_idx = q.prec_index(bits)
        stats = _collect_input_stats(params, cfg, tables, p_idx, batches)
        params = _copy_blocks(params)
        for name in LINEAR_NAMES:
            s = stats[name]
            if not q.per_channel:
                s = {k: (torch.amin(v, dim=-1, keepdim=True) if "min" in k
                         else torch.amax(v, dim=-1, keepdim=True))
                     for k, v in s.items()}
            scale, zp = _finalize_input_scales(s, float(bits), _kind(q, bits),
                                               q.symmetric, q.eps)
            lin = params["blocks"][name]
            iq_scale, iq_zp = lin["iq_scale"].clone(), lin["iq_zp"].clone()
            iq_scale[:, p_idx] = scale
            iq_zp[:, p_idx] = zp
            lin["iq_scale"], lin["iq_zp"] = iq_scale, iq_zp
    return params
