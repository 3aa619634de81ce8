"""Calibration runtime: fills the per-precision quantizer scale banks.

Counterpart of `llm_qat_tpu/train/calibration_manager.py`:
- weight quantizers are calibrated from the frozen base weights, one
  reduction pass per precision over the stacked (L, in, out) weights;
- input quantizers from N forward batches at the target precision with LoRA
  disabled and input quantizers passing through; the per-layer min/max
  stats are folded across batches (`quant/calibration.py`'s `QuantStats`)
  and finalized into the (L, P, ch) banks.

Per-tensor mode reduces the collected per-channel stats to scalars. The
functions return a new top-level dict and leave the input dict's banks
untouched. `CalibrationManager` keeps which precisions are calibrated, as
the trainer's caller does before training. The LoRA quantizers keep no
state: `sp_linear` computes their scales from the live A/B.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from ..models.config import SPModelConfig
from ..models.sp_model import PrecTables, prec_tables, sp_forward
from ..quant.calibration import QuantStats, batch_min_max, finalize, fold_stats, init_stats
from ..quant.functional import KIND_LOG, KIND_MINMAX

LINEAR_NAMES = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


def _kind(q, bits):
    return KIND_LOG if q.kind_name(bits) == "log" else KIND_MINMAX


def _weight_scale_for(w, bits: float, kind: int, per_channel: bool,
                      symmetric: bool, eps: float):
    """Scale/zp for stacked weights w: (L, d_in, d_out), channel = d_out;
    (L, d_out) per channel, (L, 1) per tensor."""
    axes = (1,) if per_channel else (1, 2)
    stats = QuantStats(*batch_min_max(w, axes, kind, eps), count=1)
    scale, zp = finalize(stats, bits, kind, symmetric, eps)
    return scale.flatten(1), zp.flatten(1)


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
            wq_scale[:, p_idx] = scale
            wq_zp[:, p_idx] = zp
        lin["wq_scale"], lin["wq_zp"] = wq_scale, wq_zp
    return out


@torch.no_grad()
def _collect_input_stats(params, cfg: SPModelConfig, tables: PrecTables,
                         prec_idx: int, kind: int, batches: Sequence[torch.Tensor]):
    """{linear: QuantStats (L, ch)} of the inputs at one precision, in
    `kind`'s stat domain, folded over the calibration batches."""
    dom = "lg" if kind == KIND_LOG else "mm"
    agg = {}
    dev = params["wte"].device
    for ids in batches:
        stats = sp_forward(params, torch.as_tensor(ids, device=dev), prec_idx,
                           cfg, tables=tables, calibration_mode=True,
                           collect_stats=True, input_passthrough=True)["stats"]
        for name, s in stats.items():
            mn, mx = s[f"{dom}_min"], s[f"{dom}_max"]
            prev = agg.get(name) or init_stats(mn.shape, dev)
            agg[name] = fold_stats(prev, mn, mx)
    return agg


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
        p_idx, kind = q.prec_index(bits), _kind(q, bits)
        stats = _collect_input_stats(params, cfg, tables, p_idx, kind, batches)
        params = _copy_blocks(params)
        for name in LINEAR_NAMES:
            st = stats[name]
            if not q.per_channel:
                st = st._replace(
                    running_min=torch.amin(st.running_min, dim=-1, keepdim=True),
                    running_max=torch.amax(st.running_max, dim=-1, keepdim=True))
            scale, zp = finalize(st, float(bits), kind, q.symmetric, q.eps)
            lin = params["blocks"][name]
            iq_scale, iq_zp = lin["iq_scale"].clone(), lin["iq_zp"].clone()
            iq_scale[:, p_idx] = scale
            iq_zp[:, p_idx] = zp
            lin["iq_scale"], lin["iq_zp"] = iq_scale, iq_zp
    return params


class CalibrationManager:
    """Calibrates the weight and input quantizer banks and tracks which
    student precisions are calibrated."""

    def __init__(self, cfg: SPModelConfig, calibration_batches: int = 10):
        self.cfg = cfg
        self.calibration_batches = calibration_batches
        self.calibrated: set = set()

    def _calibrate(self, params, batches, precisions):
        params = calibrate_weight_quantizers(params, self.cfg)
        return calibrate_input_quantizers(
            params, self.cfg, list(batches)[: self.calibration_batches],
            precisions)

    def calibrate_all_precisions(self, params, batches: Sequence[torch.Tensor]):
        """Calibrate every student precision."""
        params = self._calibrate(params, batches, self.cfg.quant.student_bits)
        self.calibrated.update(self.cfg.quant.student_bits)
        return params

    def ensure_calibrated(self, params, bits: int,
                          batches: Sequence[torch.Tensor]):
        """Calibrate `bits` if it is not yet."""
        if self.is_calibrated(bits):
            return params
        params = self._calibrate(params, batches, [bits])
        self.calibrated.add(bits)
        return params

    def is_calibrated(self, bits: int) -> bool:
        return bits >= 32 or bits in self.calibrated
