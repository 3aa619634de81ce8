"""Fake-quantization math and quantizer calibration."""

from .functional import (
    KIND_LOG,
    KIND_MINMAX,
    fake_quant,
    fake_quant_log,
    fake_quant_minmax,
    quantize_gradient,
)
from .calibration import (
    QuantStats,
    batch_min_max,
    calibrate_tensor,
    finalize,
    init_stats,
    reduction_axes,
    update_stats,
)

__all__ = [
    "KIND_LOG",
    "KIND_MINMAX",
    "fake_quant",
    "fake_quant_log",
    "fake_quant_minmax",
    "quantize_gradient",
    "QuantStats",
    "batch_min_max",
    "calibrate_tensor",
    "finalize",
    "init_stats",
    "reduction_axes",
    "update_stats",
]
