"""Training: calibration, distillation, the SP, CPT and SQuAD loops."""

from .calibration_manager import (
    CalibrationManager,
    calibrate_input_quantizers,
    calibrate_weight_quantizers,
)

__all__ = [
    "CalibrationManager",
    "calibrate_input_quantizers",
    "calibrate_weight_quantizers",
]
