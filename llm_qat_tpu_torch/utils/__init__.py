"""Utilities: stats tracking, profiling, roofline accounting."""

from .profiling import StepTimer, gpt2_decode_roofline, matmul_roofline, trace
from .stats import StatsTracker, device_memory_mb

__all__ = [
    "StepTimer",
    "gpt2_decode_roofline",
    "matmul_roofline",
    "trace",
    "StatsTracker",
    "device_memory_mb",
]
