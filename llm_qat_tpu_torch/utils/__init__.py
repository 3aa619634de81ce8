"""Utilities: stats tracking."""

from .stats import StatsTracker, device_memory_mb

__all__ = [
    "StatsTracker",
    "device_memory_mb",
]
