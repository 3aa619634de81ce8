"""Deployment: checkpoints, per-bit exports, true-INT8 packing, elastic."""

from .elastic import AsyncCheckpointManager
from .checkpoint import (
    export_int8,
    load_checkpoint,
    save_checkpoint,
    save_per_bit_checkpoints,
)

__all__ = [
    "AsyncCheckpointManager",
    "export_int8",
    "load_checkpoint",
    "save_checkpoint",
    "save_per_bit_checkpoints",
]
