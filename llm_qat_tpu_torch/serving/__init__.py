"""Continuous-batching serving (counterpart of `llm_qat_tpu/serving`)."""

from .engine import ContinuousBatchingEngine, Request

__all__ = ["ContinuousBatchingEngine", "Request"]
