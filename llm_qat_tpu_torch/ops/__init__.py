"""Operators: matmul, attention and the CUDA kernels' wrappers. Importing
them builds nothing: each kernel is compiled at its first launch
(`_build.load`)."""

from .attention import causal_attention, causal_attention_reference, flash_attention
from .quant_matmul import (
    pack_int4,
    pack_int8,
    quant_matmul,
    quant_matmul_int4,
    quant_matmul_int8,
    unpack_int4,
)

__all__ = [
    "causal_attention",
    "causal_attention_reference",
    "flash_attention",
    "pack_int4",
    "pack_int8",
    "quant_matmul",
    "quant_matmul_int4",
    "quant_matmul_int8",
    "unpack_int4",
]
