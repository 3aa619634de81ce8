"""AMP-faithful matmul forward (counterpart of `llm_qat_tpu/ops/matmul.py`).

Operands are cast to `compute_dtype` (bf16 under AMP), the product is
accumulated and returned in float32. The bf16-both-directions backward
comes with the training slice.
"""

from __future__ import annotations

import torch


def matmul_bf16(a, b, compute_dtype=torch.bfloat16):
    """a @ b with both operands rounded to `compute_dtype`, f32 result.

    The operands are rounded first and multiplied in float32: a bf16×bf16
    product is exact in float32, so this equals a bf16 MXU dot with f32
    accumulation up to summation order, on every device.
    """
    cdt = compute_dtype
    return torch.matmul(a.to(cdt).to(torch.float32), b.to(cdt).to(torch.float32))
