"""AMP-faithful matmul (counterpart of `llm_qat_tpu/ops/matmul.py`).

Operands are cast to `compute_dtype` (bf16 under AMP), the product is
accumulated and returned in float32. The backward casts the cotangent to
`compute_dtype` too, before both transpose products, as an autocast backward
does; autograd through the forward alone would multiply a float32 `g`.
"""

from __future__ import annotations

import torch

from .sharded import rows_local, rows_split


def _f32_product(a, b):
    """a @ b of two `compute_dtype` tensors, summed in float32. A bf16×bf16
    product is exact in float32, so this equals a bf16 tensor-core dot with
    float32 accumulation up to summation order, on every device."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


class _MatmulBF16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, compute_dtype):
        ab, bb = a.to(compute_dtype), b.to(compute_dtype)
        ctx.save_for_backward(ab, bb)  # the rounded operands
        ctx.compute_dtype = compute_dtype
        return _f32_product(ab, bb)

    @staticmethod
    def backward(ctx, g):
        ab, bb = ctx.saved_tensors
        gb = g.to(ctx.compute_dtype)
        da = db = None
        # a frozen operand (the tied LM head's wte) takes no gradient work
        if ctx.needs_input_grad[0]:
            da = _f32_product(gb, bb.T)
        if ctx.needs_input_grad[1]:  # sums over every leading axis of a
            db = _f32_product(ab.reshape(-1, ab.shape[-1]).T,
                              gb.reshape(-1, gb.shape[-1]))
        return da, db, None


def matmul_bf16(a, b, compute_dtype=torch.bfloat16):
    """a @ b with both operands rounded to `compute_dtype`, float32 result.

    a: (..., K), b: (K, N). Gradients: da = g @ bᵀ, db = aᵀ @ g over all
    leading axes, with g rounded to `compute_dtype` first. A DTensor `a`
    sharded on the sequence (context parallelism) with a replicated `b`
    multiplies its local rows (`sharded.rows_local`).
    """
    if rows_split(a, b):
        return rows_local(lambda x, w: _MatmulBF16.apply(x, w, compute_dtype), a, b)
    return _MatmulBF16.apply(a, b, compute_dtype)
