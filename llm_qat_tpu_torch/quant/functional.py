"""Fake-quantization forward math (counterpart of `llm_qat_tpu/quant/functional.py`).

Semantics match the JAX package, which matches the reference:
- minmax symmetric:  q = clamp(round(x/s), -(2^(b-1)-1), 2^(b-1)-1); out = q*s
- minmax asymmetric: q = clamp(round(x/s + zp), 0, 2^b-1); out = (q-zp)*s
- log: sign/magnitude quantization of log2|x| normalized into
  [log_min, log_min+log_range], zeros (|x|<eps) preserved exactly.

Backward (straight-through estimators, `torch.autograd.Function`s): the
identity for minmax and pass-through, gradient values clamped to [-10, 10]
for the log kind below 32 bits. The quantizer operands (scale, zero point,
bits, kind) get no gradient, so scales computed from a live tensor (the
LoRA banks' `dynamic_scale_flat`) carry none back into it.

`torch.round` rounds half to even, like `jnp.round`. `num_bits` and `kind`
may be tensors, so one call serves every precision of a bank.
`quantize_gradient` is the other way round: the identity forward, and a
fake-quantized cotangent in the backward.
"""

from __future__ import annotations

import torch

KIND_MINMAX = 0
KIND_LOG = 1


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _as(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _minmax_fwd_math(x, scale, zero_point, num_bits, symmetric):
    """Forward math of minmax fake-quant."""
    b = _as(num_bits, x)
    scale = _as(scale, x)
    zero_point = _as(zero_point, x)
    if symmetric:
        qmax = torch.exp2(b - 1.0) - 1.0
        q = torch.round(x / scale)
        q = torch.minimum(torch.maximum(q, -qmax), qmax)
        return q * scale
    qmax = torch.exp2(b) - 1.0
    q = torch.round(x / scale + zero_point)
    q = torch.minimum(torch.maximum(q, torch.zeros_like(qmax)), qmax)
    return (q - zero_point) * scale


class _MinmaxSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, num_bits, symmetric):
        return _minmax_fwd_math(x, scale, zero_point, num_bits, symmetric)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


def fake_quant_minmax(x, scale, zero_point, num_bits, symmetric=True):
    """Min-max fake quantization with the identity STE backward."""
    return _MinmaxSTE.apply(x, scale, zero_point, num_bits, symmetric)


def _log_fwd_math(x, log_min, log_range, num_bits, symmetric, eps):
    """Forward math of log fake-quant."""
    b = _as(num_bits, x)
    log_min = _as(log_min, x)
    log_range = _as(log_range, x)

    zero_mask = torch.abs(x) < eps
    sign_x = torch.sign(x)
    abs_x = torch.clamp(torch.abs(x), min=eps)
    log_abs = torch.log2(abs_x)

    log_norm = (log_abs - log_min) / torch.clamp(log_range, min=eps)
    log_norm = torch.clamp(log_norm, 0.0, 1.0)

    full = torch.exp2(b) - 1.0
    if symmetric:
        n_levels = torch.exp2(b - 1.0) - 1.0
        centered = log_norm - 0.5
        q = torch.round(centered * 2.0 * n_levels)
        q = torch.minimum(torch.maximum(q, -n_levels), n_levels)
        q = (q / (2.0 * n_levels) + 0.5) * full
        q_norm = q / full
    else:
        q = torch.round(log_norm * full)
        q = torch.minimum(torch.maximum(q, torch.zeros_like(full)), full)
        q_norm = q / full

    x_hat = q_norm * log_range + log_min
    magnitude = torch.exp2(x_hat)
    out = magnitude * sign_x
    return torch.where(zero_mask, torch.zeros_like(x), out)


class _LogSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, log_min, log_range, num_bits, symmetric, eps):
        return _log_fwd_math(x, log_min, log_range, num_bits, symmetric, eps)

    @staticmethod
    def backward(ctx, g):
        return torch.clamp(g, -10.0, 10.0), None, None, None, None, None


def fake_quant_log(x, log_min, log_range, num_bits, symmetric=True, eps=1e-5):
    """Log-domain fake quantization; the STE clamps gradient values to
    [-10, 10]."""
    return _LogSTE.apply(x, log_min, log_range, num_bits, symmetric, eps)


def fake_quant(x, scale, zero_point, num_bits, kind, symmetric=True, eps=1e-5):
    """Dispatch between minmax / log / pass-through.

    `num_bits >= 32` passes through. For the log kind, `zero_point` holds
    log_min and `scale` holds log_range (the reference's buffer reuse). The
    JAX version dispatches with `lax.cond`/`lax.switch`; its value and its
    gradient are `fake_quant_flat`'s, which this delegates to.
    """
    return fake_quant_flat(x, scale, zero_point, num_bits, kind, symmetric, eps)


def _flat_fwd_math(x, scale, zero_point, num_bits, kind, symmetric, eps):
    """Both quantizer domains computed, selected by `kind`/`num_bits`."""
    mm = _minmax_fwd_math(x, scale, zero_point, num_bits, symmetric)
    lg = _log_fwd_math(x, zero_point, scale, num_bits, symmetric, eps)
    kind_t = torch.as_tensor(kind, device=x.device).to(torch.int32)
    q = torch.where(kind_t == KIND_LOG, lg, mm)
    return torch.where(_as(num_bits, x) >= 32.0, x, q)


class _FlatSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, num_bits, kind, symmetric, eps):
        ctx.save_for_backward(num_bits, kind)
        return _flat_fwd_math(x, scale, zero_point, num_bits, kind, symmetric,
                              eps)

    @staticmethod
    def backward(ctx, g):
        num_bits, kind = ctx.saved_tensors
        clamp = (kind.to(torch.int32) == KIND_LOG) & (num_bits < 32.0)
        gx = torch.where(clamp, torch.clamp(g, -10.0, 10.0), g)
        return gx, None, None, None, None, None, None


def fake_quant_flat(x, scale, zero_point, num_bits, kind, symmetric=True,
                    eps=1e-5):
    """Conditional-free fake quantization with one STE: the identity for
    minmax and pass-through, the ±10 clamp for the log kind below 32 bits,
    selected by the same `kind`/`num_bits` operands. Quantizer operands are
    cast to float32 at this boundary, as in the JAX package."""
    return _FlatSTE.apply(x, _f32(scale, x), _f32(zero_point, x),
                          _f32(num_bits, x), _f32(kind, x), symmetric, eps)


class _QuantizeGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, num_bits, kind):
        ctx.save_for_backward(scale, zero_point, num_bits, kind)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        scale, zero_point, num_bits, kind = ctx.saved_tensors
        gq = _flat_fwd_math(g, scale, zero_point, num_bits, kind, True, 1e-5)
        return gq, None, None, None, None


def quantize_gradient(x, scale, zero_point, num_bits, kind):
    """Identity forward; the backward fake-quantizes the cotangent
    (`fake_quant(g, scale, zero_point, num_bits, kind, symmetric=True)`)
    and gives the quantizer operands no gradient. The CPT model quantizes
    its LoRA gradients to `gradient_bits` with it."""
    return _QuantizeGradient.apply(x, _f32(scale, x), _f32(zero_point, x),
                                   _f32(num_bits, x), _f32(kind, x))
