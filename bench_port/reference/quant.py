"""Plain formulas of switchable-precision quantization, for the references.

Written from the system's stated semantics (symmetric minmax below 5 bits,
symmetric log from 5 to 16 bits, pass-through at 32; straight-through
gradients, clamped to +-10 for the log kind), with no code of the program.

`Rounding` is the precision the references compute their products in: the
configuration's bf16 ("bf16": operands rounded to bfloat16, float32 sums),
float32 ("f32"), or the control one step below it ("fp8": operands scaled
per tensor into float8 e4m3 and back).
"""

from __future__ import annotations

import torch

EPS = 1e-5
FP8_MAX = 448.0


def kind_of(bits: int, override: dict | None = None) -> str:
    """"minmax", "log" or "none" for a bit-width."""
    if override and str(bits) in override:
        return override[str(bits)]
    if bits >= 32:
        return "none"
    return "minmax" if bits <= 4 else "log"


def round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x rounded to `precision` and returned in float32."""
    if precision == "f32":
        return x.to(torch.float32)
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        xf = x.to(torch.float32)
        s = torch.clamp(xf.abs().amax(), min=1e-30) / FP8_MAX
        return (xf / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"unknown precision {precision!r}")


class _Round(torch.autograd.Function):
    """Rounding with a straight-through gradient."""

    @staticmethod
    def forward(ctx, x, precision):
        return round_to(x, precision)

    @staticmethod
    def backward(ctx, g):
        return g, None


def rnd(x, precision: str):
    return _Round.apply(x, precision)


class _Matmul(torch.autograd.Function):
    """a @ b with both operands rounded to `precision`, float32 sums; the
    backward rounds the cotangent to `precision` before both products (an
    autocast backward). b is (K, N); a (..., K)."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ar, br = round_to(a, precision), round_to(b, precision)
        ctx.save_for_backward(ar, br)
        ctx.precision = precision
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_to(g, ctx.precision)
        da = gr @ br.T if ctx.needs_input_grad[0] else None
        db = None
        if ctx.needs_input_grad[1]:
            db = ar.reshape(-1, ar.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])
        return da, db, None


def matmul(a, b, precision: str):
    return _Matmul.apply(a, b, precision)


class _BatchedMatmul(torch.autograd.Function):
    """a @ b over equal leading axes, operands and (in the backward) the
    cotangent rounded to `precision`, float32 sums: attention's products
    as a bf16 flash kernel forms them."""

    @staticmethod
    def forward(ctx, a, b, precision):
        ar, br = round_to(a, precision), round_to(b, precision)
        ctx.save_for_backward(ar, br)
        ctx.precision = precision
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = round_to(g, ctx.precision)
        return gr @ br.transpose(-1, -2), ar.transpose(-1, -2) @ gr, None


def bmatmul(a, b, precision: str):
    return _BatchedMatmul.apply(a, b, precision)


def minmax_scale(x, bits: int, dims):
    """Symmetric minmax scale over `dims` (keepdim): max|x| / (2^(b-1) - 1)."""
    amax = torch.clamp(x.abs().amax(dim=dims, keepdim=True), min=EPS)
    return amax / (2.0 ** (bits - 1) - 1.0)


def log_range(x, dims):
    """(log_min, log_range) of log2(max(|x|, eps)) over `dims` (keepdim)."""
    la = torch.log2(torch.clamp(x.abs(), min=EPS))
    lmin = la.amin(dim=dims, keepdim=True)
    return lmin, la.amax(dim=dims, keepdim=True) - lmin


def fq_minmax(x, scale, bits: int):
    qmax = 2.0 ** (bits - 1) - 1.0
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


def fq_log(x, lmin, lrange, bits: int):
    """Symmetric log-domain fake quantization; |x| < eps maps to 0."""
    zero = x.abs() < EPS
    norm = (torch.log2(torch.clamp(x.abs(), min=EPS)) - lmin) / torch.clamp(lrange, min=EPS)
    norm = torch.clamp(norm, 0.0, 1.0)
    full = 2.0 ** bits - 1.0
    n = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round((norm - 0.5) * 2.0 * n), -n, n)
    q = ((q / (2.0 * n) + 0.5) * full) / full
    out = torch.exp2(q * lrange + lmin) * torch.sign(x)
    return torch.where(zero, torch.zeros_like(x), out)


class _FQ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, b, bits, kind):
        ctx.clamp = kind == "log"
        if kind == "log":
            return fq_log(x, a, b, bits)
        return fq_minmax(x, a, bits)

    @staticmethod
    def backward(ctx, g):
        return (torch.clamp(g, -10.0, 10.0) if ctx.clamp else g), None, None, None, None


def fake_quant(x, q, bits: int, kind: str):
    """x fake-quantized by the quantizer `q`: ("minmax", scale) or ("log",
    log_min, log_range); a straight-through gradient, clamped for log."""
    if kind == "none" or bits >= 32:
        return x
    if kind == "log":
        return _FQ.apply(x, q[0], q[1], bits, kind)
    return _FQ.apply(x, q, None, bits, kind)


def quantizer(x, bits: int, kind: str, dims):
    """The quantizer of x over `dims` (detached: no gradient reaches it)."""
    x = x.detach()
    if kind == "log":
        return log_range(x, dims)
    return minmax_scale(x, bits, dims)
