"""Fused QAT linear for the SP training path (counterpart of
`llm_qat_tpu/ops/fused_linear.py`).

Per quantized linear with per-bit LoRA:

    forward:  out  = xq @ cdt(FQ(W)) + s·(xa @ bq) + b
    backward: dxq  = g_bf @ cdt(FQ(W))ᵀ
              dxa  = s·(g_bf @ bqᵀ)
              dW   = STE_w(xqᵀ @ g_bf)      (±10 clamp iff log kind, < 32 bits)
              dbq  = s·(xaᵀ @ g_bf), dbias = Σ g

FQ is the weight fake-quant from the float32 weight and its per-column
scale bank (`fq_tile_plain`, the JAX `_fq_tile`). The TPU kernels apply it
tile by tile in VMEM, so there the quantized weight never goes to device
memory. On the card, with bf16 operands, a prologue kernel (`fq_weight`)
fake-quantizes each weight once per call into a bf16 workspace in the
layout its GEMM reads (WqT (N, K) for #14, Wq (K, N) for #15): the
quantized weight goes to device memory once, in bf16, and the GEMM is a
TMA-fed wgmma kernel. Three Pallas kernels are replaced by hand-written
CUDA kernels in `csrc/fused_linear.cu`, each with its plain PyTorch version
beside it:
- `fused_linear_fwd` (kernel #14) replaces `_fwd_kernel`; plain version
  `fused_linear_fwd_plain`;
- `fused_linear_bwd_dx` (#15) replaces `_bwd_dx_kernel`; plain version
  `fused_linear_bwd_dx_plain`;
- `fused_linear_bwd_dw` (#16) replaces `_bwd_dw_kernel`; plain version
  `fused_linear_bwd_dw_plain`;
- `fq_weight`, the prologue of #14/#15 with bf16 operands; plain version
  `fq_weight_plain`.
`_FusedCore` joins them in an `autograd.Function` and `sp_linear_fused` is
the linear itself. The input and LoRA fake-quant stay `fake_quant_flat`
calls, whose STEs give the reference backward; the quantizer banks take no
gradient.

`scalars` is a (4,) float32 tensor on the operands' device: bits, kind,
LoRA scaling, 0 (the JAX kernels' SMEM operand), so one kernel serves every
precision slot and switching precision needs no host sync.

A wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. Each counts its launches in `<fn>.launches`.
With bf16 operands the kernels take K, N and r in multiples of 8 (TMA's
16-byte strides); the wrappers raise ValueError on other shapes.
"""

from __future__ import annotations

import torch

from ..quant.calibration import dynamic_scale_flat
from ..quant.functional import KIND_LOG, fake_quant_flat
from . import _build


def fused_linear_supported(x, p, q) -> bool:
    """The JAX shape gate: M % 256, K % 128, N % 128 and a rank that is 0
    or a multiple of 8. The port's kernels also take other shapes; the gate
    stays so that both packages pick the same path."""
    if x.ndim < 2:
        return False
    K = x.shape[-1]
    M = 1
    for d in x.shape[:-1]:
        M *= d
    N = p["w"].shape[1]
    r = p["lora_A"].shape[2] if "lora_A" in p else 0
    return (M % 256 == 0 and K % 128 == 0 and N % 128 == 0
            and (r == 0 or r % 8 == 0))


# ---------------------------------------------------------------------------
# Plain versions (the JAX kernels' formulas)
# ---------------------------------------------------------------------------


def fq_tile_plain(w, scale, zp, bits, kind, symmetric: bool, eps: float):
    """The in-tile weight fake-quant (`_fq_tile`), float32 in and out.

    Both domains computed and selected by `kind`, pass-through at
    bits >= 32. Its symmetric log code normalizes as qv/(2n) + 0.5, which
    rounds differently from `fake_quant_flat`'s ((qv/(2n) + 0.5)·full)/full:
    the fused and flat paths differ by an ulp at a symmetric log slot, in
    both packages. bits/kind are float32 tensors on w's device."""
    if symmetric:
        qmax = torch.exp2(bits - 1.0) - 1.0
        q = torch.minimum(torch.maximum(torch.round(w / scale), -qmax), qmax)
        mm = q * scale
    else:
        qmax = torch.exp2(bits) - 1.0
        q = torch.minimum(torch.maximum(torch.round(w / scale + zp),
                                        torch.zeros_like(qmax)), qmax)
        mm = (q - zp) * scale
    # log: the scale slot holds log_range, the zero-point slot log_min
    log_range, log_min = scale, zp
    zero_mask = torch.abs(w) < eps
    sign_w = torch.sign(w)
    log_abs = torch.log2(torch.clamp(torch.abs(w), min=eps))
    log_norm = torch.clamp((log_abs - log_min) / torch.clamp(log_range, min=eps),
                           0.0, 1.0)
    full = torch.exp2(bits) - 1.0
    if symmetric:
        n_levels = torch.exp2(bits - 1.0) - 1.0
        qv = torch.round((log_norm - 0.5) * 2.0 * n_levels)
        qv = torch.minimum(torch.maximum(qv, -n_levels), n_levels)
        q_norm = qv / (2.0 * n_levels) + 0.5
    else:
        qc = torch.round(log_norm * full)
        q_norm = torch.minimum(torch.maximum(qc, torch.zeros_like(full)), full) / full
    lg = torch.where(zero_mask, torch.zeros_like(w),
                     torch.exp2(q_norm * log_range + log_min) * sign_w)
    out = torch.where(kind == float(KIND_LOG), lg, mm)
    return torch.where(bits >= 32.0, w, out)


def fq_weight_plain(w, ws, wz, scalars, symmetric: bool, eps: float, transpose: bool):
    """Plain version of the bf16 weight prologue of #14/#15:
    bf16(FQ(w)) as (K, N), or as (N, K) when `transpose`."""
    wq = fq_tile_plain(w, ws, wz, scalars[0], scalars[1], symmetric, eps).to(torch.bfloat16)
    return wq.T.contiguous() if transpose else wq


def _f32_dot(a, b):
    """a @ b of operand-dtype tensors, summed in float32 (a bf16 product is
    exact in float32, as in the MXU dot with a float32 result)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def fused_linear_fwd_plain(xq, xa, w, ws, wz, bq, bias, scalars, symmetric, eps):
    """Plain version of kernel #14: out (M, N) float32 =
    xq · cdt(FQ(w)) + s·(xa · bq) + bias. xq (M, K), xa (M, r), bq (r, N) in
    the operand dtype; w (K, N), ws/wz (N,), bias (N,) float32."""
    bits, kind, scaling = scalars[0], scalars[1], scalars[2]
    wq = fq_tile_plain(w, ws, wz, bits, kind, symmetric, eps).to(xq.dtype)
    acc = _f32_dot(xq, wq)
    if xa.shape[1] > 0:
        acc = acc + scaling * _f32_dot(xa, bq)
    return acc + bias


def fused_linear_bwd_dx_plain(g_bf, w, ws, wz, bq, scalars, symmetric, eps):
    """Plain version of kernel #15: dxq (M, K) = g_bf · cdt(FQ(w))ᵀ and
    dxa (M, r) = s·(g_bf · bqᵀ), both float32 (dxa None when r = 0)."""
    bits, kind, scaling = scalars[0], scalars[1], scalars[2]
    wq = fq_tile_plain(w, ws, wz, bits, kind, symmetric, eps).to(g_bf.dtype)
    dxq = _f32_dot(g_bf, wq.T)
    dxa = scaling * _f32_dot(g_bf, bq.T) if bq.shape[0] > 0 else None
    return dxq, dxa


def fused_linear_bwd_dw_plain(xq, g_bf, scalars):
    """Plain version of kernel #16: dW (K, N) float32 = STE_w(xqᵀ · g_bf),
    the contraction over all M rows; the weight STE clamps dW to ±10 iff
    the log kind is active below 32 bits."""
    dw = _f32_dot(xq.T, g_bf.to(xq.dtype))
    clamp = (scalars[1] == float(KIND_LOG)) & (scalars[0] < 32.0)
    return torch.where(clamp, torch.clamp(dw, -10.0, 10.0), dw)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(what, named, dev):
    """Each (name, tensor, dtype, shape) a contiguous tensor on dev."""
    for name, t, dtype, shape in named:
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{what}: {name} must be a {dtype} tensor on {dev}; "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous with shape "
                             f"{tuple(shape)}; got {tuple(t.shape)}")


def _operand_dtype(what, t):
    if t.device.type != "cuda" or t.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: operands must be float32 or bfloat16 CUDA "
                         f"tensors; got {t.dtype} on {t.device}")
    return t.dtype


def _tma_shapes(what, **dims):
    """The bf16 kernels read K-major operands through TMA, whose global
    strides are multiples of 16 bytes: each dimension a multiple of 8."""
    bad = {k: v for k, v in dims.items() if v % 8}
    if bad:
        raise ValueError(f"{what}: with bfloat16 operands the kernel needs K, N and r "
                         f"in multiples of 8; got {bad}")


def fq_weight(w, ws, wz, scalars, symmetric, eps, transpose, bq=None):
    """The bf16 weight prologue of #14/#15: bf16(FQ(w)), each weight
    fake-quantized once, as (K, N) or, when `transpose`, (N, K); with
    `transpose` and bq (r, N) bf16 also bqᵀ (N, r) from the same launch,
    returned as (wq, bqT). CPU tensors take the plain version; CUDA tensors
    launch `fl_fq_weight` or raise."""
    if w.device.type == "cpu":
        wq = fq_weight_plain(w, ws, wz, scalars, symmetric, eps, transpose)
        return wq if bq is None else (wq, bq.T.contiguous())
    K, N = w.shape
    r = 0 if bq is None else bq.shape[0]
    f32, bf = torch.float32, torch.bfloat16
    named = [("w", w, f32, (K, N)), ("ws", ws, f32, (N,)), ("wz", wz, f32, (N,)),
             ("scalars", scalars, f32, (4,))]
    if bq is not None:
        if not transpose:
            raise ValueError("fq_weight: bq is transposed only with transpose=True")
        named.append(("bq", bq, bf, (r, N)))
    _check("fq_weight", named, w.device)
    wq = torch.empty((N, K) if transpose else (K, N), dtype=bf, device=w.device)
    bqt = torch.empty((N, r), dtype=bf, device=w.device)
    lib = _build.load("fused_linear")
    rc = lib.fused_linear_fq_weight(
        w.data_ptr(), ws.data_ptr(), wz.data_ptr(), scalars.data_ptr(),
        bq.data_ptr() if r else None, wq.data_ptr(), bqt.data_ptr() if r else None,
        K, N, r, int(transpose), int(symmetric), eps, _build.stream(w))
    _build.check(lib, rc, "fq_weight")
    fq_weight.launches += 1
    return wq if bq is None else (wq, bqt)


fq_weight.launches = 0


def fused_linear_fwd(xq, xa, w, ws, wz, bq, bias, scalars, symmetric, eps):
    """QAT linear forward (kernel #14); shapes as `fused_linear_fwd_plain`.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise. bf16 operands: one C call launches the prologue `fl_fq_weight`
    (counted in `fq_weight.launches`), which writes WqT and bqᵀ to a bf16
    workspace, then the TMA-fed wgmma GEMM, which runs the LoRA steps,
    scales them by s, and the K steps on top (one block per 128 x 128
    output tile). float operands: the plain tiled kernel, the f32 weight
    tile fake-quantized while it is staged."""
    if xq.device.type == "cpu":
        return fused_linear_fwd_plain(xq, xa, w, ws, wz, bq, bias, scalars,
                                      symmetric, eps)
    cdt = _operand_dtype("fused_linear_fwd", xq)
    M, K = xq.shape
    N, r = w.shape[1], xa.shape[1]
    f32 = torch.float32
    _check("fused_linear_fwd", (
        ("xq", xq, cdt, (M, K)), ("xa", xa, cdt, (M, r)), ("w", w, f32, (K, N)),
        ("ws", ws, f32, (N,)), ("wz", wz, f32, (N,)), ("bq", bq, cdt, (r, N)),
        ("bias", bias, f32, (N,)), ("scalars", scalars, f32, (4,))), xq.device)
    out = torch.empty((M, N), dtype=f32, device=xq.device)
    lib = _build.load("fused_linear")
    if cdt == torch.bfloat16:
        _tma_shapes("fused_linear_fwd", K=K, N=N, r=r)
        work = torch.empty(N * (K + r), dtype=cdt, device=xq.device)
        rc = lib.fused_linear_fwd_wgmma(
            xq.data_ptr(), xa.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(),
            bq.data_ptr(), bias.data_ptr(), scalars.data_ptr(), work.data_ptr(),
            out.data_ptr(), M, K, N, r, int(symmetric), eps, _build.stream(xq))
    else:
        rc = lib.fused_linear_fwd_f32(
            xq.data_ptr(), xa.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(),
            bq.data_ptr(), bias.data_ptr(), scalars.data_ptr(), out.data_ptr(),
            M, K, N, r, int(symmetric), eps, _build.stream(xq))
    _build.check(lib, rc, "fused_linear_fwd")
    fq_weight.launches += int(cdt == torch.bfloat16)  # the prologue
    fused_linear_fwd.launches += 1
    return out


fused_linear_fwd.launches = 0


def fused_linear_bwd_dx(g_bf, w, ws, wz, bq, scalars, symmetric, eps):
    """dxq and dxa (kernel #15); shapes as `fused_linear_bwd_dx_plain`. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise. bf16 operands: one C call launches the prologue `fl_fq_weight`
    (counted in `fq_weight.launches`), which writes Wq (K, N) to a bf16
    workspace, then the wgmma GEMM, one block per 128 x 128 tile of dxq and
    per 128-column tile of dxa, each reducing over N. float operands: the
    plain tiled kernel."""
    if g_bf.device.type == "cpu":
        return fused_linear_bwd_dx_plain(g_bf, w, ws, wz, bq, scalars, symmetric, eps)
    cdt = _operand_dtype("fused_linear_bwd_dx", g_bf)
    M, N = g_bf.shape
    K, r = w.shape[0], bq.shape[0]
    f32 = torch.float32
    _check("fused_linear_bwd_dx", (
        ("g_bf", g_bf, cdt, (M, N)), ("w", w, f32, (K, N)), ("ws", ws, f32, (N,)),
        ("wz", wz, f32, (N,)), ("bq", bq, cdt, (r, N)), ("scalars", scalars, f32, (4,))),
        g_bf.device)
    dxq = torch.empty((M, K), dtype=f32, device=g_bf.device)
    dxa = torch.empty((M, r), dtype=f32, device=g_bf.device)
    lib = _build.load("fused_linear")
    if cdt == torch.bfloat16:
        _tma_shapes("fused_linear_bwd_dx", K=K, N=N, r=r)
        work = torch.empty(K * N, dtype=cdt, device=g_bf.device)
        rc = lib.fused_linear_bwd_dx_wgmma(
            g_bf.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(), bq.data_ptr(),
            scalars.data_ptr(), work.data_ptr(), dxq.data_ptr(), dxa.data_ptr(), M, K, N, r,
            int(symmetric), eps, _build.stream(g_bf))
    else:
        rc = lib.fused_linear_bwd_dx_f32(
            g_bf.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(), bq.data_ptr(),
            scalars.data_ptr(), dxq.data_ptr(), dxa.data_ptr(), M, K, N, r,
            int(symmetric), eps, _build.stream(g_bf))
    _build.check(lib, rc, "fused_linear_bwd_dx")
    fq_weight.launches += int(cdt == torch.bfloat16)  # the prologue
    fused_linear_bwd_dx.launches += 1
    return dxq, (dxa if r > 0 else None)


fused_linear_bwd_dx.launches = 0

DW_TILE, DW_STEP = 128, 32  # the dW kernel's (K, N) tile and its step over M
DW_MAX_SPLITS = 8


def dw_splits(M: int, K: int, N: int, n_sm: int) -> int:
    """Chunks of M for the dW kernel. Its blocks (one per (K, N) tile and
    chunk) run two to an SM, in waves of 2·n_sm; a block takes time in
    proportion to its steps over M. The count minimizes waves x steps per
    block, the fewest chunks among equals (each chunk adds a (K, N) float32
    partial to write and sum)."""
    tiles = -(-K // DW_TILE) * -(-N // DW_TILE)
    steps = -(-M // DW_STEP)
    cost = lambda s: -(-tiles * s // (2 * n_sm)) * -(-steps // s)
    return min(range(1, min(DW_MAX_SPLITS, steps) + 1), key=lambda s: (cost(s), s))


def fused_linear_bwd_dw(xq, g_bf, scalars):
    """dW through the weight STE (kernel #16); shapes as
    `fused_linear_bwd_dw_plain`. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. One block per 128 x 128 tile of dW
    and chunk of M; with more than one chunk (`dw_splits`) the chunks'
    partial sums go to a float32 workspace and a second CUDA kernel sums
    them in a fixed order and clamps (no atomics, deterministic)."""
    if xq.device.type == "cpu":
        return fused_linear_bwd_dw_plain(xq, g_bf, scalars)
    cdt = _operand_dtype("fused_linear_bwd_dw", xq)
    M, K = xq.shape
    N = g_bf.shape[1]
    _check("fused_linear_bwd_dw", (
        ("xq", xq, cdt, (M, K)), ("g_bf", g_bf, cdt, (M, N)),
        ("scalars", scalars, torch.float32, (4,))), xq.device)
    n_sm = torch.cuda.get_device_properties(xq.device).multi_processor_count
    splits = dw_splits(M, K, N, n_sm)
    dw = torch.empty((K, N), dtype=torch.float32, device=xq.device)
    work = (torch.empty((splits, K, N), dtype=torch.float32, device=xq.device)
            if splits > 1 else dw)
    lib = _build.load("fused_linear")
    rc = lib.fused_linear_bwd_dw(
        xq.data_ptr(), g_bf.data_ptr(), scalars.data_ptr(), dw.data_ptr(),
        work.data_ptr(), M, K, N, splits, int(cdt == torch.bfloat16),
        _build.stream(xq))
    _build.check(lib, rc, "fused_linear_bwd_dw")
    fused_linear_bwd_dw.launches += 1
    return dw


fused_linear_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# autograd core and the linear
# ---------------------------------------------------------------------------


class _FusedCore(torch.autograd.Function):
    """out = fused_linear_fwd(...); the backward runs #15, #16 (only when w
    needs a gradient) and the small dbq/dbias products. g is rounded to the
    operand dtype before #15, #16 and dbq; dbias sums the unrounded g."""

    @staticmethod
    def forward(ctx, xq, xa, bq, bias, w, ws, wz, scalars, symmetric, eps):
        ctx.save_for_backward(xq, xa, bq, w, ws, wz, scalars)
        ctx.symmetric, ctx.eps = symmetric, eps
        return fused_linear_fwd(xq, xa, w, ws, wz, bq, bias, scalars, symmetric, eps)

    @staticmethod
    def backward(ctx, g):
        xq, xa, bq, w, ws, wz, scalars = ctx.saved_tensors
        need = ctx.needs_input_grad
        g_bf = g.contiguous().to(xq.dtype)
        dxq, dxa = fused_linear_bwd_dx(g_bf, w, ws, wz, bq, scalars, ctx.symmetric,
                                       ctx.eps)
        dw = fused_linear_bwd_dw(xq, g_bf, scalars) if need[4] else None
        dxa_out = dbq = None
        if xa.shape[1] > 0:
            dxa_out = dxa.to(xa.dtype)
            if need[2]:
                dbq = (scalars[2] * _f32_dot(xa.T, g_bf)).to(bq.dtype)
        dbias = g.sum(dim=0) if need[3] else None
        return (dxq.to(xq.dtype), dxa_out, dbq, dbias, dw,
                None, None, None, None, None)


def sp_linear_fused(x, p, prec, bits, kind, scaling, cfg):
    """Quantized linear with per-bit LoRA through kernels #14-#16 (the JAX
    `sp_linear_fused`). x (..., K) float32; returns (..., N) float32.

    The input and the LoRA banks are fake-quantized by `fake_quant_flat`
    (their STEs give the reference backward); xa = x·Aq is a product of
    operand-dtype values rounded to the operand dtype, so its cotangent
    goes through that rounding; the weight fake-quant, the GEMM and the
    LoRA epilogue run in the kernels."""
    from ..models.sp_model import torch_dtype

    q = cfg.quant
    cdt = torch_dtype(cfg.compute_dtype)
    lead, K = x.shape[:-1], x.shape[-1]
    N = p["w"].shape[1]
    x2d = x.reshape(-1, K)
    xq = fake_quant_flat(x2d, p["iq_scale"][prec], p["iq_zp"][prec], bits, kind,
                         q.symmetric, q.eps).to(cdt)
    r = q.max_rank
    if r > 0:
        A, B = p["lora_A"][prec], p["lora_B"][prec]
        ch = 1 if q.per_channel else None
        a_s, a_z = dynamic_scale_flat(A, bits, kind, ch, q.symmetric, q.eps)
        b_s, b_z = dynamic_scale_flat(B, bits, kind, ch, q.symmetric, q.eps)
        Aq = fake_quant_flat(A, a_s, a_z, bits, kind, q.symmetric, q.eps)
        Bq = fake_quant_flat(B, b_s, b_z, bits, kind, q.symmetric, q.eps)
        # the raw input feeds LoRA (reference lora.py:149)
        xa = _f32_dot(x2d.to(cdt), Aq.to(cdt)).to(cdt)
        bq = Bq.to(cdt)
    else:
        xa = x2d.new_zeros((x2d.shape[0], 0), dtype=cdt)
        bq = x2d.new_zeros((0, N), dtype=cdt)
    ws = p["wq_scale"][prec].to(torch.float32).expand(N).contiguous()
    wz = p["wq_zp"][prec].to(torch.float32).expand(N).contiguous()
    bias = p["b"].to(torch.float32)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=x.device)
    scalars = torch.stack([f32(bits), f32(kind), f32(scaling), f32(0.0)])
    out = _FusedCore.apply(xq, xa.contiguous(), bq.contiguous(), bias, p["w"], ws,
                           wz, scalars, q.symmetric, q.eps)
    return out.reshape(*lead, N)
