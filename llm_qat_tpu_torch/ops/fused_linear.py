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
TMA-fed wgmma kernel. #16 (dW = xqᵀ·g, no weight) runs the same GEMM on
xq and g as they lie, MN-major, with M split over the blocks of a thread
block cluster. Three Pallas kernels are replaced by hand-written
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

Students (`student_mode="vmap"`): every kernel, plain version and wrapper
also takes a leading axis of S students, JAX's shapes under `jax.vmap` of
its fused core, where the batched `pallas_call` prepends the vmapped axis
to each kernel's grid: xq (S, M, K), xa (S, M, r), bq (S, r, N), ws and wz
(S, N), scalars (S, 4), g (S, M, N) per student; w (K, N) and bias (N,)
shared. #14 and #15 give (S, M, ·) outputs; #16 gives the shared weight's
gradient (K, N), the sum over the students of each one's dW through its
own STE (JAX's batched #16 gives (S, K, N), which the vmap's transpose
sums). One wrapper call is one launch of each kernel for all S students.

A wrapper takes its plain version for CPU tensors only; for CUDA tensors it
launches its kernel or raises. Each counts its launches in `<fn>.launches`,
one a call whatever S is.
With bf16 operands the kernels take K, N and r in multiples of 8 (TMA's
16-byte strides); the wrappers raise ValueError on other shapes.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..quant.calibration import dynamic_scale_flat
from ..quant.functional import KIND_LOG, fake_quant_flat
from . import _build
from .matmul import student_rows


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
    both packages. bits/kind are float32 tensors on w's device; every
    operand broadcasts, so scale/zp (S, 1, N) and bits/kind (S, 1, 1)
    quantize a shared w (K, N) once per student, (S, K, N)."""
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


def _scalar(scalars, i):
    """Entry i of the scalars, (1, 1) or per student (S, 1, 1), to
    broadcast against a (K, N) or (S, M, N) operand."""
    return scalars[..., i, None, None]


def _fq_students(w, ws, wz, scalars, symmetric, eps):
    """FQ(w) float32 with each student's scales and slot: (K, N), or
    (S, K, N) for ws/wz (S, N) and scalars (S, 4)."""
    return fq_tile_plain(w, ws.unsqueeze(-2), wz.unsqueeze(-2), _scalar(scalars, 0),
                         _scalar(scalars, 1), symmetric, eps)


def fq_weight_plain(w, ws, wz, scalars, symmetric: bool, eps: float, transpose: bool):
    """Plain version of the bf16 weight prologue of #14/#15:
    bf16(FQ(w)) as (K, N), or as (N, K) when `transpose`; with S students
    (ws/wz (S, N), scalars (S, 4)) one per student, (S, K, N) or (S, N, K)."""
    wq = _fq_students(w, ws, wz, scalars, symmetric, eps).to(torch.bfloat16)
    return wq.transpose(-1, -2).contiguous() if transpose else wq


def _f32_dot(a, b):
    """a @ b of operand-dtype tensors, summed in float32 (a bf16 product is
    exact in float32, as in the MXU dot with a float32 result)."""
    return torch.matmul(a.to(torch.float32), b.to(torch.float32))


def fused_linear_fwd_plain(xq, xa, w, ws, wz, bq, bias, scalars, symmetric, eps):
    """Plain version of kernel #14: out (M, N) float32 =
    xq · cdt(FQ(w)) + s·(xa · bq) + bias. xq (M, K), xa (M, r), bq (r, N) in
    the operand dtype; w (K, N), ws/wz (N,), bias (N,) float32. With S
    students: xq (S, M, K), xa (S, M, r), bq (S, r, N), ws/wz (S, N),
    scalars (S, 4), each student's product with its own FQ(w), (S, M, N)."""
    wq = _fq_students(w, ws, wz, scalars, symmetric, eps).to(xq.dtype)
    acc = _f32_dot(xq, wq)
    if xa.shape[-1] > 0:
        acc = acc + _scalar(scalars, 2) * _f32_dot(xa, bq)
    return acc + bias


def fused_linear_bwd_dx_plain(g_bf, w, ws, wz, bq, scalars, symmetric, eps):
    """Plain version of kernel #15: dxq (M, K) = g_bf · cdt(FQ(w))ᵀ and
    dxa (M, r) = s·(g_bf · bqᵀ), both float32 (dxa None when r = 0). With S
    students (g_bf (S, M, N), bq (S, r, N), ws/wz (S, N), scalars (S, 4)):
    (S, M, K) and (S, M, r)."""
    wq = _fq_students(w, ws, wz, scalars, symmetric, eps).to(g_bf.dtype)
    dxq = _f32_dot(g_bf, wq.transpose(-1, -2))
    dxa = (_scalar(scalars, 2) * _f32_dot(g_bf, bq.transpose(-1, -2))
           if bq.shape[-2] > 0 else None)
    return dxq, dxa


def fused_linear_bwd_dw_plain(xq, g_bf, scalars):
    """Plain version of kernel #16: dW (K, N) float32 = STE_w(xqᵀ · g_bf),
    the contraction over all M rows; the weight STE clamps dW to ±10 iff
    the log kind is active below 32 bits. With S students (xq (S, M, K),
    g_bf (S, M, N), scalars (S, 4)): Σ_s STE_s(xq_sᵀ · g_s), each student's
    dW clamped by its own slot before the sum."""
    dw = _f32_dot(xq.transpose(-1, -2), g_bf.to(xq.dtype))
    clamp = (_scalar(scalars, 1) == float(KIND_LOG)) & (_scalar(scalars, 0) < 32.0)
    dw = torch.where(clamp, torch.clamp(dw, -10.0, 10.0), dw)
    return dw.sum(dim=0) if xq.ndim == 3 else dw


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


def _lead(what, t, ndim):
    """((), 1) for an unbatched operand of `ndim` dims, ((S,), S) for one
    with a leading axis of S students."""
    if t.ndim == ndim:
        return (), 1
    if t.ndim == ndim + 1 and t.shape[0] > 0:
        return (t.shape[0],), t.shape[0]
    raise ValueError(f"{what}: expected {ndim} dims, or {ndim + 1} with a leading student "
                     f"axis; got shape {tuple(t.shape)}")


def _tma_shapes(what, **dims):
    """The bf16 kernels read their operands through TMA, whose global
    strides are multiples of 16 bytes: each dimension a multiple of 8."""
    bad = {k: v for k, v in dims.items() if v % 8}
    if bad:
        raise ValueError(f"{what}: with bfloat16 operands the kernel needs K, N and r "
                         f"in multiples of 8; got {bad}")


def fq_weight(w, ws, wz, scalars, symmetric, eps, transpose, bq=None):
    """The bf16 weight prologue of #14/#15: bf16(FQ(w)), each weight
    fake-quantized once, as (K, N) or, when `transpose`, (N, K); with
    `transpose` and bq (r, N) bf16 also bqᵀ (N, r) from the same launch,
    returned as (wq, bqT). With S students (ws/wz (S, N), scalars (S, 4),
    bq (S, r, N)) one launch writes each student's, (S, K, N) or (S, N, K)
    and (S, N, r). CPU tensors take the plain version; CUDA tensors launch
    `fl_fq_weight` or raise."""
    if w.device.type == "cpu":
        wq = fq_weight_plain(w, ws, wz, scalars, symmetric, eps, transpose)
        return wq if bq is None else (wq, bq.transpose(-1, -2).contiguous())
    K, N = w.shape
    lead, S = _lead("fq_weight", scalars, 1)
    r = 0 if bq is None else bq.shape[-2]
    f32, bf = torch.float32, torch.bfloat16
    named = [("w", w, f32, (K, N)), ("ws", ws, f32, lead + (N,)),
             ("wz", wz, f32, lead + (N,)), ("scalars", scalars, f32, lead + (4,))]
    if bq is not None:
        if not transpose:
            raise ValueError("fq_weight: bq is transposed only with transpose=True")
        named.append(("bq", bq, bf, lead + (r, N)))
    _check("fq_weight", named, w.device)
    wq = torch.empty(lead + ((N, K) if transpose else (K, N)), dtype=bf, device=w.device)
    bqt = torch.empty(lead + (N, r), dtype=bf, device=w.device)
    lib = _build.load("fused_linear")
    rc = lib.fused_linear_fq_weight(
        w.data_ptr(), ws.data_ptr(), wz.data_ptr(), scalars.data_ptr(),
        bq.data_ptr() if r else None, wq.data_ptr(), bqt.data_ptr() if r else None,
        K, N, r, S, int(transpose), int(symmetric), eps, _build.stream(w))
    _build.check(lib, rc, "fq_weight")
    fq_weight.launches += 1
    return wq if bq is None else (wq, bqt)


fq_weight.launches = 0


def fused_linear_fwd(xq, xa, w, ws, wz, bq, bias, scalars, symmetric, eps):
    """QAT linear forward (kernel #14); shapes as `fused_linear_fwd_plain`,
    with or without the student axis. CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise. bf16 operands: one C call
    launches the prologue `fl_fq_weight` (counted in `fq_weight.launches`),
    which writes each student's WqT and bqᵀ to a bf16 workspace, then the
    TMA-fed wgmma GEMM, which runs the LoRA steps, scales them by s, and
    the K steps on top (one block per 128 x 128 output tile and student).
    float operands: the plain tiled kernel, the f32 weight tile
    fake-quantized while it is staged."""
    if xq.device.type == "cpu":
        return fused_linear_fwd_plain(xq, xa, w, ws, wz, bq, bias, scalars,
                                      symmetric, eps)
    cdt = _operand_dtype("fused_linear_fwd", xq)
    lead, S = _lead("fused_linear_fwd", xq, 2)
    M, K = xq.shape[-2:]
    N, r = w.shape[1], xa.shape[-1]
    f32 = torch.float32
    _check("fused_linear_fwd", (
        ("xq", xq, cdt, lead + (M, K)), ("xa", xa, cdt, lead + (M, r)),
        ("w", w, f32, (K, N)), ("ws", ws, f32, lead + (N,)), ("wz", wz, f32, lead + (N,)),
        ("bq", bq, cdt, lead + (r, N)), ("bias", bias, f32, (N,)),
        ("scalars", scalars, f32, lead + (4,))), xq.device)
    out = torch.empty(lead + (M, N), dtype=f32, device=xq.device)
    lib = _build.load("fused_linear")
    if cdt == torch.bfloat16:
        _tma_shapes("fused_linear_fwd", K=K, N=N, r=r)
        work = torch.empty(S * N * (K + r), dtype=cdt, device=xq.device)
        rc = lib.fused_linear_fwd_wgmma(
            xq.data_ptr(), xa.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(),
            bq.data_ptr(), bias.data_ptr(), scalars.data_ptr(), work.data_ptr(),
            out.data_ptr(), M, K, N, r, S, int(symmetric), eps, _build.stream(xq))
    else:
        rc = lib.fused_linear_fwd_f32(
            xq.data_ptr(), xa.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(),
            bq.data_ptr(), bias.data_ptr(), scalars.data_ptr(), out.data_ptr(),
            M, K, N, r, S, int(symmetric), eps, _build.stream(xq))
    _build.check(lib, rc, "fused_linear_fwd")
    fq_weight.launches += int(cdt == torch.bfloat16)  # the prologue
    fused_linear_fwd.launches += 1
    return out


fused_linear_fwd.launches = 0


def fused_linear_bwd_dx(g_bf, w, ws, wz, bq, scalars, symmetric, eps):
    """dxq and dxa (kernel #15); shapes as `fused_linear_bwd_dx_plain`, with
    or without the student axis. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise. bf16 operands: one C call launches
    the prologue `fl_fq_weight` (counted in `fq_weight.launches`), which
    writes each student's Wq (K, N) to a bf16 workspace, then the wgmma
    GEMM, one block per 128 x 128 tile of dxq and per 128-column tile of
    dxa and student, each reducing over N. float operands: the plain tiled
    kernel."""
    if g_bf.device.type == "cpu":
        return fused_linear_bwd_dx_plain(g_bf, w, ws, wz, bq, scalars, symmetric, eps)
    cdt = _operand_dtype("fused_linear_bwd_dx", g_bf)
    lead, S = _lead("fused_linear_bwd_dx", g_bf, 2)
    M, N = g_bf.shape[-2:]
    K, r = w.shape[0], bq.shape[-2]
    f32 = torch.float32
    _check("fused_linear_bwd_dx", (
        ("g_bf", g_bf, cdt, lead + (M, N)), ("w", w, f32, (K, N)),
        ("ws", ws, f32, lead + (N,)), ("wz", wz, f32, lead + (N,)),
        ("bq", bq, cdt, lead + (r, N)), ("scalars", scalars, f32, lead + (4,))),
        g_bf.device)
    dxq = torch.empty(lead + (M, K), dtype=f32, device=g_bf.device)
    dxa = torch.empty(lead + (M, r), dtype=f32, device=g_bf.device)
    lib = _build.load("fused_linear")
    if cdt == torch.bfloat16:
        _tma_shapes("fused_linear_bwd_dx", K=K, N=N, r=r)
        work = torch.empty(S * K * N, dtype=cdt, device=g_bf.device)
        rc = lib.fused_linear_bwd_dx_wgmma(
            g_bf.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(), bq.data_ptr(),
            scalars.data_ptr(), work.data_ptr(), dxq.data_ptr(), dxa.data_ptr(), M, K, N, r,
            S, int(symmetric), eps, _build.stream(g_bf))
    else:
        rc = lib.fused_linear_bwd_dx_f32(
            g_bf.data_ptr(), w.data_ptr(), ws.data_ptr(), wz.data_ptr(), bq.data_ptr(),
            scalars.data_ptr(), dxq.data_ptr(), dxa.data_ptr(), M, K, N, r, S,
            int(symmetric), eps, _build.stream(g_bf))
    _build.check(lib, rc, "fused_linear_bwd_dx")
    fq_weight.launches += int(cdt == torch.bfloat16)  # the prologue
    fused_linear_bwd_dx.launches += 1
    return dxq, (dxa if r > 0 else None)


fused_linear_bwd_dx.launches = 0

# Kernel #16 with bf16 operands: its (K, N) tile, its step over M (GK) and
# its blocks per SM (a 4-stage ring of 48 KB stages fills shared memory).
DW_TILE, DW_STEP, DW_BLOCKS_PER_SM = (128, 256), 64, 1
# The plan's limits on the split of M. Each chunk is one block of a thread
# block cluster, and the kernel takes up to DW_MAX_SPLITS (8, a cluster's
# portable size). The wgmma's float32 accumulation errs in proportion to
# the length of its chain: on an H100 an unsplit M = 8192 (128 steps) put
# dW up to 1.1e-5 of max |plain| from its plain version, 64 steps up to
# 5.3e-6, so a chunk takes at most DW_MAX_CHUNK_STEPS steps, with up to
# DW_MAX_SPLITS chunks where that needs them. Past DW_MAX_SPLITS x
# DW_MAX_CHUNK_STEPS steps (M > 32768) even 8 chunks are longer; at
# M = 65536 (8 chunks of 128 steps) dW still kept within 1e-5 of max
# |plain| on an H100 (PERF.md §6; `tests/test_torch_cuda.py::
# test_fused_dw_long_m_keeps_chunks_short`). Otherwise the plan takes at
# most DW_FAST_SPLITS: clusters of more blocks were slower than the best of
# 2-5 at every GPT-2 shape (PERF.md; the split sweep of `chip_smoke.py
# --fused-linear`).
DW_MAX_SPLITS, DW_FAST_SPLITS = 8, 5
DW_MAX_CHUNK_STEPS = 64
# A block's fixed cost (its ring's first fill, the epilogue and the
# cluster's sum), in steps: blocks of few steps lose to it.
DW_BLOCK_COST = 10


def dw_splits(M: int, K: int, N: int, n_sm: int, students: int = 1) -> int:
    """Chunks of M for kernel #16 with bf16 operands, each a whole number
    of DW_STEP steps and one block of a cluster. Its blocks (one per (K, N)
    tile, chunk and student) run in waves of DW_BLOCKS_PER_SM·n_sm; a block
    takes time in proportion to its steps over M plus DW_BLOCK_COST. The
    count minimizes waves x (steps per block + DW_BLOCK_COST), the fewest
    chunks among equals, from the fewest that keep a chunk within
    DW_MAX_CHUNK_STEPS (at most DW_MAX_SPLITS) to DW_FAST_SPLITS (or the
    steps of M, if fewer). M is one student's rows."""
    tiles = students * -(-K // DW_TILE[0]) * -(-N // DW_TILE[1])
    steps = -(-M // DW_STEP)
    wave = DW_BLOCKS_PER_SM * n_sm
    cost = lambda s: -(-tiles * s // wave) * (-(-steps // s) + DW_BLOCK_COST)
    lo = min(-(-steps // DW_MAX_CHUNK_STEPS), DW_MAX_SPLITS, steps)
    hi = max(lo, min(DW_FAST_SPLITS, steps))
    return min(range(lo, hi + 1), key=lambda s: (cost(s), s))


def dw_chunks(M: int, splits: int):
    """The (first, end) rows of M that each of #16's `splits` blocks of a
    cluster sums; the wrapper passes these bounds to the kernel. Whole
    DW_STEP steps, block z from step ⌊steps·z/splits⌋, the last ending
    at M."""
    steps = -(-M // DW_STEP)
    bound = lambda z: min(M, steps * z // splits * DW_STEP)
    return [(bound(z), bound(z + 1)) for z in range(splits)]


# The plan and the chunk bounds are cached: at attn_proj's shape the kernel
# runs for about as long as a call takes on the host.
@functools.lru_cache(maxsize=None)
def _dw_plan(M: int, K: int, N: int, students: int, index: int) -> int:
    return dw_splits(M, K, N, _build.sm_count(index), students)


@functools.lru_cache(maxsize=None)
def _dw_rows(M: int, splits: int):
    """`dw_chunks`' bounds as the C array the kernel's entry point reads:
    the first row of each chunk, then M."""
    rows = [b for b, _ in dw_chunks(M, splits)] + [M]
    return (ctypes.c_int * len(rows))(*rows)


def launch_dw_wgmma(xq, g_bf, scalars, dw, splits: int) -> None:
    """One launch of #16's bf16 kernel into `dw` with each student's M
    rows in `splits` chunks (`dw_chunks`), whatever the plan; raises on a
    CUDA error. xq (M, K) or (S, M, K); dw (K, N), or (S, K, N) with each
    student's dW through its STE. Not counted: `fused_linear_bwd_dw`
    counts its own launches, and the split sweep and tests that call this
    directly hold the kernel, not the path."""
    M, K = xq.shape[-2:]
    N = g_bf.shape[-1]
    S = xq.shape[0] if xq.ndim == 3 else 1
    lib = _build.load("fused_linear")
    rc = lib.fused_linear_bwd_dw_wgmma(
        xq.data_ptr(), g_bf.data_ptr(), scalars.data_ptr(), dw.data_ptr(), M, K, N, S, splits,
        _dw_rows(M, splits), _build.stream(xq))
    _build.check(lib, rc, "fused_linear_bwd_dw")


def fused_linear_bwd_dw(xq, g_bf, scalars):
    """dW through the weight STE (kernel #16); shapes as
    `fused_linear_bwd_dw_plain`, with or without the student axis. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise. bf16 operands: one C call encodes the MN-major tensor maps of xq
    and g and launches the TMA-fed wgmma GEMM, one block per 128 x 256 tile
    of dW, chunk of M and student (`dw_splits`, `dw_chunks`); the chunks of
    a tile are the blocks of a thread block cluster, which sum their
    partial tiles in a fixed order through distributed shared memory and
    clamp by their student's STE (no atomics, deterministic). K and N must
    be multiples of 8. float operands: the plain tiled kernel over all of
    M. With S students the kernel writes each one's clamped dW to an
    (S, K, N) float32 workspace, and one `torch.sum` over S (deterministic)
    gives the shared weight's gradient, as JAX sums its batched #16's
    output over the vmapped axis."""
    if xq.device.type == "cpu":
        return fused_linear_bwd_dw_plain(xq, g_bf, scalars)
    cdt = _operand_dtype("fused_linear_bwd_dw", xq)
    lead, S = _lead("fused_linear_bwd_dw", xq, 2)
    M, K = xq.shape[-2:]
    N = g_bf.shape[-1]
    _check("fused_linear_bwd_dw", (
        ("xq", xq, cdt, lead + (M, K)), ("g_bf", g_bf, cdt, lead + (M, N)),
        ("scalars", scalars, torch.float32, lead + (4,))), xq.device)
    dw = torch.empty(lead + (K, N), dtype=torch.float32, device=xq.device)
    if cdt == torch.bfloat16:
        _tma_shapes("fused_linear_bwd_dw", K=K, N=N)
        launch_dw_wgmma(xq, g_bf, scalars, dw, _dw_plan(M, K, N, S, xq.device.index))
    else:
        lib = _build.load("fused_linear")
        rc = lib.fused_linear_bwd_dw_f32(
            xq.data_ptr(), g_bf.data_ptr(), scalars.data_ptr(), dw.data_ptr(), M, K, N, S,
            _build.stream(xq))
        _build.check(lib, rc, "fused_linear_bwd_dw")
    fused_linear_bwd_dw.launches += 1
    return dw.sum(dim=0) if lead else dw


fused_linear_bwd_dw.launches = 0


# ---------------------------------------------------------------------------
# autograd core and the linear
# ---------------------------------------------------------------------------


class _FusedCore(torch.autograd.Function):
    """out = fused_linear_fwd(...); the backward runs #15, #16 (only when w
    needs a gradient) and the small dbq/dbias products. g is rounded to the
    operand dtype before #15, #16 and dbq; dbias sums the unrounded g. With
    the student axis each kernel runs once for all students; dbq is each
    student's s·xaᵀ·g (one batched product) and dbias sums every student's
    rows, as JAX computes them outside its kernels."""

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
        if xa.shape[-1] > 0:
            dxa_out = dxa.to(xa.dtype)
            if need[2]:
                dbq = (_scalar(scalars, 2) * _f32_dot(xa.transpose(-1, -2), g_bf)).to(bq.dtype)
        dbias = g.reshape(-1, g.shape[-1]).sum(dim=0) if need[3] else None
        return (dxq.to(xq.dtype), dxa_out, dbq, dbias, dw,
                None, None, None, None, None)


BANKS = ("iq_scale", "iq_zp", "wq_scale", "wq_zp", "lora_A", "lora_B")


def sp_linear_fused(x, p, prec, bits, kind, scaling, cfg):
    """Quantized linear with per-bit LoRA through kernels #14-#16 (the JAX
    `sp_linear_fused`). x (..., K) float32; returns (..., N) float32.

    The input and the LoRA banks are fake-quantized by `fake_quant_flat`
    (their STEs give the reference backward); xa = x·Aq is a product of
    operand-dtype values rounded to the operand dtype, so its cotangent
    goes through that rounding; the weight fake-quant, the GEMM and the
    LoRA epilogue run in the kernels.

    With a vector of S slots (`prec`, and `bits`, `kind`, `scaling`
    gathered by it), x is (S, ..., K), as under JAX's `jax.vmap` over the
    students: the input and LoRA fake-quant run once for all students with
    per-student quantizers (broadcast as on the flat path), the students'
    rows meet their own LoRA A in one batched product, and each kernel
    runs once for all students, each with its own scalars, weight scales
    and LoRA banks; the shared `w` takes the sum of the students' dW.
    """
    from ..models.sp_model import per_student, torch_dtype

    q = cfg.quant
    cdt = torch_dtype(cfg.compute_dtype)
    w, bias = p["w"], p["b"]
    banks = {k: p[k][prec] for k in BANKS if k in p}
    lead, K = x.shape[:-1], x.shape[-1]
    N = w.shape[1]
    if isinstance(prec, torch.Tensor) and prec.ndim == 1:
        students = (prec.shape[0],)
        x2d = x.reshape(*students, -1, K)
        at = per_student  # a per-student operand broadcast against n dims
    else:
        students = ()
        x2d = x.reshape(-1, K)
        at = lambda v, n: v
    xq = fake_quant_flat(x2d, at(banks["iq_scale"], 3), at(banks["iq_zp"], 3),
                         at(bits, 3), at(kind, 3), q.symmetric, q.eps).to(cdt)
    r = q.max_rank
    if r > 0:
        A, B = banks["lora_A"], banks["lora_B"]
        ch = 1 if q.per_channel else None
        bk = (at(bits, 3), at(kind, 3))
        a_s, a_z = dynamic_scale_flat(A, *bk, ch, q.symmetric, q.eps, len(students))
        b_s, b_z = dynamic_scale_flat(B, *bk, ch, q.symmetric, q.eps, len(students))
        Aq = fake_quant_flat(A, a_s, a_z, *bk, q.symmetric, q.eps)
        Bq = fake_quant_flat(B, b_s, b_z, *bk, q.symmetric, q.eps)
        # the raw input feeds LoRA (reference lora.py:149)
        xa = student_rows(lambda u, v: _f32_dot(u.to(cdt), v.to(cdt)).to(cdt), x2d, Aq)
        bq = Bq.to(cdt)
    else:
        xa = x2d.new_zeros(x2d.shape[:-1] + (0,), dtype=cdt)
        bq = x2d.new_zeros(students + (0, N), dtype=cdt)
    ws = banks["wq_scale"].to(torch.float32).expand(*students, N).contiguous()
    wz = banks["wq_zp"].to(torch.float32).expand(*students, N).contiguous()
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=x.device)
    scalars = torch.stack([f32(bits), f32(kind), f32(scaling),
                           torch.zeros_like(f32(bits))], dim=-1)
    out = _FusedCore.apply(xq, xa.contiguous(), bq.contiguous(), bias.to(torch.float32),
                           w, ws, wz, scalars, q.symmetric, q.eps)
    return out.reshape(*lead, N)
