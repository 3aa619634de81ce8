"""Dequantize-and-multiply for int8 and nibble-packed int4 weights.

Counterpart of `llm_qat_tpu/ops/quant_matmul.py`. Weights are stored as
integer codes with a per-column (or per-tensor) scale; the product is
x @ (codes · scale).

- `pack_int8`, `pack_int4`, `unpack_int4`: the JAX package's packings,
  bit for bit. int4 interleaves rows: byte row k of (K/2, N) holds code row
  2k in its low nibble and row 2k + 1 in its high nibble, each stored as
  q + 8 in [1, 15].
- `quant_matmul_int8_reference` / `_int4_reference`: the float32 product of
  x with the dequantized weight (what JAX runs off the TPU).
- `quant_matmul_int8` (kernel #10) / `quant_matmul_int4` (kernel #11): the
  Pallas kernels' arithmetic: x rounded to bf16, times the codes as bf16
  (exact), float32 sums, times the column scale after the sum. CPU tensors
  take the plain versions `quant_matmul_int8_plain` / `_int4_plain`; CUDA
  tensors launch the one templated GEMM in `csrc/quant_matmul.cu` or raise.
  Each counts its launches in `<fn>.launches`.
- `quant_matmul(bits=8|4)`: the JAX dispatch, the kernel for CUDA tensors
  and the reference for CPU ones (JAX takes the reference off the TPU).

bf16 x bf16 products are exact in float32, so a kernel and its plain
version differ by the order of the float32 sums only.
"""

from __future__ import annotations

import torch

from . import _build


def pack_int8(w, per_channel: bool = True):
    """w (K, N) float → (int8 codes (K, N), scale (N,) or (1,)): absmax / 127."""
    w = w.to(torch.float32)
    dims = (0,) if per_channel else (0, 1)
    scale = torch.clamp(w.abs().amax(dim=dims), min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1)


def pack_int4(w, per_channel: bool = True):
    """w (K, N) float, K even → (uint8 (K/2, N) of two +8 nibbles along K,
    scale (N,) or (1,)): absmax / 7, codes in ±7."""
    w = w.to(torch.float32)
    K = w.shape[0]
    if K % 2:
        raise ValueError(f"int4 packing needs an even K; got {K}")
    dims = (0,) if per_channel else (0, 1)
    scale = torch.clamp(w.abs().amax(dim=dims), min=1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int32) + 8
    packed = (q[0::2] | (q[1::2] << 4)).to(torch.uint8)
    return packed, scale.reshape(-1)


def unpack_int4(packed):
    """(K/2, N) uint8 → (K, N) int32 codes in [-7, 7]."""
    p = packed.to(torch.int32)
    lo, hi = (p & 0xF) - 8, ((p >> 4) & 0xF) - 8
    return torch.stack([lo, hi], dim=1).reshape(2 * p.shape[0], p.shape[1])


def quant_matmul_int8_reference(x, w_q, scale):
    return torch.matmul(x.to(torch.float32),
                        w_q.to(torch.float32) * scale.to(torch.float32)[None, :])


def quant_matmul_int4_reference(x, packed, scale):
    return torch.matmul(x.to(torch.float32),
                        unpack_int4(packed).to(torch.float32)
                        * scale.to(torch.float32)[None, :])


def _plain(x, codes, scale):
    """`_int8_kernel`'s order: bf16 operands, float32 sum, scale after."""
    f32 = torch.float32
    acc = torch.matmul(x.to(torch.bfloat16).to(f32), codes.to(f32))
    return acc * scale.to(f32).reshape(1, -1)


def quant_matmul_int8_plain(x, w_q, scale):
    """Plain version of kernel #10: x (M, K) @ (w_q (K, N) int8 · scale)."""
    return _plain(x, w_q, scale)


def quant_matmul_int4_plain(x, packed, scale):
    """Plain version of kernel #11 on the interleaved nibbles."""
    return _plain(x, unpack_int4(packed), scale)


def _launch(x, w, scale, bits, what):
    """Check the operands and launch the GEMM; returns (M, N) float32."""
    if x.dim() != 2 or w.dim() != 2:
        raise ValueError(f"{what}: x and the weight must be 2-D; got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    rows, N = w.shape
    want_dtype = (torch.int8,) if bits == 8 else (torch.uint8, torch.int8)
    if rows * (8 // bits) != K:
        raise ValueError(f"{what}: weight of {rows} rows does not match K = {K}")
    if K % 2:
        raise ValueError(f"{what}: K must be even; got {K}")
    if w.dtype not in want_dtype or not w.is_contiguous():
        raise ValueError(f"{what}: the weight must be a contiguous {want_dtype[0]} "
                         f"tensor; got {w.dtype}")
    if scale.numel() not in (1, N):
        raise ValueError(f"{what}: scale must hold 1 or {N} values; got {scale.numel()}")
    for name, t in (("w", w), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} must be on {x.device}; got {t.device}")
    xb = x.to(torch.bfloat16).contiguous()
    if xb.data_ptr() % 4:  # the kernel loads bf16 pairs
        xb = xb.clone()
    s = scale.to(torch.float32).reshape(-1).expand(N).contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    lib = _build.load("quant_matmul")
    rc = lib.quant_matmul(xb.data_ptr(), w.data_ptr(), s.data_ptr(), out.data_ptr(),
                          M, K, N, bits, _build.stream(x))
    _build.check(lib, rc, what)
    return out


def quant_matmul_int8(x, w_q, scale):
    """x (M, K) @ dequant(w_q (K, N) int8, scale (N,)) → (M, N) float32,
    kernel #10. CPU tensors take `quant_matmul_int8_plain`."""
    if x.device.type == "cpu":
        return quant_matmul_int8_plain(x, w_q, scale)
    out = _launch(x, w_q, scale, 8, "quant_matmul_int8")
    quant_matmul_int8.launches += 1
    return out


def quant_matmul_int4(x, packed, scale):
    """x (M, K) @ dequant(packed (K/2, N) uint8 nibbles, scale (N,)) → (M, N)
    float32, kernel #11. CPU tensors take `quant_matmul_int4_plain`."""
    if x.device.type == "cpu":
        return quant_matmul_int4_plain(x, packed, scale)
    out = _launch(x, packed, scale, 4, "quant_matmul_int4")
    quant_matmul_int4.launches += 1
    return out


quant_matmul_int8.launches = 0
quant_matmul_int4.launches = 0


def quant_matmul(x, w_packed, scale, bits: int = 8):
    """Dispatch as the JAX package does: the kernel on the card (CUDA
    tensors), the float32 reference elsewhere."""
    use_kernel = x.device.type == "cuda"
    if bits == 8:
        if use_kernel:
            return quant_matmul_int8(x, w_packed, scale)
        return quant_matmul_int8_reference(x, w_packed, scale)
    if bits == 4:
        if use_kernel:
            return quant_matmul_int4(x, w_packed, scale)
        return quant_matmul_int4_reference(x, w_packed, scale)
    raise ValueError(f"unsupported packed bits: {bits}")
