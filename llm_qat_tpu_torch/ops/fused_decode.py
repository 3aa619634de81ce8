"""The fused int8 decode layer (counterpart of `llm_qat_tpu/ops/fused_decode.py`).

At S = 1 on an `int8_xla` tree with static per-tensor activation scales,
`infer_forward_unrolled(fused_linears=True)` runs a layer as two kernels
around the attention:

    fused_ln_qkv          (kernel #12)  h → LN1 → q8 → s8·s8 dot · (xs·ws) + b
                                        + LoRA → qkv
    fused_post_attention  (kernel #13)  attn → proj(+LoRA) → +h → LN2 →
                                        fc(+LoRA) → GELU → mlp(+LoRA) → +h1

`_ln_f32`, `_q8`, `_i8_dot`, `_erf` (Abramowitz & Stegun 7.1.26, as the
JAX kernels use), `_gelu_exact` and `_lora` are the JAX kernels' helpers;
`fused_ln_qkv_plain` and `fused_post_attention_plain` compute both kernels
from them in plain PyTorch. The wrappers take the plain versions for CPU
tensors only; for CUDA tensors they launch the CUDA sequences in
`csrc/fused_decode.cu` or raise. Each counts its launches in
`<fn>.launches`. Without LoRA banks the LoRA branch is skipped (JAX passes
zero banks to the same kernel).

The integer dots are exact (`exact_int_matmul` here, int32 __dp4a on the
card); the float32 sums of LN and LoRA are taken in another order by the
kernels, which now and then moves an activation code on a rounding
boundary of q8.
"""

from __future__ import annotations

import torch

from . import _build
from .mega_decode import exact_int_matmul

MAX_B = 16     # batch rows the kernels take
MAX_RANK = 64  # LoRA rank the kernels take


def _ln_f32(x, g, b, eps):
    n = x.shape[-1]
    mean = x.sum(dim=-1, keepdim=True) / n
    var = torch.square(x - mean).sum(dim=-1, keepdim=True) / n
    return g * (x - mean) * torch.rsqrt(var + eps) + b


def _q8(x, xs):
    """Activation codes on the int8 grid (float values in ±127)."""
    return torch.clamp(torch.round(x / xs), -127.0, 127.0)


def _i8_dot(qx, w, ws, xs, b):
    acc = exact_int_matmul(qx, w, 127.0 * 127.0)
    return acc.to(torch.float32) * (xs * ws) + b


def _erf(z):
    """Abramowitz & Stegun 7.1.26 rational erf (max abs error 1.5e-7)."""
    s = torch.sign(z)
    za = torch.abs(z)
    t = 1.0 / (1.0 + 0.3275911 * za)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-za * za))


def _gelu_exact(x):
    return 0.5 * x * (1.0 + _erf(x * 0.7071067811865476))


def _lora(x, a, b):
    f32 = torch.float32
    xa = torch.matmul(x.to(a.dtype).to(f32), a.to(f32))
    return torch.matmul(xa.to(b.dtype).to(f32), b.to(f32))


def fused_ln_qkv_plain(h, ln_g, ln_b, w_i8, w_s, bias, x_s, lora_a, lora_b, *,
                       eps: float = 1e-5):
    """Plain version of kernel #12: h (B, d) → qkv (B, N) float32.
    lora_a (d, r) / lora_b (r, N) may be None."""
    f32 = torch.float32
    hn = _ln_f32(h.to(f32), ln_g.to(f32), ln_b.to(f32), eps)
    xs = torch.as_tensor(x_s, dtype=f32, device=h.device).reshape(())
    out = _i8_dot(_q8(hn, xs), w_i8, w_s.to(f32).reshape(-1), xs, bias.to(f32))
    if lora_a is not None:
        out = out + _lora(hn, lora_a, lora_b)
    return out


def _linear_plain(x, lin, xs):
    f32 = torch.float32
    out = _i8_dot(_q8(x, xs), lin["w_i8"], lin["w_s"].to(f32).reshape(-1), xs,
                  lin["b"].to(f32))
    if "lora_A" in lin:
        out = out + _lora(x, lin["lora_A"], lin["lora_B"])
    return out


def fused_post_attention_plain(attn, h, ln2_g, ln2_b, proj, fc, mlp, x_scales, *,
                               eps: float = 1e-5):
    """Plain version of kernel #13: attn, h (B, d) → h' (B, d) float32.
    proj / fc / mlp: dicts with "w_i8", "w_s", "b" and optionally "lora_A",
    "lora_B"; x_scales (3,): the static input scales of proj, fc, mlp."""
    f32 = torch.float32
    s = x_scales.to(f32).reshape(3)
    h1 = h.to(f32) + _linear_plain(attn.to(f32), proj, s[0])
    hn = _ln_f32(h1, ln2_g.to(f32), ln2_b.to(f32), eps)
    g = _gelu_exact(_linear_plain(hn, fc, s[1]))
    return h1 + _linear_plain(g, mlp, s[2])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _f32(t, n, dev, what, name):
    """t as a contiguous float32 (n,) tensor on dev."""
    t = t.to(torch.float32).reshape(-1)
    if t.numel() != n or t.device != dev:
        raise ValueError(f"{what}: {name} must hold {n} values on {dev}; got "
                         f"{t.numel()} on {t.device}")
    return t.contiguous()


def _scale(t, n, dev, what, name):
    """A weight scale of n values or one (per tensor): (tensor, per column)."""
    per_col = t.numel() != 1
    return _f32(t, n if per_col else 1, dev, what, name), per_col


def _codes(w, K, N, dev, what, name):
    if (w.dtype != torch.int8 or tuple(w.shape) != (K, N) or not w.is_contiguous()
            or w.device != dev or w.data_ptr() % 4):
        raise ValueError(f"{what}: {name} must be a contiguous, 4-byte aligned int8 "
                         f"({K}, {N}) tensor on {dev}; got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    return w


def _banks(a, b, K, N, dev, what, name):
    """The LoRA banks as contiguous tensors of one dtype; (None, None, 0)
    without LoRA."""
    if a is None:
        return None, None, 0
    r = a.shape[1]
    if r > MAX_RANK or tuple(a.shape) != (K, r) or tuple(b.shape) != (r, N):
        raise ValueError(f"{what}: {name} LoRA banks must be ({K}, r) and (r, {N}) "
                         f"with r <= {MAX_RANK}; got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: {name} LoRA banks must share bf16 or float32; "
                         f"got {a.dtype}, {b.dtype}")
    if a.device != dev or b.device != dev:
        raise ValueError(f"{what}: {name} LoRA banks must be on {dev}")
    return a.contiguous(), b.contiguous(), r


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_rows(h, what):
    B, d = h.shape
    if not 1 <= B <= MAX_B:
        raise ValueError(f"{what}: 1 to {MAX_B} batch rows; got {B}")
    if d % 4:
        raise ValueError(f"{what}: the width must be a multiple of 4; got {d}")
    return B, d


def fused_ln_qkv(h, ln_g, ln_b, w_i8, w_s, bias, x_s, lora_a, lora_b, *,
                 eps: float = 1e-5):
    """LN1 + int8 QKV + LoRA of one decode layer (kernel #12): h (B, d)
    float32 → (B, N) float32. w_i8 (d, N) int8 codes, w_s (N,) or (1,)
    scales, bias (N,), x_s the static input scale (a tensor on h's device:
    no host sync), lora_a (d, r) / lora_b (r, N) or None. CPU tensors take
    `fused_ln_qkv_plain`."""
    if h.device.type == "cpu":
        return fused_ln_qkv_plain(h, ln_g, ln_b, w_i8, w_s, bias, x_s, lora_a, lora_b,
                                  eps=eps)
    what, dev = "fused_ln_qkv", h.device
    B, d = _check_rows(h, what)
    N = w_i8.shape[1]
    if N % 4:
        raise ValueError(f"{what}: N must be a multiple of 4; got {N}")
    w = _codes(w_i8, d, N, dev, what, "w_i8")
    la, lb, r = _banks(lora_a, lora_b, d, N, dev, what, "qkv")
    hf = h.to(torch.float32).contiguous()
    g, b = _f32(ln_g, d, dev, what, "ln_g"), _f32(ln_b, d, dev, what, "ln_b")
    (ws, ws_col), bs = _scale(w_s, N, dev, what, "w_s"), _f32(bias, N, dev, what, "bias")
    xs = _f32(torch.as_tensor(x_s, device=dev), 1, dev, what, "x_s")
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, N), **f32)
    hn = torch.empty((B, d), **f32)
    acc = torch.empty((B, N), dtype=torch.int32, device=dev)
    part = torch.empty((-(-d // 16) * B * max(r, 1),), **f32)
    lib = _build.load("fused_decode")
    rc = lib.fused_ln_qkv(
        hf.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(), ws.data_ptr(),
        bs.data_ptr(), xs.data_ptr(), _ptr(la), _ptr(lb), out.data_ptr(), hn.data_ptr(),
        acc.data_ptr(), part.data_ptr(), B, d, N, r, int(ws_col),
        int(la is not None and la.dtype == torch.bfloat16), float(eps), _build.stream(h))
    _build.check(lib, rc, what)
    fused_ln_qkv.launches += 1
    return out


def fused_post_attention(attn, h, ln2_g, ln2_b, proj, fc, mlp, x_scales, *,
                         eps: float = 1e-5):
    """proj(+LoRA), residual, LN2, fc(+LoRA), GELU, mlp(+LoRA), residual of
    one decode layer (kernel #13): attn, h (B, d) float32 → h' (B, d)
    float32. proj / fc / mlp as in `fused_post_attention_plain`; x_scales a
    (3,) tensor on the device. CPU tensors take the plain version."""
    if h.device.type == "cpu":
        return fused_post_attention_plain(attn, h, ln2_g, ln2_b, proj, fc, mlp, x_scales,
                                          eps=eps)
    what, dev = "fused_post_attention", h.device
    B, d = _check_rows(h, what)
    dff = fc["w_i8"].shape[1]
    if dff % 4:
        raise ValueError(f"{what}: the MLP width must be a multiple of 4; got {dff}")
    if tuple(attn.shape) != (B, d):
        raise ValueError(f"{what}: attn has shape {tuple(attn.shape)}; want {(B, d)}")
    has_lora = "lora_A" in proj
    args, rank, bank, ws_cols = [], None, None, 0
    for i, (name, lin, K, N) in enumerate((("proj", proj, d, d), ("fc", fc, d, dff),
                                           ("mlp", mlp, dff, d))):
        la, lb, r = _banks(lin.get("lora_A") if has_lora else None,
                           lin.get("lora_B") if has_lora else None, K, N, dev, what, name)
        if has_lora and la is None:
            raise ValueError(f"{what}: {name} has no LoRA banks while proj has")
        if rank is not None and (r != rank or (la is not None and la.dtype != bank)):
            raise ValueError(f"{what}: the three linears' LoRA banks must share rank "
                             "and dtype")
        rank, bank = r, None if la is None else la.dtype
        ws, per_col = _scale(lin["w_s"], N, dev, what, f"{name} w_s")
        ws_cols |= int(per_col) << i
        args += [_codes(lin["w_i8"], K, N, dev, what, f"{name} w_i8"), ws,
                 _f32(lin["b"], N, dev, what, f"{name} b"), la, lb]
    af = attn.to(torch.float32).contiguous()
    hf = h.to(torch.float32).contiguous()
    g, b = _f32(ln2_g, d, dev, what, "ln2_g"), _f32(ln2_b, d, dev, what, "ln2_b")
    xs3 = _f32(x_scales, 3, dev, what, "x_scales")
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((B, d), **f32)
    h1, hn = torch.empty((B, d), **f32), torch.empty((B, d), **f32)
    gbuf = torch.empty((B, dff), **f32)
    acc = torch.empty((B, max(d, dff)), dtype=torch.int32, device=dev)
    part = torch.empty((-(-max(d, dff) // 16) * B * max(rank, 1),), **f32)
    lib = _build.load("fused_decode")
    rc = lib.fused_post_attention(
        af.data_ptr(), hf.data_ptr(), g.data_ptr(), b.data_ptr(),
        *[_ptr(t) for t in args], xs3.data_ptr(), out.data_ptr(), h1.data_ptr(),
        hn.data_ptr(), gbuf.data_ptr(), acc.data_ptr(), part.data_ptr(), B, d, dff, rank,
        ws_cols, int(bank == torch.bfloat16), float(eps), _build.stream(h))
    _build.check(lib, rc, what)
    fused_post_attention.launches += 1
    return out


fused_ln_qkv.launches = 0
fused_post_attention.launches = 0
