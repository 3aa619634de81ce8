"""Inference path: weights pre-quantized once, prefill, decode.

Counterpart of `llm_qat_tpu/models/inference.py` for the serving slices:
`quantize_for_inference` (dense, `int8`, `int8_xla` and `int4_xla` weight
formats, int4/int8 LM head, factored LoRA with int8 codes), the forward
`infer_forward_unrolled` over dense or packed caches (flash prefill
branch; single-token steps on packed caches through the
`decode_attention_hbm` kernel; the `int8` format's linears through
`quant_matmul`; the decode options `fused_attention` and `fused_linears`
through `decode_attention` and the fused int8 decode layer), `_lm_head`,
and `InferenceEngine` with `kv_layout` "dense", "packed" and "mega" (KV 16,
8 or 4 bits).

Integer dots (`_int4_dot`, `_int8_dot`, the int4/int8 head) are exact: the
codes go through float32 matmuls in K-chunks small enough that every
partial sum stays an exact integer (`ops.mega_decode.exact_int_matmul`).
The mega decode step runs the CUDA kernel for tensors on the card and its
plain PyTorch version on the CPU. Caches are updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.attention import flash_attention, flash_attention_plain
from ..ops.decode_attention import (
    decode_attention,
    decode_attention_hbm,
    decode_attention_hbm_plain,
    decode_attention_plain,
    kv_pack_factor,
    pack_kv,
    unpack_kv,
)
from ..ops.fused_decode import (
    _lora,
    fused_ln_qkv,
    fused_ln_qkv_plain,
    fused_post_attention,
    fused_post_attention_plain,
)
from ..ops.mega_decode import (
    exact_int_matmul,
    mega_decode_step,
    mega_decode_step_kv8,
    mega_decode_step_kv8_plain,
    mega_decode_step_plain,
    pack_mega_weights,
)
from ..ops.quant_matmul import pack_int8, quant_matmul, quant_matmul_int8_plain
from ..quant.calibration import dynamic_scale_flat
from ..quant.functional import (
    KIND_LOG,
    _log_fwd_math,
    _minmax_fwd_math,
    fake_quant,
)
from .config import SPModelConfig
from .generate import _filter_logits
from .sp_model import _layer, prec_tables

NEG_INF = -1e30


class StaticMeta(NamedTuple):
    """Static precision metadata of an inference tree."""

    bits: int
    kind: int


def _static_fake_quant(x, scale, zp, bits: int, kind: int, symmetric: bool,
                       eps: float):
    """Fake-quant with static bits/kind."""
    if bits >= 32:
        return x
    if kind == KIND_LOG:
        return _log_fwd_math(x, zp, scale, float(bits), symmetric, eps)
    return _minmax_fwd_math(x, scale, zp, float(bits), symmetric)


def _unpack_planes(p):
    """Plane-packed bytes → (low, high) sign-extended nibble planes (int32)."""
    wi = p.to(torch.int32)
    return (wi << 28) >> 28, wi >> 4


def _pack_planes(lo, hi):
    """(low, high) codes in ±7 → plane-packed int8 bytes."""
    return ((lo.to(torch.int32) & 0xF) | (hi.to(torch.int32) << 4)).to(torch.int8)


def _int8_dot(x, w_i8, w_s, x_s=None):
    """x (..., K) float @ dequant(w_i8 (K, N), w_s (N,)), exact s32 dot.

    Per-tensor symmetric activation codes in ±127: the calibrated static
    scale `x_s`, or max|x|/127 over the last two axes when None.
    """
    xf = x.to(torch.float32)
    if x_s is None:
        amax = torch.clamp(xf.abs().amax(dim=(-2, -1), keepdim=True), min=1e-8)
        x_s = amax / 127.0
    qx = torch.clamp(torch.round(xf / x_s), -127, 127)
    acc = exact_int_matmul(qx, w_i8, 127.0 * 127.0)
    return acc.to(torch.float32) * (x_s * w_s)


def _int4_dot(x, w_i4, w_s, x_s, qmax=7.0):
    """x (..., K) float @ dequant(plane-packed w_i4 (K/2, N)), exact s32 dot.

    Byte row k holds code row k in its low nibble and row k + K/2 in its
    high nibble: acc = qx[:, :K/2] @ lo + qx[:, K/2:] @ hi. Activation codes
    are clamped to ±qmax (7 for the 4-bit minmax grid).
    """
    xf = x.to(torch.float32)
    qx = torch.clamp(torch.round(xf / x_s), -qmax, qmax)
    K2 = w_i4.shape[0]
    lo, hi = _unpack_planes(w_i4)
    bound = 7.0 * float(qmax)
    acc = (exact_int_matmul(qx[..., :K2], lo, bound)
           + exact_int_matmul(qx[..., K2:], hi, bound))
    return acc.to(torch.float32) * (x_s * w_s)


def quantize_for_inference(params, cfg: SPModelConfig, bits: int,
                           dtype=torch.bfloat16, weight_format: str = "dense",
                           lm_head_int8: bool = False,
                           lm_head_bits: int = None) -> Dict[str, Any]:
    """Materialize a single-precision inference tree (same keys and layouts
    as the JAX package's). `lm_head_int8` is the older spelling of
    `lm_head_bits=8`."""
    if lm_head_bits is None and lm_head_int8:
        lm_head_bits = 8
    q = cfg.quant
    p_idx = q.prec_index(bits)
    dev = params["wte"].device
    tables = prec_tables(q, dev)
    bits_t = tables.bits[p_idx]
    kind_t = tables.kind[p_idx]
    scaling = float(q.scaling_table()[p_idx])
    minmax_sym = q.symmetric and q.kind_name(bits) == "minmax"
    if weight_format not in ("dense", "int8", "int8_xla", "int4_xla"):
        raise ValueError(f"unknown weight_format {weight_format!r}")

    def codes_of(wq, ws):
        return torch.round(wq / torch.clamp(ws[:, None, :], min=1e-12)).to(torch.int8)

    def conv_linear(lin):
        wq = fake_quant(lin["w"], lin["wq_scale"][:, p_idx][:, None, :],
                        lin["wq_zp"][:, p_idx][:, None, :], bits_t, kind_t,
                        q.symmetric, q.eps)
        out = {"b": lin["b"], "iq_scale": lin["iq_scale"][:, p_idx],
               "iq_zp": lin["iq_zp"][:, p_idx]}
        iq = lin["iq_scale"][:, p_idx]
        if weight_format == "int4_xla":
            if not (minmax_sym and bits <= 4):
                raise ValueError(
                    "int4_xla needs the symmetric minmax ≤4-bit configuration; "
                    f"got bits={bits} kind={q.kind_name(bits)} "
                    f"symmetric={q.symmetric}")
            ws = lin["wq_scale"][:, p_idx]          # (L, out) or (L, 1)
            codes = codes_of(wq, ws)
            K = codes.shape[1]
            if K % 2:
                raise ValueError("int4 packing needs an even input dim")
            out["w_i4"] = _pack_planes(codes[:, :K // 2], codes[:, K // 2:])
            out["w_s"] = ws
            out["x_s"] = iq.amax(dim=-1)
            out["qmax"] = torch.full((wq.shape[0],), 2.0 ** (bits - 1) - 1.0,
                                     dtype=torch.float32, device=dev)
        elif weight_format in ("int8", "int8_xla"):
            # "int8_xla" keeps the exact minmax codes where there are some;
            # "int8" (the quant_matmul kernel's format) always re-grids
            ws = lin["wq_scale"][:, p_idx]
            key = "w_i8" if weight_format == "int8_xla" else "w_int8"
            if weight_format == "int8_xla" and minmax_sym and bits <= 8:
                out[key], out["w_s"] = codes_of(wq, ws), ws
            else:
                packed = [pack_int8(wl) for wl in wq]
                out[key] = torch.stack([c for c, _ in packed])
                out["w_s"] = torch.stack([s for _, s in packed])
            if weight_format == "int8_xla" and minmax_sym:
                out["x_s"] = iq.amax(dim=-1)
        else:
            out["w_q"] = wq.to(dtype)
        if q.max_rank > 0 and scaling > 0.0:
            A = lin["lora_A"][:, p_idx]  # (L, in, r)
            B = lin["lora_B"][:, p_idx]  # (L, r, out)
            ch = 1 if q.per_channel else None
            a_s, a_z = dynamic_scale_flat(A, bits_t, kind_t, ch, q.symmetric,
                                          q.eps, batch_dims=1)
            b_s, b_z = dynamic_scale_flat(B, bits_t, kind_t, ch, q.symmetric,
                                          q.eps, batch_dims=1)
            Aq = fake_quant(A, a_s, a_z, bits_t, kind_t, q.symmetric, q.eps)
            Bq = fake_quant(B, b_s, b_z, bits_t, kind_t, q.symmetric, q.eps)
            out["lora_A"] = Aq.to(dtype)
            out["lora_B"] = (scaling * Bq).to(dtype)
            if minmax_sym and bits <= 8:
                # minmax-symmetric Aq/Bq sit on the scale grid: the codes
                # are lossless
                out["lora_A_i8"] = torch.round(
                    Aq / torch.clamp(a_s, min=1e-12)).to(torch.int8)
                out["lora_A_s"] = a_s.to(torch.float32)
                out["lora_B_i8"] = torch.round(
                    Bq / torch.clamp(b_s, min=1e-12)).to(torch.int8)
                out["lora_B_s"] = scaling * b_s.to(torch.float32)
        return out

    def conv_ln(ln, stacked=True):
        if stacked:
            return {"g": ln["g"][:, p_idx], "b": ln["b"][:, p_idx]}
        return {"g": ln["g"][p_idx], "b": ln["b"][p_idx]}

    blocks = params["blocks"]
    out = {
        "wte": params["wte"].to(dtype),
        "wpe": params["wpe"],
        "blocks": {
            "ln1": conv_ln(blocks["ln1"]),
            "ln2": conv_ln(blocks["ln2"]),
            "c_attn": conv_linear(blocks["c_attn"]),
            "attn_proj": conv_linear(blocks["attn_proj"]),
            "c_fc": conv_linear(blocks["c_fc"]),
            "mlp_proj": conv_linear(blocks["mlp_proj"]),
        },
        "ln_f": conv_ln(params["ln_f"], stacked=False),
        "_bits": torch.tensor(float(bits), dtype=torch.float32, device=dev),
        "_kind": tables.kind[p_idx],
    }
    if lm_head_bits in (4, 8):
        # per-vocab-row codes of the tied embedding; int4 packs lanes j and
        # j + d/2 of a row into byte j (low / high nibble)
        wte = params["wte"].to(torch.float32)  # (V, d)
        d_ = wte.shape[1]
        if lm_head_bits == 4 and d_ % 2:
            raise ValueError("lm_head_bits=4 needs an even n_embd")
        qm = 7.0 if lm_head_bits == 4 else 127.0
        amax = torch.clamp(wte.abs().amax(dim=1), min=1e-8)
        out["head_s"] = amax / qm
        codes = torch.clamp(torch.round(wte / out["head_s"][:, None]), -qm, qm)
        if lm_head_bits == 4:
            out["head_i4"] = _pack_planes(codes[:, :d_ // 2], codes[:, d_ // 2:])
        else:
            out["head_i8"] = codes.to(torch.int8)
    elif lm_head_bits is not None:
        raise ValueError(f"lm_head_bits must be 8 or 4; got {lm_head_bits}")
    out["_static"] = StaticMeta(bits=int(bits), kind=int(tables.kind[p_idx]))
    return out


def _lora_branch(x, lin):
    """LoRA epilogue on the raw input, x@Aq@(scaling·Bq). Operands round to
    the bank dtype; products accumulate in float32."""
    if "lora_A" not in lin:
        return 0.0
    return _lora(x, lin["lora_A"], lin["lora_B"])


def _infer_linear(x, lin, cfg: SPModelConfig, quantize_input: bool,
                  static: Optional[StaticMeta], bits=None, kind=None,
                  use_kernels: bool = True):
    """One inference linear. The `w_int8` format runs `quant_matmul` (kernel
    #10 on the card, the float32 reference on the CPU, as in JAX);
    `use_kernels=False` runs the kernel's plain version instead."""
    q = cfg.quant
    if "w_i4" in lin:
        out = _int4_dot(x, lin["w_i4"], lin["w_s"], lin["x_s"],
                        qmax=lin["qmax"]) + lin["b"]
        return out + _lora_branch(x, lin)
    if "w_i8" in lin:
        out = _int8_dot(x, lin["w_i8"], lin["w_s"], x_s=lin.get("x_s")) + lin["b"]
        return out + _lora_branch(x, lin)
    if quantize_input:
        if static is not None:
            xq = _static_fake_quant(x, lin["iq_scale"], lin["iq_zp"], static.bits,
                                    static.kind, q.symmetric, q.eps)
        else:
            xq = fake_quant(x, lin["iq_scale"], lin["iq_zp"], bits, kind,
                            q.symmetric, q.eps)
    else:
        xq = x
    if "w_int8" in lin:
        B_, S_, K_ = xq.shape
        xb = xq.reshape(B_ * S_, K_).to(torch.bfloat16)
        if use_kernels:
            out = quant_matmul(xb, lin["w_int8"], lin["w_s"], bits=8)
        else:
            out = quant_matmul_int8_plain(xb, lin["w_int8"], lin["w_s"])
        return out.reshape(B_, S_, -1) + lin["b"] + _lora_branch(x, lin)
    cdt = lin["w_q"].dtype
    out = torch.matmul(xq.to(cdt).to(torch.float32),
                       lin["w_q"].to(torch.float32)) + lin["b"]
    return out + _lora_branch(x, lin)


def _ln(x, g, b, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return (g * (xf - mean) * torch.rsqrt(var + eps) + b).to(x.dtype)


def init_layer_caches(cfg: SPModelConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, kv_bits: int = 16,
                      kv_layout: str = "dense", device=None):
    """Per-layer KV caches as a flat tuple (k0, v0, k1, v1, ...) of `dtype`:
    (B, H, T, head_dim), or with `kv_layout="packed"` (B, H, T/P, P·head_dim)
    with P = `kv_pack_factor(head_dim)` timesteps per 128-lane row and T
    rounded up to a multiple of max(8·P, 128)."""
    if kv_layout == "packed":
        m = cfg.model
        P = kv_pack_factor(m.head_dim)
        unit = max(8 * P, 128)
        T = -(-max_len // unit) * unit
        shape = (batch, m.n_head, T // P, P * m.head_dim)
        dev = resolve_device(device)
        return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                     for _ in range(2 * m.n_layer))
    if kv_bits == 8:
        raise NotImplementedError(
            "the unfused int8 KV cache (ops/kv_cache.py) is not yet ported "
            "(ROADMAP queue A); use kv_layout='mega' with kv_bits=8")
    m = cfg.model
    dev = resolve_device(device)
    shape = (batch, m.n_head, max_len, m.head_dim)
    return tuple(torch.zeros(shape, dtype=dtype, device=dev)
                 for _ in range(2 * m.n_layer))


def _write_rows(kc, vc, kh, vh, start, P):
    """Write K/V rows (B, H, S, D) into the caches at timestep `start`, as
    packed rows when P > 1 (start and S multiples of P)."""
    S = kh.shape[2]
    if P > 1:
        kh, vh = pack_kv(kh), pack_kv(vh)
    kc[:, :, start // P:(start + S) // P] = kh.to(kc.dtype)
    vc[:, :, start // P:(start + S) // P] = vh.to(vc.dtype)


def _flash_prefill_attn(qh, kh, vh, use_kernels=True):
    """Initial-prefill attention through the flash kernel: the cache prefix
    is empty, so causal attention over the fresh k/v is the whole answer.
    q, k and v keep their dtype (float32 from the linears, as in JAX), and
    P is rounded at the k-block that JAX takes for S padded to a multiple
    of 128 (`jax_block_k`). The kernel masks the ragged tail, so no padding
    is needed."""
    fn = flash_attention if use_kernels else flash_attention_plain
    return fn(qh.contiguous(), kh.contiguous(), vh.contiguous())


def infer_forward_unrolled(iparams, input_ids, cfg: SPModelConfig, caches,
                           length, *, quantize_input: bool = True,
                           static: Optional[StaticMeta] = None,
                           fused_attention: bool = False,
                           fused_linears: bool = False,
                           initial_prefill: bool = False,
                           use_kernels: bool = True):
    """Forward over dense or packed per-layer caches, layers unrolled.

    Writes the new K/V rows into `caches` in place at [length, length+S).
    Returns (logits, caches, length + S). `initial_prefill` with S >= 128
    and head_dim 64/128 takes the flash kernel for attention. On packed
    caches (`init_layer_caches(kv_layout="packed")`) a single token goes
    through `decode_attention_hbm`; a longer segment must start and end on
    a multiple of P, is written as packed rows, and attends by flash or
    densely on the unpacked view. The JAX package's decode options, each
    taken only at S = 1: `fused_linears` runs a layer as `fused_ln_qkv`
    and `fused_post_attention` on an `int8_xla` tree with static activation
    scales (h then stays float32 between layers, as in JAX);
    `fused_attention` runs `decode_attention` on dense caches (packed
    caches keep `decode_attention_hbm`). `use_kernels=False` runs the
    kernels' plain versions (the reference on the card).
    """
    m = cfg.model
    bits, kind = iparams["_bits"], iparams["_kind"]
    B, S = input_ids.shape
    start = int(length)
    D = m.head_dim
    P = kv_pack_factor(D)
    packed = P > 1 and caches[0].shape[-1] == P * D
    T_max = P * caches[0].shape[2] if packed else caches[0].shape[2]
    if packed and S > 1 and (start % P or S % P):
        raise ValueError(f"a packed-cache segment must start and end on a "
                         f"multiple of {P}; got [{start}, {start + S})")
    wte = iparams["wte"]
    pos = torch.arange(start, start + S, device=wte.device)
    h = wte[input_ids] + iparams["wpe"][pos][None].to(wte.dtype)
    lin = lambda x, p: _infer_linear(x, p, cfg, quantize_input, static, bits, kind,
                                     use_kernels)
    f32 = torch.float32
    eps = m.layer_norm_epsilon
    ln_qkv = fused_ln_qkv if use_kernels else fused_ln_qkv_plain
    post = fused_post_attention if use_kernels else fused_post_attention_plain

    for li in range(m.n_layer):
        bp = _layer(iparams["blocks"], li)
        ca = bp["c_attn"]
        use_fused = fused_linears and S == 1 and "w_i8" in ca and "x_s" in ca
        if use_fused:
            h2d = h[:, 0].to(f32)
            qkv = ln_qkv(h2d, bp["ln1"]["g"], bp["ln1"]["b"], ca["w_i8"], ca["w_s"],
                         ca["b"], ca["x_s"], ca.get("lora_A"), ca.get("lora_B"),
                         eps=eps)[:, None]
        else:
            qkv = lin(_ln(h, bp["ln1"]["g"], bp["ln1"]["b"], eps), ca)
        qh, kh, vh = (t.reshape(B, S, m.n_head, m.head_dim).permute(0, 2, 1, 3)
                      for t in torch.split(qkv, m.n_embd, dim=-1))
        kc, vc = caches[2 * li], caches[2 * li + 1]
        if packed and S == 1:
            step = decode_attention_hbm if use_kernels else decode_attention_hbm_plain
            attn = step(qh, kh, vh, kc, vc, start)[0]
        elif fused_attention and S == 1 and not packed:
            step = decode_attention if use_kernels else decode_attention_plain
            attn = step(qh, kh, vh, kc, vc, start)[0]
        elif initial_prefill and S >= 128 and D in (64, 128):
            _write_rows(kc, vc, kh, vh, start, P if packed else 1)
            attn = _flash_prefill_attn(qh, kh, vh, use_kernels)
        else:
            _write_rows(kc, vc, kh, vh, start, P if packed else 1)
            if packed:
                kc, vc = unpack_kv(kc, D), unpack_kv(vc, D)
            scale = 1.0 / math.sqrt(m.head_dim)
            scores = torch.einsum("bhsd,bhtd->bhst", qh.to(f32), kc.to(f32)) * scale
            q_pos = start + torch.arange(S, device=h.device)[:, None]
            k_pos = torch.arange(T_max, device=h.device)[None, :]
            scores = torch.where((k_pos <= q_pos)[None, None], scores,
                                 torch.full_like(scores, NEG_INF))
            probs = torch.softmax(scores, dim=-1).to(vc.dtype)
            attn = torch.einsum("bhst,bhtd->bhsd", probs.to(f32),
                                vc.to(f32)).to(vc.dtype)
        if use_fused:
            x_s = torch.stack([bp[n]["x_s"] for n in ("attn_proj", "c_fc", "mlp_proj")])
            h = post(attn.permute(0, 2, 1, 3).reshape(B, -1).to(f32), h2d,
                     bp["ln2"]["g"], bp["ln2"]["b"], bp["attn_proj"], bp["c_fc"],
                     bp["mlp_proj"], x_s, eps=eps)[:, None]
            continue
        attn = attn.permute(0, 2, 1, 3).reshape(B, S, -1).to(h.dtype)
        h = h + lin(attn, bp["attn_proj"]).to(h.dtype)
        h2 = _ln(h, bp["ln2"]["g"], bp["ln2"]["b"], eps)
        fc = F.gelu(lin(h2, bp["c_fc"])).to(h.dtype)  # exact erf
        h = h + lin(fc, bp["mlp_proj"]).to(h.dtype)

    h = _ln(h, iparams["ln_f"]["g"], iparams["ln_f"]["b"], eps)
    return _lm_head(iparams, h), caches, start + S


def head_planes(iparams):
    """The int4/int8 head's codes as float32 (d_half, V) planes, unpacked
    once for repeated `_lm_head` calls; None for the float head."""
    if "head_i4" in iparams:
        lo, hi = _unpack_planes(iparams["head_i4"])
        return (lo.to(torch.float32).T.contiguous(),
                hi.to(torch.float32).T.contiguous())
    if "head_i8" in iparams:
        return (iparams["head_i8"].to(torch.float32).T.contiguous(),)
    return None


def _lm_head(iparams, h, planes=None):
    """Weight-tied LM head over post-ln_f hidden states (B, S, d).

    int4/int8 heads quantize the activations per sequence (max|h| over
    (S, d) / 127) and take an exact s32 dot with the per-row codes; else the
    plain tied `wte.T` product in float32."""
    if "head_i4" not in iparams and "head_i8" not in iparams:
        return torch.matmul(h.to(torch.float32),
                            iparams["wte"].to(torch.float32).T)
    if planes is None:
        planes = head_planes(iparams)
    hf = h.to(torch.float32)
    amax = torch.clamp(hf.abs().amax(dim=(1, 2), keepdim=True), min=1e-8)
    xs = amax / 127.0
    qh = torch.clamp(torch.round(hf / xs), -127, 127)
    if "head_i4" in iparams:
        d2 = planes[0].shape[0]
        acc = (exact_int_matmul(qh[..., :d2], planes[0], 127.0 * 7.0)
               + exact_int_matmul(qh[..., d2:], planes[1], 127.0 * 7.0))
    else:
        acc = exact_int_matmul(qh, planes[0], 127.0 * 127.0)
    return acc.to(torch.float32) * (xs[..., :1] * iparams["head_s"])


def quantize_kv_rows(rows, kv_bits: int):
    """KV rows (..., d) → the mega layout: per-row absmax scales (...,) and
    int8 codes (kv_bits 8) or ±7 lane-halves nibbles (..., d/2) (kv_bits 4)."""
    qmax = 127.0 if kv_bits == 8 else 7.0
    rf = rows.to(torch.float32)
    s = torch.clamp(rf.abs().amax(dim=-1), min=1e-8) / qmax
    codes = torch.clamp(torch.round(rf / s[..., None]), -qmax, qmax)
    if kv_bits == 4:
        d2 = codes.shape[-1] // 2
        return _pack_planes(codes[..., :d2], codes[..., d2:]), s
    return codes.to(torch.int8), s


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


class InferenceEngine:
    """Serving wrapper over the pre-quantized decode path.

    kv_layout "dense": dense-cache prefill and per-token unfused decode.
    kv_layout "packed": packed caches; a P-aligned prefill, single-token
    steps for the prompt's unaligned tail, then per-token decode, every
    single-token step through `decode_attention_hbm`. "auto" picks "packed"
    on a CUDA device and "dense" on the CPU (the JAX package's
    accelerator / other split).
    kv_layout "mega": dense-cache prefill, one conversion to the mega layout
    (kv_bits 16: float head-interleaved rows through `mega_decode_step`;
    8/4: quantized rows through `mega_decode_step_kv8`), then one
    whole-model step per token.
    Sampling: greedy, or temperature / top-k / top-p with EOS freeze.
    Runs on `device` ("cuda" by default; "cpu" runs every plain version).
    `use_kernels=False` runs the kernels' plain PyTorch versions on the card
    too: the reference the kernels are held against.
    """

    def __init__(self, params, cfg: SPModelConfig, bits: int,
                 max_batch: int = 8, max_len: int = 1024,
                 dtype=torch.bfloat16, weight_format: str = "dense",
                 lm_head_int8: bool = False, lm_head_bits: int = None,
                 kv_layout: str = "auto", kv_bits: int = 16,
                 mega_tbp: int = 64, mega_tiles_per_step: int = 4,
                 mega_lora_int8: bool = True, device=None,
                 use_kernels: bool = True):
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.cfg = cfg
        self.bits = bits
        self.max_batch = max_batch
        self.max_len = min(max_len, cfg.model.n_positions)
        self.dtype = dtype
        if kv_layout == "auto":
            kv_layout = "packed" if self.device.type == "cuda" else "dense"
        if kv_layout not in ("dense", "packed", "mega"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits must be 16, 8 or 4; got {kv_bits}")
        if kv_bits in (8, 4) and kv_layout != "mega":
            raise ValueError(f"kv_bits={kv_bits} requires kv_layout='mega'")
        self.kv_layout = kv_layout
        self.kv_bits = kv_bits
        self.mega_tbp = mega_tbp
        self.mega_tpg = mega_tiles_per_step
        iparams = quantize_for_inference(
            _tree_to(params, self.device), cfg, bits, dtype,
            weight_format=weight_format, lm_head_int8=lm_head_int8,
            lm_head_bits=lm_head_bits)
        self.static = iparams.pop("_static")
        self.iparams = iparams
        self._planes = head_planes(iparams)
        self.mega = None
        if kv_layout == "mega":
            if cfg.model.n_embd % 128:
                raise ValueError("kv_layout='mega' needs n_embd % 128 == 0; got "
                                 f"{cfg.model.n_embd}")
            self.mega = pack_mega_weights(iparams, cfg, lora_int8=mega_lora_int8)
            self._has_lora = "lora_A" in iparams["blocks"]["c_attn"]
            ca = iparams["blocks"]["c_attn"]
            self._aq_max = float(ca["qmax"][0]) if "qmax" in ca else 127.0

    @torch.no_grad()
    def prefill(self, input_ids, caches):
        """Initial prefill into empty caches; returns (logits, caches)."""
        logits, caches, _ = infer_forward_unrolled(
            self.iparams, input_ids, self.cfg, caches, 0, static=self.static,
            initial_prefill=True, use_kernels=self.use_kernels)
        return logits, caches

    def _to_mega(self, caches):
        """Dense per-layer (B, H, T, hd) caches → stacked (L, B, T, d) rows
        (row t holds every head's K or V): with kv_bits 16 the two float
        stacks; else quantized per row to int8 codes or lane-halves int4
        nibbles, with (L, B, T) scales."""
        def conv(c):
            B_, H_, T_, D_ = c.shape
            return c.permute(0, 2, 1, 3).reshape(B_, T_, H_ * D_)

        ks = torch.stack([conv(c) for c in caches[0::2]])
        vs = torch.stack([conv(c) for c in caches[1::2]])
        if self.kv_bits == 16:
            return ks.contiguous(), vs.contiguous()
        kc, ksc = quantize_kv_rows(ks, self.kv_bits)
        vc, vsc = quantize_kv_rows(vs, self.kv_bits)
        return kc.contiguous(), vc.contiguous(), ksc.contiguous(), vsc.contiguous()

    def _sample(self, logits, temperature, top_k, top_p, do_sample, generator):
        if not do_sample and top_k is None and top_p is None:
            return torch.argmax(logits, dim=-1)
        filt = _filter_logits(logits, temperature, top_k, top_p)
        if do_sample:
            probs = torch.softmax(filt, dim=-1)
            return torch.multinomial(probs, 1, generator=generator)[:, 0]
        return torch.argmax(filt, dim=-1)

    def _forward(self, ids, caches, start):
        """infer_forward_unrolled of `ids` at `start`; returns (last
        position's logits, caches)."""
        logits, caches, _ = infer_forward_unrolled(
            self.iparams, ids, self.cfg, caches, start, static=self.static,
            use_kernels=self.use_kernels)
        return logits[:, -1], caches

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int = 64, *,
                 temperature: float = 1.0, top_k=None, top_p=None,
                 do_sample: bool = False, eos_token_id=None,
                 generator: Optional[torch.Generator] = None):
        """input_ids (B, T) → (B, T + max_new_tokens) on the engine's device.

        The first new token is sampled from the prefill logits, then each
        step runs the forward on the token just emitted."""
        ids = torch.as_tensor(input_ids, device=self.device).to(torch.int64)
        B, T0 = ids.shape
        if B > self.max_batch:
            raise ValueError(f"batch {B} exceeds max_batch={self.max_batch}")
        if T0 + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({T0}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"engine max_len={self.max_len}")
        cfg = self.cfg
        if self.kv_layout == "mega":
            # cache rows rounded up to a multiple of 32, as the JAX engine does
            T_all = -(-min(self.max_len, T0 + max_new_tokens) // 32) * 32
        else:
            T_all = min(self.max_len, T0 + max_new_tokens)
        layout = "packed" if self.kv_layout == "packed" else "dense"
        caches = init_layer_caches(cfg, B, T_all, self.dtype, kv_layout=layout,
                                   device=self.device)
        # packed caches take a P-aligned prefill; the prompt's unaligned
        # tail goes one token at a time (S = 1: decode_attention_hbm)
        T0e = T0 - T0 % kv_pack_factor(cfg.model.head_dim) if layout == "packed" else T0
        last = None
        if T0e > 0:
            logits, caches = self.prefill(ids[:, :T0e], caches)
            last = logits[:, -1]
        for t in range(T0e, T0):
            last, caches = self._forward(ids[:, t:t + 1], caches, t)
        done = torch.zeros((B,), dtype=torch.bool, device=self.device)
        if self.mega is not None:
            caches = self._to_mega(caches)
        toks = []
        for i in range(max_new_tokens):
            tok = self._sample(last, temperature, top_k, top_p, do_sample,
                               generator)
            if eos_token_id is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id), tok)
                done = done | (tok == eos_token_id)
            toks.append(tok)
            if self.mega is None:
                last, caches = self._forward(tok[:, None], caches, T0 + i)
            else:
                last, *caches = self.mega_step(tok, T0 + i, *caches)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)

    def mega_step(self, tok, pos, *caches):
        """One mega decode token: embed `tok` at `pos`, run every layer
        (caches updated in place: (kc, vc) with kv_bits 16, else (kc, vc,
        ks, vs)), ln_f and the LM head. Returns (logits (B, V), *caches)."""
        m = self.cfg.model
        wte, lnf = self.iparams["wte"], self.iparams["ln_f"]
        h = (wte[tok] + self.iparams["wpe"][pos][None].to(wte.dtype)).to(torch.float32)
        kw = dict(n_head=m.n_head, head_dim=m.head_dim, has_lora=self._has_lora,
                  eps=m.layer_norm_epsilon, act_dtype=self.dtype, aq_max=self._aq_max,
                  tbp=self.mega_tbp, tiles_per_step=self.mega_tpg)
        if self.kv_bits == 16:
            step = mega_decode_step if self.use_kernels else mega_decode_step_plain
        else:
            step = mega_decode_step_kv8 if self.use_kernels else mega_decode_step_kv8_plain
            kw["kv_bits"] = self.kv_bits
        h_out, *caches = step(h, self.mega, *caches, pos, **kw)
        hf = _ln(h_out[:, None, :].to(self.dtype), lnf["g"], lnf["b"],
                 m.layer_norm_epsilon)
        return (_lm_head(self.iparams, hf, self._planes)[:, 0], *caches)
