"""Whole-model decode step: int8 / int4 KV, float KV, continuous batching.

Counterpart of `llm_qat_tpu/ops/mega_decode.py`. Three wrappers launch the
CUDA step in `csrc/mega_decode.cu`, each with a plain PyTorch version
beside it that computes the same function op for op:
- `mega_decode_step_kv8` (the Pallas `_mega_kernel_kv8`, per_slot=False):
  int8 / int4 KV codes with row scales, one shared position;
- `mega_decode_step` (the Pallas `_mega_kernel`): float32 or bf16
  head-interleaved caches, q·sm_scale and each block's probabilities
  rounded to the cache dtype before their dots;
- `mega_decode_step_cb` (`_mega_kernel_kv8`, per_slot=True): continuous
  batching, per-slot lengths over read-only main caches, then one
  chunk-local recent block at the uniform `rpos`, which receives the new
  codes; `cb_merge_recent` (plain PyTorch, as in JAX, where it is XLA
  code) merges the recent rows into the main caches once per chunk.
The three differ only in their attention; the weights, LoRA and row
numerics below are shared.

One step runs one token per sequence through all L layers. Per layer: LN1,
static per-tensor activation quantization to ±aq_max, s8×s8→s32 dots over
int8 or per-tile K-halves int4 (d, d) weight tiles, per-channel scale, bias
and factored LoRA; the new K/V row is quantized per row and appended at
`pos`; online-softmax attention over the cached prefix [0, pos) with s8
score and PV dots, probabilities quantized per (b, h, tbp-row block); the
new token is merged in float32 from its dequantized codes; then proj, LN2,
fc, A&S-erf GELU and mlp, with residuals. Integer dots are exact; every
other quantity is float32, rounded to bf16 at the JAX kernel's `_rt` points
when `act_dtype` is bf16. The kernel sums its floats in another order than
this version, so the two differ by float32 rounding, and now and then an
activation or KV code at a rounding boundary differs by one.

Layouts. `MegaWeights` keeps the JAX package's "full" bank layout: 12
tiles per layer (3 qkv out-tiles, 1 proj, 4 fc out-tiles, 4 mlp in-tiles).
The KV caches are (L, B, T, d) int8 codes (kv_bits=8) or (L, B, T, d/2)
bytes holding ±7 nibbles along lane halves (low nibble = lane i, high =
lane i + d/2). The per-row KV scales are (L, B, T) float32 — the JAX
package's (L, T, 128) batch-on-lanes layout is a TPU layout and is not kept.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple

import numpy as np
import torch

from . import _build
from .decode_attention import _CACHE_DTYPE_CODE, block_rows

NEG_INF = -1e30
N_TILES = 12  # 3 qkv + 1 attn-proj + 4 fc + 4 mlp-proj partials
_KSPLIT = 16  # K-slices of the CUDA GEMV (its grid's y extent)
_LB_SPLIT = 4  # of which compute LoRA-B partials (csrc/mega_decode.cu LB_SPLIT)
MAX_SLOTS = 256  # batch rows of a step (csrc/mega_decode.cu MAX_SLOTS)


class MegaWeights(NamedTuple):
    """Stacked per-(layer, tile) operand banks (the JAX "full" layout)."""

    wt: torch.Tensor    # (L, 12, d, d) int8 tiles, or (L, 12, d/2, d) int4
    #                     tiles packed per tile along K-halves
    ws: torch.Tensor    # (L, 12, 1, d) f32 per-out-channel dequant scales
    bias: torch.Tensor  # (L, 12, 1, d) f32 (mlp bias only on tile 11)
    at: torch.Tensor    # (L, 12, d, r) LoRA A bank: f32/bf16 values or int8
    bt: torch.Tensor    # (L, 12, r, d) LoRA B bank (scaling folded in)
    at_s: torch.Tensor  # (L, 12) f32 per-tile scalar A scales (ones if float)
    bt_s: torch.Tensor  # (L, 12) f32 per-tile scalar B scales
    ln: torch.Tensor    # (L, 4, d) f32: ln1_g, ln1_b, ln2_g, ln2_b
    xs: torch.Tensor    # (L, 4) f32 static activation scales (qkv,proj,fc,mlp)


def _unpack4_rows(p):
    """(..., K/2, N) K-halves packed bytes → (..., K, N) int8 codes."""
    wi = p.to(torch.int32)
    lo = ((wi << 28) >> 28).to(torch.int8)
    hi = (wi >> 4).to(torch.int8)
    return torch.cat([lo, hi], dim=-2)


def _pack4_rows(codes):
    """(..., K, N) int8 codes in ±7 → (..., K/2, N) K-halves packed bytes."""
    k2 = codes.shape[-2] // 2
    lo = codes[..., :k2, :].to(torch.int32)
    hi = codes[..., k2:, :].to(torch.int32)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def pack_mega_weights(iparams: Dict[str, Any], cfg,
                      lora_int8: bool = True) -> MegaWeights:
    """Build the tiled operand banks from an `int8_xla` or `int4_xla` tree.

    int4 trees are re-tiled from whole-matrix K-halves packing to per-tile
    K-halves packing, so each (d, d) tile is a (d/2, d) byte block. With
    `lora_int8` and per-tensor LoRA scales the banks carry int8 codes plus
    per-tile scalar scales; otherwise float banks.
    """
    m = cfg.model
    d, ff = m.n_embd, 4 * m.n_embd
    blocks = iparams["blocks"]
    is_int4 = "w_i4" in blocks["c_attn"]
    wkey = "w_i4" if is_int4 else "w_i8"
    for name in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        lin = blocks[name]
        if wkey not in lin or "x_s" not in lin:
            raise ValueError(
                f"mega decode needs int8_xla/int4_xla weights with static "
                f"activation scales; linear {name!r} has keys {sorted(lin)}")

    def codes(lin):
        return _unpack4_rows(lin["w_i4"]) if is_int4 else lin["w_i8"]

    if codes(blocks["c_fc"]).shape[2] != ff:
        raise ValueError("mega decode assumes d_ff == 4*d_model")
    L = blocks["c_attn"][wkey].shape[0]
    dev = blocks["c_attn"][wkey].device
    f32 = torch.float32

    def outvec(x, n):
        return torch.as_tensor(x, dtype=f32, device=dev).reshape(L, -1).expand(L, n)

    qkv, proj, fc, mlp = (blocks["c_attn"], blocks["attn_proj"],
                          blocks["c_fc"], blocks["mlp_proj"])

    def tiles_out(w):  # (L, d, n*d) -> n x (L, d, d) col tiles
        return [w[:, :, i * d:(i + 1) * d] for i in range(w.shape[2] // d)]

    def tiles_in(w):  # (L, n*d, d) -> n x (L, d, d) row tiles
        return [w[:, i * d:(i + 1) * d, :] for i in range(w.shape[1] // d)]

    tile_list = (tiles_out(codes(qkv)) + [codes(proj)]
                 + tiles_out(codes(fc)) + tiles_in(codes(mlp)))
    if is_int4:
        tile_list = [_pack4_rows(t) for t in tile_list]
    wt = torch.stack(tile_list, dim=1).contiguous()

    def vec_tiles(v, n):
        return [v[:, i * d:(i + 1) * d] for i in range(n)]

    qkv_s, fc_s = outvec(qkv["w_s"], 3 * d), outvec(fc["w_s"], ff)
    proj_s, mlp_s = outvec(proj["w_s"], d), outvec(mlp["w_s"], d)
    ws = torch.stack(vec_tiles(qkv_s, 3) + [proj_s] + vec_tiles(fc_s, 4)
                     + [mlp_s] * 4, dim=1)[:, :, None, :].contiguous()
    zs = torch.zeros((L, d), dtype=f32, device=dev)
    bias = torch.stack(
        vec_tiles(qkv["b"].to(f32), 3) + [proj["b"].to(f32)]
        + vec_tiles(fc["b"].to(f32), 4) + [zs, zs, zs, mlp["b"].to(f32)],
        dim=1)[:, :, None, :].contiguous()

    has_lora = "lora_A" in qkv
    use_i8 = bool(lora_int8 and has_lora and "lora_A_i8" in qkv
                  and qkv["lora_A_s"].numel() == L
                  and qkv["lora_B_s"].numel() == L)
    akey, bkey = ("lora_A_i8", "lora_B_i8") if use_i8 else ("lora_A", "lora_B")
    if has_lora:
        r = qkv[akey].shape[2]
        ldt = qkv[akey].dtype
        za = torch.zeros((L, d, r), dtype=ldt, device=dev)
        zb = torch.zeros((L, r, d), dtype=ldt, device=dev)
        at = torch.stack([qkv[akey], za, za, proj[akey], fc[akey], za, za, za]
                         + tiles_in(mlp[akey]), dim=1)
        bt = torch.stack(tiles_out(qkv[bkey]) + [proj[bkey]]
                         + tiles_out(fc[bkey]) + [zb, zb, zb, mlp[bkey]], dim=1)
        if use_i8:
            one = torch.ones((L,), dtype=f32, device=dev)
            sc = lambda lin, key: lin[key].to(f32).reshape(L)
            a_q, a_p, a_f, a_m = (sc(x, "lora_A_s") for x in (qkv, proj, fc, mlp))
            b_q, b_p, b_f, b_m = (sc(x, "lora_B_s") for x in (qkv, proj, fc, mlp))
            at_s = torch.stack([a_q, one, one, a_p, a_f, one, one, one,
                                a_m, a_m, a_m, a_m], dim=1)
            bt_s = torch.stack([b_q, b_q, b_q, b_p, b_f, b_f, b_f, b_f,
                                one, one, one, b_m], dim=1)
    else:
        r = 8
        at = torch.zeros((L, N_TILES, d, r), dtype=torch.bfloat16, device=dev)
        bt = torch.zeros((L, N_TILES, r, d), dtype=torch.bfloat16, device=dev)
    if not use_i8:
        at_s = torch.ones((L, N_TILES), dtype=f32, device=dev)
        bt_s = torch.ones((L, N_TILES), dtype=f32, device=dev)
    b = blocks
    ln = torch.stack([b["ln1"]["g"].to(f32), b["ln1"]["b"].to(f32),
                      b["ln2"]["g"].to(f32), b["ln2"]["b"].to(f32)], dim=1)
    xs = torch.stack([lin["x_s"].to(f32).reshape(L)
                      for lin in (qkv, proj, fc, mlp)], dim=1)
    return MegaWeights(wt=wt, ws=ws, bias=bias, at=at.contiguous(),
                       bt=bt.contiguous(), at_s=at_s.contiguous(),
                       bt_s=bt_s.contiguous(), ln=ln.contiguous(),
                       xs=xs.contiguous())


# ---------------------------------------------------------------------------
# Shared numerics
# ---------------------------------------------------------------------------


def _rt(x, act_bf16: bool):
    """bf16 round-to-nearest-even at the JAX kernel's `_rt` points."""
    return x.to(torch.bfloat16).to(torch.float32) if act_bf16 else x


def _q8(x, xs, qmax):
    """clamp(rne(x / xs), ±qmax) as float codes."""
    return torch.clamp(torch.round(x / xs), -qmax, qmax)


def _erf_as(z):
    """A&S 7.1.26 rational erf (max abs err 1.5e-7), as the TPU kernel."""
    s = torch.sign(z)
    za = z.abs()
    t = 1.0 / (1.0 + 0.3275911 * za)
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return s * (1.0 - poly * torch.exp(-za * za))


def _gelu_as(x):
    return 0.5 * x * (1.0 + _erf_as(x * 0.7071067811865476))


def _ln_f32(x, g, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return g * (x - mean) * torch.rsqrt(var + eps) + b


def exact_int_matmul(a, b, bound: float):
    """a (..., K) @ b (K, N) for integer-valued operands, exact in int32.

    `bound` is max|a|·max|b| (e.g. 127·7). Float32 sums of integers are
    exact while every partial sum stays below 2^24, so K is cut into chunks
    that keep it there (bound 127·127 gives 1040-wide chunks) and the chunk
    results are summed as int32. Runs the same way on the CPU and the card,
    where float32 matmuls are full precision by default.
    """
    K = a.shape[-1]
    chunk = max(1, int((1 << 24) // max(float(bound), 1.0)))
    af, bf = a.to(torch.float32), b.to(torch.float32)
    out = None
    for k0 in range(0, K, chunk):
        part = torch.matmul(af[..., k0:k0 + chunk], bf[k0:k0 + chunk])
        part = part.to(torch.int32)
        out = part if out is None else out + part
    return out


def _tile_codes(mw: MegaWeights, l: int, wbits: int):
    """Layer l's 12 weight tiles as (12, d, d) float codes."""
    w = mw.wt[l]
    return (_unpack4_rows(w) if wbits == 4 else w).to(torch.float32)


def _kv_codes(c, kv_bits):
    """(..., dc) cache bytes → (..., d) float codes (lane-halves nibbles)."""
    if kv_bits == 8:
        return c.to(torch.float32)
    wi = c.to(torch.int32)
    return torch.cat([(wi << 28) >> 28, wi >> 4], dim=-1).to(torch.float32)


def _kv_bytes(codes, kv_bits):
    """(..., d) float codes → (..., dc) cache bytes."""
    ci = codes.to(torch.int32)
    if kv_bits == 8:
        return ci.to(torch.int8)
    d2 = ci.shape[-1] // 2
    return ((ci[..., :d2] & 0xF) | (ci[..., d2:] << 4)).to(torch.int8)


def _check_step(h, mw, k_cache, v_cache, k_scale, v_scale, pos, n_head,
                head_dim, tbp, kv_bits, tiles_per_step):
    """Validate shapes and `pos` on the host; returns (tbp, wbits, dc, T).
    kv_bits 8/4: code caches (L, B, T, dc) with (L, B, T) scales; kv_bits
    16: float32 or bf16 caches (L, B, T, d) and no scales (None)."""
    B, d = h.shape
    L = mw.wt.shape[0]
    if n_head * head_dim != d:
        raise ValueError(f"n_head*head_dim={n_head * head_dim} != d={d}")
    if d % 128:
        raise ValueError(f"the mega decode step needs d % 128 == 0; got {d}")
    if kv_bits not in (16, 8, 4):
        raise ValueError(f"kv_bits must be 16, 8 or 4; got {kv_bits}")
    if N_TILES % int(tiles_per_step):
        raise ValueError(f"tiles_per_step={tiles_per_step} must divide {N_TILES}")
    dc = d // 2 if kv_bits == 4 else d
    Tc = k_cache.shape[2]
    shapes = [("k_cache", k_cache, (L, B, Tc, dc)), ("v_cache", v_cache, (L, B, Tc, dc))]
    if kv_bits == 16:
        if k_cache.dtype not in (torch.float32, torch.bfloat16) or v_cache.dtype != k_cache.dtype:
            raise ValueError(f"float caches must share a float32 or bf16 dtype; got "
                             f"{k_cache.dtype}/{v_cache.dtype}")
    else:
        shapes += [("k_scale", k_scale, (L, B, Tc)), ("v_scale", v_scale, (L, B, Tc))]
    for name, t, shape in shapes:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {shape}")
    pos = int(pos)
    if not 0 <= pos < Tc:
        # the append writes row `pos`: out of range is memory corruption
        raise ValueError(f"pos={pos} outside the cache [0, {Tc})")
    tbp = block_rows(Tc, tbp)
    dk = mw.wt.shape[2]
    if dk not in (d, d // 2):
        raise ValueError(f"weight tiles of {dk} rows fit neither int8 nor int4")
    return tbp, (4 if dk == d // 2 else 8), dc, Tc


def _check_cb(h, mw, k_main, v_main, ks_main, vs_main, k_rec, v_rec, ks_rec,
              vs_rec, lengths, rpos, n_head, head_dim, tbp, kv_bits,
              tiles_per_step):
    """Validate `mega_decode_step_cb`'s operands on the host; returns
    (tbp, wbits, Tc, Tr, lengths as an int32 numpy array, rpos)."""
    B, d = h.shape
    L = mw.wt.shape[0]
    Tc, Tr = k_main.shape[2], k_rec.shape[2]
    dc = d if kv_bits == 8 else d // 2
    for name, t, shape in (("k_rec", k_rec, (L, B, Tr, dc)),
                           ("v_rec", v_rec, (L, B, Tr, dc)),
                           ("ks_rec", ks_rec, (L, B, Tr)),
                           ("vs_rec", vs_rec, (L, B, Tr))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {shape}")
    _, wbits, _, _ = _check_step(h, mw, k_main, v_main, ks_main, vs_main, 0,
                                 n_head, head_dim, tbp, kv_bits, tiles_per_step)
    tbp = min(tbp, Tc, Tr)
    while (Tc % tbp or Tr % tbp) and tbp > 8:
        tbp -= 8
    if Tc % tbp or Tr % tbp or tbp % 8:
        raise ValueError(f"no tbp multiple of 8 divides both {Tc} and {Tr}")
    if Tr != tbp:
        raise ValueError(f"the recent buffer must be one stream block (Tr == tbp); "
                         f"got Tr={Tr}, tbp={tbp}")
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu()
    lens = np.asarray(lengths, np.int64).reshape(-1)
    if lens.shape != (B,):
        raise ValueError(f"lengths must hold one length per slot ({B}); got {lens.shape}")
    if (lens < 0).any() or (lens > Tc).any():
        raise ValueError(f"lengths {lens.tolist()} outside [0, {Tc}]")
    rpos = int(rpos)
    if not 0 <= rpos < Tr:
        # the append writes recent row rpos: out of range is memory corruption
        raise ValueError(f"rpos={rpos} outside the recent buffer [0, {Tr})")
    return tbp, wbits, Tc, Tr, lens.astype(np.int32), rpos


def _lora_operand_dtype(mw: MegaWeights, act_bf16: bool):
    """dtype the LoRA dots round their operands to: the bank's own float
    dtype, or bf16/f32 by act_dtype for int8 banks (codes are exact)."""
    if mw.at.dtype == torch.int8:
        return torch.bfloat16 if act_bf16 else torch.float32
    return mw.at.dtype


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _new_kv_codes(kn_f, vn_f, kv_bits):
    """Per-row quantization of the new K/V rows (absmax over all d lanes):
    (kcode, vcode, ks_new (B, 1), vs_new (B, 1))."""
    kvq = 127.0 if kv_bits == 8 else 7.0
    ks_new = torch.clamp(kn_f.abs().amax(dim=1, keepdim=True), min=1e-8) / kvq
    vs_new = torch.clamp(vn_f.abs().amax(dim=1, keepdim=True), min=1e-8) / kvq
    return _q8(kn_f, ks_new, kvq), _q8(vn_f, vs_new, kvq), ks_new, vs_new


def _kv8_blocks(state, qcode, qs, kc, vc, ks, vs, nblk, limit, tbp, kv_bits,
                H, D):
    """Online-softmax update over `nblk` tbp-row blocks of int8/int4 caches
    kc/vc (B, T, dc) with scales ks/vs (B, T), rows < limit[b] valid (limit
    (B,) int64). Probabilities are quantized per (b, h, block), after the
    per-row V scale is folded in. state = (m, lsum, acc); returns it."""
    m, lsum, acc = state
    if not nblk:
        return state
    B = qcode.shape[0]
    n = nblk * tbp
    kcodes = _kv_codes(kc[:, :n], kv_bits).reshape(B, nblk, tbp, H, D)
    vcodes = _kv_codes(vc[:, :n], kv_bits).reshape(B, nblk, tbp, H, D)
    s32 = torch.einsum("bhi,bjthi->bhjt", qcode, kcodes)  # exact integers
    s = s32 * qs[..., None] * ks[:, :n].reshape(B, 1, nblk, tbp)
    t = torch.arange(n, device=qcode.device)
    valid = (t[None] < limit[:, None]).reshape(B, 1, nblk, tbp)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    bmax = s.amax(dim=3)                                  # (B, H, nblk)
    # running max after each block: m_j = max(m, bmax_1, ..., bmax_j)
    m_run = torch.maximum(m[..., None],
                          torch.cummax(torch.clamp(bmax, min=NEG_INF), dim=2).values)
    p = torch.exp(s - m_run[..., None])
    psum = p.sum(dim=3)
    pscaled = torch.where(valid, p * vs[:, :n].reshape(B, 1, nblk, tbp),
                          torch.zeros_like(p))
    ps = torch.clamp(pscaled.amax(dim=3, keepdim=True), min=1e-30) / 127.0
    pq = _q8(pscaled, ps, 127.0)
    pv = torch.einsum("bhjt,bjthi->bhji", pq, vcodes) * ps  # exact ints * ps
    for j in range(nblk):
        m_new = m_run[:, :, j]
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + psum[:, :, j]
        acc = acc * corr[..., None] + pv[:, :, j]
        m = m_new
    return m, lsum, acc


def _merge_new(state, q, kn, vn, act_bf16):
    """Merge the new token (q pre-scaled, kn/vn (B, H, D) float32) into the
    online softmax; returns attn2d (B, d)."""
    m, lsum, acc = state
    B, H, D = q.shape
    s_new = (q * kn).sum(dim=2)                                 # (B, H)
    m_f = torch.maximum(m, s_new)
    corr = torch.exp(m - m_f)
    p_new = torch.exp(s_new - m_f)
    l_f = lsum * corr + p_new
    out = acc * corr[..., None] + p_new[..., None] * vn
    return _rt((out / torch.clamp(l_f, min=1e-30)[..., None]).reshape(B, H * D),
               act_bf16)


def _init_state(B, H, D, dev):
    f32 = torch.float32
    return (torch.full((B, H), NEG_INF, dtype=f32, device=dev),
            torch.zeros((B, H), dtype=f32, device=dev),
            torch.zeros((B, H, D), dtype=f32, device=dev))


def _q_codes(q):
    """q (B, H, D) quantized per (b, h) row: (codes, scale (B, H, 1))."""
    qs = torch.clamp(q.abs().amax(dim=2, keepdim=True), min=1e-8) / 127.0
    return _q8(q, qs, 127.0), qs


def _attention_plain(q_row, kn_f, vn_f, kc, vc, ks, vs, pos, H, D, tbp,
                     kv_bits, act_bf16):
    """#1's attention for one layer, all (b, h), appended in place at `pos`.

    q_row (B, d) pre-scaled; kn_f/vn_f (B, d) new K/V; kc/vc (B, T, dc)
    codes; ks/vs (B, T). Returns attn2d (B, d)."""
    B = q_row.shape[0]
    kcode, vcode, ks_new, vs_new = _new_kv_codes(kn_f, vn_f, kv_bits)
    q = q_row.reshape(B, H, D)
    qcode, qs = _q_codes(q)
    limit = torch.full((B,), pos, dtype=torch.int64, device=q.device)
    state = _kv8_blocks(_init_state(B, H, D, q.device), qcode, qs, kc, vc, ks, vs,
                        -(-pos // tbp), limit, tbp, kv_bits, H, D)
    attn2d = _merge_new(state, q, (kcode * ks_new).reshape(B, H, D),
                        (vcode * vs_new).reshape(B, H, D), act_bf16)
    kc[:, pos] = _kv_bytes(kcode, kv_bits)
    vc[:, pos] = _kv_bytes(vcode, kv_bits)
    ks[:, pos] = ks_new[:, 0]
    vs[:, pos] = vs_new[:, 0]
    return attn2d


def _attention_f_plain(q_row, kn_f, vn_f, kc, vc, pos, H, D, tbp, act_bf16):
    """#3's attention for one layer over float caches kc/vc (B, T, d) of the
    cache dtype, appended in place at `pos`. q·sm_scale is rounded to the
    cache dtype for the score dots, each block's probabilities before the
    P·V dot, and the new K/V before their score (against the unrounded q)
    and merge (JAX `_mega_kernel`)."""
    B = q_row.shape[0]
    f32, cdt = torch.float32, kc.dtype
    q = q_row.reshape(B, H, D)
    qm = q.to(cdt).to(f32)
    kn, vn = kn_f.to(cdt), vn_f.to(cdt)
    m, lsum, acc = _init_state(B, H, D, q.device)
    nblk = -(-pos // tbp)
    if nblk:
        n = nblk * tbp
        kb = kc[:, :n].to(f32).reshape(B, nblk, tbp, H, D)
        vb = vc[:, :n].to(f32).reshape(B, nblk, tbp, H, D)
        s = torch.einsum("bhi,bjthi->bhjt", qm, kb)
        valid = (torch.arange(n, device=q.device) < pos).reshape(1, 1, nblk, tbp)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_run = torch.cummax(torch.clamp(s.amax(dim=3), min=NEG_INF), dim=2).values
        p = torch.exp(s - m_run[..., None])
        psum = p.sum(dim=3)
        pv = torch.einsum("bhjt,bjthi->bhji", p.to(cdt).to(f32), vb)
        for j in range(nblk):
            corr = torch.exp(m - m_run[:, :, j])
            lsum = lsum * corr + psum[:, :, j]
            acc = acc * corr[..., None] + pv[:, :, j]
            m = m_run[:, :, j]
    attn2d = _merge_new((m, lsum, acc), q, kn.to(f32).reshape(B, H, D),
                        vn.to(f32).reshape(B, H, D), act_bf16)
    kc[:, pos] = kn
    vc[:, pos] = vn
    return attn2d


def _attention_cb_plain(q_row, kn_f, vn_f, main, rec, lengths, rpos, H, D, tbp,
                        kv_bits, act_bf16):
    """#4's attention for one layer: main caches (kc, vc, ks, vs) rows
    [0, lengths[b]) in tbp-row blocks up to the batch's longest row (a block
    that a row masks entirely adds exactly 0, or, while the row has no
    valid score yet, a finite sum that the final correction exp(m - m_f)
    zeroes), then the recent block (kr, vr, ksr, vsr) rows [0, rpos), then
    the new token; the new codes and scales are appended to the recent
    buffer at rpos."""
    B = q_row.shape[0]
    kcode, vcode, ks_new, vs_new = _new_kv_codes(kn_f, vn_f, kv_bits)
    q = q_row.reshape(B, H, D)
    qcode, qs = _q_codes(q)
    dev = q.device
    state = _kv8_blocks(_init_state(B, H, D, dev), qcode, qs, *main,
                        -(-int(lengths.max()) // tbp), lengths, tbp, kv_bits, H, D)
    state = _kv8_blocks(state, qcode, qs, *rec, 1,
                        torch.full((B,), rpos, dtype=torch.int64, device=dev), tbp,
                        kv_bits, H, D)
    attn2d = _merge_new(state, q, (kcode * ks_new).reshape(B, H, D),
                        (vcode * vs_new).reshape(B, H, D), act_bf16)
    kr, vr, ksr, vsr = rec
    kr[:, rpos] = _kv_bytes(kcode, kv_bits)
    vr[:, rpos] = _kv_bytes(vcode, kv_bits)
    ksr[:, rpos] = ks_new[:, 0]
    vsr[:, rpos] = vs_new[:, 0]
    return attn2d


def _step_plain(h, mw: MegaWeights, attention, *, n_head, has_lora, eps,
                act_dtype, aq_max, sm_scale):
    """The layer loop shared by the plain versions. `attention(l, q_row,
    kn_f, vn_f)` runs layer l's attention (caches updated in place) and
    returns attn2d (B, d)."""
    B, d = h.shape
    L = mw.wt.shape[0]
    wbits = 4 if mw.wt.shape[2] == d // 2 else 8
    act_bf16 = act_dtype == torch.bfloat16
    ldt = _lora_operand_dtype(mw, act_bf16)
    f32 = torch.float32
    o = h.to(f32).clone()
    bound = aq_max * (7.0 if wbits == 4 else 127.0)

    for l in range(L):
        W = _tile_codes(mw, l, wbits)                     # (12, d, d)
        ws, bias = mw.ws[l, :, 0], mw.bias[l, :, 0]       # (12, d)
        xs = mw.xs[l]
        at = mw.at[l].to(ldt).to(f32)                     # (12, d, r)
        bt = mw.bt[l].to(ldt).to(f32)                     # (12, r, d)
        ln = mw.ln[l]

        def lora_a(x, t):
            return torch.matmul(x.to(ldt).to(f32), at[t]) * mw.at_s[l, t]

        def lora_b(xa, t):
            return torch.matmul(xa.to(ldt).to(f32), bt[t]) * mw.bt_s[l, t]

        def linear(qx, tiles, xs_i, xa):
            """Σ_tiles int dot, scale, bias, LoRA-B; out tiles concatenate."""
            outs = []
            for t in tiles:
                acc = exact_int_matmul(qx, W[t], bound)
                y = acc.to(f32) * (xs_i * ws[t]) + bias[t]
                if has_lora:
                    y = y + lora_b(xa, t)
                outs.append(y)
            return torch.cat(outs, dim=1)

        hn = _rt(_ln_f32(o, ln[0], ln[1], eps), act_bf16)
        qx = _q8(hn, xs[0], aq_max)
        xa = lora_a(hn, 0) if has_lora else None
        qkv = linear(qx, (0, 1, 2), xs[0], xa)
        attn2d = attention(l, qkv[:, :d] * sm_scale, qkv[:, d:2 * d], qkv[:, 2 * d:])
        xa = lora_a(attn2d, 3) if has_lora else None
        proj = linear(_q8(attn2d, xs[1], aq_max), (3,), xs[1], xa)
        o = _rt(o + _rt(proj, act_bf16), act_bf16)
        hn2 = _rt(_ln_f32(o, ln[2], ln[3], eps), act_bf16)
        xa = lora_a(hn2, 4) if has_lora else None
        fc = linear(_q8(hn2, xs[2], aq_max), (4, 5, 6, 7), xs[2], xa)
        g = _rt(_gelu_as(fc), act_bf16)                   # (B, 4d)
        qg = _q8(g, xs[3], aq_max)
        acc = sum(exact_int_matmul(qg[:, i * d:(i + 1) * d], W[8 + i], bound)
                  for i in range(4))
        mlp = acc.to(f32) * (xs[3] * ws[11]) + bias[11]
        if has_lora:
            xam = lora_a(g[:, :d], 8)
            for i in range(1, 4):
                xam = xam + lora_a(g[:, i * d:(i + 1) * d], 8 + i)
            mlp = mlp + lora_b(xam, 11)
        o = _rt(o + _rt(mlp, act_bf16), act_bf16)
    return o


def mega_decode_step_kv8_plain(h, mw: MegaWeights, k_cache, v_cache, k_scale,
                               v_scale, pos, *, n_head: int, head_dim: int,
                               has_lora: bool, eps: float = 1e-5,
                               tbp: int = 32, act_dtype=torch.bfloat16,
                               aq_max: float = 127.0, kv_bits: int = 8,
                               tiles_per_step: int = 1):
    """Plain PyTorch version of `mega_decode_step_kv8` (same arguments,
    caches updated in place, same return)."""
    tbp, _wbits, _dc, _T = _check_step(h, mw, k_cache, v_cache, k_scale, v_scale,
                                       pos, n_head, head_dim, tbp, kv_bits,
                                       tiles_per_step)
    pos = int(pos)
    act_bf16 = act_dtype == torch.bfloat16

    def attention(l, q_row, kn_f, vn_f):
        return _attention_plain(q_row, kn_f, vn_f, k_cache[l], v_cache[l],
                                k_scale[l], v_scale[l], pos, n_head, head_dim,
                                tbp, kv_bits, act_bf16)

    o = _step_plain(h, mw, attention, n_head=n_head, has_lora=has_lora, eps=eps,
                    act_dtype=act_dtype, aq_max=aq_max,
                    sm_scale=1.0 / math.sqrt(head_dim))
    return o, k_cache, v_cache, k_scale, v_scale


def mega_decode_step_plain(h, mw: MegaWeights, k_cache, v_cache, pos, *,
                           n_head: int, head_dim: int, has_lora: bool,
                           eps: float = 1e-5, tbp: int = 32,
                           act_dtype=torch.bfloat16, aq_max: float = 127.0,
                           tiles_per_step: int = 1):
    """Plain PyTorch version of `mega_decode_step` (same arguments, caches
    updated in place, same return)."""
    tbp, _wbits, _dc, _T = _check_step(h, mw, k_cache, v_cache, None, None, pos,
                                       n_head, head_dim, tbp, 16, tiles_per_step)
    pos = int(pos)
    act_bf16 = act_dtype == torch.bfloat16

    def attention(l, q_row, kn_f, vn_f):
        return _attention_f_plain(q_row, kn_f, vn_f, k_cache[l], v_cache[l], pos,
                                  n_head, head_dim, tbp, act_bf16)

    o = _step_plain(h, mw, attention, n_head=n_head, has_lora=has_lora, eps=eps,
                    act_dtype=act_dtype, aq_max=aq_max,
                    sm_scale=1.0 / math.sqrt(head_dim))
    return o, k_cache, v_cache


def mega_decode_step_cb_plain(h, mw: MegaWeights, k_main, v_main, ks_main,
                              vs_main, k_rec, v_rec, ks_rec, vs_rec, lengths,
                              rpos, *, n_head: int, head_dim: int,
                              has_lora: bool, eps: float = 1e-5, tbp: int = 64,
                              act_dtype=torch.bfloat16, aq_max: float = 127.0,
                              kv_bits: int = 8, tiles_per_step: int = 1):
    """Plain PyTorch version of `mega_decode_step_cb` (same arguments, the
    recent buffer updated in place, same return)."""
    tbp, _wbits, _Tc, _Tr, lens, rpos = _check_cb(
        h, mw, k_main, v_main, ks_main, vs_main, k_rec, v_rec, ks_rec, vs_rec,
        lengths, rpos, n_head, head_dim, tbp, kv_bits, tiles_per_step)
    act_bf16 = act_dtype == torch.bfloat16
    lens_t = torch.as_tensor(lens, dtype=torch.int64, device=h.device)

    def attention(l, q_row, kn_f, vn_f):
        return _attention_cb_plain(
            q_row, kn_f, vn_f, (k_main[l], v_main[l], ks_main[l], vs_main[l]),
            (k_rec[l], v_rec[l], ks_rec[l], vs_rec[l]), lens_t, rpos, n_head,
            head_dim, tbp, kv_bits, act_bf16)

    o = _step_plain(h, mw, attention, n_head=n_head, has_lora=has_lora, eps=eps,
                    act_dtype=act_dtype, aq_max=aq_max,
                    sm_scale=1.0 / math.sqrt(head_dim))
    return o, k_rec, v_rec, ks_rec, vs_rec


def cb_merge_recent(kc, vc, ksc, vsc, k_rec, v_rec, ks_rec, vs_rec, lengths,
                    k: int):
    """Merge a chunk's `k` recent rows into the main caches, per slot, in
    place: slot b's rows go to [row, row + k) with row = clip(lengths[b], 0,
    T - k). Inactive slots merge finite garbage at their stale length,
    which is never attended (per-slot lengths mask it) and which prefill
    overwrites on reuse. Scales are (L, B, T) / (L, B, Tr)."""
    T = kc.shape[2]
    k = min(int(k), T)
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.detach().cpu()
    for b, n in enumerate(np.asarray(lengths, np.int64).reshape(-1)):
        row = min(max(int(n), 0), T - k)
        kc[:, b, row:row + k] = k_rec[:, b, :k]
        vc[:, b, row:row + k] = v_rec[:, b, :k]
        ksc[:, b, row:row + k] = ks_rec[:, b, :k]
        vsc[:, b, row:row + k] = vs_rec[:, b, :k]
    return kc, vc, ksc, vsc


# ---------------------------------------------------------------------------
# The CUDA kernels' wrappers
# ---------------------------------------------------------------------------

_LORA_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SCRATCH: Dict[tuple, tuple] = {}


def _scratch(dev, B: int, d: int, r: int):
    """The step's device scratch for (device, B, d, r), allocated once:
    activation codes, LoRA-A output, prepared row, int32 K-slice partials,
    LoRA-B partials, qkv, attention output and the fc output. The step
    writes each before it reads it, and calls on one stream run in order."""
    key = (dev, B, d, r)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        f32, i32 = torch.float32, torch.int32
        bufs = (torch.empty((B, 4 * d), dtype=torch.int8, device=dev),
                torch.empty((B, max(r, 1)), dtype=f32, device=dev),
                torch.empty((B, 4 * d), dtype=f32, device=dev),
                torch.empty((_KSPLIT, B, 4 * d), dtype=i32, device=dev),
                torch.empty((_LB_SPLIT, B, 4 * d), dtype=f32, device=dev),
                torch.empty((B, 3 * d), dtype=f32, device=dev),
                torch.empty((B, d), dtype=f32, device=dev),
                torch.empty((B, 4 * d), dtype=f32, device=dev))
        _SCRATCH[key] = bufs
    return bufs


def _launch_parts(what, h, mw, caches, head_dim, has_lora, act_dtype):
    """Checks shared by the three step kernels. `caches` maps a name to
    (tensor, dtype). Returns (h_out, weight pointers, scratch pointers,
    r, LoRA ints (has_lora, lora dtype, act_bf16, lora_round))."""
    B, d = h.shape
    r = mw.at.shape[3]
    if B > MAX_SLOTS:
        raise ValueError(f"{what}: at most {MAX_SLOTS} batch rows; got {B}")
    if head_dim > 128 or head_dim % 4:
        raise ValueError(f"head_dim must be a multiple of 4 up to 128; got {head_dim}")
    if r > 256:
        raise ValueError(f"LoRA rank {r} above 256")
    if mw.at.dtype not in _LORA_DTYPE_CODE or mw.bt.dtype != mw.at.dtype:
        raise ValueError(f"LoRA banks must share a dtype of f32/bf16/int8; got "
                         f"{mw.at.dtype}/{mw.bt.dtype}")
    want = {
        "h": (h, torch.float32), "wt": (mw.wt, torch.int8),
        "ws": (mw.ws, torch.float32), "bias": (mw.bias, torch.float32),
        "at": (mw.at, mw.at.dtype), "bt": (mw.bt, mw.at.dtype),
        "at_s": (mw.at_s, torch.float32), "bt_s": (mw.bt_s, torch.float32),
        "ln": (mw.ln, torch.float32), "xs": (mw.xs, torch.float32), **caches,
    }
    for name, (t, dt) in want.items():
        if t.device != h.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous {dt} tensor on "
                             f"{h.device}; got {t.dtype} on {t.device}")
    act_bf16 = act_dtype == torch.bfloat16
    lora_round = _lora_operand_dtype(mw, act_bf16) == torch.bfloat16
    h_out = torch.empty_like(h)
    weights = [h, h_out, mw.wt, mw.ws, mw.bias, mw.at, mw.bt, mw.at_s, mw.bt_s,
               mw.ln, mw.xs]
    lora = [int(bool(has_lora)), _LORA_DTYPE_CODE[mw.at.dtype], int(act_bf16),
            int(lora_round)]
    return h_out, weights, list(_scratch(h.device, B, d, r)), r, lora


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def mega_decode_step_kv8(h, mw: MegaWeights, k_cache, v_cache, k_scale,
                         v_scale, pos, *, n_head: int, head_dim: int,
                         has_lora: bool, eps: float = 1e-5, tbp: int = 32,
                         act_dtype=torch.bfloat16, aq_max: float = 127.0,
                         kv_bits: int = 8, tiles_per_step: int = 1):
    """One decode token through all layers; KV caches updated at `pos`.

    h: (B, d) f32 post-embedding hidden state. k_cache/v_cache: (L, B, T, d)
    int8 codes (kv_bits=8) or (L, B, T, d/2) lane-halves nibbles
    (kv_bits=4); k_scale/v_scale: (L, B, T) f32 per-row scales. The caches
    and scales are updated in place and returned. `tiles_per_step` is a TPU
    grid option, validated and otherwise unused. Returns
    (h_out, k_cache, v_cache, k_scale, v_scale).

    CPU tensors take `mega_decode_step_kv8_plain`; CUDA tensors launch the
    step in `csrc/mega_decode.cu` or raise. Counts its launches (one per
    step) in `mega_decode_step_kv8.launches`.
    """
    if h.device.type == "cpu":
        return mega_decode_step_kv8_plain(
            h, mw, k_cache, v_cache, k_scale, v_scale, pos, n_head=n_head,
            head_dim=head_dim, has_lora=has_lora, eps=eps, tbp=tbp,
            act_dtype=act_dtype, aq_max=aq_max, kv_bits=kv_bits,
            tiles_per_step=tiles_per_step)
    tbp, wbits, dc, Tc = _check_step(h, mw, k_cache, v_cache, k_scale, v_scale,
                                     pos, n_head, head_dim, tbp, kv_bits,
                                     tiles_per_step)
    B, d = h.shape
    caches = {"k_cache": (k_cache, torch.int8), "v_cache": (v_cache, torch.int8),
              "k_scale": (k_scale, torch.float32), "v_scale": (v_scale, torch.float32)}
    h_out, weights, scratch, r, lora = _launch_parts(
        "mega_decode_step_kv8", h, mw, caches, head_dim, has_lora, act_dtype)
    lib = _build.load("mega_decode")
    rc = lib.mega_decode_step_kv(
        *_ptrs(weights), *_ptrs((k_cache, v_cache, k_scale, v_scale)),
        *_ptrs(scratch), mw.wt.shape[0], B, d, n_head, Tc, r, int(pos), tbp, wbits,
        kv_bits, *lora, _KSPLIT, float(eps), float(aq_max),
        1.0 / math.sqrt(head_dim), _build.stream(h))
    _build.check(lib, rc, "mega_decode_step_kv8")
    mega_decode_step_kv8.launches += 1
    return h_out, k_cache, v_cache, k_scale, v_scale


def mega_decode_step(h, mw: MegaWeights, k_cache, v_cache, pos, *,
                     n_head: int, head_dim: int, has_lora: bool,
                     eps: float = 1e-5, tbp: int = 32,
                     act_dtype=torch.bfloat16, aq_max: float = 127.0,
                     tiles_per_step: int = 1):
    """One decode token through all layers over float head-interleaved
    caches (L, B, T, d) of float32 or bf16 (row t holds every head's K or
    V), updated in place at `pos`. Returns (h_out, k_cache, v_cache).

    CPU tensors take `mega_decode_step_plain`; CUDA tensors launch the step
    in `csrc/mega_decode.cu` (attention kernel `k_attn_f`) or raise. Counts
    its launches in `mega_decode_step.launches`.
    """
    if h.device.type == "cpu":
        return mega_decode_step_plain(
            h, mw, k_cache, v_cache, pos, n_head=n_head, head_dim=head_dim,
            has_lora=has_lora, eps=eps, tbp=tbp, act_dtype=act_dtype,
            aq_max=aq_max, tiles_per_step=tiles_per_step)
    tbp, wbits, _dc, Tc = _check_step(h, mw, k_cache, v_cache, None, None, pos,
                                      n_head, head_dim, tbp, 16, tiles_per_step)
    B, d = h.shape
    cdt = k_cache.dtype
    caches = {"k_cache": (k_cache, cdt), "v_cache": (v_cache, cdt)}
    h_out, weights, scratch, r, lora = _launch_parts(
        "mega_decode_step", h, mw, caches, head_dim, has_lora, act_dtype)
    lib = _build.load("mega_decode")
    rc = lib.mega_decode_step_f(
        *_ptrs(weights), *_ptrs((k_cache, v_cache)), *_ptrs(scratch),
        mw.wt.shape[0], B, d, n_head, Tc, r, int(pos), tbp, wbits,
        _CACHE_DTYPE_CODE[cdt], *lora, _KSPLIT, float(eps), float(aq_max),
        1.0 / math.sqrt(head_dim), _build.stream(h))
    _build.check(lib, rc, "mega_decode_step")
    mega_decode_step.launches += 1
    return h_out, k_cache, v_cache


def mega_decode_step_cb(h, mw: MegaWeights, k_main, v_main, ks_main, vs_main,
                        k_rec, v_rec, ks_rec, vs_rec, lengths, rpos, *,
                        n_head: int, head_dim: int, has_lora: bool,
                        eps: float = 1e-5, tbp: int = 64,
                        act_dtype=torch.bfloat16, aq_max: float = 127.0,
                        kv_bits: int = 8, tiles_per_step: int = 1):
    """Continuous-batching step: per-slot prefixes, two-level KV.

    k_main/v_main (L, B, Tc, dc) + ks_main/vs_main (L, B, Tc): each slot's
    prefix up to `lengths[b]` (read only). k_rec/v_rec (L, B, Tr, dc) +
    ks_rec/vs_rec (L, B, Tr): the chunk-local recent buffer (Tr == tbp),
    whose rows [0, rpos) are attended after the main prefix and which
    receives the new codes and scales at the batch-uniform `rpos`, in place.
    `lengths` lives on the host (a sequence, numpy array or CPU tensor) and
    is checked there, as is rpos < Tr. Merge the recent rows into the main
    caches once per chunk with `cb_merge_recent`. Returns
    (h_out, k_rec, v_rec, ks_rec, vs_rec).

    CPU tensors take `mega_decode_step_cb_plain`; CUDA tensors launch the
    step in `csrc/mega_decode.cu` or raise. Counts its launches in
    `mega_decode_step_cb.launches`.
    """
    if h.device.type == "cpu":
        return mega_decode_step_cb_plain(
            h, mw, k_main, v_main, ks_main, vs_main, k_rec, v_rec, ks_rec,
            vs_rec, lengths, rpos, n_head=n_head, head_dim=head_dim,
            has_lora=has_lora, eps=eps, tbp=tbp, act_dtype=act_dtype,
            aq_max=aq_max, kv_bits=kv_bits, tiles_per_step=tiles_per_step)
    tbp, wbits, Tc, Tr, lens, rpos = _check_cb(
        h, mw, k_main, v_main, ks_main, vs_main, k_rec, v_rec, ks_rec, vs_rec,
        lengths, rpos, n_head, head_dim, tbp, kv_bits, tiles_per_step)
    B, d = h.shape
    i8, f32 = torch.int8, torch.float32
    caches = {"k_main": (k_main, i8), "v_main": (v_main, i8),
              "ks_main": (ks_main, f32), "vs_main": (vs_main, f32),
              "k_rec": (k_rec, i8), "v_rec": (v_rec, i8),
              "ks_rec": (ks_rec, f32), "vs_rec": (vs_rec, f32)}
    h_out, weights, scratch, r, lora = _launch_parts(
        "mega_decode_step_cb", h, mw, caches, head_dim, has_lora, act_dtype)
    lib = _build.load("mega_decode")
    rc = lib.mega_decode_step_cb(
        *_ptrs(weights), *_ptrs((k_main, v_main, ks_main, vs_main)),
        *_ptrs((k_rec, v_rec, ks_rec, vs_rec)), lens.ctypes.data, *_ptrs(scratch),
        mw.wt.shape[0], B, d, n_head, Tc, Tr, r, rpos, tbp, wbits, kv_bits, *lora,
        _KSPLIT, float(eps), float(aq_max), 1.0 / math.sqrt(head_dim),
        _build.stream(h))
    _build.check(lib, rc, "mega_decode_step_cb")
    mega_decode_step_cb.launches += 1
    return h_out, k_rec, v_rec, ks_rec, vs_rec


mega_decode_step_kv8.launches = 0
mega_decode_step.launches = 0
mega_decode_step_cb.launches = 0
