"""Single-token decode attention over KV caches, with in-place append.

Counterpart of `llm_qat_tpu/ops/decode_attention.py`: the packed layout
helpers (`kv_pack_factor`, `pack_kv`, `unpack_kv`), the dense reference
`decode_attention_reference`, the dense-cache kernel `decode_attention`
(the Pallas `_decode_attn_kernel`, kernel #9), and the two kernels of the
packed layout: `decode_attention_hbm` (shared position, the Pallas
`_hbm_kernel`, #7) and `decode_attention_hbm_multi` (per-slot positions with
-1 = inactive, the Pallas `_hbm_kernel_multi`, #8). The packed wrappers
launch one CUDA kernel in `csrc/decode_attention.cu`, which takes a
position per slot; the shared position is broadcast to every slot. #9 is a
second kernel in the same source. Each has its plain PyTorch version
beside it.

Dense layout (#9): caches (B, H, T, D). The new K/V row is written at pos
in the cache dtype, then q·sm_scale (float32, not rounded) attends over
rows 0 … pos with one exact softmax; the probabilities stay float32 and
the output takes q's dtype.

Packed layout: a cache is (B, H, T/P, P·D) with P = `kv_pack_factor(D)`;
packed row u holds timesteps P·u … P·u + P − 1 in lane groups of D. The
attention streams the prefix [0, pos) in blocks of `tbp` packed rows with a
float32 online softmax whose maximum is taken per block over both lane
groups; q·sm_scale and each block's probabilities are rounded to the cache
dtype before their dots, as the JAX kernel does. The new token's K/V go
through the cache dtype and merge last, with its score taken against the
unrounded float32 q. The append writes only the lane group of row pos // P
that belongs to `pos`, and only for slots with pos >= 0; every other byte
of the cache stays as it was. Caches are updated in place.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build

NEG_INF = -1e30
MAX_SLOTS = 256  # slots per call: the kernel takes the positions by value


def kv_pack_factor(head_dim: int) -> int:
    """Timesteps per 128-lane packed row (1 if head_dim doesn't divide 128)."""
    return 128 // head_dim if 128 % head_dim == 0 and head_dim < 128 else 1


def pack_kv(x):
    """(B, H, S, D) -> packed (B, H, S/P, P*D), P = kv_pack_factor(D)."""
    B, H, S, D = x.shape
    P = kv_pack_factor(D)
    if S % P:
        raise ValueError(f"pack_kv needs S % {P} == 0; got S={S}")
    return x.reshape(B, H, S // P, P * D)


def unpack_kv(x, head_dim: int = 64):
    """Packed (B, H, Tp, P*D) -> (B, H, P*Tp, D) (a view)."""
    B, H, Tp, PD = x.shape
    if PD % head_dim:
        raise ValueError(f"row width {PD} is not a multiple of {head_dim}")
    return x.reshape(B, H, (PD // head_dim) * Tp, head_dim)


def decode_attention_reference(q, k_new, v_new, k_cache, v_cache, pos):
    """Dense reference (the unfused decode path's math) on unpacked
    (B, H, T, D) caches; returns new caches, leaving the inputs as they are."""
    B, H, _, D = q.shape
    T = k_cache.shape[2]
    pos = torch.as_tensor(pos, device=q.device).to(torch.int64).expand(B)
    rows = torch.arange(B, device=q.device)
    kc, vc = k_cache.clone(), v_cache.clone()
    kc[rows, :, pos] = k_new[:, :, 0].to(kc.dtype)
    vc[rows, :, pos] = v_new[:, :, 0].to(vc.dtype)
    f32 = torch.float32
    s = torch.einsum("bhsd,bhtd->bhst", q.to(f32), kc.to(f32)) / math.sqrt(D)
    valid = torch.arange(T, device=q.device)[None] <= pos[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1).to(vc.dtype)
    out = torch.einsum("bhst,bhtd->bhsd", p.to(f32), vc.to(f32)).to(vc.dtype)
    return out, kc, vc


def block_rows(T: int, tbp: int) -> int:
    """The streamed block: the largest multiple of 8 up to tbp that divides
    the T cache rows (the JAX wrappers' rule)."""
    tbp = min(tbp, T)
    while T % tbp and tbp > 8:
        tbp -= 8
    if T % tbp or tbp % 8:
        raise ValueError(f"cache length {T} has no tbp multiple of 8 dividing it")
    return tbp


def _positions(pos, B: int, T: int, shared: bool) -> np.ndarray:
    """The (B,) host positions, checked against the cache: 0 <= pos < T for
    a shared position; -1 (inactive) or 0 <= pos < T per slot. An append
    past the cache end would write out of bounds on the card."""
    if shared:
        p = int(pos)
        if not 0 <= p < T:
            raise ValueError(f"pos={p} outside the cache [0, {T})")
        return np.full((B,), p, np.int32)
    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu()
    p = np.asarray(pos, np.int64).reshape(-1)
    if p.shape != (B,):
        raise ValueError(f"pos must hold one position per slot ({B}); got {p.shape}")
    bad = (p < -1) | (p >= T)
    if bad.any():
        raise ValueError(f"positions {p[bad].tolist()} outside the cache [0, {T}) "
                         f"(-1 marks an inactive slot)")
    return p.astype(np.int32)


def _check_shapes(q, k_new, v_new, k_cache, v_cache):
    B, H, S, D = q.shape
    P = kv_pack_factor(D)
    if S != 1:
        raise ValueError(f"decode attention takes one token; got S={S}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, H, 1, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {(B, H, 1, D)}")
    Tp = k_cache.shape[2]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(t.shape) != (B, H, Tp, P * D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want "
                             f"{(B, H, Tp, P * D)}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache must share a dtype")
    return B, H, D, P, Tp


def _dense_positions(pos, B: int, T: int) -> np.ndarray:
    """#9's (B,) host positions: one shared position (an int or a 0-d
    tensor) or one per slot, each 0 <= pos < T."""
    shared = not isinstance(pos, (list, tuple, np.ndarray)) and (
        not isinstance(pos, torch.Tensor) or pos.dim() == 0)
    p = _positions(pos, B, T, shared)
    if (p < 0).any():
        raise ValueError(f"positions {p[p < 0].tolist()} outside the cache [0, {T})")
    return p


def _check_dense(q, k_new, v_new, k_cache, v_cache):
    B, H, S, D = q.shape
    if S != 1:
        raise ValueError(f"decode attention takes one token; got S={S}")
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, H, 1, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {(B, H, 1, D)}")
    T = k_cache.shape[2]
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if tuple(t.shape) != (B, H, T, D):
            raise ValueError(f"{name} has shape {tuple(t.shape)}; want {(B, H, T, D)}")
    if v_cache.dtype != k_cache.dtype:
        raise ValueError("k_cache and v_cache must share a dtype")
    return B, H, T, D


def _dense_plain(q, k_new, v_new, k_cache, v_cache, pos):
    """Plain version of #9 over (B,) host positions."""
    B, H, T, D = _check_dense(q, k_new, v_new, k_cache, v_cache)
    f32, dev = torch.float32, q.device
    p = torch.as_tensor(pos, dtype=torch.int64, device=dev)
    rows = torch.arange(B, device=dev)
    k_cache[rows, :, p] = k_new[:, :, 0].to(k_cache.dtype)
    v_cache[rows, :, p] = v_new[:, :, 0].to(v_cache.dtype)
    qs = q.to(f32) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhsd,bhtd->bhst", qs, k_cache.to(f32))
    valid = torch.arange(T, device=dev)[None] <= p[:, None]
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    pr = torch.exp(s - s.amax(dim=-1, keepdim=True))
    lsum = pr.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhst,bhtd->bhsd", pr, v_cache.to(f32)) / torch.clamp(lsum, min=1e-30)
    return o.to(q.dtype), k_cache, v_cache


def decode_attention_plain(q, k_new, v_new, k_cache, v_cache, pos):
    """Plain PyTorch version of `decode_attention` (same arguments; caches
    updated in place; same return)."""
    return _dense_plain(q, k_new, v_new, k_cache, v_cache,
                        _dense_positions(pos, q.shape[0], k_cache.shape[2]))


def decode_attention(q, k_new, v_new, k_cache, v_cache, pos):
    """One-token attention on dense caches (kernel #9).

    q/k_new/v_new: (B, H, 1, D); k_cache/v_cache: (B, H, T, D) float32 or
    bf16, updated in place at `pos`: one shared position (a host int) or one
    per slot ((B,) on the host), each 0 <= pos < T. Returns (out (B, H, 1, D)
    in q's dtype, k_cache, v_cache).

    CPU tensors take `decode_attention_plain`; CUDA tensors launch the
    kernel in `csrc/decode_attention.cu` or raise. Counts its launches in
    `decode_attention.launches`.
    """
    B = q.shape[0]
    host = _dense_positions(pos, B, k_cache.shape[2])
    if q.device.type == "cpu":
        return _dense_plain(q, k_new, v_new, k_cache, v_cache, host)
    B, H, T, D = _check_dense(q, k_new, v_new, k_cache, v_cache)
    what = "decode_attention"
    if D not in (32, 64, 128):
        raise ValueError(f"{what}: head_dim must be 32, 64 or 128; got {D}")
    if T + 33 + 128 > 12 * 1024:
        raise ValueError(f"{what}: at most {12 * 1024 - 161} cache rows; got {T}")
    if B > MAX_SLOTS:
        raise ValueError(f"{what}: at most {MAX_SLOTS} slots; got {B}")
    cdt = k_cache.dtype
    if cdt not in _CACHE_DTYPE_CODE:
        raise ValueError(f"{what}: caches must be float32 or bfloat16; got {cdt}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}; got {t.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():  # appended in place: no copy may stand in
            raise ValueError(f"{what}: {name} must be contiguous")
    qf, kf, vf = (t.to(torch.float32).contiguous() for t in (q, k_new, v_new))
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_dense(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), host.ctypes.data, B, H, D, T,
        _CACHE_DTYPE_CODE[cdt], 1.0 / math.sqrt(D), _build.stream(q))
    _build.check(lib, rc, what)
    decode_attention.launches += 1
    return out.to(q.dtype), k_cache, v_cache


def _hbm_plain(q, k_new, v_new, k_cache, v_cache, pos, tbp):
    """Plain version of both kernels over (B,) host positions `pos`."""
    B, H, D, P, Tp = _check_shapes(q, k_new, v_new, k_cache, v_cache)
    tbp = block_rows(Tp, tbp)
    f32, cdt, dev = torch.float32, k_cache.dtype, q.device
    sm_scale = 1.0 / math.sqrt(D)
    qf = q.reshape(B, H, D).to(f32) * sm_scale
    qm = qf.to(cdt).to(f32)                       # Qm: q·sm_scale in the cache dtype
    kn = k_new.reshape(B, H, D).to(cdt)
    vn = v_new.reshape(B, H, D).to(cdt)
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=dev)

    m = torch.full((B, H), NEG_INF, dtype=f32, device=dev)
    lsum = torch.zeros((B, H), dtype=f32, device=dev)
    acc = torch.zeros((B, H, P, D), dtype=f32, device=dev)  # acc[i] over group i
    nblk = -(-max(int(pos.max()), 0) // (P * tbp))
    if nblk:
        n = nblk * tbp
        kb = k_cache[:, :, :n].to(f32).reshape(B, H, nblk, tbp, P, D)
        vb = v_cache[:, :, :n].to(f32).reshape(B, H, nblk, tbp, P, D)
        s = torch.einsum("bhd,bhjupd->bhjup", qm, kb)
        t = torch.arange(n * P, device=dev).reshape(1, 1, nblk, tbp, P)
        valid = t < pos_t.reshape(B, 1, 1, 1, 1)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        bmax = s.amax(dim=(3, 4))                                   # (B, H, nblk)
        m_run = torch.cummax(torch.clamp(bmax, min=NEG_INF), dim=2).values
        pbl = torch.exp(s - m_run[..., None, None])
        psum = pbl.sum(dim=(3, 4))
        pv = torch.einsum("bhjup,bhjupd->bhjpd", pbl.to(cdt).to(f32), vb)
        for j in range(nblk):
            corr = torch.exp(m - m_run[:, :, j])
            lsum = lsum * corr + psum[:, :, j]
            acc = acc * corr[..., None, None] + pv[:, :, j]
            m = m_run[:, :, j]

    s_new = (qf * kn.to(f32)).sum(dim=-1)                            # unrounded q
    m_f = torch.maximum(m, s_new)
    corr = torch.exp(m - m_f)
    p_new = torch.exp(s_new - m_f)
    l_f = lsum * corr + p_new
    out = acc[:, :, 0]
    for i in range(1, P):
        out = out + acc[:, :, i]
    out = out * corr[..., None] + p_new[..., None] * vn.to(f32)
    out = out / torch.clamp(l_f, min=1e-30)[..., None]

    for b in np.flatnonzero(pos >= 0):
        u, part = divmod(int(pos[b]), P)
        k_cache[b, :, u, part * D:(part + 1) * D] = kn[b]
        v_cache[b, :, u, part * D:(part + 1) * D] = vn[b]
    return out.reshape(B, H, 1, D), k_cache, v_cache


def decode_attention_hbm_plain(q, k_new, v_new, k_cache, v_cache, pos, *,
                               tbp: int = 32):
    """Plain PyTorch version of `decode_attention_hbm` (same arguments;
    caches updated in place; same return)."""
    B, _, _, D = q.shape
    T = kv_pack_factor(D) * k_cache.shape[2]
    return _hbm_plain(q, k_new, v_new, k_cache, v_cache,
                      _positions(pos, B, T, True), tbp)


def decode_attention_hbm_multi_plain(q, k_new, v_new, k_cache, v_cache, pos,
                                     *, tbp: int = 32):
    """Plain PyTorch version of `decode_attention_hbm_multi`."""
    B, _, _, D = q.shape
    T = kv_pack_factor(D) * k_cache.shape[2]
    return _hbm_plain(q, k_new, v_new, k_cache, v_cache,
                      _positions(pos, B, T, False), tbp)


_CACHE_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _launch(q, k_new, v_new, k_cache, v_cache, pos, tbp, what):
    """Check the operands and launch the CUDA kernel; returns (out, k, v)."""
    B, H, D, P, Tp = _check_shapes(q, k_new, v_new, k_cache, v_cache)
    tbp = block_rows(Tp, tbp)
    if P * D != 128 or D % 4:
        raise ValueError(f"{what}: the kernel takes 128-lane packed rows of head "
                         f"groups (head_dim 16, 32 or 64); got head_dim {D}")
    if B > MAX_SLOTS:
        raise ValueError(f"{what}: at most {MAX_SLOTS} slots; got {B}")
    cdt = k_cache.dtype
    if cdt not in _CACHE_DTYPE_CODE:
        raise ValueError(f"{what}: caches must be float32 or bfloat16; got {cdt}")
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache),
                    ("v_cache", v_cache)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} must be on {q.device}; got {t.device}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():  # appended in place: no copy may stand in
            raise ValueError(f"{what}: {name} must be contiguous")
    qf, kf, vf = (t.to(torch.float32).contiguous() for t in (q, k_new, v_new))
    out = torch.empty((B, H, 1, D), dtype=torch.float32, device=q.device)
    host = np.ascontiguousarray(pos, np.int32)
    lib = _build.load("decode_attention")
    rc = lib.decode_attention_hbm(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), out.data_ptr(), host.ctypes.data, B, H, D, Tp, P,
        tbp, _CACHE_DTYPE_CODE[cdt], 1.0 / math.sqrt(D), _build.stream(q))
    _build.check(lib, rc, what)
    return out, k_cache, v_cache


def decode_attention_hbm(q, k_new, v_new, k_cache, v_cache, pos, *,
                         tbp: int = 32):
    """One-token attention on packed caches at a shared position `pos`.

    q/k_new/v_new: (B, H, 1, D); k_cache/v_cache: packed (B, H, T/P, P·D)
    float32 or bf16, updated in place at `pos` (a host int, 0 <= pos < T).
    Returns (out (B, H, 1, D) float32, k_cache, v_cache).

    CPU tensors take `decode_attention_hbm_plain`; CUDA tensors launch the
    kernel in `csrc/decode_attention.cu` or raise. Counts its launches in
    `decode_attention_hbm.launches`.
    """
    if q.device.type == "cpu":
        return decode_attention_hbm_plain(q, k_new, v_new, k_cache, v_cache,
                                          pos, tbp=tbp)
    B, _, _, D = q.shape
    host = _positions(pos, B, kv_pack_factor(D) * k_cache.shape[2], True)
    out = _launch(q, k_new, v_new, k_cache, v_cache, host, tbp,
                  "decode_attention_hbm")
    decode_attention_hbm.launches += 1
    return out


def decode_attention_hbm_multi(q, k_new, v_new, k_cache, v_cache, pos, *,
                               tbp: int = 32):
    """`decode_attention_hbm` with a position per slot: `pos` (B,) on the
    host (a sequence, numpy array or CPU tensor), -1 marking an inactive
    slot, whose cache is not written and whose output row is finite and
    unspecified. Counts its launches in `decode_attention_hbm_multi.launches`.
    """
    if q.device.type == "cpu":
        return decode_attention_hbm_multi_plain(q, k_new, v_new, k_cache,
                                                v_cache, pos, tbp=tbp)
    B, _, _, D = q.shape
    host = _positions(pos, B, kv_pack_factor(D) * k_cache.shape[2], False)
    out = _launch(q, k_new, v_new, k_cache, v_cache, host, tbp,
                  "decode_attention_hbm_multi")
    decode_attention_hbm_multi.launches += 1
    return out


decode_attention.launches = 0
decode_attention_hbm.launches = 0
decode_attention_hbm_multi.launches = 0
