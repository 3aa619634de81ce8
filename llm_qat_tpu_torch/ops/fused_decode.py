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
tensors only; for CUDA tensors they launch the persistent cooperative
kernel of `csrc/fused_decode.cu` once, or raise. Each counts its launches
in `<fn>.launches`. Without LoRA banks the LoRA branch is skipped (JAX
passes zero banks to the same kernel). A launch takes at most `MAX_B`
batch rows, so more rows take one launch per 16 (rows are independent: LN
per row, static activation scales). An output width (#12's N, #13's MLP
width) that is not a multiple of `E_COLS` runs on operands padded with
zero columns (and the MLP's zero input rows), copied on each call
(`padded_qkv`, `padded_post`), and the result is sliced: the padded
columns are 0 and add 0, so the function is the same. The port's models
never pad: their widths are 3d and 4d, multiples of 32 whenever d is,
which the kernel needs anyway.

`fused_plan` is the host side of that kernel: which block of the grid owns
which weight bytes (pieces: a column group of `CW` columns times a range
of K rows), LoRA-A items (`la_rows` input rows times every LoRA output)
and epilogue items (`E_COLS` columns times every batch row) of each
linear, and where each lands in the block's shared memory. The kernel
trusts it; a shape it cannot hold raises ValueError here.

The integer dots are exact (`exact_int_matmul` here, int32 __dp4a on the
card); the float32 sums of LN and LoRA are taken in another order by the
kernel, which now and then moves an activation code on a rounding
boundary of q8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from . import _build
from .mega_decode import exact_int_matmul

MAX_B = 16      # batch rows of one launch: the wrappers launch once per 16 rows
MAX_RANK = 128  # LoRA rank the kernel takes


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
# The kernel's plan
# ---------------------------------------------------------------------------

PT = 256           # threads of a block (csrc/fused_decode.cu PT)
CW = 128           # columns of a weight piece: 32 lanes x 4 (CW)
BOX_ROWS = 16      # weight rows of one TMA box; a piece's range is whole boxes (BOX_ROWS)
E_COLS = 32        # columns of an epilogue item (E_COLS)
LA_ROWS = 128      # input rows of a LoRA-A item: a multiple of this, so that
LA_MAX_ITEMS = 24  # no linear has more items than an output sums at once (LA_LOADS)
SMEM_MAX = 232448  # dynamic shared memory a block may ask for on an H100 (227 KB)
FIXED_BYTES = 256  # mbarriers, scalars and LN statistics (FIXED_BYTES)
RH = 16            # ints of a block record's header (RH)
PIECE, ITEM, EPI = 6, 3, 5  # ints of a record's entries (P_PIECE, P_ITEM, P_EPI)
# The launch header, read by the host entry points (csrc/fused_decode.cu H_*):
# blocks, linears, dynamic shared memory, record ints, and the shared-memory
# offsets of the record, the work area and, inside the work area, the
# activation region, the LoRA-A reduction and the rounded LoRA-A sums; the
# LoRA-A item rows of each linear, the scratch offsets of the LoRA-A
# partials, h1 and g, the scratch bytes, and the linear whose input is LN(x).
(H_NB, H_NLIN, H_SMEM, H_REC_LEN, H_REC, H_WORK, H_ACT, H_RED, H_XA, H_LA0,
 H_SC_LAP, H_SC_H1, H_SC_G, H_SC_BYTES, H_LN_AT) = (
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 12, 13, 14, 15, 16)
HDR = 17


class FusedPlan(NamedTuple):
    """Which block of the kernel's grid owns which work of each linear j.

    pieces[j]: (block, column group, first K row, end K row, slot), by
    slot; every weight byte lies in exactly one. A piece's int32 sums go to
    partial-sum slot `slot`; a column group's slots are contiguous and in
    row order (group_slots[j][g] to group_slots[j][g + 1]), and its
    epilogue adds them in that order. lora[j]: (block, t), item t the input
    rows [t·la_rows[j], (t + 1)·la_rows[j]) times every LoRA output.
    epilogue[j]: (block,
    e), item e the columns [e·E_COLS, (e + 1)·E_COLS) of every batch row.
    block_bytes: per block, the bytes its prologue copies into shared
    memory. smem_bytes: the dynamic shared memory the launch asks for.
    header: the launch header (H_*); table: the blocks' records, rec_len
    ints each, which the kernel reads."""

    n_blocks: int
    pieces: tuple
    group_slots: tuple
    lora: tuple
    epilogue: tuple
    la_rows: tuple
    block_bytes: tuple
    smem_bytes: int
    header: np.ndarray
    table: np.ndarray


def _align(x: int, a: int) -> int:
    return -(-x // a) * a


def _fill(load, units: int, unit_bytes: int):
    """Units per block that bring load[b] + n_b·unit_bytes to one level:
    the least level whose fill holds every unit, less the excess taken from
    the fullest blocks."""
    lo, hi = min(load), max(load) + units * unit_bytes

    def count(level):
        return sum(max(0, (level - x) // unit_bytes) for x in load)

    while lo < hi:
        mid = (lo + hi) // 2
        if count(mid) >= units:
            hi = mid
        else:
            lo = mid + 1
    n = [max(0, (lo - x) // unit_bytes) for x in load]
    excess = sum(n) - units
    for b in sorted(range(len(load)), key=lambda b: (-(load[b] + n[b] * unit_bytes), -b)):
        if excess == 0:
            break
        if n[b]:
            n[b] -= 1
            excess -= 1
    return n


def fused_plan(d: int, n_out_list: Sequence[int], K_list: Sequence[int], r: int,
               n_blocks: int, *, batch: int = MAX_B, bank_bytes: int = 2) -> FusedPlan:
    """Split the linears of one fused decode kernel over `n_blocks` blocks.

    Linear j reads K_list[j] input rows and writes n_out_list[j] columns;
    the input of one of them is LN(x) over d: the first of one linear
    (#12's qkv), the second of three (#13's fc). `batch` rows, LoRA rank r
    (0: none) with banks of `bank_bytes` (2 bf16, 4 float32) per element.

    Linear by linear, in phase order: its LoRA-A items and then its
    epilogue items go to the block with the fewest bytes so far, and its
    weight (column group × quad of K rows units, group after group) is cut
    into contiguous ranges, in block order, whose sizes bring every block to
    one level of bytes (water-filling): a block that owns little of one
    linear owns more of the next, so the bytes each block copies are
    balanced over the whole layer. A range splits at column groups into
    pieces.

    Raises ValueError on what one launch cannot run: batch outside 1..16,
    rank above 128, a width that is not a multiple of E_COLS = 32 (the
    epilogue items; the bulk copies also need 16-byte rows), or a block
    whose operands and work area do not fit SMEM_MAX bytes of shared
    memory. (The wrappers launch once per 16 rows and pad output widths.)"""
    ns, ks = [int(n) for n in n_out_list], [int(k) for k in K_list]
    n_lin, d, r, nb, B = len(ns), int(d), int(r), int(n_blocks), int(batch)
    if n_lin not in (1, 3) or len(ks) != n_lin:
        raise ValueError(f"one linear (#12) or three (#13); got {n_out_list}, {K_list}")
    if not 1 <= B <= MAX_B:
        raise ValueError(f"1 to {MAX_B} batch rows; got {B}")
    if not 0 <= r <= MAX_RANK:
        raise ValueError(f"LoRA rank {r} outside [0, {MAX_RANK}]")
    if bank_bytes not in (2, 4):
        raise ValueError(f"LoRA banks are bf16 (2) or float32 (4); got {bank_bytes}")
    for w in [d, *ns, *ks]:
        if w < E_COLS or w % E_COLS:
            raise ValueError(f"widths must be positive multiples of {E_COLS}; got {w}")
    if nb < 1:
        raise ValueError(f"n_blocks must be at least 1; got {n_blocks}")
    ln_at = 0 if n_lin == 1 else 1
    if ks[ln_at] != d:
        raise ValueError(f"the LN linear {ln_at} must read d = {d} rows")
    esz = bank_bytes if r else 0
    la_rows = tuple(LA_ROWS * -(-K // (LA_ROWS * LA_MAX_ITEMS)) for K in ks)
    load = [0] * nb
    pieces, group_slots, lora, epilogue = [], [], [], []
    for j, (N, K) in enumerate(zip(ns, ks)):
        groups, quads, la = -(-N // CW), K // 4, la_rows[j]
        width = [min(CW, N - g * CW) for g in range(groups)]
        n_la = -(-K // la) if r else 0
        item_bytes = [min(la, K - t * la) * r * esz for t in range(n_la)]
        epi_bytes = r * E_COLS * esz + 2 * E_COLS * 4
        if j == ln_at:
            load = [x + 2 * d * 4 for x in load]
        plist, items, epis = [], [], []
        for t in range(n_la):
            blk = min(range(nb), key=lambda b: (load[b], b))
            items.append((blk, t))
            load[blk] += item_bytes[t]
        for e in range(N // E_COLS):
            blk = min(range(nb), key=lambda b: (load[b], b))
            epis.append((blk, e))
            load[blk] += epi_bytes
        counts = _fill(load, groups * quads, 4 * CW)
        u = 0
        for blk in range(nb):
            u1 = u + counts[blk]
            while u < u1:
                g = u // quads
                e = min(u1, (g + 1) * quads)
                r0, r1 = 4 * (u - g * quads), 4 * (e - g * quads)
                plist.append((blk, g, r0, r1))
                load[blk] += (r1 - r0) * width[g]
                u = e
        plist.sort(key=lambda p: (p[1], p[2]))  # slot order: by group, then by row
        starts = [0] * (groups + 1)
        for _, g, _, _ in plist:
            starts[g + 1] += 1
        group_slots.append(tuple(np.cumsum(starts).tolist()))
        pieces.append(tuple((blk, g, r0, r1, s) for s, (blk, g, r0, r1) in enumerate(plist)))
        lora.append(tuple(items))
        epilogue.append(tuple(epis))

    # the blocks' records and shared-memory layouts
    recs, op_end, act_bytes, block_bytes = [], [], 0, []
    for blk in range(nb):
        own = [([p for p in pieces[j] if p[0] == blk], [q for q in lora[j] if q[0] == blk],
                [e for e in epilogue[j] if e[0] == blk]) for j in range(n_lin)]
        head = [0] * RH
        for j, (pj, qj, ej) in enumerate(own):
            head[3 * j:3 * j + 3] = [len(pj), len(qj), len(ej)]
        recs.append((head, own))
    rec_len = max(RH + sum(PIECE * len(p) + ITEM * len(q) + EPI * len(e) for p, q, e in own)
                  for _, own in recs)
    op0 = _align(FIXED_BYTES + 4 * rec_len, 128)
    table = np.zeros((nb, rec_len), np.int32)
    for blk, (head, own) in enumerate(recs):
        off, body, copied = op0, [], 0
        for j, (pj, qj, ej) in enumerate(own):
            N, la = ns[j], la_rows[j]
            if j == ln_at:
                head[9] = off
                off += _align(2 * d * 4, 16)
                copied += 2 * d * 4
            act = 0
            for _, g, r0, r1, s in pj:
                off = _align(off, 128)
                body += [g, r0, r1, s, off, act]
                off += _align(r1 - r0, BOX_ROWS) * CW  # whole TMA boxes
                copied += (r1 - r0) * min(CW, N - g * CW)
                act += _align(B * (r1 - r0), 16)
            for _, t in qj:
                rows = min(la, ks[j] - t * la)
                body += [t, off, act]
                off += _align(rows * r * esz, 16)
                copied += rows * r * esz
                act += _align(B, 4) * rows * 4
            for _, e in ej:
                g = e * E_COLS // CW
                off = _align(off, 128)
                body += [e, off, off + r * E_COLS * esz, group_slots[j][g],
                         group_slots[j][g + 1]]
                off += r * E_COLS * esz + 2 * E_COLS * 4
                copied += r * E_COLS * esz + E_COLS * 4 * 2
            act_bytes = max(act_bytes, act)
        table[blk, :RH + len(body)] = head + body
        op_end.append(off)
        block_bytes.append(copied)
    work_off = _align(max(op_end), 128)
    ln_bytes = B * d * 4
    red = (PT // r) * B * r * 4 if r else 0
    n_items = max((len(q) for q in lora), default=0)
    act_off = ln_bytes
    red_off = act_off + _align(act_bytes, 16)
    xa_off = red_off + red
    work = xa_off + B * r * 4
    smem = work_off + _align(work, 16)
    if smem > SMEM_MAX:
        worst = int(np.argmax(op_end))
        raise ValueError(f"block {worst} of {nb} needs {smem} bytes of shared memory "
                         f"({op_end[worst] - op0} of operands, {work} of work area); the "
                         f"kernel may ask for {SMEM_MAX}: take a larger grid")
    sc_lap = _align(max(len(p) for p in pieces) * B * CW * 4, 256)
    sc_h1 = sc_lap + _align(n_items * B * r * 4, 256)
    sc_g = sc_h1 + (_align(B * ns[0] * 4, 256) if n_lin == 3 else 0)
    sc_bytes = sc_g + (_align(B * ns[1] * 4, 256) if n_lin == 3 else 0)
    header = np.zeros(HDR, np.int32)
    header[[H_NB, H_NLIN, H_SMEM, H_REC_LEN, H_REC, H_WORK, H_ACT, H_RED, H_XA]] = [
        nb, n_lin, smem, rec_len, FIXED_BYTES, work_off, act_off, red_off, xa_off]
    header[H_LA0:H_LA0 + n_lin] = la_rows
    header[[H_SC_LAP, H_SC_H1, H_SC_G, H_SC_BYTES, H_LN_AT]] = [sc_lap, sc_h1, sc_g,
                                                                sc_bytes, ln_at]
    return FusedPlan(nb, tuple(pieces), tuple(group_slots), tuple(lora), tuple(epilogue),
                     la_rows, tuple(block_bytes), smem, header, table.reshape(-1))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_PLANS = {}
_GRID = {}
_BAR = {}


def fused_grid(dev) -> int:
    """Blocks of the kernel's cooperative grid on `dev`: one per SM."""
    dev = torch.device(dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _GRID:
        _GRID[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _GRID[idx]


def barriers(n_lin: int) -> int:
    """Grid barriers of one launch of n_lin linears: one after each phase
    but the last."""
    return 2 * n_lin - 1


def _barrier(dev):
    """The grid barrier's counter on `dev`, zeroed once: the barrier only
    flips its top bit, so any count of barriers leaves it usable."""
    bar = _BAR.get(dev)
    if bar is None:
        bar = _BAR[dev] = torch.zeros((16,), dtype=torch.int32, device=dev)
    return bar


def _plan_on(dev, d, ns, ks, r, grid, B, bank_bytes):
    """(plan, its table on `dev`) at `grid` blocks (one per SM when None),
    cached."""
    nb = fused_grid(dev) if grid is None else int(grid)
    key = (dev, d, tuple(ns), tuple(ks), r, nb, B, bank_bytes)
    got = _PLANS.get(key)
    if got is None:
        plan = fused_plan(d, ns, ks, r, nb, batch=B, bank_bytes=bank_bytes)
        got = _PLANS[key] = (plan, torch.as_tensor(plan.table, device=dev))
    return got


def phase_clock(buf: Optional[torch.Tensor]) -> None:
    """Instrumentation: the launches after this call write, for each grid
    barrier k and block i, the card's global timer (ns) at arrival to
    buf[2k, i] and at release to buf[2k + 1, i], at the block's end to
    buf[2n, i] and at its start to buf[2n + 1, i] (n barriers: `barriers`;
    buf: int64 on the card, (2n + 2, blocks) or larger); None turns it
    off."""
    _build.load("fused_decode").fused_phase_clock(None if buf is None else buf.data_ptr())


def _f32(t, n, dev, what, name, copied=True):
    """t as a contiguous float32 tensor of n values on dev (only its data
    pointer is passed on); 16-byte aligned (a copy where it is not) if the
    kernel copies it with bulk copies."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    if t.numel() != n or t.device != dev:
        raise ValueError(f"{what}: {name} must hold {n} values on {dev}; got "
                         f"{t.numel()} on {t.device}")
    return t if not copied or t.data_ptr() % 16 == 0 else t.clone()


def _scale(t, n, dev, what, name):
    """A weight scale of n values or one (per tensor, which the kernel
    loads as a scalar): (tensor, per column)."""
    per_col = t.numel() != 1
    return _f32(t, n if per_col else 1, dev, what, name, copied=per_col), per_col


def _codes(w, K, N, dev, what, name):
    if (w.dtype != torch.int8 or tuple(w.shape) != (K, N) or not w.is_contiguous()
            or w.device != dev or w.data_ptr() % 16):
        raise ValueError(f"{what}: {name} must be a contiguous, 16-byte aligned int8 "
                         f"({K}, {N}) tensor on {dev}; got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    return w


def _banks(a, b, K, N, dev, what, name):
    """The LoRA banks as contiguous, 16-byte aligned tensors of one dtype;
    (None, None, 0) without LoRA."""
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
    a, b = a.contiguous(), b.contiguous()
    return (a if a.data_ptr() % 16 == 0 else a.clone(),
            b if b.data_ptr() % 16 == 0 else b.clone(), r)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_width(h, what):
    """(B, d) of h: d, the LN and residual width, must be a multiple of
    E_COLS (every GPT-2 width is); B may be any count."""
    B, d = h.shape
    if B < 1:
        raise ValueError(f"{what}: at least one batch row; got {B}")
    if d % E_COLS:
        raise ValueError(f"{what}: the width must be a multiple of {E_COLS}; got {d}")
    return B, d


def _pad(t, dim: int, n: int, n_pad: int):
    """t with zeros appended along `dim` from n to n_pad; t itself if it is
    None or not n long there (a shape the wrapper's checks then refuse)."""
    if t is None or n_pad == n or t.shape[dim] != n:
        return t
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, n_pad - n]
    return torch.nn.functional.pad(t, pad).contiguous()


def padded_qkv(w_i8, w_s, bias, lora_b):
    """#12's operands with the output width N padded to a multiple of
    E_COLS: zero code columns, scales (per column) and biases, and zero
    LoRA-B columns. The padded outputs are 0. The operands themselves where
    N is such a multiple."""
    N = w_i8.shape[1]
    Np = _align(N, E_COLS)
    if Np == N:
        return w_i8, w_s, bias, lora_b
    return (_pad(w_i8, 1, N, Np), _pad(w_s, 0, N, Np) if w_s.numel() == N else w_s,
            _pad(bias, 0, N, Np), _pad(lora_b, 1, N, Np))


def padded_post(fc, mlp):
    """#13's fc and mlp with the MLP width padded to a multiple of E_COLS:
    fc as `padded_qkv` pads it, mlp with zero code rows and zero LoRA-A
    rows. The padded fc outputs are 0, GELU(0) = 0 and its code 0, so the
    padded rows add nothing. fc and mlp themselves where the width is such
    a multiple."""
    dff = fc["w_i8"].shape[1]
    dp = _align(dff, E_COLS)
    if dp == dff:
        return fc, mlp
    w, ws, b, lb = padded_qkv(fc["w_i8"], fc["w_s"], fc["b"], fc.get("lora_B"))
    fc = dict(fc, w_i8=w, w_s=ws, b=b)
    mlp = dict(mlp, w_i8=_pad(mlp["w_i8"], 0, dff, dp))
    if lb is not None and "lora_A" in mlp:
        fc["lora_B"] = lb
        mlp["lora_A"] = _pad(mlp["lora_A"], 0, dff, dp)
    return fc, mlp


def fused_ln_qkv(h, ln_g, ln_b, w_i8, w_s, bias, x_s, lora_a, lora_b, *,
                 eps: float = 1e-5, grid: Optional[int] = None):
    """LN1 + int8 QKV + LoRA of one decode layer (kernel #12): h (B, d)
    float32 → (B, N) float32. w_i8 (d, N) int8 codes, w_s (N,) or (1,)
    scales, bias (N,), x_s the static input scale (a tensor on h's device:
    no host sync), lora_a (d, r) / lora_b (r, N) or None. CPU tensors take
    `fused_ln_qkv_plain`; CUDA tensors launch the kernel of
    `csrc/fused_decode.cu` cooperatively on `fused_grid` blocks, once per
    16 batch rows (`grid` forces another count, for tests; a count the card
    cannot hold at once is refused and raises), or raise."""
    if h.device.type == "cpu":
        return fused_ln_qkv_plain(h, ln_g, ln_b, w_i8, w_s, bias, x_s, lora_a, lora_b,
                                  eps=eps)
    what, dev = "fused_ln_qkv", h.device
    B, d = _check_width(h, what)
    N = w_i8.shape[1]
    w_i8, w_s, bias, lora_b = padded_qkv(w_i8, w_s, bias, lora_b)
    Np = w_i8.shape[1]
    w = _codes(w_i8, d, Np, dev, what, "w_i8")
    la, lb, r = _banks(lora_a, lora_b, d, Np, dev, what, "qkv")
    hf = h.to(torch.float32).contiguous()
    g, b = _f32(ln_g, d, dev, what, "ln_g"), _f32(ln_b, d, dev, what, "ln_b")
    (ws, ws_col), bs = _scale(w_s, Np, dev, what, "w_s"), _f32(bias, Np, dev, what, "bias")
    xs = _f32(torch.as_tensor(x_s, device=dev), 1, dev, what, "x_s", copied=False)
    bank_bf16 = la is not None and la.dtype == torch.bfloat16
    out = torch.empty((B, Np), dtype=torch.float32, device=dev)
    lib = _build.load("fused_decode")
    ptrs = [_ptr(t) for t in (g, b, w, ws, bs, xs, la, lb)]
    for b0 in range(0, B, MAX_B):  # rows are independent: a launch per 16
        Bc = min(MAX_B, B - b0)
        plan, table = _plan_on(dev, d, (Np,), (d,), r, grid, Bc, 2 if bank_bf16 else 4)
        scratch = torch.empty((int(plan.header[H_SC_BYTES]),), dtype=torch.uint8, device=dev)
        rc = lib.fused_ln_qkv(
            hf.data_ptr() + 4 * b0 * d, *ptrs, out.data_ptr() + 4 * b0 * Np,
            scratch.data_ptr(), _barrier(dev).data_ptr(), table.data_ptr(),
            plan.header.ctypes.data, Bc, d, Np, r, int(ws_col), int(bank_bf16), float(eps),
            _build.stream(h))
        _build.check(lib, rc, what)
        fused_ln_qkv.launches += 1
    return out if Np == N else out[:, :N].contiguous()


def fused_post_attention(attn, h, ln2_g, ln2_b, proj, fc, mlp, x_scales, *,
                         eps: float = 1e-5, grid: Optional[int] = None):
    """proj(+LoRA), residual, LN2, fc(+LoRA), GELU, mlp(+LoRA), residual of
    one decode layer (kernel #13): attn, h (B, d) float32 → h' (B, d)
    float32. proj / fc / mlp as in `fused_post_attention_plain`; x_scales a
    (3,) tensor on the device. CPU tensors take the plain version; CUDA
    tensors launch the kernel once per 16 batch rows, as `fused_ln_qkv`
    does (`grid` likewise), or raise."""
    if h.device.type == "cpu":
        return fused_post_attention_plain(attn, h, ln2_g, ln2_b, proj, fc, mlp, x_scales,
                                          eps=eps)
    what, dev = "fused_post_attention", h.device
    B, d = _check_width(h, what)
    if tuple(attn.shape) != (B, d):
        raise ValueError(f"{what}: attn has shape {tuple(attn.shape)}; want {(B, d)}")
    has_lora = "lora_A" in proj
    fc, mlp = padded_post(fc, mlp)
    dff = fc["w_i8"].shape[1]
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
    xs3 = _f32(x_scales, 3, dev, what, "x_scales", copied=False)
    bank_bf16 = bank == torch.bfloat16
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = _build.load("fused_decode")
    ptrs = [_ptr(t) for t in args]
    for b0 in range(0, B, MAX_B):  # rows are independent: a launch per 16
        Bc = min(MAX_B, B - b0)
        plan, table = _plan_on(dev, d, (d, dff, d), (d, d, dff), rank, grid, Bc,
                               2 if bank_bf16 else 4)
        scratch = torch.empty((int(plan.header[H_SC_BYTES]),), dtype=torch.uint8, device=dev)
        row = 4 * b0 * d  # byte offset of row b0 in the float32 (B, d) tensors
        rc = lib.fused_post_attention(
            af.data_ptr() + row, hf.data_ptr() + row, g.data_ptr(), b.data_ptr(), *ptrs,
            xs3.data_ptr(), out.data_ptr() + row, scratch.data_ptr(),
            _barrier(dev).data_ptr(), table.data_ptr(), plan.header.ctypes.data, Bc, d, dff,
            rank, ws_cols, int(bank_bf16), float(eps), _build.stream(h))
        _build.check(lib, rc, what)
        fused_post_attention.launches += 1
    return out


fused_ln_qkv.launches = 0
fused_post_attention.launches = 0
