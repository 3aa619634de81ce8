"""The persistent decode step's plan (`ops/mega_decode.py::mega_plan`) on
the CPU: which block of the cooperative grid of kernels #1/#3/#4 owns which
weight bytes, LoRA-A items and epilogue columns of each GEMV, the table the
kernel reads, and the scratch it needs; and the passes of #3's float-cache
attention item (`attn_pass_blocks`).
"""

import numpy as np
import pytest
import torch

from llm_qat_tpu_torch.ops import mega_decode as md

GRIDS = [1, 7, 61, 132, 264]
SHAPES = [(768, 4), (768, 8), (256, 4), (256, 8)]
# every block's weight bytes of a layer at most this share above the mean,
# at GPT-2's width (a small d leaves blocks of a large grid idle)
BALANCE = 1.3


def _geometry(d, wbits, j):
    """(column groups, byte rows) of GEMV j's tiles."""
    dk = d // 2 if wbits == 4 else d
    _, n_out, n_in = md.GEMVS[j]
    return n_out * d // md.CW, n_in * dk


@pytest.mark.parametrize("nb", GRIDS)
@pytest.mark.parametrize("d,wbits", SHAPES)
def test_every_weight_byte_owned_once(d, wbits, nb):
    """Every byte of every weight tile of each GEMV lies in exactly one
    piece, of one block; pieces are whole quads of byte rows, at most
    max_rows of them; each piece has its own partial-sum slot, and a column
    group's slots are contiguous and in row order."""
    for max_rows in (md.CH_ROWS, 4 * md.CH_ROWS):
        plan = md.mega_plan(d, wbits, 64, nb, max_rows)
        for j in range(4):
            groups, rows = _geometry(d, wbits, j)
            owned = np.zeros((groups, rows), np.int64)
            by_slot = {}
            for blk, g, r0, r1, slot in plan.pieces[j]:
                assert 0 <= blk < nb and 0 <= g < groups and 0 <= r0 < r1 <= rows
                assert r0 % 4 == 0 and r1 % 4 == 0 and r1 - r0 <= max_rows
                owned[g, r0:r1] += 1
                by_slot[slot] = (g, r0)
            assert (owned == 1).all(), (j, int(owned.min()), int(owned.max()))
            assert sorted(by_slot) == list(range(len(plan.pieces[j])))
            gs = plan.group_slots[j]
            assert len(gs) == groups + 1 and gs[0] == 0 and gs[-1] == len(by_slot)
            assert [by_slot[s_] for s_ in range(len(by_slot))] == sorted(by_slot.values())
            assert all(by_slot[s_][0] == g for g in range(groups) for s_ in range(gs[g], gs[g + 1]))


@pytest.mark.parametrize("nb", GRIDS)
@pytest.mark.parametrize("d,wbits", SHAPES)
def test_every_lora_row_and_epilogue_column_owned_once(d, wbits, nb):
    """Every input row of each LoRA-A tile the step reads (tile 0, 3, 4 and
    the mlp's 8-11) lies in exactly one item of one block, no item straddles
    two of the mlp's d-wide chunks, and every column of the qkv and fc
    epilogues (their LoRA-B tiles) lies in exactly one item."""
    plan = md.mega_plan(d, wbits, 64, nb)
    for j in range(4):
        n_in = md.GEMVS[j][2]
        rows = np.zeros(n_in * d, np.int64)
        for blk, t in plan.lora[j]:
            assert 0 <= blk < nb
            k0, k1 = t * md.LA_ROWS, (t + 1) * md.LA_ROWS
            assert k0 // d == (k1 - 1) // d
            rows[k0:k1] += 1
        assert (rows == 1).all(), j
    for j, items in plan.epilogue.items():
        cols = np.zeros(md.GEMVS[j][1] * d, np.int64)
        for blk, e in items:
            assert blk == e % nb
            cols[e * md.E_COLS:(e + 1) * md.E_COLS] += 1
        assert (cols == 1).all(), j


@pytest.mark.parametrize("nb", GRIDS)
@pytest.mark.parametrize("wbits", [4, 8])
def test_block_bytes_near_the_mean(wbits, nb):
    """At GPT-2's width every block's weight bytes of a layer stay within
    BALANCE of the mean, and `units` agrees with the pieces."""
    d = 768
    plan = md.mega_plan(d, wbits, 64, nb)
    units = np.zeros(nb, np.int64)
    for j in range(4):
        for blk, _, r0, r1, _ in plan.pieces[j]:
            units[blk] += (r1 - r0) // 4
    assert tuple(units) == plan.units
    nbytes = units * 4 * md.CW
    dk = d // 2 if wbits == 4 else d
    assert nbytes.sum() == 12 * dk * d
    assert nbytes.max() <= BALANCE * nbytes.mean(), (nbytes.max(), nbytes.mean())


def _decode(table):
    """The table read as the kernel reads it (csrc/mega_decode.cu P_*):
    per GEMV the (block, group, r0, r1, slot) pieces, the (block, item)
    items and the column groups' first slots."""
    nb, la_rows, off_p, off_l = (int(x) for x in table[:4])
    hdr = 16
    poff = table[hdr:hdr + 4 * (nb + 1)].reshape(4, nb + 1)
    loff = table[hdr + 4 * (nb + 1):hdr + 8 * (nb + 1)].reshape(4, nb + 1)
    pieces, lora, gslots = [], [], []
    for j in range(4):
        pieces.append(tuple((blk, *(int(x) for x in table[off_p + 4 * p:off_p + 4 * p + 4]))
                            for blk in range(nb) for p in range(poff[j, blk], poff[j, blk + 1])))
        lora.append(tuple((blk, int(table[off_l + q]))
                          for blk in range(nb) for q in range(loff[j, blk], loff[j, blk + 1])))
        gs0 = int(table[8 + j])
        gslots.append(gs0)
    return nb, la_rows, tuple(pieces), tuple(lora), table[4:8].tolist(), gslots


@pytest.mark.parametrize("nb", GRIDS)
@pytest.mark.parametrize("d,wbits", SHAPES)
def test_table_is_the_plan(d, wbits, nb):
    """The int32 table, read with the kernel's offsets, gives back the
    plan's pieces and items, block by block, and the item counts."""
    plan = md.mega_plan(d, wbits, 64, nb)
    assert plan.table.dtype == np.int32
    got_nb, la_rows, pieces, lora, n_la, gs_off = _decode(plan.table)
    assert (got_nb, la_rows) == (nb, md.LA_ROWS)
    assert pieces == plan.pieces and lora == plan.lora
    assert n_la == [md.GEMVS[j][2] * d // md.LA_ROWS for j in range(4)]
    for j in range(4):
        gs = plan.group_slots[j]
        assert plan.table[gs_off[j]:gs_off[j] + len(gs)].tolist() == list(gs)


def _ring_order(plan, blk, L):
    """The stages block `blk` consumes, in order, as its GEMV phases walk
    its pieces layer after layer: (l, j, g, first byte row, rows)."""
    out = []
    for l in range(L):
        for j in range(4):
            for b_, g, r0, r1, _ in plan.pieces[j]:
                if b_ != blk:
                    continue
                for c0 in range(r0, r1, md.CH_ROWS):
                    out.append((l, j, g, c0, min(md.CH_ROWS, r1 - c0)))
    return out


def _kernel_walk(table, blk, L):
    """The stages the block's warp 0 requests, step by step as the kernel's
    iterator runs on the table (csrc/mega_decode.cu wit_norm / ring_issue):
    normalise (next piece, next GEMV, next layer), then issue."""
    nb = int(table[0])
    off_p = int(table[2])
    poff = table[16:16 + 4 * (nb + 1)].reshape(4, nb + 1)
    l, j, p, c = 0, 0, int(poff[0, blk]), 0
    out = []
    while True:
        while l < L:
            if p < poff[j, blk + 1]:
                g, r0, r1 = (int(x) for x in table[off_p + 4 * p:off_p + 4 * p + 3])
                if c * md.CH_ROWS < r1 - r0:
                    break
                p, c = p + 1, 0
                continue
            c = 0
            j += 1
            if j == 4:
                j, l = 0, l + 1
            p = int(poff[j, blk])
        if l >= L:
            return out
        c0 = r0 + c * md.CH_ROWS
        out.append((l, j, g, c0, min(md.CH_ROWS, r1 - c0)))
        c += 1


@pytest.mark.parametrize("nb", [1, 7, 132])
def test_ring_walk_matches_the_gemv_phases(nb):
    """The order in which a block's warp 0 requests weight stages is the
    order in which its GEMV phases consume them, layer after layer; every
    stage holds at most CH_ROWS byte rows, whole quads, and no piece needs
    more than half the ring (its stages stay held until it is done)."""
    plan = md.mega_plan(768, 4, 64, nb)
    for blk in sorted({0, nb // 2, nb - 1}):
        want = _ring_order(plan, blk, 3)
        assert _kernel_walk(plan.table, blk, 3) == want
        assert all(0 < nr <= md.CH_ROWS and nr % 4 == 0 for *_, nr in want)
        assert all(-(-(r1 - r0) // md.CH_ROWS) <= md.NST // 2
                   for j in range(4) for _, _, r0, r1, _ in plan.pieces[j])


@pytest.mark.parametrize("B,d,r", [(8, 768, 64), (3, 256, 8), (256, 768, 256)])
def test_plan_fits_the_scratch(B, d, r):
    """The partial sums of every piece (one slot each), the LoRA-A partials
    of every item and the activation rows of the mlp's 4d inputs fit the
    buffers `_mega_scratch` allocates for the plan; the barrier's counter
    starts at zero."""
    for wbits in (4, 8):
        plan = md.mega_plan(d, wbits, r, 61, md.CH_ROWS if B > md.BP else 4 * md.CH_ROWS)
        qx, xf, part, la, qkv, attn, bar = md._mega_scratch(torch.device("cpu"), B, d, r,
                                                            plan.n_slots)
        for j in range(4):
            assert max(s_ for *_, s_ in plan.pieces[j]) < part.shape[0]
            assert max(g for _, g, _, _, _ in plan.pieces[j]) * md.CW + md.CW <= md.GEMVS[j][1] * d
            assert max(t for _, t in plan.lora[j]) < la.shape[0]
        assert part.shape[1:] == (B, md.CW) and la.shape[1:] == (B, r)
        assert qx.shape == xf.shape == (B, 4 * d) and qkv.shape == (B, 3 * d)
        assert attn.shape == (B, d) and int(bar.abs().sum()) == 0


def test_barrier_count_is_even():
    """Nine barriers a layer, the count made even so that the counter is
    left as the step found it."""
    assert md.mega_barriers(12) == 108
    assert md.mega_barriers(1) == 10
    assert all(md.mega_barriers(L) % 2 == 0 for L in range(1, 25))


@pytest.mark.parametrize("args", [(200, 8, 64, 132), (768, 6, 64, 132), (768, 8, 0, 132),
                                  (768, 8, 300, 132), (768, 4, 64, 0), (8192, 8, 64, 132),
                                  (768, 8, 64, 132, 96), (768, 8, 64, 132, 512)])
def test_plan_refuses_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError):
        md.mega_plan(*args)


# The float-cache attention item's arrays before its staged V rows
# (csrc/mega_decode.cu attn_item_f), in floats: the reduction space, q and
# the new V row, the pass's scores and rounded probabilities, 8 block
# maxima and sums, 8 rows of P.V sums.
ATT_ARRAYS = 64 + 2 * md.MAX_HD + 2 * md.PT + 16 + 8 * md.MAX_HD


@pytest.mark.parametrize("tbp", [8, 16, 24, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_attn_pass_fits_the_work_area(head_dim, dtype, tbp):
    """A pass of #3's attention item takes 1 to 8 JAX blocks, one row a
    thread (at most PT rows), as many as fit beside the item's arrays in the
    work area; where one block of V rows cannot fit (float32 at head_dim
    128, tbp 256), the plan refuses."""
    assert 4 * ATT_ARRAYS <= md.ATT_FIXED
    esz = torch.empty((), dtype=dtype).element_size()
    block = tbp * head_dim * esz
    if md.ATT_FIXED + block > md.WORK_BYTES:
        with pytest.raises(ValueError):
            md.attn_pass_blocks(tbp, head_dim, dtype)
        return
    n = md.attn_pass_blocks(tbp, head_dim, dtype)
    assert 1 <= n <= 8 and n * tbp <= md.PT
    assert md.ATT_FIXED + n * block <= md.WORK_BYTES
    # no more would fit
    assert n == 8 or (n + 1) * tbp > md.PT or md.ATT_FIXED + (n + 1) * block > md.WORK_BYTES


@pytest.mark.parametrize("args", [(64, 64, torch.float16), (64, 64, torch.int8),
                                  (64, 256, torch.bfloat16), (512, 64, torch.bfloat16),
                                  (256, 128, torch.float32)])
def test_attn_pass_refuses_what_the_kernel_cannot_run(args):
    """A cache dtype the item has no instantiation for, a head above
    MAX_HD, a block above one row a thread, a block too large to stage."""
    with pytest.raises(ValueError):
        md.attn_pass_blocks(*args)
