"""The fused int8 decode kernel's plan (`ops/fused_decode.py::fused_plan`)
on the CPU: which block of the cooperative grid of kernels #12/#13 owns
which weight bytes, LoRA-A items and epilogue columns of each linear, the
block records the kernel reads (decoded here as the kernel decodes them),
their shared-memory layout and its limit, the balance of bytes, and the
shapes the kernel refuses.
"""

import numpy as np
import pytest
import torch

from llm_qat_tpu_torch.ops import fused_decode as fd

GRIDS = [132, 66, 8]
# (name, d, dff or qkv width): #13 reads (d, d), (d, dff), (dff, d); #12 (d, 3d)
POST = [("gpt2", 768, 3072), ("small", 256, 1024)]
QKV = [("gpt2", 768, 2304), ("small", 256, 768)]
# every block's bytes at most this share above the layer's mean, at GPT-2's
# widths on the plan's grid and half of it
BALANCE = 1.05


def _post(d, dff):
    return (d, dff, d), (d, d, dff)


def _plans(kind, d, n, nb, **kw):
    ns, ks = _post(d, n) if kind == "post" else ((n,), (d,))
    return ns, ks, fd.fused_plan(d, ns, ks, 64, nb, **kw)


def _cases():
    for nb in GRIDS:
        for name, d, dff in POST:
            yield "post", name, d, dff, nb
        for name, d, n in QKV:
            yield "qkv", name, d, n, nb


# GPT-2's layer does not fit 8 blocks' shared memory
# (test_plan_refuses_what_the_kernel_cannot_run); the rest do
CASES = [pytest.param(*c, id=f"{c[0]}-{c[1]}-{c[4]}") for c in _cases()
         if not (c[1] == "gpt2" and c[4] == 8)]


def _records(plan, n_lin):
    """Per block: per linear (pieces, items, epilogue items) as the kernel
    reads them from the table (csrc/fused_decode.cu RH, P_*), and R_LN."""
    rec_len = int(plan.header[fd.H_REC_LEN])
    out = []
    for blk in range(plan.n_blocks):
        rec = plan.table[blk * rec_len:(blk + 1) * rec_len]
        off, per = fd.RH, []
        for j in range(n_lin):
            np_, ni, ne = (int(x) for x in rec[3 * j:3 * j + 3])
            pcs = [tuple(rec[off + fd.PIECE * i:off + fd.PIECE * (i + 1)]) for i in range(np_)]
            off += fd.PIECE * np_
            its = [tuple(rec[off + fd.ITEM * i:off + fd.ITEM * (i + 1)]) for i in range(ni)]
            off += fd.ITEM * ni
            eps = [tuple(rec[off + fd.EPI * i:off + fd.EPI * (i + 1)]) for i in range(ne)]
            off += fd.EPI * ne
            per.append((pcs, its, eps))
        out.append((per, int(rec[9])))
    return out


@pytest.mark.parametrize("kind,name,d,n,nb", CASES)
def test_every_weight_byte_lora_row_and_column_owned_once(kind, name, d, n, nb):
    """Every weight byte of each linear lies in exactly one piece (whole
    quads of K rows inside one column group), every input row of its LoRA-A
    bank in exactly one item, every output column in exactly one epilogue
    item; a column group's slots are contiguous, in row order."""
    ns, ks, plan = _plans(kind, d, n, nb)
    for j, (N, K) in enumerate(zip(ns, ks)):
        groups = -(-N // fd.CW)
        owned = np.zeros((groups, K), np.int64)
        for s, (blk, g, r0, r1, slot) in enumerate(plan.pieces[j]):
            assert slot == s and 0 <= blk < nb and r0 % 4 == 0 and r1 % 4 == 0
            owned[g, r0:r1] += 1
        assert (owned == 1).all(), j
        gs = plan.group_slots[j]
        assert gs[0] == 0 and gs[-1] == len(plan.pieces[j])
        for g in range(groups):
            rows = [plan.pieces[j][s][2:4] for s in range(gs[g], gs[g + 1])]
            assert all(plan.pieces[j][s][1] == g for s in range(gs[g], gs[g + 1]))
            assert rows == sorted(rows) and rows[0][0] == 0 and rows[-1][1] == K
        la = plan.la_rows[j]
        rows = np.zeros(K, np.int64)
        for blk, t in plan.lora[j]:
            rows[t * la:(t + 1) * la] += 1
        assert (rows == 1).all() and -(-K // la) <= fd.LA_MAX_ITEMS
        cols = np.zeros(N, np.int64)
        for blk, e in plan.epilogue[j]:
            cols[e * fd.E_COLS:(e + 1) * fd.E_COLS] += 1
        assert (cols == 1).all()


@pytest.mark.parametrize("kind,name,d,n,nb", CASES)
@pytest.mark.parametrize("batch", [1, 8, 16])
def test_shared_memory_layout_fits_the_request(kind, name, d, n, nb, batch):
    """Each block's operands (LN parameters, weight rows at CW bytes each
    in whole TMA boxes of BOX_ROWS rows, LoRA-A rows, LoRA-B slices with
    their scale and bias slices) lie in disjoint 16-byte aligned ranges
    (128-byte aligned where a TMA box lands) after its record and before
    the work area; its activation codes and LoRA-A inputs in disjoint ranges of the
    activation region; the work area's parts within the request, which is
    within SMEM_MAX."""
    ns, ks, plan = _plans(kind, d, n, nb, batch=batch)
    h = plan.header
    r, esz = 64, 2
    assert plan.smem_bytes == h[fd.H_SMEM] <= fd.SMEM_MAX
    op0 = h[fd.H_REC] + 4 * h[fd.H_REC_LEN]
    work, act0 = h[fd.H_WORK], h[fd.H_WORK] + h[fd.H_ACT]
    assert h[fd.H_WORK] >= op0 and h[fd.H_ACT] == batch * d * 4
    assert h[fd.H_ACT] <= h[fd.H_RED] <= h[fd.H_XA]
    assert work + h[fd.H_XA] + batch * r * 4 <= plan.smem_bytes
    act_end = work + h[fd.H_RED]
    for per, ln_off in _records(plan, len(ns)):
        spans = [(ln_off, ln_off + 2 * d * 4)]
        for j, (pcs, its, eps) in enumerate(per):
            N, K, la = ns[j], ks[j], plan.la_rows[j]
            acts = []
            for g, r0, r1, slot, soff, aoff in pcs:
                assert soff % 128 == 0
                spans.append((soff, soff + -(-(r1 - r0) // fd.BOX_ROWS) * fd.BOX_ROWS * fd.CW))
                acts.append((aoff, aoff + batch * (r1 - r0)))
            for t, soff, aoff in its:
                rows = min(la, K - t * la)
                spans.append((soff, soff + rows * r * esz))
                acts.append((aoff, aoff + -(-batch // 4) * 4 * rows * 4))
            for e, lb_off, vec_off, s0, s1 in eps:
                assert lb_off % 128 == 0 and vec_off == lb_off + r * fd.E_COLS * esz
                spans.append((lb_off, vec_off + 2 * fd.E_COLS * 4))
                g = e * fd.E_COLS // fd.CW
                assert (s0, s1) == plan.group_slots[j][g:g + 2]
            acts.sort()
            assert all(a % 16 == 0 for a, _ in acts)
            assert all(b0 <= a1 for (_, b0), (a1, _) in zip(acts, acts[1:]))
            assert all(act0 + b <= act_end for _, b in acts)
        spans.sort()
        assert all(a % 16 == 0 and op0 <= a for a, _ in spans)
        assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
        assert spans[-1][1] <= work


@pytest.mark.parametrize("kind,name,d,n,nb", CASES)
def test_records_reproduce_the_layer(kind, name, d, n, nb):
    """The kernel's arithmetic from the records alone, in numpy: each
    piece's int dot to its slot, each epilogue column's slots summed in the
    plan's order (exactly the whole int dot), each LoRA-A item's partial
    sums, added in item order (the whole LoRA-A product)."""
    ns, ks, plan = _plans(kind, d, n, nb, batch=3)
    rng = np.random.default_rng(nb + d)
    for j, (N, K) in enumerate(zip(ns, ks)):
        w = rng.integers(-127, 128, (K, N)).astype(np.int64)
        x = rng.integers(-127, 128, (3, K)).astype(np.int64)
        a = rng.normal(size=(K, 64))
        xf = rng.normal(size=(3, K))
        slots, part = {}, {}
        recs = _records(plan, len(ns))
        for per, _ in recs:
            for g, r0, r1, slot, _, _ in per[j][0]:
                cols = slice(g * fd.CW, min(N, (g + 1) * fd.CW))
                assert slot not in slots
                slots[slot] = (g, x[:, r0:r1] @ w[r0:r1, cols])
            la = plan.la_rows[j]
            for t, _, _ in per[j][1]:
                part[t] = xf[:, t * la:(t + 1) * la] @ a[t * la:(t + 1) * la]
        out = np.zeros((3, N), np.int64)
        for per, _ in recs:
            for e, _, _, s0, s1 in per[j][2]:
                c0 = e * fd.E_COLS
                g = c0 // fd.CW
                acc = sum(slots[s][1] for s in range(s0, s1))
                assert all(slots[s][0] == g for s in range(s0, s1))
                out[:, c0:c0 + fd.E_COLS] = acc[:, c0 % fd.CW:c0 % fd.CW + fd.E_COLS]
        assert np.array_equal(out, x @ w), j
        xa = part[0]
        for t in range(1, len(part)):
            xa = xa + part[t]
        np.testing.assert_allclose(xa, xf @ a, rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("nb", [132, 66])
@pytest.mark.parametrize("kind", ["post", "qkv"])
def test_bytes_balanced_over_the_layer(kind, nb):
    """At GPT-2's widths every block copies within BALANCE of the layer's
    mean bytes (weights, LoRA banks, scales, biases, LN parameters), and the
    blocks together copy every byte once (the LN parameters once a block)."""
    d, n = (768, 3072) if kind == "post" else (768, 2304)
    ns, ks, plan = _plans(kind, d, n, nb)
    mean = sum(plan.block_bytes) / nb
    assert max(plan.block_bytes) <= BALANCE * mean, (max(plan.block_bytes), mean)
    weights = sum(N * K for N, K in zip(ns, ks))
    lora = sum(64 * (N + K) * 2 for N, K in zip(ns, ks))
    vecs = sum(2 * N * 4 for N in ns)
    assert sum(plan.block_bytes) == weights + lora + vecs + nb * 2 * d * 4


def test_plan_refuses_what_the_kernel_cannot_run():
    """More than 16 batch rows in one launch (the wrappers launch once per
    16), a rank above 128, widths that are not a multiple of 32 (of 4 among
    them; the wrappers pad output widths), and GPT-2's layer on 8 blocks,
    or at rank 128 on 16 (its operands do not fit their shared memory):
    ValueError."""
    ns, ks = _post(768, 3072)
    with pytest.raises(ValueError, match="batch rows"):
        fd.fused_plan(768, ns, ks, 64, 132, batch=17)
    with pytest.raises(ValueError, match="rank"):
        fd.fused_plan(768, ns, ks, 129, 132)
    for bad in (770, 784):
        with pytest.raises(ValueError, match="multiples"):
            fd.fused_plan(768, (bad,), (768,), 64, 132)
        with pytest.raises(ValueError, match="multiples"):
            fd.fused_plan(bad, (768,), (bad,), 64, 132)
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_plan(768, ns, ks, 64, 8)
    with pytest.raises(ValueError, match="shared memory"):
        fd.fused_plan(768, ns, ks, fd.MAX_RANK, 16)


@pytest.mark.parametrize("nb", [132, 66])
@pytest.mark.parametrize("kind", ["post", "qkv"])
def test_plan_takes_rank_128_at_gpt2_width(kind, nb):
    """Rank 128 (`--lora_rank` is the user's) at GPT-2 124M width fits the
    plan's grid and half of it, at 16 batch rows: every weight byte owned
    once and the request within the card's shared memory."""
    d, n = (768, 3072) if kind == "post" else (768, 2304)
    ns, ks = _post(d, n) if kind == "post" else ((n,), (d,))
    plan = fd.fused_plan(d, ns, ks, fd.MAX_RANK, nb, batch=16)
    assert fd.MAX_RANK >= 128 and plan.smem_bytes <= fd.SMEM_MAX
    for j, (N, K) in enumerate(zip(ns, ks)):
        assert sum((r1 - r0) * min(fd.CW, N - g * fd.CW)
                   for _, g, r0, r1, _ in plan.pieces[j]) == N * K


def _layer(K, N, rank, bank, seed):
    g = torch.Generator().manual_seed(seed)
    lin = {"w_i8": torch.randint(-127, 128, (K, N), generator=g, dtype=torch.int8),
           "w_s": 2e-4 + 8e-4 * torch.rand((N,), generator=g),
           "b": 0.1 * torch.randn((N,), generator=g)}
    if rank:
        lin["lora_A"] = (0.3 * torch.randn((K, rank), generator=g)).to(bank)
        lin["lora_B"] = (0.05 * torch.randn((rank, N), generator=g)).to(bank)
    return lin


@pytest.mark.parametrize("rank,bank", [(8, torch.bfloat16), (8, torch.float32), (0, None)])
def test_padded_widths_give_the_same_function(rank, bank):
    """An output width that is not a multiple of 32 runs on operands padded
    with zeros (#12's N = 200; #13's MLP width 1000, whose padded fc outputs
    are 0, GELU(0) = 0 and its code 0): the plain versions on the padded
    operands, sliced, equal them on the originals to float32 rounding (the
    integer dots are exact; a float32 LoRA matmul over 1024 rows instead of
    1000 may sum in another order), and the padded columns are 0."""
    d, N, dff, B = 64, 200, 1000, 3
    g = torch.Generator().manual_seed(rank)
    h, attn = torch.randn((B, d), generator=g), torch.randn((B, d), generator=g)
    lng, lnb = 0.5 + torch.rand((d,), generator=g), 0.1 * torch.randn((d,), generator=g)
    xs = torch.tensor([3.0, 3.0, 4.0, 2.0]) / 127.0
    qkv = _layer(d, N, rank, bank, 1)
    proj, fc, mlp = _layer(d, d, rank, bank, 2), _layer(d, dff, rank, bank, 3), \
        _layer(dff, d, rank, bank, 4)
    w, ws, b, lb = fd.padded_qkv(qkv["w_i8"], qkv["w_s"], qkv["b"], qkv.get("lora_B"))
    assert w.shape == (d, 224) and ws.shape == b.shape == (224,)
    want = fd.fused_ln_qkv_plain(h, lng, lnb, qkv["w_i8"], qkv["w_s"], qkv["b"], xs[0],
                                 qkv.get("lora_A"), qkv.get("lora_B"))
    got = fd.fused_ln_qkv_plain(h, lng, lnb, w, ws, b, xs[0], qkv.get("lora_A"), lb)
    torch.testing.assert_close(got[:, :N], want, atol=1e-6 * want.abs().max().item(), rtol=0)
    assert not got[:, N:].any()
    pfc, pmlp = fd.padded_post(fc, mlp)
    assert pfc["w_i8"].shape == (d, 1024) and pmlp["w_i8"].shape == (1024, d)
    want = fd.fused_post_attention_plain(attn, h, lng, lnb, proj, fc, mlp, xs[1:])
    got = fd.fused_post_attention_plain(attn, h, lng, lnb, proj, pfc, pmlp, xs[1:])
    torch.testing.assert_close(got, want, atol=1e-6 * want.abs().max().item(), rtol=0)


@pytest.mark.parametrize("d", [768, 1024, 1280, 1600])
def test_model_widths_are_never_padded(d):
    """At every GPT-2 width the model's output widths (#12's 3d, #13's MLP
    width 4d) are multiples of 32, so the wrappers pass each layer's
    operands on as they are, for all 12 layers: no copy is made. A width
    that is not a multiple pads only the operands of that width; one of
    another width is left for the wrapper's checks to refuse."""
    for layer in range(12):
        qkv, fc, mlp = (_layer(K, N, 8, torch.bfloat16, layer)
                        for K, N in ((d, 3 * d), (d, 4 * d), (4 * d, d)))
        ops = (qkv["w_i8"], qkv["w_s"], qkv["b"], qkv["lora_B"])
        assert all(a is b for a, b in zip(fd.padded_qkv(*ops), ops))
        pfc, pmlp = fd.padded_post(fc, mlp)
        assert pfc is fc and pmlp is mlp
    w, ws, b, lb = fd.padded_qkv(qkv["w_i8"][:, :200].contiguous(), qkv["w_s"][:201],
                                 qkv["b"][:200], qkv["lora_B"][:, :200])
    assert w.shape == (d, 224) and b.shape == (224,) and lb.shape == (8, 224)
    assert ws.shape == (201,)


def test_plan_without_lora_and_float_banks():
    """Rank 0 has no LoRA-A items and copies no bank bytes; float32 banks
    copy twice the bf16 bytes."""
    ns, ks = _post(256, 1024)
    p0 = fd.fused_plan(256, ns, ks, 0, 66)
    assert all(not items for items in p0.lora)
    p2 = fd.fused_plan(256, ns, ks, 16, 66, bank_bytes=2)
    p4 = fd.fused_plan(256, ns, ks, 16, 66, bank_bytes=4)
    lora = sum(16 * (N + K) for N, K in zip(ns, ks))
    assert sum(p4.block_bytes) - sum(p2.block_bytes) == 2 * lora
    assert sum(p2.block_bytes) - sum(p0.block_bytes) == 2 * lora
