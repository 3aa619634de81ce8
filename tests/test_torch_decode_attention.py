"""PyTorch port: the packed-cache decode attention #7 (`decode_attention_hbm`)
and #8 (`decode_attention_hbm_multi`) against the JAX Pallas kernels in
interpret mode on the CPU, plus the packed layout helpers.

B = 4 slots, H = 2 heads, 32 packed rows in blocks of 8 (tbp 8), head_dim
64 (P = 2 timesteps per 128-lane row) and 32 (P = 4); positions -1
(inactive, #8 only), 0 (empty prefix), an odd one inside a row, and the
last timestep of the cache; float32 and bf16 caches."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import decode_attention as jd
from llm_qat_tpu_torch.ops import decode_attention as td

B, H, TP, TBP = 4, 2, 32, 8


def _inputs(D, dtype, seed):
    P = 128 // D
    rng = np.random.default_rng(seed)
    q, kn, vn = (rng.standard_normal((B, H, 1, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((B, H, TP, P * D)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc, jdt),
          jnp.asarray(vc, jdt)]
    tx = [torch.tensor(q), torch.tensor(kn), torch.tensor(vn), torch.tensor(kc).to(tdt),
          torch.tensor(vc).to(tdt)]
    return P * TP, jx, tx


def _same_caches(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.float().numpy(), np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 32])
def test_shared_position_matches_pallas(D, dtype):
    """#7 at pos 0, an odd pos inside a packed row, and T - 1. Outputs
    (float32, values O(1)) within 2e-6: both round q·sm_scale and each
    block's probabilities to the cache dtype at the same block maxima, so
    they differ by the order of float32 sums only; the caches are equal
    after the append, which writes only the new lane group."""
    T, jx, tx = _inputs(D, dtype, D)
    for pos in (0, 17, T - 1):
        jo, *jc = jd.decode_attention_hbm(*jx, pos, tbp=TBP, interpret=True)
        to, *tc = td.decode_attention_hbm(*[t.clone() for t in tx], pos, tbp=TBP)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6, rtol=0,
                                   err_msg=f"pos {pos}")
        _same_caches(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 32])
def test_per_slot_positions_match_pallas(D, dtype):
    """#8 with positions [-1, 0, 17, T - 1]: the active slots' outputs
    within 2e-6 (a slot at pos 0, whose running max stays -1e30 through the
    blocks the others need, returns its new V in both); the inactive slot
    writes nothing, so the caches are equal, its row untouched."""
    T, jx, tx = _inputs(D, dtype, 100 + D)
    pos = np.array([-1, 0, 17, T - 1], np.int32)
    jo, *jc = jd.decode_attention_hbm_multi(*jx, jnp.asarray(pos), tbp=TBP,
                                            interpret=True)
    to, *tc = td.decode_attention_hbm_multi(*[t.clone() for t in tx], pos, tbp=TBP)
    act = pos >= 0
    np.testing.assert_allclose(to.numpy()[act], np.asarray(jo)[act], atol=2e-6, rtol=0)
    _same_caches(tc, jc)
    for g, t in zip(tc, tx[3:]):
        assert torch.equal(g[0], t[0])
    vn0 = tx[2][1, :, 0].to(getattr(torch, dtype)).float()
    np.testing.assert_array_equal(to[1, :, 0].numpy(), vn0.numpy())


def test_plain_matches_dense_reference():
    """On the unpacked view the packed plain version computes the dense
    decode attention (`decode_attention_reference`, the unfused path's
    softmax) to float32 rounding (2e-6) in float32, and appends the same
    rows."""
    T, _, tx = _inputs(64, "float32", 7)
    q, kn, vn, kc, vc = tx
    pos = 45
    want, wk, wv = td.decode_attention_reference(q, kn, vn, td.unpack_kv(kc),
                                                 td.unpack_kv(vc), pos)
    got, gk, gv = td.decode_attention_hbm(q, kn, vn, kc.clone(), vc.clone(), pos, tbp=TBP)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    assert torch.equal(td.unpack_kv(gk), wk) and torch.equal(td.unpack_kv(gv), wv)


def test_pack_helpers_and_capacity_checks():
    """pack_kv / unpack_kv are inverse reshapes with the JAX layout
    (timesteps P·u … P·u + P − 1 share row u); positions at or past the
    cache end, or below -1 per slot, raise before anything is written."""
    x = np.random.default_rng(0).standard_normal((2, 3, 8, 64)).astype(np.float32)
    packed = td.pack_kv(torch.tensor(x))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jd.pack_kv(jnp.asarray(x))))
    assert torch.equal(td.unpack_kv(packed, 64), torch.tensor(x))
    assert td.kv_pack_factor(64) == jd.kv_pack_factor(64) == 2
    assert td.kv_pack_factor(128) == jd.kv_pack_factor(128) == 1
    T, _, tx = _inputs(64, "float32", 1)
    with pytest.raises(ValueError, match="outside the cache"):
        td.decode_attention_hbm(*tx, T)
    with pytest.raises(ValueError, match="outside the cache"):
        td.decode_attention_hbm_multi(*tx, [0, 1, T, 2])
    with pytest.raises(ValueError, match="outside the cache"):
        td.decode_attention_hbm_multi(*tx, [0, -2, 3, 2])
