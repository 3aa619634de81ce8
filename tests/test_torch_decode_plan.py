"""The launch plans of the port's one-token decode attention kernels, on
the CPU: `dense_split` (#9) and `hbm_split` (#7/#8) pick at most MAX_SPLIT
blocks per cluster, one for an empty prefix, and `split_ranges`, the cut
both kernels make of each slot's own prefix, gives every live row (#9) or
every JAX block (#7/#8) to exactly one block of the cluster, at the main
paths' positions and at ragged ones, inactive slots included."""

import numpy as np
import pytest
import torch

from llm_qat_tpu_torch.ops import decode_attention as da

# (name, positions): path B's fused step (T = 192, pos 128 .. 191), the
# packed server's steady state (T = 512), InferenceEngine's packed run
# (T = 256, pos 143), and ragged mixes
POSITIONS = [
    ("path_b_first", [128] * 8),
    ("path_b_mid", [160] * 8),
    ("path_b_last", [191] * 8),
    ("server", [150, 182, 214, 246, 278, 310, 342, 374]),
    ("engine_packed", [143] * 8),
    ("empty", [0] * 4),
    ("ragged_short", [0, 1, 2, 23, 24, 25]),
    ("ragged_long", [-1, 0, 1, 63, 64, 65, 300, 511]),
    ("all_inactive", [-1, -1, 0]),
    ("long_cache", [4095, 17, -1, 2048]),
]


def _owned_once(n: int, split: int):
    """Each of n items in exactly one block's range; ranges contiguous and
    in rank order."""
    owner = np.zeros(n, np.int64)
    end = 0
    for r0, r1 in da.split_ranges(n, split):
        assert r0 == min(end, n) and r0 <= r1 <= n
        owner[r0:r1] += 1
        end = r1
    assert (owner == 1).all()


@pytest.mark.parametrize("name,pos", POSITIONS, ids=[n for n, _ in POSITIONS])
def test_dense_split_owns_every_row_once(name, pos):
    """#9: 1 <= S <= 8, S = 1 when every slot is at pos 0; each slot's rows
    0 .. pos (its own position) in exactly one block, at the plan's S and
    at every forced S."""
    pos = np.maximum(np.asarray(pos), 0)  # #9 has no inactive slot
    S = da.dense_split(pos)
    assert 1 <= S <= da.MAX_SPLIT
    if pos.max() == 0:
        assert S == 1
    assert S == min(da.MAX_SPLIT, max(1, -(-(int(pos.max()) + 1) // da.DENSE_ROWS_PER_BLOCK)))
    for split in sorted({S, *range(1, da.MAX_SPLIT + 1)}):
        for p in pos:
            _owned_once(int(p) + 1, split)


@pytest.mark.parametrize("tbp", [32, 8])
@pytest.mark.parametrize("name,pos", POSITIONS, ids=[n for n, _ in POSITIONS])
def test_hbm_split_owns_every_jax_block_once(name, pos, tbp):
    """#7/#8 (head_dim 64, P = 2): 1 <= S <= 8, one block per JAX block of
    the longest prefix up to 8, S = 1 when no slot has a prefix (pos -1 or
    0); each slot's JAX blocks ceil(pos / (P tbp)) — the TPU kernel's
    count — in exactly one block of the cluster, at every forced S."""
    P = da.kv_pack_factor(64)
    pos = np.asarray(pos)
    nblk = da.hbm_blocks(pos, P, tbp)
    want = [max(0, -(-int(p) // (P * tbp))) for p in pos]
    assert nblk.tolist() == want
    S = da.hbm_split(pos, P, tbp)
    assert 1 <= S <= da.MAX_SPLIT
    assert S == min(da.MAX_SPLIT, max(1, max(want)))
    for split in range(1, da.MAX_SPLIT + 1):
        for n in want:
            _owned_once(n, split)


def test_main_path_plans():
    """The plans at the main paths' shapes: #9 at path B's pos 160 (161
    rows) takes 3 blocks; #8 at the server's positions 6 (its longest
    prefix, 374, has 6 JAX blocks of 64 timesteps); #7 at pos 143 of
    T = 256, 3."""
    assert da.dense_split([160] * 8) == 3
    assert da.hbm_split([150, 182, 214, 246, 278, 310, 342, 374], 2, 32) == 6
    assert da.hbm_split([143] * 8, 2, da.block_rows(128, 32)) == 3


def test_launchers_refuse_cpu_tensors():
    """The kernels have no CPU mode: the launchers that force a split raise
    on CPU tensors (the public wrappers take the plain versions there)."""
    q = torch.zeros((2, 1, 1, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        da.launch_dense(q, q, q, torch.zeros((2, 1, 8, 64)), torch.zeros((2, 1, 8, 64)), 3, 1)
    with pytest.raises(ValueError, match="CUDA device"):
        da.launch_hbm(q, q, q, torch.zeros((2, 1, 8, 128)), torch.zeros((2, 1, 8, 128)),
                      [3, -1], 8, 1)
