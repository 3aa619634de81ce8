"""PyTorch port: the float-cache decode step #3 (`mega_decode_step`, the
`kv_layout="mega", kv_bits=16` engine path) against the JAX
`mega_decode_step(interpret=True)` on the CPU. Tiny config and weights as
in test_torch_mega_cb.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import mega_decode as jm
from llm_qat_tpu_torch.ops import mega_decode as tm
from test_torch_mega_cb import B, D_MODEL, H, L, T, _weights, calibrated  # noqa: F401


@pytest.mark.parametrize("cache,act", [("float32", "float32"),
                                       ("bfloat16", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_float_cache_step_matches_jax(calibrated, cache, act):
    """#3's plain version against the JAX `mega_decode_step` at pos 0, 37,
    38, 47 (tbp 16: empty, full and partial blocks) over a (L, B, T, d)
    cache of `cache` dtype. h_out within 1e-4 (values O(1); float32 sums in
    another order; activation codes equal on these seeded inputs: with bf16
    activations an ulp can move a value across a bf16 rounding and so a code,
    ROADMAP.md "Known reference behaviours"), each step from
    the same caches. Cache rows other than the appended one must be
    untouched; the appended row holds
    the new K/V, whose float32 values differ by the order of the LoRA and
    dot sums: within 1e-5 relative in float32, and in bf16 at most 1 % of
    them a bf16 ulp apart (a value on a rounding boundary)."""
    _check_against_jax(calibrated, cache, act, H)


@pytest.mark.parametrize("cache,act", [("float32", "float32"),
                                       ("bfloat16", "bfloat16")])
def test_float_cache_step_head_dim_128_matches_jax(calibrated, cache, act):
    """As test_float_cache_step_matches_jax, with one head of 128 lanes (the
    weights do not depend on the head split): the head_dim at which a
    float32 pass of the CUDA attention item stages the most bytes per row."""
    _check_against_jax(calibrated, cache, act, 1)


def _check_against_jax(calibrated, cache, act, n_head):
    jmw, tmw, aq = _weights(calibrated, 8)
    rng = np.random.default_rng(12)
    kc, vc = (rng.standard_normal((L, B, T, D_MODEL)).astype(np.float32)
              for _ in range(2))
    jdt, tdt = getattr(jnp, cache), getattr(torch, cache)
    kw = dict(n_head=n_head, head_dim=D_MODEL // n_head, has_lora=True, aq_max=aq, tbp=16,
              tiles_per_step=4)
    jstep = jax.jit(functools.partial(jm.mega_decode_step, **kw,
                                      act_dtype=getattr(jnp, act), interpret=True))
    jc = [jnp.asarray(kc, jdt), jnp.asarray(vc, jdt)]
    for pos in (0, 37, 38, 47):
        # each step starts from the JAX caches, so a rounding difference in
        # an earlier appended row does not carry into the next step
        tcache = [torch.tensor(np.asarray(c, np.float32)).to(tdt) for c in jc]
        h = rng.normal(0, 0.5, (B, D_MODEL)).astype(np.float32)
        jh, *jc = jstep(jnp.asarray(h), jmw, *jc, jnp.int32(pos))
        th, *tcache = tm.mega_decode_step(torch.tensor(h), tmw, *tcache, pos,
                                          act_dtype=getattr(torch, act), **kw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                                   err_msg=f"pos {pos}")
        other = np.arange(T) != pos
        for a, b in zip(tcache, jc):
            got, want = a.float().numpy(), np.asarray(b, np.float32)
            np.testing.assert_array_equal(got[:, :, other], want[:, :, other])
            if cache == "float32":
                np.testing.assert_allclose(got[:, :, pos], want[:, :, pos],
                                           rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(got[:, :, pos], want[:, :, pos], rtol=2 ** -7)
                assert (got[:, :, pos] != want[:, :, pos]).mean() <= 0.01
