"""PyTorch port: KV-cached generation on SP parameters (`models/generate.py`)
against the JAX package on the CPU: `forward_with_cache` prefill and
incremental decode (logits and caches, float32, abs 1e-4), greedy
`generate` tokens with and without EOS, and the clamped writes and
positions past the cache and past `n_positions`."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
import llm_qat_tpu.models.generate  # noqa: F401  (the module, not the function)
import llm_qat_tpu_torch.models.generate  # noqa: F401
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc

JG = sys.modules["llm_qat_tpu.models.generate"]
TG = sys.modules["llm_qat_tpu_torch.models.generate"]
ABS = 1e-4
# the JAX reference, compiled once per shape
j_forward = jax.jit(JG.forward_with_cache, static_argnames=("cfg",))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one intra-op thread
    each (restored after the module), as pytest-xdist runs several files
    side by side and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """The tiny config (bits 4/8/32, rank 4) with live LoRA, calibrated by
    the JAX package, in both forms."""
    from llm_qat_tpu.train import calibration_manager as jcm

    jcfg, tcfg = J.tiny_test_config((4, 8, 32)), tc.tiny_test_config((4, 8, 32))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, 256, (2, 16))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _close(got, want, what):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ABS,
                               err_msg=what)


@pytest.mark.parametrize("prec", [0, 1, 2])
def test_prefill_matches_jax(model, prec):
    jcfg, tcfg, jp, tp = model
    ids = np.random.default_rng(prec).integers(0, 256, (2, 12))
    jl, jc = j_forward(jp, jnp.asarray(ids), prec, jcfg, JG.init_kv_cache(jcfg, 2, 20))
    tl, tcache = TG.forward_with_cache(tp, torch.as_tensor(ids), prec, tcfg,
                                       TG.init_kv_cache(tcfg, 2, 20, device="cpu"))
    assert tl.dtype == torch.float32 and tcache.length == int(jc.length) == 12
    _close(tl, jl, "logits")
    _close(tcache.k, jc.k, "k cache")
    _close(tcache.v, jc.v, "v cache")
    assert not tcache.k[:, :, :, 12:].any()  # rows past the prefill untouched


def test_prefill_then_incremental_decode_matches_jax(model):
    """A 5-token prefill, then 6 single-token steps on the same tokens in
    both packages: every step's logits and the final caches."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 256, (2, 11))
    jc = JG.init_kv_cache(jcfg, 2, 16)
    tcache = TG.init_kv_cache(tcfg, 2, 16, device="cpu")
    jl, jc = j_forward(jp, jnp.asarray(ids[:, :5]), 1, jcfg, jc)
    tl, tcache = TG.forward_with_cache(tp, torch.as_tensor(ids[:, :5]), 1, tcfg, tcache)
    _close(tl, jl, "prefill logits")
    for t in range(5, 11):
        jl, jc = j_forward(jp, jnp.asarray(ids[:, t:t + 1]), 1, jcfg, jc)
        tl, tcache = TG.forward_with_cache(tp, torch.as_tensor(ids[:, t:t + 1]), 1,
                                           tcfg, tcache)
        _close(tl, jl, f"step {t} logits")
    assert tcache.length == int(jc.length) == 11
    _close(tcache.k, jc.k, "k cache")
    _close(tcache.v, jc.v, "v cache")
    # the cached decode equals the full forward of the same prefix
    full = TG.forward_with_cache(tp, torch.as_tensor(ids), 1, tcfg,
                                 TG.init_kv_cache(tcfg, 2, 16, device="cpu"))[0]
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, -1].numpy(), atol=ABS)


@pytest.mark.parametrize("prec,eos", [(0, None), (1, None), (2, None), (0, "first"),
                                      (1, "mid")])
def test_greedy_generate_matches_jax(model, prec, eos):
    """Greedy tokens equal. With an EOS id taken from the tokens the run
    emits (its first token, or one emitted mid-run), every row that emits it
    keeps emitting it."""
    jcfg, tcfg, jp, tp = model
    ids = np.random.default_rng(20 + prec).integers(0, 256, (3, 7))
    kw = dict(max_new_tokens=12, do_sample=False)
    free = np.asarray(JG.generate(jp, jnp.asarray(ids), prec, jcfg, **kw))
    eos_id = None if eos is None else int(free[0, 7] if eos == "first" else free[1, 12])
    want = np.asarray(JG.generate(jp, jnp.asarray(ids), prec, jcfg, eos_token_id=eos_id, **kw))
    got = TG.generate(tp, torch.as_tensor(ids), prec, tcfg, eos_token_id=eos_id, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    if eos_id is not None:
        new = got[:, 7:].numpy()
        hit = new == eos_id
        assert hit.any()
        for row, h in zip(new, hit):
            if h.any():
                assert (row[np.argmax(h):] == eos_id).all()


def test_generate_past_n_positions_matches_jax(model):
    """A 40-token prompt and 40 new tokens at n_positions 64: the cache holds
    64 rows, the last 16 steps write clamped to the last row and read the
    last wpe row, and all 40 steps are taken, as in JAX."""
    jcfg, tcfg, jp, tp = model
    ids = np.random.default_rng(5).integers(0, 256, (2, 40))
    kw = dict(max_new_tokens=40, do_sample=False)
    want = np.asarray(JG.generate(jp, jnp.asarray(ids), 2, jcfg, **kw))
    got = TG.generate(tp, torch.as_tensor(ids), 2, tcfg, **kw)
    assert got.shape == (2, 80)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("length,S", [(14, 4), (16, 1), (30, 2)])
def test_clamped_write_matches_jax(model, length, S):
    """A segment that does not fit at `length` of a 16-row cache: JAX's
    update slice clamps its start to 16 - S and the positions read the
    clamped wpe rows; the port does the same (logits and caches)."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(length)
    ids = rng.integers(0, 256, (2, S))
    k0 = rng.normal(0, 1, (2, 2, 2, 16, 16)).astype(np.float32)
    v0 = rng.normal(0, 1, k0.shape).astype(np.float32)
    jc = JG.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0), length=jnp.int32(length))
    tcache = TG.KVCache(k=torch.tensor(k0), v=torch.tensor(v0), length=length)
    jl, jc = j_forward(jp, jnp.asarray(ids), 1, jcfg, jc)
    tl, tcache = TG.forward_with_cache(tp, torch.as_tensor(ids), 1, tcfg, tcache)
    assert tcache.length == int(jc.length) == length + S
    _close(tl, jl, "logits")
    _close(tcache.k, jc.k, "k cache")
    _close(tcache.v, jc.v, "v cache")


def test_sampled_generate_is_seeded_and_in_range(model):
    """Sampled draws come from one torch.Generator (they differ from JAX's
    draws): the same seed gives the same tokens, top-k 1 gives the greedy
    tokens."""
    _, tcfg, _, tp = model
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, 256, (2, 6)))
    run = lambda seed, **k: TG.generate(
        tp, ids, 0, tcfg, max_new_tokens=8,
        generator=torch.Generator().manual_seed(seed), **k)
    a, b = run(1, temperature=0.8, top_p=0.9), run(1, temperature=0.8, top_p=0.9)
    assert torch.equal(a, b) and ((a >= 0) & (a < 256)).all()
    assert torch.equal(run(2, top_k=1), TG.generate(tp, ids, 0, tcfg, max_new_tokens=8,
                                                    do_sample=False))
