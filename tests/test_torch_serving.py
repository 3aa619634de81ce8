"""PyTorch port: `ContinuousBatchingEngine` against the JAX engine on the
CPU (the JAX kernels in interpret mode), and the port's own sampling and
capacity contracts. The mega layout's greedy comparison is in
test_torch_serving_mega.py.

Tiny float32 config (d=256, 2 layers, 4 heads of 64, vocab 256), as
test_torch_engine.py: with bf16 activations an ulp-level float32
difference flips a low-bit activation code now and then, and on a random
model whose top two logits are often close that changes a greedy token
(ROADMAP.md "Known reference behaviours")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models.generate import _filter_logits_vec as j_filter_vec
from llm_qat_tpu.serving import ContinuousBatchingEngine as JServer
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.generate import _filter_logits_vec as t_filter_vec
from llm_qat_tpu_torch.serving import ContinuousBatchingEngine as TServer

V = 256
# (kv_layout, kv_bits, weight bits / format, LM head bits)
LAYOUTS = {
    "dense": ("dense", 8, 8, "int8_xla", 8),
    "dense_int8": ("dense", 8, 8, "int8", 8),   # quant_matmul's weight format
    "packed": ("packed", 8, 8, "int8_xla", 8),
    "mega_kv8": ("mega", 8, 8, "int8_xla", None),
    "mega_kv4": ("mega", 4, 4, "int4_xla", 4),
}


@pytest.fixture(scope="module")
def calibrated():
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=256, n_layer=2, n_head=4)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q))
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _kw(layout):
    kv_layout, kv_bits, bits, fmt, head = LAYOUTS[layout]
    return dict(bits=bits, weight_format=fmt, lm_head_bits=head, kv_layout=kv_layout,
                kv_bits=kv_bits, mega_tbp=64)


def _server(tp, tcfg, layout, **kw):
    return TServer(tp, tcfg, n_slots=2, max_len=192, dtype=torch.float32,
                   device="cpu", **{**_kw(layout), **kw})


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, (n,)).astype(np.int32) for n in (5, 130, 9)]


@pytest.mark.parametrize("layout", ["dense", "packed", "dense_int8"])
def test_greedy_tokens_match_jax_engine(calibrated, layout):
    """Three greedy requests on two slots (one waits for a recycled slot),
    prompt lengths 5, 130 and 9 (the 130-token prompt's bucket of 192
    reaches the flash prefill; 5 and 9 are odd, leaving a pad token in the
    last packed row), 6 new tokens each: equal token for token, also with
    the "int8" weight format (`quant_matmul`'s float32 reference on the CPU
    in both packages). Integer dots
    are exact in both packages and the float32 sums differ by ulps, which
    flip no argmax on these seeded inputs."""
    check_greedy_against_jax(calibrated, layout)


def check_greedy_against_jax(calibrated, layout):
    jcfg, tcfg, jp, tp = calibrated
    prompts = _prompts()
    jeng = JServer(jp, jcfg, n_slots=2, max_len=192, dtype=jnp.float32,
                   attn_interpret=True, **_kw(layout))
    jids = [jeng.submit(p, max_new_tokens=6) for p in prompts]
    want = jeng.run_until_done()
    teng = _server(tp, tcfg, layout)
    tids = [teng.submit(p, max_new_tokens=6) for p in prompts]
    got = teng.run_until_done()
    assert set(got) == set(tids)
    for j, t in zip(jids, tids):
        assert got[t].generated == [int(x) for x in want[j].generated], (layout, t)


@pytest.mark.parametrize("layout", ["dense", "packed", "mega_kv8"])
def test_chunked_matches_stepwise(calibrated, layout):
    """step_chunk(4) (one host sync per chunk; on mega one recent-buffer
    merge per chunk) gives the tokens of per-step decode."""
    _, tcfg, _, tp = calibrated
    prompts = _prompts(1)
    outs = []
    for chunk in (1, 4):
        eng = _server(tp, tcfg, layout)
        ids = [eng.submit(p[:12], max_new_tokens=7) for p in prompts]
        fin = eng.run_until_done(chunk=chunk)
        outs.append([fin[i].generated for i in ids])
    assert outs[0] == outs[1]
    assert all(len(g) == 7 for g in outs[0])


def test_filter_logits_vec_matches_jax():
    """Per-row temperature, top-k and top-p (top-p on the top-k-filtered
    row) on the same logits: float32 division and softmax sums in another
    order, so kept logits within 1e-6 and the kept sets equal (these
    logits leave no cumulative probability within an ulp of top_p)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 2.0, (5, 64)).astype(np.float32)
    temp = np.array([1.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 10, 3], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.6, 0.9], np.float32)
    want = np.asarray(j_filter_vec(jnp.asarray(logits), jnp.asarray(temp),
                                   jnp.asarray(top_k), jnp.asarray(top_p)))
    got = t_filter_vec(torch.tensor(logits), torch.tensor(temp),
                       torch.tensor(top_k), torch.tensor(top_p)).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_sampling_reproducible_chunk_invariant_and_not_greedy(calibrated):
    """Sampled requests (temperature 1.5, top-k 50 / top-p 0.9) beside a
    greedy one: the same seed gives the same tokens, stepwise and chunked
    alike (token i of a request draws from (seed, request id, i) only); a
    torch.Generator seed works the same way; another seed or greedy
    decoding gives other tokens."""
    _, tcfg, _, tp = calibrated
    prompts = _prompts(2)

    def run(seed, chunk, sample=True):
        eng = _server(tp, tcfg, "dense", rng=seed)
        ids = [eng.submit(prompts[0], max_new_tokens=8, temperature=1.5, top_k=50,
                          do_sample=sample),
               eng.submit(prompts[2], max_new_tokens=8),
               eng.submit(prompts[1][:20], max_new_tokens=8, temperature=1.5,
                          top_p=0.9, do_sample=sample)]
        fin = eng.run_until_done(chunk=chunk)
        return [fin[i].generated for i in ids]

    a = run(7, 1)
    assert run(7, 4) == a
    g = torch.Generator().manual_seed(3)
    b = run(g, 1)
    assert run(torch.Generator().manual_seed(3), 4) == b
    assert run(8, 1) != a
    greedy = run(7, 1, sample=False)
    assert greedy[1] == a[1]            # the greedy request is unaffected
    assert greedy[0] != a[0] and greedy[2] != a[2]


def test_capacity_contract_and_empty_requests(calibrated):
    """A prompt with no room for one generated token raises at submit (on
    the card a decode step would append past the cache end) and the engine
    keeps serving; a 2-D prompt raises; max_new_tokens=0 finishes without
    sampling the prefill token; a request longer than the cache finishes
    early at the cache limit, stepwise and chunked."""
    _, tcfg, _, tp = calibrated
    rng = np.random.default_rng(5)
    eng = TServer(tp, tcfg, n_slots=1, max_len=16, dtype=torch.float32,
                  device="cpu", **_kw("mega_kv8"))
    for n in (16, 40):
        with pytest.raises(ValueError, match="capacity"):
            eng.submit(rng.integers(1, V, (n,)), max_new_tokens=4)
    with pytest.raises(ValueError, match="1-D"):
        eng.submit(rng.integers(1, V, (2, 4)), max_new_tokens=4)
    r0 = eng.submit(rng.integers(1, V, (4,)), max_new_tokens=0)
    r1 = eng.submit(rng.integers(1, V, (4,)), max_new_tokens=2)
    fin = eng.run_until_done()
    assert fin[r0].generated == [] and len(fin[r1].generated) == 2
    for chunk in (1, 8):
        eng = TServer(tp, tcfg, n_slots=1, max_len=16, dtype=torch.float32,
                      device="cpu", **_kw("packed"))
        rid = eng.submit(rng.integers(1, V, (10,)), max_new_tokens=50)
        got = len(eng.run_until_done(chunk=chunk)[rid].generated)
        assert 1 <= got < 50
