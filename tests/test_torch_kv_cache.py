"""PyTorch port: the int8 KV cache (`ops/kv_cache.py`), its branch of
`infer_forward_unrolled`, `infer_forward_with_cache` and the folded LoRA
format, against the JAX package on the CPU.

The inference trees are float32 (as in the engine-equality tests): with bf16
activations an ulp-level float32 difference now and then flips an
activation code, which the tolerances here are not meant to absorb. The
`int8` format's linears take the float32 reference of #10 on the CPU in
both packages."""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
import llm_qat_tpu.models.generate  # noqa: F401  (the module, not the function)
import llm_qat_tpu_torch.models.generate  # noqa: F401
from llm_qat_tpu.models import inference as ji
from llm_qat_tpu.ops import kv_cache as jkv
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.ops import kv_cache as tkv

JG = sys.modules["llm_qat_tpu.models.generate"]
TG = sys.modules["llm_qat_tpu_torch.models.generate"]
L, D_MODEL, H, R, V = 2, 128, 2, 4, 256

j_with_cache = jax.jit(ji.infer_forward_with_cache, static_argnames=("cfg", "quantize_input"))
j_unrolled = jax.jit(ji.infer_forward_unrolled,
                     static_argnames=("cfg", "static", "initial_prefill"))


def _cfgs():
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: R for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * R for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=D_MODEL, n_layer=L, n_head=H)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q)))


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
def calibrated():
    """JAX-calibrated params (random LoRA B so LoRA is live) in both forms."""
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


_TREES = {}


def _trees(calibrated, bits, fmt, dtype="float32", lora_format="factored"):
    """(JAX tree, its static meta, port tree, its static meta), built once
    per module (the forwards do not modify a tree)."""
    key = (id(calibrated), bits, fmt, dtype, lora_format)
    if key not in _TREES:
        jcfg, tcfg, jp, tp = calibrated
        jt = ji.quantize_for_inference(jp, jcfg, bits, getattr(jnp, dtype),
                                       weight_format=fmt, lora_format=lora_format)
        tt = ti.quantize_for_inference(tp, tcfg, bits, getattr(torch, dtype),
                                       weight_format=fmt, lora_format=lora_format)
        _TREES[key] = (jt, jt.pop("_static"), tt, tt.pop("_static"))
    return _TREES[key]


def _rows(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.normal(0, 1, shape)).astype(np.float32)
    x[0, 0, 0] = 0.0                      # an all-zero row: amax clamps to 1e-8
    x[0, 0, 1, :4] = [127.0, 63.5, -0.5, 1.5]  # codes at .5: half to even
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (1, 2, 7, 64)])
def test_quantize_rows_bit_equal_to_jax(dtype, shape):
    x = _rows(sum(shape), shape)
    jc, js = jkv.quantize_rows(jnp.asarray(x).astype(getattr(jnp, dtype)))
    tcodes, tscales = tkv.quantize_rows(torch.tensor(x).to(getattr(torch, dtype)))
    assert tcodes.dtype == torch.int8 and tscales.dtype == torch.float32
    np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tscales.numpy(), np.asarray(js))


@pytest.mark.parametrize("start,S", [(0, 6), (5, 1), (9, 3), (11, 4)])
def test_append_dequantize_attention_match_jax(start, S):
    """Rows appended at `start` of a 12-row cache that already holds rows
    (the last case is clamped to 8, as the JAX update slice clamps), then
    attention for the appended queries: against JAX (abs 1e-5), and against
    dequantize-then-attend in float32."""
    B, Hh, T, D = 2, 3, 12, 16
    rng = np.random.default_rng(start)
    prev = [rng.normal(0, 1, (B, Hh, T, D)).astype(np.float32) for _ in range(2)]
    new = [rng.normal(0, 1, (B, Hh, S, D)).astype(np.float32) for _ in range(2)]
    q = rng.normal(0, 1, (B, Hh, S, D)).astype(np.float32)
    jcache = [jkv.append_rows(jkv.QuantizedKV(*jkv.quantize_rows(jnp.asarray(p_))),
                              jnp.asarray(n_), start) for p_, n_ in zip(prev, new)]
    tcache = [tkv.append_rows(tkv.QuantizedKV(*tkv.quantize_rows(torch.tensor(p_))),
                              torch.tensor(n_), start) for p_, n_ in zip(prev, new)]
    for jc, tc_ in zip(jcache, tcache):
        np.testing.assert_array_equal(tc_.codes.numpy(), np.asarray(jc.codes))
        np.testing.assert_array_equal(tc_.scales.numpy(), np.asarray(jc.scales))
        np.testing.assert_allclose(tkv.dequantize(tc_).numpy(), np.asarray(jkv.dequantize(jc)),
                                   rtol=0, atol=1e-6)
    want = jkv.attention_with_quantized_kv(jnp.asarray(q), *jcache, start, S, 64)
    got = tkv.attention_with_quantized_kv(torch.tensor(q), *tcache, start, S, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    k, v = (tkv.dequantize(c) for c in tcache)
    s0 = min(start, T - S)
    scores = torch.tensor(q) @ k.transpose(-1, -2) / math.sqrt(D)
    q_pos = start + torch.arange(S)[:, None]
    scores = scores.masked_fill(torch.arange(T)[None, :] > q_pos, -1e30)
    ref = torch.softmax(scores, dim=-1) @ v
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    assert s0 == (8 if start == 11 else start)


@pytest.mark.parametrize("fmt,bits", [("int8_xla", 8), ("int8", 8)])
def test_infer_forward_unrolled_int8_kv_matches_jax(calibrated, fmt, bits):
    """A 20-token prefill, then 4 single-token steps, on `init_layer_caches(
    kv_bits=8)` in both packages: logits (abs 1e-4) and the caches' codes
    and scales (codes equal but for a rounding boundary: at most one code
    step, in at most 0.1 % of the values)."""
    jcfg, tcfg, _, _ = calibrated
    jt, js, tt, ts = _trees(calibrated, bits, fmt)
    ids = np.random.default_rng(7).integers(0, V, (2, 24))
    jc = ji.init_layer_caches(jcfg, 2, 32, kv_bits=8)
    tcaches = ti.init_layer_caches(tcfg, 2, 32, kv_bits=8, device="cpu")
    assert len(tcaches) == 2 * L and all(isinstance(c, tkv.QuantizedKV) for c in tcaches)
    segs = [(0, 20), (20, 21), (21, 22), (22, 23), (23, 24)]
    for a, b in segs:
        jl, jc, jn = j_unrolled(jt, jnp.asarray(ids[:, a:b]), jcfg, jc, jnp.int32(a),
                                static=js, initial_prefill=a == 0)
        tl, tcaches, tn = ti.infer_forward_unrolled(tt, torch.as_tensor(ids[:, a:b]), tcfg,
                                                    tcaches, a, static=ts,
                                                    initial_prefill=a == 0)
        assert tn == int(jn) == b
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4,
                                   err_msg=f"logits of [{a}, {b})")
    for j, t in zip(jc, tcaches):
        moved = np.abs(t.codes.numpy().astype(np.int32) - np.asarray(j.codes, np.int32))
        assert moved.max() <= 1 and moved.mean() <= 1e-3
        np.testing.assert_allclose(t.scales.numpy(), np.asarray(j.scales), rtol=1e-5)


@pytest.mark.parametrize("fmt,bits", [("int8_xla", 8), ("int4_xla", 4), ("int8", 8)])
def test_infer_forward_with_cache_matches_jax(calibrated, fmt, bits):
    """A 16-token prefill and 3 decode steps through `infer_forward_with_cache`
    on the stacked float32 KVCache: logits and caches within abs 1e-4."""
    jcfg, tcfg, _, _ = calibrated
    jt, _, tt, _ = _trees(calibrated, bits, fmt)
    ids = np.random.default_rng(8).integers(0, V, (2, 19))
    jc = JG.init_kv_cache(jcfg, 2, 24)
    tcache = TG.init_kv_cache(tcfg, 2, 24, device="cpu")
    for a, b in [(0, 16), (16, 17), (17, 18), (18, 19)]:
        jl, jc = j_with_cache(jt, jnp.asarray(ids[:, a:b]), jcfg, jc)
        tl, tcache = ti.infer_forward_with_cache(tt, torch.as_tensor(ids[:, a:b]), tcfg,
                                                 tcache)
        assert tcache.length == int(jc.length) == b
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4,
                                   err_msg=f"logits of [{a}, {b})")
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jc.k), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jc.v), rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt,bits", [("int8_xla", 8), ("dense", 8)])
def test_folded_lora_tree_matches_jax(calibrated, dtype, fmt, bits):
    """`lora_format="folded"`: `lora_AB` = scaling · Aq @ Bq in place of the
    factors and their codes; bf16 equal to JAX's, float32 within 1e-6
    relative (a rank-4 sum in another order); every other tensor as in the
    factored tree."""
    jt, js, tt, ts = _trees(calibrated, bits, fmt, dtype, "folded")
    assert tuple(js) == tuple(ts)
    ft = _trees(calibrated, bits, fmt, dtype)[2]
    for name in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        got, want = tt["blocks"][name], jt["blocks"][name]
        assert set(got) == set(want) and "lora_AB" in got
        assert not any(k.startswith("lora_A") and k != "lora_AB" for k in got)
        assert not any(k.startswith("lora_B") for k in got)
        for k in got:
            if k == "lora_AB":
                continue
            assert torch.equal(got[k], ft["blocks"][name][k])
        ab, want_ab = got["lora_AB"].float().numpy(), np.asarray(want["lora_AB"], np.float32)
        assert got["lora_AB"].dtype == getattr(torch, dtype)
        if dtype == "bfloat16":
            np.testing.assert_array_equal(ab, want_ab)
        else:
            np.testing.assert_allclose(ab, want_ab, rtol=1e-6, atol=1e-6 * np.abs(want_ab).max())


def _flip_rule(got, want, what):
    """Logits within 1e-4 but where an activation code moved: an ulp-level
    float32 difference upstream (here the LoRA sum in another order) puts a
    value on the other side of a rounding boundary now and then, and the
    moved code shifts that position's logits by about 3e-4 at this size. At
    most 2 % of the logits may sit beyond 1e-4, none beyond 2e-3."""
    err = np.abs(got - want)
    assert (err > 1e-4).mean() <= 0.02 and err.max() <= 2e-3, (what, err.max(),
                                                               (err > 1e-4).mean())


def test_folded_lora_logits_match_factored_in_float32(calibrated):
    """Without activation quantization (`quantize_input=False`, the dense
    float32 tree) the folded and factored trees differ by float32 rounding
    alone: within 1e-5, and the port's folded logits within 1e-5 of JAX's."""
    jcfg, tcfg, _, _ = calibrated
    jt, _, tt, _ = _trees(calibrated, 8, "dense", lora_format="folded")
    _, _, tf, _ = _trees(calibrated, 8, "dense")
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, V, (2, 16)))
    run = lambda tree: ti.infer_forward_with_cache(
        tree, ids, tcfg, TG.init_kv_cache(tcfg, 2, 16, device="cpu"),
        quantize_input=False)[0].numpy()
    want = j_with_cache(jt, jnp.asarray(ids.numpy()), jcfg, JG.init_kv_cache(jcfg, 2, 16),
                        quantize_input=False)[0]
    np.testing.assert_allclose(run(tt), run(tf), rtol=0, atol=1e-5)
    np.testing.assert_allclose(run(tt), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("fmt", ["int8_xla", "int8"])
def test_folded_lora_logits_match_factored_and_jax(calibrated, fmt):
    """The folded float32 tree of a quantized format through
    `infer_forward_with_cache`: against the factored tree's logits and
    JAX's folded logits, by `_flip_rule`."""
    jcfg, tcfg, _, _ = calibrated
    jt, _, tt, _ = _trees(calibrated, 8, fmt, lora_format="folded")
    _, _, tf, _ = _trees(calibrated, 8, fmt)
    ids = torch.as_tensor(np.random.default_rng(9).integers(0, V, (2, 16)))
    run = lambda tree: ti.infer_forward_with_cache(
        tree, ids, tcfg, TG.init_kv_cache(tcfg, 2, 16, device="cpu"))[0].numpy()
    folded = run(tt)
    want = j_with_cache(jt, jnp.asarray(ids.numpy()), jcfg, JG.init_kv_cache(jcfg, 2, 16))[0]
    _flip_rule(folded, run(tf), "folded vs factored")
    _flip_rule(folded, np.asarray(want), "folded vs JAX")
