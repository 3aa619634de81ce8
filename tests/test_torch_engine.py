"""PyTorch port: greedy `InferenceEngine.generate` against the JAX engine
(`attn_interpret=True`, so the JAX megakernel runs in interpret mode).

The served configuration of the bench at tiny size: W4A4 int4_xla tree,
int8 LoRA banks, int4 LM head; kv_layout "mega" with kv_bits 4, 8 and 16
(the float-cache step #3), "dense", and "packed" (a 21-token prompt: a
20-token aligned prefill, then the odd tail and the decode through the
packed kernel #7). A 128-token prompt takes the flash prefill branch on
both sides.
The trees are float32, as in the JAX package's own engine-equality tests:
with bf16 activations an ulp-level float32 difference (attention
probabilities rounded to bf16 after a softmax summed in another order)
flips a ±7 activation code now and then, and on a random model whose top
two logits are often within 0.02 that changes a greedy token.
test_torch_inference.py bounds the bf16 prefill's logits instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models.inference import InferenceEngine as JEngine
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.inference import InferenceEngine as TEngine
from llm_qat_tpu_torch.models.inference import init_layer_caches

V = 256


@pytest.fixture(scope="module")
def calibrated():
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=256, n_layer=2, n_head=4)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                           compute_dtype="bfloat16")
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                            compute_dtype="bfloat16")
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(2)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("kv_layout,kv_bits,prompt", [
    ("mega", 4, 128), ("mega", 8, 20), ("dense", 16, 20), ("packed", 16, 21),
    ("mega", 16, 20)])
def test_greedy_generate_matches_jax_engine(calibrated, kv_layout, kv_bits, prompt):
    """Greedy tokens must be equal. The integer dots are exact in both
    packages and the float32 sums differ by ulps, which flip no argmax on
    these seeded inputs (a flip would show as a token mismatch, not as a
    tolerance question)."""
    jcfg, tcfg, jp, tp = calibrated
    kw = dict(bits=4, max_batch=2, max_len=160, weight_format="int4_xla",
              lm_head_bits=4, kv_layout=kv_layout, kv_bits=kv_bits, mega_tbp=64)
    ids = np.random.default_rng(prompt).integers(0, V, (2, prompt))
    want = np.asarray(JEngine(jp, jcfg, attn_interpret=True, dtype=jnp.float32,
                              **kw).generate(ids, max_new_tokens=8))
    got = TEngine(tp, tcfg, device="cpu", dtype=torch.float32, **kw).generate(
        ids, max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_engine_refuses_unported_layouts_and_overlong_requests(calibrated):
    """What raises: KV8 / KV4 outside the mega layout (the engine, as the
    JAX engine does, even though `init_layer_caches(kv_bits=8)` gives the
    unfused int8 caches: 2·L `QuantizedKV`s of JAX's shapes), an unknown
    layout, and requests past max_len. "auto" picks the dense layout on the
    CPU."""
    from llm_qat_tpu.models.inference import init_layer_caches as j_init
    from llm_qat_tpu_torch.ops.kv_cache import QuantizedKV

    jcfg, tcfg, _, tp = calibrated
    kw = dict(bits=4, weight_format="int4_xla", device="cpu")
    eng = TEngine(tp, tcfg, **kw)
    assert eng.kv_layout == "dense"
    got, want = init_layer_caches(tcfg, 1, 16, kv_bits=8, device="cpu"), j_init(jcfg, 1, 16,
                                                                                 kv_bits=8)
    assert len(got) == len(want) == 2 * tcfg.model.n_layer
    for g, w in zip(got, want):
        assert isinstance(g, QuantizedKV)
        assert (g.codes.dtype, g.scales.dtype) == (torch.int8, torch.float32)
        assert (tuple(g.codes.shape), tuple(g.scales.shape)) == (w.codes.shape, w.scales.shape)
        assert not g.codes.any() and not g.scales.any()
    with pytest.raises(ValueError, match="requires kv_layout='mega'"):
        TEngine(tp, tcfg, kv_bits=8, **kw)
    with pytest.raises(ValueError, match="requires kv_layout='mega'"):
        TEngine(tp, tcfg, kv_bits=4, **kw)
    with pytest.raises(ValueError, match="unknown kv_layout"):
        TEngine(tp, tcfg, kv_layout="paged", **kw)
    eng = TEngine(tp, tcfg, kv_layout="mega", kv_bits=4, max_len=64, **kw)
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.generate(np.zeros((1, 60), np.int64), max_new_tokens=8)
