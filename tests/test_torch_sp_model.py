"""PyTorch port: SP model forward and calibration against the JAX package.

Tiny config (L=2, n_embd=32 and 128, r=4, vocab 256); the same JAX
parameters go through both packages via `bridge.params_from_numpy`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import calibration_manager as tcm


def _cfgs(per_channel, compute_dtype="float32"):
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=per_channel,
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                            compute_dtype=compute_dtype),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                             compute_dtype=compute_dtype))


def _jax_params(jcfg, seed=0):
    """JAX init with non-zero LoRA B banks, so the LoRA branch is exercised."""
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    return p


def _batches(n=2, shape=(2, 16)):
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, shape) for _ in range(n)]


def _assert_tree_close(t_tree, j_tree, rtol, atol):
    for path, a in jax.tree_util.tree_leaves_with_path(j_tree):
        b = t_tree
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol, err_msg=str(path))


def test_init_sp_params_layout_matches_jax():
    jcfg, tcfg = _cfgs(True)
    jp = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(0), jcfg))
    tp = tsp.init_sp_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    for path, a in jax.tree_util.tree_leaves_with_path(jp):
        b = tp
        for k in path:
            b = b[k.key]
        assert tuple(b.shape) == a.shape and b.dtype == torch.float32, path
    # same distributions: LoRA A zero in the 32-bit slot, U(±1/sqrt(r)) else
    la = tp["blocks"]["c_fc"]["lora_A"]
    assert float(la[:, 2].abs().max()) == 0.0
    assert 0.4 < float(la[:, 0].abs().max()) <= 0.5


@pytest.mark.parametrize("per_channel", [True, False])
def test_calibration_matches_jax(per_channel):
    """Weight then input calibration. The weight scales are exact (same
    reductions and division); the input scales come from forwards whose
    float32 matmuls sum in another order, so 1e-5 relative."""
    jcfg, tcfg = _cfgs(per_channel)
    jp = _jax_params(jcfg)
    tp = bridge.params_from_numpy(jp, "cpu")
    jw = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, jp), jcfg)
    tw = tcm.calibrate_weight_quantizers(tp, tcfg)
    _assert_tree_close(tw, jax.tree.map(np.asarray, jw), 0, 0)
    batches = _batches()
    ji = jcm.calibrate_input_quantizers(jw, jcfg, [jnp.asarray(b) for b in batches])
    ti = tcm.calibrate_input_quantizers(tw, tcfg, [torch.tensor(b) for b in batches])
    _assert_tree_close(ti, jax.tree.map(np.asarray, ji), 1e-5, 1e-7)
    # the input tree was left as it was
    assert float(tp["blocks"]["c_attn"]["iq_scale"].max()) == 1.0


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_sp_forward_matches_jax(compute_dtype):
    """Logits in calibration mode (LoRA off, input quantizers passing
    through, stats collected), and in float32 the normal mode at every
    precision slot.

    Tolerances: logits 2e-4 absolute (O(1) logits; float32 sums in another
    order). Stats to 1e-5 relative in float32. In bf16 the attention
    probabilities are rounded to bf16 after a float32 softmax whose last bit
    may differ between XLA and PyTorch, so the attention output — the
    attn_proj input — may move by one bf16 ulp: stats to 2^-8 relative.
    That ulp also flips low-bit fake-quant codes downstream, which is why
    the bf16 case checks the unquantized calibration forward only.
    lg_min is log2 of an input's smallest |x|, a near-cancelled sum whose
    relative error is far above epsilon; it is compared in the linear
    domain (2^lg_min to 1e-6 absolute)."""
    f32 = compute_dtype == "float32"
    jcfg, tcfg = _cfgs(False, compute_dtype)
    jp = _jax_params(jcfg, seed=1)
    jp = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, jp), jcfg)
    jp = jcm.calibrate_input_quantizers(jp, jcfg, [jnp.asarray(b) for b in _batches()])
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    ids = np.random.default_rng(5).integers(0, 256, (2, 24))
    jo = J.sp_forward(jp, jnp.asarray(ids), 0, jcfg, calibration_mode=True,
                      collect_stats=True, input_passthrough=True)
    to = tsp.sp_forward(tp, torch.tensor(ids), 0, tcfg, calibration_mode=True,
                        collect_stats=True, input_passthrough=True)
    np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                               atol=2e-4)
    for name, st in jo["stats"].items():
        for key, want in st.items():
            got = to["stats"][name][key].numpy()
            if key == "lg_min":
                np.testing.assert_allclose(np.exp2(got), np.exp2(want), atol=1e-6,
                                           rtol=0 if f32 else 2 ** -8)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5 if f32 else 2 ** -8,
                                           atol=1e-6, err_msg=f"{name} {key}")
    if not f32:
        return
    for prec in range(3):
        jl = J.sp_forward(jp, jnp.asarray(ids), prec, jcfg, labels=jnp.asarray(ids))
        tl = tsp.sp_forward(tp, torch.tensor(ids), prec, tcfg,
                            labels=torch.tensor(ids))
        np.testing.assert_allclose(tl["logits"].numpy(), np.asarray(jl["logits"]),
                                   atol=2e-4, err_msg=f"prec {prec}")
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)


def test_out_of_vocabulary_ids_match_jax():
    """Ids past the vocabulary (the byte tokenizer's eos 256 and pad 257
    under a vocabulary of 256, as `main_sp --tiny` builds them): the
    embedding reads the last row, as JAX's gather clamps, and such a label
    makes the loss NaN, as JAX's `take_along_axis` fills it. Logits 2e-4
    absolute, loss 1e-5 relative, as above."""
    jcfg, tcfg = _cfgs(True)
    jp = _jax_params(jcfg, seed=2)
    tp = bridge.params_from_numpy(jp, "cpu")
    ids = np.random.default_rng(6).integers(0, 256, (2, 12))
    ids[0, 3], ids[1, 7] = 256, 257
    labels = ids.copy()
    labels[0, 3], labels[1, 7] = -100, -100
    for lab, finite in ((labels, True), (ids, False)):
        jo = J.sp_forward(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids), 2, jcfg,
                          labels=jnp.asarray(lab))
        to = tsp.sp_forward(tp, torch.tensor(ids), 2, tcfg, labels=torch.tensor(lab))
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                                   atol=2e-4)
        assert np.isfinite(float(jo["loss"])) == finite
        np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]), rtol=1e-5)
