"""PyTorch port: quantize_for_inference, the exact integer dots, and the
dense-cache prefill (S < 128 dense attention, S = 128 the flash branch),
against the JAX package on the CPU (JAX's flash kernel in interpret mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import inference as ji
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.ops.attention import flash_attention, flash_attention_plain

L, D_MODEL, H, R, V = 2, 128, 2, 4, 256


def _cfgs(compute_dtype="bfloat16"):
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: R for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * R for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=D_MODEL, n_layer=L, n_head=H)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                            compute_dtype=compute_dtype),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                             compute_dtype=compute_dtype))


@pytest.fixture(scope="module")
def calibrated():
    """JAX-calibrated params (random LoRA B so LoRA is live) in both forms."""
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    pn = jax.tree.map(np.asarray, p)
    return jcfg, tcfg, p, bridge.params_from_numpy(pn, "cpu")


@pytest.mark.parametrize("bits,fmt,head", [
    (4, "int4_xla", 4), (4, "int4_xla", 8), (8, "int8_xla", 4),
    (8, "int8_xla", 8), (4, "dense", None)])
def test_quantize_for_inference_matches_jax(calibrated, bits, fmt, head):
    """Every tensor of the inference tree. Integer codes, scales and the
    bf16 casts are exact; the LoRA fake-quant divides by the same scales,
    so everything is compared bit for bit."""
    jcfg, tcfg, jp, tp = calibrated
    want = ji.quantize_for_inference(jp, jcfg, bits, weight_format=fmt,
                                     lm_head_bits=head)
    got = ti.quantize_for_inference(tp, tcfg, bits, weight_format=fmt,
                                    lm_head_bits=head)
    assert tuple(want.pop("_static")) == tuple(got.pop("_static"))
    want = jax.tree.map(np.asarray, want)
    paths = jax.tree_util.tree_leaves_with_path(want)
    assert len(paths) == len(jax.tree_util.tree_leaves(
        bridge.params_to_numpy(got)))
    for path, a in paths:
        b = got
        for k in path:
            b = b[k.key]
        assert tuple(b.shape) == a.shape, path
        assert str(b.dtype).split(".")[-1] == a.dtype.name, (path, b.dtype, a.dtype)
        np.testing.assert_array_equal(b.float().numpy(), np.asarray(a, np.float32),
                                      err_msg=str(path))


def test_int8_dot_exact_past_two_to_the_24():
    """K=3072 at ±127 codes reaches 4.9e7 > 2^24: the K-split keeps the s32
    dot exact (compared with int64 numpy)."""
    rng = np.random.default_rng(1)
    x = np.full((2, 3, 3072), 1.0, np.float32)
    x[..., ::7] = -1.0
    w = rng.integers(-127, 128, (3072, 16)).astype(np.int8)
    w[:, 0] = 127
    got = ti._int8_dot(torch.tensor(x), torch.tensor(w), torch.ones(16),
                       x_s=torch.tensor(1.0 / 127.0))
    codes = np.clip(np.round(x * 127.0), -127, 127).astype(np.int64)
    want = (codes @ w.astype(np.int64)).astype(np.float32) * np.float32(1.0 / 127.0)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.abs(codes @ w.astype(np.int64)).max() > 2 ** 24


@pytest.mark.parametrize("S", [40, 128])
def test_prefill_logits_match_jax(calibrated, S):
    """Dense-cache prefill of the W4A4 tree with the int4 head. S=128 takes
    the flash branch (JAX: `flash_attention(interpret=True)`; port: the
    flash wrapper's plain version on the CPU). Tolerance: at most 1% of the
    O(1) logits differ by more than 1e-5, none by more than 1e-2, and ≥ 99%
    of the argmaxes agree — float32 attention sums in another order can flip
    a bf16 rounding, and a flipped activation code (±7 in the linears, ±127
    in the head) moves a logit by one code step."""
    jcfg, tcfg, jp, tp = calibrated
    jt = ji.quantize_for_inference(jp, jcfg, 4, weight_format="int4_xla",
                                   lm_head_bits=4)
    jstatic = jt.pop("_static")
    tt = ti.quantize_for_inference(tp, tcfg, 4, weight_format="int4_xla",
                                   lm_head_bits=4)
    tstatic = tt.pop("_static")
    ids = np.random.default_rng(S).integers(0, V, (2, S))
    jc = ji.init_layer_caches(jcfg, 2, 160, jnp.bfloat16)
    jl, jc, _ = ji.infer_forward_unrolled(jt, jnp.asarray(ids), jcfg, jc,
                                          jnp.int32(0), static=jstatic,
                                          initial_prefill=True,
                                          attn_interpret=True)
    tcaches = ti.init_layer_caches(tcfg, 2, 160, torch.bfloat16, device="cpu")
    tl, tcaches, n = ti.infer_forward_unrolled(tt, torch.tensor(ids), tcfg,
                                               tcaches, 0, static=tstatic,
                                               initial_prefill=True)
    assert n == S
    jl, tl = np.asarray(jl), tl.numpy()
    err = np.abs(tl - jl)
    print("prefill logits: max err", err.max(), "share > 1e-5", (err > 1e-5).mean())
    assert err.max() <= 1e-2 and (err > 1e-5).mean() <= 0.01
    assert (tl.argmax(-1) == jl.argmax(-1)).mean() >= 0.99
    # the caches hold the same rows
    for a, b in zip(jc, tcaches):
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=2e-2, rtol=2 ** -7)


def test_flash_plain_matches_jax_interpret():
    """The flash wrapper on CPU tensors (its plain version) against the JAX
    Pallas kernel in interpret mode, float32, T = 256: 2e-6 absolute
    (softmax sums in another order)."""
    from llm_qat_tpu.ops.attention import flash_attention as jflash

    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 1, (1, 2, 256, 64)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True))
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    # ragged T: the plain version needs no padding (the kernel masks the tail)
    got_r = flash_attention_plain(*(torch.tensor(t[:, :, :200]) for t in (q, k, v)))
    np.testing.assert_allclose(got_r.numpy(), want[:, :, :200], atol=2e-6)
