"""PyTorch port: pack_mega_weights and mega_decode_step_kv8 against the JAX
megakernel `mega_decode_step_kv8(interpret=True)` on the CPU.

Tiny config (L=2, d=128, H=2, head_dim 64, r=4). Each case starts from the
same random KV prefix (codes and per-row scales) and runs three steps at
pos 37, 38, 47 with tbp=16, so the attention streams full and partial
blocks and the p-quantization block partition matters. The JAX scale
layout (L, T, 128) is converted to the port's (L, B, T)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import inference as ji
from llm_qat_tpu.ops import mega_decode as jm
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.ops import mega_decode as tm

L, D_MODEL, H, R, V, B, T, TBP = 2, 128, 2, 4, 256, 3, 64, 16
POSITIONS = (37, 38, 47)


def _cfgs():
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: R for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * R for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=D_MODEL, n_layer=L, n_head=H)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q)))


@pytest.fixture(scope="module")
def calibrated():
    jcfg, tcfg = _cfgs()
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


# (weight bits, kv bits, int8 LoRA banks, has_lora, act dtype, bank dtype);
# the int8-weight cases are in test_torch_mega_decode_int8.py
CASES = {
    "w4kv4_i8lora_f32": (4, 4, True, True, "float32", "float32"),
    "w4kv4_i8lora_bf16": (4, 4, True, True, "bfloat16", "bfloat16"),
    "w8kv8_bf16lora_f32": (8, 8, False, True, "float32", "bfloat16"),
    "w8kv8_nolora_f32": (8, 8, True, False, "float32", "float32"),
}


@pytest.mark.parametrize("case", ["w4kv4_i8lora_f32", "w4kv4_i8lora_bf16"])
def test_mega_step_matches_jax_interpret(calibrated, case):
    run_case(calibrated, case)


def run_case(calibrated, case):
    """One case of CASES against the JAX interpret-mode kernel.

    Tolerances: h_out to 1e-4 absolute (O(1) values): the integer dots
    are exact in both, the float32 LoRA/LN/softmax sums run in another
    order, and the activation codes absorb such ulps except at a rounding
    boundary, which these seeded inputs do not hit. Cache codes appended by
    the step: ≤ 1% may differ, by one code (the new row's float32 value sits
    on a rounding boundary after an ulp-level difference); scales 1e-6
    relative. Everything else in the caches must be untouched."""
    wbits, kv_bits, lora_i8, has_lora, act, bank = CASES[case]
    jcfg, tcfg, jp, tp = calibrated
    bits = 4 if wbits == 4 else 8
    fmt = "int4_xla" if wbits == 4 else "int8_xla"
    jt = ji.quantize_for_inference(jp, jcfg, bits, dtype=getattr(jnp, bank),
                                   weight_format=fmt)
    jt.pop("_static")
    tt = ti.quantize_for_inference(tp, tcfg, bits, dtype=getattr(torch, bank),
                                   weight_format=fmt)
    tt.pop("_static")
    jmw = jm.pack_mega_weights(jt, jcfg, lora_int8=lora_i8)
    tmw = tm.pack_mega_weights(tt, tcfg, lora_int8=lora_i8)
    for f in jm.MegaWeights._fields:
        a, b = np.asarray(getattr(jmw, f)), getattr(tmw, f)
        assert a.shape == tuple(b.shape) and a.dtype.name == str(b.dtype)[6:], f
        np.testing.assert_array_equal(b.float().numpy(), a.astype(np.float32), f)
    assert (tmw.at.dtype == torch.int8) == lora_i8

    rng = np.random.default_rng(wbits * 10 + kv_bits)
    d, qm = D_MODEL, (127 if kv_bits == 8 else 7)
    codes = rng.integers(-qm, qm + 1, (2, L, B, T, d))
    if kv_bits == 4:
        cb = ((codes[..., :d // 2] & 0xF) | (codes[..., d // 2:] << 4)).astype(np.int8)
    else:
        cb = codes.astype(np.int8)
    sc = rng.uniform(0.01, 0.05, (2, L, B, T)).astype(np.float32)
    jsc = np.zeros((2, L, T, 128), np.float32)
    jsc[..., :B] = sc.transpose(0, 1, 3, 2)
    aq = float(np.asarray(jt["blocks"]["c_attn"].get("qmax", [127.0]))[0])
    kw = dict(n_head=H, head_dim=d // H, has_lora=has_lora, aq_max=aq, tbp=TBP,
              kv_bits=kv_bits, tiles_per_step=4)
    jstep = jax.jit(functools.partial(jm.mega_decode_step_kv8, **kw,
                                      act_dtype=getattr(jnp, act), interpret=True))
    jc = [jnp.asarray(cb[0]), jnp.asarray(cb[1]), jnp.asarray(jsc[0]),
          jnp.asarray(jsc[1])]
    tcache = [torch.tensor(cb[0]), torch.tensor(cb[1]), torch.tensor(sc[0]),
              torch.tensor(sc[1])]
    for pos in POSITIONS:
        h = rng.normal(0, 0.5, (B, d)).astype(np.float32)
        jh, *jc = jstep(jnp.asarray(h), jmw, *jc, jnp.int32(pos))
        th, *tcache = tm.mega_decode_step_kv8(
            torch.tensor(h), tmw, *tcache, pos, act_dtype=getattr(torch, act), **kw)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                                   err_msg=f"pos {pos}")
    unpack = (lambda c: np.concatenate([(c.astype(np.int32) << 28) >> 28,
                                        c.astype(np.int32) >> 4], -1)
              if kv_bits == 4 else c.astype(np.int32))
    rows = list(POSITIONS)
    for i in range(2):
        jcodes, tcodes = unpack(np.asarray(jc[i])), unpack(tcache[i].numpy())
        other = np.ones(T, bool)
        other[rows] = False
        np.testing.assert_array_equal(tcodes[:, :, other], jcodes[:, :, other])
        diff = tcodes[:, :, rows] - jcodes[:, :, rows]
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 0.01, case
        jscale = np.asarray(jc[2 + i])[..., :B].transpose(0, 2, 1)
        np.testing.assert_allclose(tcache[2 + i].numpy(), jscale, rtol=1e-6)
