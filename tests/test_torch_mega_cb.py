"""PyTorch port: the continuous-batching step #4 (`mega_decode_step_cb`)
and `cb_merge_recent` against the JAX package on the CPU (the JAX kernel
in interpret mode). The float-cache step #3 is in test_torch_mega_kv16.py.

Tiny config (L=2, d=128, H=2, head_dim 64, r=4), int8_xla / int4_xla trees
with int8 LoRA banks. The JAX scale layout (L, T, 128), batch on lanes, is
converted to the port's (L, B, T)."""

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

L, D_MODEL, H, R, V, B, T = 2, 128, 2, 4, 256, 3, 64


@pytest.fixture(scope="module")
def calibrated():
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             per_channel=False,
             lora_rank_per_bit={b: R for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * R for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=D_MODEL, n_layer=L, n_head=H)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q))
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    return jcfg, tcfg, p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _weights(calibrated, wbits):
    jcfg, tcfg, jp, tp = calibrated
    fmt = f"int{wbits}_xla"
    jt = ji.quantize_for_inference(jp, jcfg, wbits, dtype=jnp.float32, weight_format=fmt)
    tt = ti.quantize_for_inference(tp, tcfg, wbits, dtype=torch.float32,
                                   weight_format=fmt)
    jt.pop("_static")
    tt.pop("_static")
    aq = float(np.asarray(jt["blocks"]["c_attn"].get("qmax", [127.0]))[0])
    return jm.pack_mega_weights(jt, jcfg), tm.pack_mega_weights(tt, tcfg), aq


def _codes(rng, kv_bits, shape):
    """Random KV cache bytes for rows of shape[-1] lanes: int8 codes, or ±7
    lane-halves nibbles (half as many bytes)."""
    qm = 127 if kv_bits == 8 else 7
    c = rng.integers(-qm, qm + 1, shape)
    if kv_bits == 4:
        d2 = shape[-1] // 2
        c = (c[..., :d2] & 0xF) | (c[..., d2:] << 4)
    return c.astype(np.int8)


def _jax_scales(s):
    """(L, B, T) scales -> the JAX (L, T, 128) layout, batch on lanes."""
    out = np.ones((s.shape[0], s.shape[2], 128), np.float32)
    out[..., :s.shape[1]] = s.transpose(0, 2, 1)
    return out


def _unpack(c, kv_bits):
    c = np.asarray(c).astype(np.int32)
    return np.concatenate([(c << 28) >> 28, c >> 4], -1) if kv_bits == 4 else c


@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("rpos", [0, 5])
def test_cb_step_matches_jax(calibrated, kv_bits, rpos):
    """#4's plain version against the JAX `mega_decode_step_cb` with slot
    lengths [5, 0, 9] (a slot of length 0 keeps its running max at -1e30
    through the main blocks, where both versions must still give exactly
    the recent rows' and the new token's attention) and rpos 0 and 5 in a
    16-row recent buffer (tbp 16). h_out within 1e-4 (float32 sums in
    another order); the main caches are read only; the recent buffer's
    appended codes may differ by one code in at most 1 % of them (an ulp on
    a rounding boundary), its scales within 1e-6 relative, every other
    recent row equal."""
    wbits = 4 if kv_bits == 4 else 8
    jmw, tmw, aq = _weights(calibrated, wbits)
    rng = np.random.default_rng(kv_bits * 10 + rpos)
    TR = 16
    main = [_codes(rng, kv_bits, (L, B, T, D_MODEL)) for _ in range(2)]
    main += [rng.uniform(0.01, 0.05, (L, B, T)).astype(np.float32) for _ in range(2)]
    rec = [_codes(rng, kv_bits, (L, B, TR, D_MODEL)) for _ in range(2)]
    rec += [rng.uniform(0.01, 0.05, (L, B, TR)).astype(np.float32) for _ in range(2)]
    lengths = np.array([5, 0, 9], np.int32)
    h = rng.normal(0, 0.5, (B, D_MODEL)).astype(np.float32)
    kw = dict(n_head=H, head_dim=D_MODEL // H, has_lora=True, aq_max=aq, tbp=16,
              kv_bits=kv_bits, tiles_per_step=4)
    jx = lambda xs: [jnp.asarray(x) for x in xs[:2]] + [jnp.asarray(_jax_scales(x))
                                                       for x in xs[2:]]
    jstep = jax.jit(functools.partial(jm.mega_decode_step_cb, **kw,
                                      act_dtype=jnp.float32, interpret=True))
    jh, *jrec = jstep(jnp.asarray(h), jmw, *jx(main), *jx(rec), jnp.asarray(lengths),
                      jnp.int32(rpos))
    tmain = [torch.tensor(x) for x in main]
    trec = [torch.tensor(x) for x in rec]
    th, *trec = tm.mega_decode_step_cb(torch.tensor(h), tmw, *tmain, *trec, lengths,
                                       rpos, act_dtype=torch.float32, **kw)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    for a, x in zip(tmain, main):
        np.testing.assert_array_equal(a.numpy(), x)
    other = np.arange(TR) != rpos
    for i in range(2):
        got, want = _unpack(trec[i].numpy(), kv_bits), _unpack(jrec[i], kv_bits)
        np.testing.assert_array_equal(got[:, :, other], want[:, :, other])
        diff = got[:, :, rpos] - want[:, :, rpos]
        assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 0.01
        jscale = np.asarray(jrec[2 + i])[..., :B].transpose(0, 2, 1)
        np.testing.assert_array_equal(trec[2 + i].numpy()[:, :, other], jscale[:, :, other])
        np.testing.assert_allclose(trec[2 + i].numpy()[:, :, rpos], jscale[:, :, rpos],
                                   rtol=1e-6)


def test_cb_step_length_zero_slot_is_exact(calibrated):
    """A slot of length 0 with rpos 0 attends to its new token alone: its
    row equals a shared-position step at pos 0 on an empty cache (the
    over-streamed main blocks add nothing), bit for bit."""
    _, tmw, aq = _weights(calibrated, 8)
    rng = np.random.default_rng(5)
    main = [torch.tensor(_codes(rng, 8, (L, B, T, D_MODEL))) for _ in range(2)]
    main += [torch.tensor(rng.uniform(0.01, 0.05, (L, B, T)).astype(np.float32))
             for _ in range(2)]
    rec = [torch.zeros((L, B, 16, D_MODEL), dtype=torch.int8) for _ in range(2)]
    rec += [torch.ones((L, B, 16)) for _ in range(2)]
    h = torch.tensor(rng.normal(0, 0.5, (B, D_MODEL)).astype(np.float32))
    kw = dict(n_head=H, head_dim=D_MODEL // H, has_lora=True, aq_max=aq, tbp=16,
              kv_bits=8, act_dtype=torch.float32)
    got = tm.mega_decode_step_cb(h, tmw, *main, *rec, [40, 0, 64], 0, **kw)[0]
    fresh = [torch.zeros((L, 1, 16, D_MODEL), dtype=torch.int8) for _ in range(2)]
    fresh += [torch.ones((L, 1, 16)) for _ in range(2)]
    want = tm.mega_decode_step_kv8(h[1:2], tmw, *fresh, 0, **kw)[0]
    assert torch.equal(got[1], want[0])


def test_cb_wrappers_check_capacity(calibrated):
    """rpos at or past the recent buffer, or a length past the main cache,
    raises before anything is written (on the card it would write out of
    bounds)."""
    _, tmw, aq = _weights(calibrated, 8)
    main = [torch.zeros((L, B, T, D_MODEL), dtype=torch.int8) for _ in range(2)]
    main += [torch.ones((L, B, T)) for _ in range(2)]
    rec = [torch.zeros((L, B, 16, D_MODEL), dtype=torch.int8) for _ in range(2)]
    rec += [torch.ones((L, B, 16)) for _ in range(2)]
    h = torch.zeros((B, D_MODEL))
    kw = dict(n_head=H, head_dim=D_MODEL // H, has_lora=True, aq_max=aq, tbp=16)
    with pytest.raises(ValueError, match="rpos=16 outside"):
        tm.mega_decode_step_cb(h, tmw, *main, *rec, [1, 2, 3], 16, **kw)
    with pytest.raises(ValueError, match="outside"):
        tm.mega_decode_step_cb(h, tmw, *main, *rec, [1, 65, 3], 0, **kw)
    with pytest.raises(ValueError, match="one stream block"):
        tm.mega_decode_step_cb(h, tmw, *main, *rec, [1, 2, 3], 0,
                               **dict(kw, tbp=8))
    fc = [torch.zeros((L, B, T, D_MODEL)) for _ in range(2)]
    with pytest.raises(ValueError, match="pos=64 outside"):
        tm.mega_decode_step(h, tmw, *fc, 64, **kw)


def test_cb_merge_recent_matches_jax():
    """Integer codes and scales are copied: equal exactly, per slot at its
    length (clipped so the k rows fit), scales converted between layouts."""
    rng = np.random.default_rng(9)
    k, TR = 4, 8
    main = [_codes(rng, 8, (L, B, T, D_MODEL)) for _ in range(2)]
    main += [rng.uniform(0.01, 0.05, (L, B, T)).astype(np.float32) for _ in range(2)]
    rec = [_codes(rng, 8, (L, B, TR, D_MODEL)) for _ in range(2)]
    rec += [rng.uniform(0.01, 0.05, (L, B, TR)).astype(np.float32) for _ in range(2)]
    lengths = np.array([5, 0, 62], np.int32)
    jx = lambda xs: [jnp.asarray(x) for x in xs[:2]] + [jnp.asarray(_jax_scales(x))
                                                       for x in xs[2:]]
    want = jm.cb_merge_recent(*jx(main), *jx(rec), jnp.asarray(lengths), k)
    got = tm.cb_merge_recent(*[torch.tensor(x) for x in main],
                             *[torch.tensor(x) for x in rec], lengths, k)
    for i in range(2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(
            got[2 + i].numpy(), np.asarray(want[2 + i])[..., :B].transpose(0, 2, 1))
