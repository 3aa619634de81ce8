"""PyTorch port, training slice: the straight-through estimators, the
matmul and LayerNorm backwards, the QuantStats fold and CalibrationManager,
each held against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import sp_model as jsp
from llm_qat_tpu.ops.matmul import matmul_bf16 as j_matmul
from llm_qat_tpu.quant import calibration as jcal
from llm_qat_tpu.quant import functional as jf
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.ops.matmul import matmul_bf16 as t_matmul
from llm_qat_tpu_torch.quant import calibration as tcal
from llm_qat_tpu_torch.quant import functional as tf
from llm_qat_tpu_torch.train import calibration_manager as tcm


def _quant_inputs(kind, bits):
    rng = np.random.default_rng(bits * 10 + kind)
    x = rng.normal(0, 1.0, (6, 16)).astype(np.float32)
    x[0, :3] = 0.0
    if kind == jf.KIND_LOG:
        la = np.log2(np.maximum(np.abs(x), 1e-5))
        zp = la.min(axis=0, keepdims=True)
        scale = la.max(axis=0, keepdims=True) - zp
    else:
        scale = np.abs(x).max(axis=0, keepdims=True) / (2.0 ** (bits - 1) - 1)
        zp = np.zeros_like(scale)
    # a cotangent large enough that the log STE's ±10 clamp bites
    g = rng.normal(0, 20.0, x.shape).astype(np.float32)
    return x, scale.astype(np.float32), zp.astype(np.float32), g


def _port_grads(fn, x, operands, g):
    """x's gradient and the quantizer operands' gradients (None when the
    operand took none) through the port's function."""
    xt = torch.tensor(x, requires_grad=True)
    ops = [torch.tensor(o, requires_grad=True) for o in operands]
    fn(xt, *ops).backward(torch.tensor(g))
    return xt.grad.numpy(), [o.grad for o in ops]


CASES = [("fake_quant_minmax", jf.KIND_MINMAX), ("fake_quant_log", jf.KIND_LOG),
         ("fake_quant_flat", jf.KIND_MINMAX), ("fake_quant_flat", jf.KIND_LOG),
         ("fake_quant", jf.KIND_MINMAX), ("fake_quant", jf.KIND_LOG)]


@pytest.mark.parametrize("fn,kind", CASES)
@pytest.mark.parametrize("bits", [4, 8, 32])
def test_ste_gradients_match_jax(fn, kind, bits):
    """The STE gradients are the identity or a clamp of the cotangent, so x's
    gradient is exact. The quantizer operands get zeros in JAX and no
    gradient at all in the port."""
    x, scale, zp, g = _quant_inputs(kind, bits)
    b = np.float32(bits)
    if fn == "fake_quant_minmax":
        jfn = lambda x_, s, z, b_: jf.fake_quant_minmax(x_, s, z, b_)
        tfn = lambda x_, s, z, b_: tf.fake_quant_minmax(x_, s, z, b_)
        operands = (scale, zp, b)
    elif fn == "fake_quant_log":
        jfn = lambda x_, z, s, b_: jf.fake_quant_log(x_, z, s, b_)
        tfn = lambda x_, z, s, b_: tf.fake_quant_log(x_, z, s, b_)
        operands = (zp, scale, b)
    else:
        k = np.float32(kind)
        jfn = lambda x_, s, z, b_, k_: getattr(jf, fn)(x_, s, z, b_, k_)
        tfn = lambda x_, s, z, b_, k_: getattr(tf, fn)(x_, s, z, b_, k_)
        operands = (scale, zp, b, k)
    out, vjp = jax.vjp(jfn, jnp.asarray(x), *(jnp.asarray(o) for o in operands))
    want = vjp(jnp.asarray(g))
    got_x, got_ops = _port_grads(tfn, x, operands, g)
    np.testing.assert_array_equal(got_x, np.asarray(want[0]))
    assert all(np.all(np.asarray(w) == 0) for w in want[1:])
    assert all(o is None for o in got_ops)
    clamped = fn == "fake_quant_log" or (kind == jf.KIND_LOG and bits < 32)
    assert (np.abs(got_x).max() <= 10.0) == clamped


@pytest.mark.parametrize("per_channel", [True, False])
def test_lora_scales_carry_no_gradient(per_channel):
    """A LoRA bank quantized with scales computed from itself gets the STE
    gradient only, as in JAX (where the scale's cotangent is zeroed)."""
    A = np.random.default_rng(0).normal(0, 0.3, (32, 4)).astype(np.float32)
    g = np.random.default_rng(1).normal(0, 1.0, A.shape).astype(np.float32)
    ch = 1 if per_channel else None

    def jfn(a):
        s, z = jcal.dynamic_scale_flat(a, 4.0, jf.KIND_MINMAX, ch)
        return jf.fake_quant_flat(a, s, z, 4.0, jf.KIND_MINMAX)

    want = jax.vjp(jfn, jnp.asarray(A))[1](jnp.asarray(g))[0]
    At = torch.tensor(A, requires_grad=True)
    s, z = tcal.dynamic_scale_flat(At, 4.0, tf.KIND_MINMAX, ch)
    tf.fake_quant_flat(At, s, z, 4.0, tf.KIND_MINMAX).backward(torch.tensor(g))
    np.testing.assert_array_equal(At.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(At.grad.numpy(), g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_bf16_backward_matches_jax(dtype):
    """Both round the operands and the cotangent to the compute dtype the
    same way (round to nearest even), so only float32 summation order
    differs: 1e-5 relative."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 1, (2, 5, 48)).astype(np.float32)
    b = rng.normal(0, 1, (48, 24)).astype(np.float32)
    g = rng.normal(0, 1, (2, 5, 24)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    out, vjp = jax.vjp(lambda x, y: j_matmul(x, y, jdt), jnp.asarray(a), jnp.asarray(b))
    da, db = vjp(jnp.asarray(g))
    at, bt = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    ot = t_matmul(at, bt, getattr(torch, dtype))
    ot.backward(torch.tensor(g))
    np.testing.assert_allclose(ot.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(da), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(db), rtol=1e-5, atol=1e-5)


def test_matmul_bf16_skips_a_frozen_operand():
    """No gradient work for an operand that does not require grad (the
    tied LM head's wte)."""
    a = torch.randn(3, 8, requires_grad=True)
    w = torch.randn(16, 8)
    t_matmul(a, w.T, torch.bfloat16).sum().backward()
    assert a.grad is not None and w.grad is None


def test_layernorm_backward_matches_jax():
    """The hand-written backward against JAX's `_layernorm_cvjp` and
    against the port's own autodiff path, through the (P, d) bank gather:
    float32 sums in another order, 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.normal(0.5, 2.0, (2, 7, 32)).astype(np.float32)
    ln = {"g": rng.normal(1, 0.1, (3, 32)).astype(np.float32),
          "b": rng.normal(0, 0.1, (3, 32)).astype(np.float32)}
    dy = rng.normal(0, 1, x.shape).astype(np.float32)
    f = lambda x_, l_: jsp.switchable_layernorm(x_, l_, 1, 1e-5)
    out, vjp = jax.vjp(f, jnp.asarray(x), jax.tree.map(jnp.asarray, ln))
    jdx, jdl = vjp(jnp.asarray(dy))
    grads = {}
    for impl in ("cvjp", "autodiff"):
        xt = torch.tensor(x, requires_grad=True)
        lt = {k: torch.tensor(v, requires_grad=True) for k, v in ln.items()}
        old, tsp.LN_IMPL = tsp.LN_IMPL, impl
        try:
            ot = tsp.switchable_layernorm(xt, lt, 1, 1e-5)
        finally:
            tsp.LN_IMPL = old
        ot.backward(torch.tensor(dy))
        np.testing.assert_allclose(ot.detach().numpy(), np.asarray(out), rtol=1e-5, atol=1e-5)
        grads[impl] = (xt.grad.numpy(), lt["g"].grad.numpy(), lt["b"].grad.numpy())
        for got, want in zip(grads[impl], (jdx, jdl["g"], jdl["b"])):
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    assert np.all(grads["cvjp"][1][[0, 2]] == 0)


@pytest.mark.parametrize("kind", [jf.KIND_MINMAX, jf.KIND_LOG])
@pytest.mark.parametrize("channel_dim", [None, 0, -1])
@pytest.mark.parametrize("symmetric", [True, False])
def test_quant_stats_fold_matches_jax(kind, channel_dim, symmetric):
    """Three batches folded, then finalized; and the one-shot
    calibrate_tensor. Exact for minmax; log2 may differ by an ulp between
    XLA and PyTorch, so 1e-6 relative."""
    rng = np.random.default_rng(kind * 7 + 2 * ((channel_dim or 0) + 1) + 3 * symmetric)
    xs = [rng.normal(0.2, 1.0, (5, 8)).astype(np.float32) for _ in range(3)]
    js, ts = jcal.init_stats(), tcal.init_stats(device="cpu")
    for x in xs:
        js = jcal.update_stats(js, jnp.asarray(x), channel_dim, kind)
        ts = tcal.update_stats(ts, torch.tensor(x), channel_dim, kind)
    assert int(ts.count) == int(js.count) == 3
    tol = dict(rtol=1e-6, atol=0) if kind == jf.KIND_LOG else dict(rtol=0, atol=0)
    np.testing.assert_allclose(ts.running_min.numpy(), np.asarray(js.running_min), **tol)
    np.testing.assert_allclose(ts.running_max.numpy(), np.asarray(js.running_max), **tol)
    for got, want in zip(tcal.finalize(ts, 4.0, kind, symmetric),
                         jcal.finalize(js, 4.0, kind, symmetric)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    for got, want in zip(tcal.calibrate_tensor(torch.tensor(xs[0]), 8.0, kind, channel_dim, symmetric),
                         jcal.calibrate_tensor(jnp.asarray(xs[0]), 8.0, kind, channel_dim, symmetric)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _cfgs():
    # minmax at both student widths: a log-kind input bank holds log2 of an
    # input's smallest |x|, a near-cancelled sum far from float32 epsilon
    # (test_torch_sp_model.py compares it in the linear domain)
    q = dict(bit_widths=(4, 8, 32), per_channel=True, quantizer_per_bit={8: "minmax"},
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q)))


def test_calibration_manager_matches_jax():
    """calibrate_all_precisions, then the bookkeeping of ensure_calibrated
    and is_calibrated. Banks to 1e-5 relative (the input scales come from
    float32 forwards summed in another order)."""
    jcfg, tcfg = _cfgs()
    jp = J.init_sp_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batches = [np.random.default_rng(i).integers(0, 256, (2, 16)) for i in range(3)]
    jm, tm = jcm.CalibrationManager(jcfg, 2), tcm.CalibrationManager(tcfg, 2)
    want = jm.calibrate_all_precisions(jp, [jnp.asarray(b) for b in batches])
    got = tm.calibrate_all_precisions(tp, [torch.tensor(b) for b in batches])
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want)):
        b = got
        for k in path:
            b = b[k.key]
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-7, err_msg=str(path))
    assert tm.calibrated == jm.calibrated == {4, 8}
    assert all(tm.is_calibrated(b) == jm.is_calibrated(b) for b in (4, 8, 16, 32))
    assert tm.ensure_calibrated(got, 8, batches) is got

    fresh_j, fresh_t = jcm.CalibrationManager(jcfg, 2), tcm.CalibrationManager(tcfg, 2)
    assert not fresh_t.is_calibrated(4) and fresh_t.is_calibrated(32)
    want4 = fresh_j.ensure_calibrated(jp, 4, [jnp.asarray(b) for b in batches])
    got4 = fresh_t.ensure_calibrated(tp, 4, [torch.tensor(b) for b in batches])
    np.testing.assert_allclose(got4["blocks"]["c_fc"]["iq_scale"].numpy(),
                               np.asarray(want4["blocks"]["c_fc"]["iq_scale"]),
                               rtol=1e-5, atol=1e-7)
    assert fresh_t.calibrated == fresh_j.calibrated == {4}
