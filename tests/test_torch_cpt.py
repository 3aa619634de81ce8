"""PyTorch port, cyclic-precision training: `quantize_gradient`, the
scheduler and the precision range test, `cpt_forward`, the calibration
tables and gradient-quantizer scales, two `make_cpt_train_step` steps and
greedy `cpt_generate`, each held against the JAX package on the CPU.

Tiny config: L = 2, n_embd 32, n_head 2, vocab 256, n_positions 64, LoRA
rank 4 / alpha 8, bits (3, 4, 5, 6, 7, 8, 32), log quantizers (the CPT
default), float32 unless stated. B = 2, T = 32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import cpt_model as jcm
from llm_qat_tpu.quant import functional as jf
from llm_qat_tpu.train import cpt_trainer as jct
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import cpt_model as tcm
from llm_qat_tpu_torch.quant import functional as tf
from llm_qat_tpu_torch.train import cpt_trainer as tct
from llm_qat_tpu_torch.train import optim

B, T = 2, 32
MODEL = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
BITS = (3, 4, 5, 6, 7, 8, 32)
LINEARS = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


def configs(**kw):
    kw = dict(bit_widths=BITS, lora_rank=4, lora_alpha=8) | kw
    return (J.CPTConfig(model=J.GPT2Config(**MODEL), **kw),
            tc.CPTConfig(model=tc.GPT2Config(**MODEL), **kw))


def _linears(p):
    return [p["blocks"][n] for n in LINEARS] + [p["lm_head"]]


def clear_log_ties(p, bits, margin=0.02):
    """Moves every base weight within `margin` of a rounding boundary of a
    log slot's code grid 2·margin codes away from it (XLA's and PyTorch's
    float32 log2 may differ by an ulp, and such a weight would take
    neighbouring codes in the two packages). The extremes, which set the
    calibrated range, sit on the grid's ends and never move."""
    for lin in _linears(p):
        stacked = lin["w"].ndim == 3
        w = lin["w"].astype(np.float64)
        for slot, b in enumerate(bits):
            if b >= 32:
                continue
            n = 2.0 ** (b - 1) - 1
            pick = (lambda t: t[:, slot][:, None]) if stacked else (lambda t: t[slot][None])
            lmin, lrange = pick(lin["wq_zp"]), pick(lin["wq_scale"])
            la = np.log2(np.maximum(np.abs(w), 1e-5))
            pos = (np.clip((la - lmin) / lrange, 0, 1) - 0.5) * 2 * n
            near = np.abs(pos - np.floor(pos) - 0.5) < margin
            w = np.where(near, w * 2.0 ** (-2 * margin * lrange / (2 * n)), w)
        lin["w"] = w.astype(np.float32)
    return p


def _init(jcfg, seed):
    """JAX init with non-zero LoRA B (numpy tree)."""
    p = jax.tree.map(np.asarray, jcm.init_cpt_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lin in _linears(p):
        lin["lora_B"] = rng.normal(0, 0.05, lin["lora_B"].shape).astype(np.float32)
    return p


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (restored
    after the module): pytest-xdist runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """JAX's init, calibrated at every bit (weights, inputs, gradient
    quantizers; by the port's manager, which the calibration tests hold
    against JAX's), clear of log-grid ties, as a numpy tree; and a batch."""
    jcfg, tcfg = configs()
    rng = np.random.default_rng(0)
    cal = [torch.tensor(rng.integers(0, 256, (B, T))) for _ in range(2)]
    mgr = tct.CPTCalibrationManager(tcfg, 2)
    tp = bridge.params_from_numpy(_init(jcfg, 0), "cpu")
    for b in BITS:
        tp = mgr.ensure_calibrated(tp, b, cal)
    tp = mgr.calibrate_gradient_quantizers(tp, cal[0])
    p = clear_log_ties(bridge.params_to_numpy(tp), BITS)
    ids = rng.integers(0, 256, (B, T))
    return jcfg, tcfg, p, ids


@pytest.fixture(scope="module")
def jax_forward():
    """One jitted JAX forward for every slot (the slot is traced)."""
    def fwd(params, ids, prec, mask, cfg):
        out = jcm.cpt_forward(params, ids, prec, cfg, labels=ids, attention_mask=mask)
        return out["logits"], out["loss"]

    return jax.jit(fwd, static_argnums=(4,))


# ---------------------------------------------------------------------------
# quantize_gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,bits", [(jf.KIND_MINMAX, 8), (jf.KIND_MINMAX, 4),
                                       (jf.KIND_LOG, 8), (jf.KIND_MINMAX, 32)])
def test_quantize_gradient_matches_jax(kind, bits):
    """Forward: the identity, bit for bit. Cotangent: fake_quant(g) with the
    given operands; the quantizer operands get no gradient. minmax is
    exact (the same round-half-even grid); log goes through log2/exp2,
    whose float32 results may differ by an ulp: within 1e-6 relative."""
    rng = np.random.default_rng(bits + 10 * kind)
    x = rng.normal(0, 1, (6, 4)).astype(np.float32)
    g = rng.normal(0, 1e-3, (6, 4)).astype(np.float32)
    if kind == jf.KIND_LOG:
        la = np.log2(np.maximum(np.abs(g), 1e-5))
        zp = np.float32(la.min())
        scale = np.float32(la.max() - la.min())
    else:
        scale = np.float32(np.abs(g).max() / 100.0)
        zp = np.float32(0.0)
    s2 = np.full((1, 1), scale, np.float32)
    z2 = np.full((1, 1), zp, np.float32)

    jy, vjp = jax.vjp(lambda a: jf.quantize_gradient(a, s2, z2, jnp.float32(bits),
                                                     jnp.float32(kind)), jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    ts = torch.tensor(s2, requires_grad=True)
    ty = tf.quantize_gradient(tx, ts, torch.tensor(z2), float(bits), float(kind))
    ty.backward(torch.tensor(g))
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    if kind == jf.KIND_LOG:
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6)
    else:
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jg))
    if bits < 32:
        assert not np.array_equal(tx.grad.numpy(), g)  # it did quantize
    assert ts.grad is None


# ---------------------------------------------------------------------------
# Scheduler and precision range test (pure Python)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [((4, 6, 8), "cosine", 32, 4),
                                  ((4, 8), "triangular", 8, 1),
                                  ((4, 8), "cosine", 4, 8),
                                  ((2, 5, 9), "cosine", 100, 10),
                                  (tuple(range(2, 19)), "triangular", 150, 15),
                                  (tuple(range(2, 19)), "cosine", 150, 15)])
def test_scheduler_matches_jax(args):
    """Every epoch's bit-width (cosine, triangular, fractional cycles,
    rounding to the configured bits) equals the JAX scheduler's."""
    j, t = jct.CyclicPrecisionScheduler(*args), tct.CyclicPrecisionScheduler(*args)
    got = [t.get_precision_for_epoch(e) for e in range(args[2])]
    assert got == [j.get_precision_for_epoch(e) for e in range(args[2])]
    assert set(got) <= set(args[0])


def test_scheduler_unknown_type_raises():
    s = tct.CyclicPrecisionScheduler((4, 8), "bogus", 10, 2)
    with pytest.raises(ValueError, match="Unknown schedule type"):
        s.get_precision_for_epoch(0)


PRT_CURVES = {
    "jump": {3: 0.10, 4: 0.11, 5: 0.50, 6: 0.52, 7: 0.53, 8: 0.53},
    "plateau": {3: 0.10, 4: 0.1002, 5: 0.1003, 6: 0.1004, 7: 0.2, 8: 0.2},
    "fallback": {3: 0.10, 4: 0.105, 5: 0.11, 6: 0.12, 7: 0.125, 8: 0.13},
    "zeros": {b: 0.0 for b in range(3, 9)},
}


@pytest.mark.parametrize("curve", sorted(PRT_CURVES))
@pytest.mark.parametrize("threshold,target", [(0.5, 5), (0.03, 8), (0.1, 4)])
def test_prt_matches_jax(curve, threshold, target):
    """`find_bounds` on injected accuracy curves (a jump, a plateau, slow
    growth into the fallback, all zeros) equals JAX's, with the same eval
    calls in the same order."""
    acc = PRT_CURVES[curve]
    bounds, calls = [], []
    for mod in (jct, tct):
        seen = []

        def eval_fn(bits, batch, seen=seen):
            seen.append((bits, batch))
            return acc[bits] * 1000, 1000, 1.0 + batch

        prt = mod.PrecisionRangeTest(eval_fn, start_bits=3, max_bits=8,
                                     threshold=threshold, test_iterations=2,
                                     target_bits=target)
        bounds.append(prt.find_bounds([0, 1, 2]))
        calls.append(seen)
    assert bounds[0] == bounds[1]
    assert calls[0] == calls[1]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


# Each (batch, position) row's logits within 2e-6 of max |logits| and the
# loss within 2e-6 relative at every slot (float32 summation order; measured
# up to 6.3e-7 and 5.1e-7 with the weights clear of log ties). Every slot
# quantizes its activations through log2/exp2, whose float32 results differ
# by an ulp between XLA and PyTorch: an activation that close to a code
# boundary takes the neighbouring code in the other package and moves the
# rows after it. So at most 5 % of the rows may exceed 2e-6, none 2e-3
# (measured: one row of 64, 3.5e-4, at the 8-bit slot with the mask).
LOGIT_REL, LOSS_REL = 2e-6, 2e-6
FLIP_ROWS, FLIP_MAX = 0.05, 2e-3


@pytest.mark.parametrize("masked", [False, True])
def test_cpt_forward_matches_jax_at_every_slot(setup, jax_forward, masked):
    """Logits and loss at every slot, without and with a padding mask (the
    additive (1 - mask)·(-10000) after the causal -1e30)."""
    jcfg, tcfg, p, ids = setup
    mask = np.ones((B, T), np.float32)
    mask[1, -5:] = 0
    m = mask if masked else None
    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, "cpu")
    with torch.no_grad():
        for slot in range(len(BITS)):
            jl, jloss = jax_forward(jp, jnp.asarray(ids), jnp.int32(slot),
                                    None if m is None else jnp.asarray(m), jcfg)
            out = tcm.cpt_forward(tp, torch.tensor(ids), slot, tcfg,
                                  labels=torch.tensor(ids),
                                  attention_mask=None if m is None else torch.tensor(m))
            jl = np.asarray(jl)
            rows = np.abs(out["logits"].numpy() - jl).max(-1) / np.abs(jl).max()
            assert (rows > LOGIT_REL).mean() <= FLIP_ROWS, f"slot {slot}: {rows.max():.2e}"
            assert rows.max() <= FLIP_MAX, f"slot {slot}: {rows.max():.2e}"
            np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=LOSS_REL)
    if masked:  # the mask moves the logits of the rows it pads after
        with torch.no_grad():
            plain = tcm.cpt_forward(tp, torch.tensor(ids), 2, tcfg)["logits"]
        assert not torch.allclose(plain[1, -1], out["logits"][1, -1])


def test_cpt_forward_bf16_matches_jax(setup, jax_forward):
    """compute_dtype="bfloat16" at the 7-bit slot: operands rounded to bf16
    before each product (the LoRA product rounded between its two dots),
    float32 sums. A float32 difference of an ulp moves a value across a
    bf16 rounding now and then, and through the log codes that moves the
    rows after it: at most 10 % of the rows beyond 1e-4 of max |logits|,
    none beyond 1e-1 (measured: 4.7 %, 2.5e-2, in the last three positions
    of one sequence); loss within 5e-5 relative (measured 6.7e-6)."""
    jcfg, tcfg, p, ids = setup
    jb = dataclasses.replace(jcfg, compute_dtype="bfloat16")
    tb = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    slot = BITS.index(7)
    jl, jloss = jax_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(ids),
                            jnp.int32(slot), None, jb)
    with torch.no_grad():
        out = tcm.cpt_forward(bridge.params_from_numpy(p, "cpu"), torch.tensor(ids),
                              slot, tb, labels=torch.tensor(ids))
    jl = np.asarray(jl)
    rows = np.abs(out["logits"].numpy() - jl).max(-1) / np.abs(jl).max()
    assert (rows > 1e-4).mean() <= 0.1 and rows.max() <= 1e-1, rows.max()
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=5e-5)


def test_ids_past_the_vocabulary(setup, jax_forward):
    """An id past the vocabulary reads the last embedding row (JAX's gather
    clamps), and as a label makes the loss NaN, in both packages."""
    jcfg, tcfg, p, ids = setup
    ids = ids.copy()
    ids[0, 3] = 257
    jl, jloss = jax_forward(jax.tree.map(jnp.asarray, p), jnp.asarray(ids),
                            jnp.int32(6), None, jcfg)
    with torch.no_grad():
        to = tcm.cpt_forward(bridge.params_from_numpy(p, "cpu"), torch.tensor(ids), 6,
                             tcfg, labels=torch.tensor(ids))
    jl = np.asarray(jl)
    assert np.abs(to["logits"].numpy() - jl).max() / np.abs(jl).max() <= LOGIT_REL
    assert np.isnan(float(jloss)) and torch.isnan(to["loss"])


def test_init_cpt_params_layout():
    """The port's init from a torch.Generator: JAX's names, shapes and
    dtypes; LoRA B and biases zero, every scale bank one."""
    jcfg, tcfg = configs()
    jp = jax.tree.map(np.asarray, jcm.init_cpt_params(jax.random.PRNGKey(0), jcfg))
    tp = tcm.init_cpt_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jl = {tuple(k.key for k in path): a
          for path, a in jax.tree_util.tree_leaves_with_path(jp)}
    tl = dict(optim.leaves_with_paths(tp))
    assert sorted(jl) == sorted(tl)
    for path, a in jl.items():
        t = tl[path]
        assert tuple(t.shape) == a.shape and str(t.dtype) == "torch." + str(a.dtype), path
        if path[-1] in ("lora_B", "b", "wq_zp", "iq_zp", "gq_zp_A", "gq_zp_B"):
            assert not t.any(), path
        if path[-1] in ("wq_scale", "iq_scale", "gq_scale_A", "gq_scale_B", "g"):
            assert bool((t == 1).all()), path
    a = tp["blocks"]["c_attn"]["lora_A"]
    assert float(a.abs().max()) <= 0.5 and float(a.std()) > 0.1  # U(±1/sqrt(4))
    assert abs(float(tp["wte"].std()) - 0.02) < 2e-3


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _leaf_err(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("kind,per_channel", [("log", True), ("minmax", True),
                                               ("log", False)])
def test_calibration_tables_match_jax(kind, per_channel):
    """The weight and input banks after `calibrate_weights` and
    `calibrate_inputs` at every bit, from the same parameters and batches
    (two of three folded). Weight banks: 2 ulps at 16 (4e-6). Input banks:
    minmax (activation min/max, and their scale) within 1e-5 of the
    largest entry; log: within 4e-3 in log2 units, since log_min comes
    from the smallest |activation|, a cancellation residue that a float32
    ulp upstream moves by up to 0.3 % (measured 2.8e-3). Per-tensor banks
    keep one channel. The 32-bit slot and every other leaf are bit for bit
    unchanged. `ensure_calibrated` is these two calls, once per bit."""
    jcfg, tcfg = configs(quantizer_kind=kind, per_channel=per_channel)
    p = _init(jcfg, 2)
    rng = np.random.default_rng(2)
    cal = [rng.integers(0, 256, (B, T)) for _ in range(3)]
    jm, tm = jct.CPTCalibrationManager(jcfg, 2), tct.CPTCalibrationManager(tcfg, 2)
    jp = jm.calibrate_weights(jax.tree.map(jnp.asarray, p), BITS)
    jp = jm.calibrate_inputs(jp, [jnp.asarray(c) for c in cal], BITS)
    tp = tm.calibrate_weights(bridge.params_from_numpy(p, "cpu"), BITS)
    tp = tm.calibrate_inputs(tp, [torch.tensor(c) for c in cal], BITS)
    iq_tol = 4e-3 if kind == "log" else 1e-5
    for path, a in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp)):
        path = tuple(k.key for k in path)
        t = optim.get_leaf(tp, path).numpy()
        name = path[-1]
        assert t.shape == a.shape, path
        if name.startswith("wq"):
            assert _leaf_err(t, a) <= 4e-6, path
        elif name.startswith("iq"):
            assert _leaf_err(t, a) <= iq_tol * max(1.0, np.abs(a).max()), path
        else:
            np.testing.assert_array_equal(t, a, err_msg=str(path))
        if name.endswith("scale"):
            assert np.all(t[..., -1, :] == 1.0), path
            assert t.shape[-1] == 1 or per_channel, path
    # ensure_calibrated: the two calls at one bit, once, never at 32, and
    # no other slot written (the input stats are taken at slot 0's weight
    # quantizer, calibrated or not, as in JAX)
    tm2 = tct.CPTCalibrationManager(tcfg, 2)
    tcal = [torch.tensor(c) for c in cal]
    t5 = tm2.ensure_calibrated(bridge.params_from_numpy(p, "cpu"), 5, tcal)
    assert tm2.ensure_calibrated(t5, 5, []) is t5 and tm2.calibrated == {5}
    assert tm2.ensure_calibrated(t5, 32, []) is t5
    want = tm.calibrate_inputs(tm.calibrate_weights(bridge.params_from_numpy(p, "cpu"),
                                                    [5]), tcal, [5])
    one = BITS.index(5)
    others = [i for i in range(len(BITS)) if i != one]
    for lt, lw in zip(_linears(t5), _linears(want)):
        for k in ("wq_scale", "wq_zp", "iq_scale", "iq_zp"):
            assert torch.equal(lt[k], lw[k]), k
            assert bool((lt[k][..., others, :] == (1.0 if "scale" in k else 0.0)).all())


def test_gradient_quantizer_scales_match_jax():
    """One 32-bit backward for the LoRA gradients. Where lora_B is 0, as at
    init (here c_attn's and attn_proj's), A's gradient is 0, so gq_scale_A
    is eps/127 exactly in both packages; every other scale within 1e-5
    relative (float32 sums; measured 5e-7), zero points 0, and the LoRA
    leaves come back without grad."""
    jcfg, tcfg = configs()
    p = _init(jcfg, 4)
    for n in ("c_attn", "attn_proj"):
        p["blocks"][n]["lora_B"][:] = 0.0
    ids = np.random.default_rng(4).integers(0, 256, (B, T))
    jp = jct.CPTCalibrationManager(jcfg).calibrate_gradient_quantizers(
        jax.tree.map(jnp.asarray, p), jnp.asarray(ids))
    tp = tct.CPTCalibrationManager(tcfg).calibrate_gradient_quantizers(
        bridge.params_from_numpy(p, "cpu"), torch.tensor(ids))
    eps_scale = np.float32(1e-5) / np.float32(127)
    for name, lt, lj in zip(LINEARS + ("lm_head",), _linears(tp),
                            _linears(jax.tree.map(np.asarray, jp))):
        for k in ("gq_scale_A", "gq_scale_B", "gq_zp_A", "gq_zp_B"):
            assert tuple(lt[k].shape) == lj[k].shape, k
            np.testing.assert_allclose(lt[k].numpy(), lj[k], rtol=1e-5, err_msg=k)
        zero_b = name in ("c_attn", "attn_proj")
        assert np.all(lj["gq_scale_A"] == eps_scale) == zero_b, name
        assert bool((lt["gq_scale_A"] == eps_scale).all()) == zero_b, name
        assert not lt["lora_A"].requires_grad and not lt["lora_B"].requires_grad
    assert tp["blocks"]["c_attn"]["gq_scale_A"].shape == (2, 1, 1)
    assert tp["lm_head"]["gq_scale_B"].shape == (1, 1)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def test_trainable_mask_matches_jax(setup):
    _, _, p, _ = setup
    jm = jct.cpt_trainable_mask(p)
    jl = {tuple(k.key for k in path): m
          for path, m in jax.tree_util.tree_leaves_with_path(jm)}
    tl = dict(optim.leaves_with_paths(tct.cpt_trainable_mask(p)))
    assert jl == tl
    assert sorted(path for path, m in tl.items() if m) == sorted(
        [("blocks", n, k) for n in LINEARS for k in ("lora_A", "lora_B")]
        + [("blocks", ln, k) for ln in ("ln1", "ln2") for k in ("g", "b")]
        + [("lm_head", "lora_A"), ("lm_head", "lora_B"), ("ln_f", "b"), ("ln_f", "g")])


# Relative limits, each about 10x the spread measured over the two steps at
# the 5-bit log slot: loss 5e-6 (measured 1.7e-7), grad_norm 5e-6 (1.2e-7),
# lr 1e-6. Each trainable leaf's update within 2e-3 of its largest
# magnitude: with Adam's eps 1e-8 an update is about ±lr whatever the
# gradient's size, and an element whose gradient is near eps moves by a
# fraction of lr that a float32 difference in the gradient shifts
# (measured 5.1e-4 at one element of ln1's g in the first step, 1.2e-5
# elsewhere). Frozen leaves bit for bit unchanged.
STEP_RTOL = {"loss": 5e-6, "grad_norm": 5e-6, "lr": 1e-6}
STEP_UPDATE_TOL = 2e-3


def test_two_train_steps_match_jax(setup):
    """Two steps of both packages from the same parameters, at the 5-bit
    slot with the LoRA gradients quantized to 8 bits: loss, `grad_norm`
    (over every leaf's gradient, the frozen base linears, the head and
    wte/wpe included, as JAX reports it), lr, the updated trainable leaves,
    and the frozen leaves unchanged."""
    jcfg, tcfg, p, _ = setup
    rng = np.random.default_rng(5)
    j_init, j_step = jct.make_cpt_train_step(jcfg, learning_rate=1e-2, total_steps=10)
    t_init, t_step = tct.make_cpt_train_step(tcfg, learning_rate=1e-2, total_steps=10)
    j_state = j_init(jax.tree.map(jnp.asarray, p))
    t_state = t_init(bridge.params_from_numpy(p, "cpu"))
    t_params0 = t_state["params"]
    j_step = jax.jit(j_step)
    mask = dict(optim.leaves_with_paths(tct.cpt_trainable_mask(p)))
    slot = BITS.index(5)
    for step in range(2):
        ids = rng.integers(0, 256, (B, T))
        j_old, t_old = j_state["params"], t_state["params"]
        j_state, jm = j_step(j_state, jnp.asarray(ids), jnp.int32(slot))
        t_state, tm = t_step(t_state, torch.tensor(ids), slot)
        assert t_state["step"] == int(j_state["step"]) == step + 1
        want_lr = 0.5 * 1e-2 * (1 + np.cos(np.pi * step / 10))
        for key, rtol in STEP_RTOL.items():
            want = float(jm[key]) if key in jm else want_lr
            np.testing.assert_allclose(float(tm[key]), want, rtol=rtol,
                                       err_msg=f"step {step} {key}")
        for path, trainable in mask.items():
            jn, tn = optim.get_leaf(j_state["params"], path), optim.get_leaf(t_state["params"], path)
            if not trainable:
                assert tn is optim.get_leaf(t_params0, path), path
                np.testing.assert_array_equal(np.asarray(jn), optim.get_leaf(p, path))
                continue
            dj = np.asarray(jn) - np.asarray(optim.get_leaf(j_old, path))
            dt = (tn - optim.get_leaf(t_old, path)).numpy()
            err = np.abs(dt - dj).max() / np.abs(dj).max()
            assert err <= STEP_UPDATE_TOL, f"step {step} {path}: {err:.2e}"
    assert int(t_state["opt_state"].count) == 2


def test_grad_norm_counts_the_frozen_leaves(setup):
    """The step's grad_norm is over every gradient: the norm of the
    trainable leaves alone (what the clip uses) is smaller, and adding the
    frozen leaves' gradients (base w/b, lm_head, wte, wpe) gives it."""
    _, tcfg, p, ids = setup
    tp = bridge.params_from_numpy(p, "cpu")
    slot = BITS.index(5)
    init, step = tct.make_cpt_train_step(tcfg, learning_rate=1e-3)
    _, m = step(init(tp), torch.tensor(ids), slot)
    live = optim.replace_leaves(tp, {
        path: optim.get_leaf(tp, path).clone().requires_grad_(True)
        for path, _ in optim.leaves_with_paths(tp)})
    loss = tcm.cpt_forward(live, torch.tensor(ids), slot, tcfg, labels=torch.tensor(ids),
                           grad_quant=True)["loss"]
    loss.backward()
    mask = dict(optim.leaves_with_paths(tct.cpt_trainable_mask(tp)))
    grads = {path: optim.get_leaf(live, path).grad for path in mask}
    train_norm = optim.global_norm([grads[q] for q, tr in mask.items() if tr])
    all_norm = optim.global_norm([g for g in grads.values() if g is not None])
    assert float(train_norm) < 0.5 * float(m["grad_norm"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(all_norm), rtol=1e-6)
    for path, g in grads.items():  # the quantizer banks take no gradient
        if path[-1] in tct._QUANTIZER_LEAVES:
            assert g is None or not g.any(), path


# ---------------------------------------------------------------------------
# Generation
# ---------------------------------------------------------------------------


def test_greedy_generate_matches_jax(setup):
    """Greedy tokens at the 8-bit slot equal JAX's, and generation stops at
    n_positions (64): a 61-token prompt gets 3 of its 5 new tokens."""
    jcfg, tcfg, p, _ = setup
    prompt = np.random.default_rng(61).integers(0, 256, (2, 61))
    slot = BITS.index(8)
    jo = jcm.cpt_generate(jax.tree.map(jnp.asarray, p), jnp.asarray(prompt), slot, jcfg,
                          max_new_tokens=5, do_sample=False)
    to = tcm.cpt_generate(bridge.params_from_numpy(p, "cpu"), torch.tensor(prompt), slot,
                          tcfg, max_new_tokens=5, do_sample=False)
    assert tuple(to.shape) == (2, MODEL["n_positions"])
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_sampled_generate_is_seeded():
    """Sampled tokens come from the given generator: the same seed gives
    the same tokens."""
    _, tcfg = configs()
    tp = tcm.init_cpt_params(torch.Generator().manual_seed(1), tcfg, device="cpu")
    prompt = torch.randint(0, 256, (2, 4), generator=torch.Generator().manual_seed(2))
    runs = [tcm.cpt_generate(tp, prompt, 2, tcfg, max_new_tokens=6, temperature=0.7,
                             generator=torch.Generator().manual_seed(s))
            for s in (3, 3)]
    assert torch.equal(runs[0], runs[1]) and tuple(runs[0].shape) == (2, 10)
    assert torch.equal(runs[0][:, :4], prompt)


def test_bridge_round_trip_cpt_and_qa_trees():
    """CPT and QA trees (JAX init) through the bridge and back, leaf for
    leaf: same paths, dtypes, shapes and values."""
    jcfg, _ = configs()
    trees = [jcm.init_cpt_params(jax.random.PRNGKey(0), jcfg),
             J.init_qa_params(jax.random.PRNGKey(1), J.tiny_test_config((4, 8, 32)))]
    for tree in trees:
        tree = jax.tree.map(np.asarray, tree)
        back = bridge.params_to_numpy(bridge.params_from_numpy(tree, "cpu"))
        flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
        flat_a = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat_a) == len(flat_b)
        for path, a in flat_a:
            b = flat_b[path]
            assert a.dtype == b.dtype and a.shape == b.shape, path
            np.testing.assert_array_equal(a, b)
