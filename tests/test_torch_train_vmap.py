"""PyTorch port, `student_mode="vmap"`: every student of a train step in
one batched forward (a student axis in front of every activation, the
slots a vector) and one backward, on the CPU.

- Two vmap steps of both packages (the JAX flash kernels in interpret
  mode, the port on their plain versions), JAX's draws replayed.
- The port's vmap step against its scan step from the same generator,
  dropout on, also on every linear path and attention.
- The fused linear under vmap against JAX's, where one student's rows
  pass the fused gate and where only the folded rows of all students
  would.
- The batched pieces (`matmul_bf16`, `sp_linear`, `switchable_layernorm`,
  `sp_forward`, `attention_fn`) against a stack of per-slot calls,
  gradients included.
- The pipelined vmap step on two gloo ranks against the plain vmap step
  (the port against itself: JAX's CPU compile of its pipelined vmap step
  runs for minutes).

Config of test_torch_train_model.py (d = 128, 2 layers, head_dim 64, LoRA
rank 4, bits (4, 8, 32), float32 compute, T = 128, B = 2) unless a test
says otherwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.ops import fused_linear as jfl
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.ops import fused_linear as tfl
from llm_qat_tpu_torch.ops.attention import causal_attention_reference
from llm_qat_tpu_torch.ops.matmul import matmul_bf16
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst
from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
from test_torch_fused_linear import SP_TOL, _linear
from test_torch_fused_linear import _cfgs as linear_cfgs
from test_torch_fused_linear import _rel as rel_np
from test_torch_train_model import LINEARS, B, T, clear_log_ties, configs, live
from test_torch_train_step import RTOL, TRAIN, UPDATE_TOL, _replayed_draws
from torch_parallel_ranks import RankRun

torch.set_num_threads(1)  # beside other xdist workers

VMAP = dict(TRAIN, student_mode="vmap")
SLOTS = [1, 0, 2, 1]  # both student kinds, the teacher slot, a slot twice


def calibrated(jcfg, tcfg, seed, batch=B):
    """JAX init with non-zero LoRA B banks, calibrated by the port (its
    calibration is held against the JAX package's in
    test_torch_train_quant.py), clear of log-grid ties (numpy tree)."""
    jp = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lin in LINEARS:
        b = jp["blocks"][lin]
        b["lora_B"] = rng.normal(0, 0.05, b["lora_B"].shape).astype(np.float32)
    cal = [torch.tensor(rng.integers(0, 256, (batch, T))) for _ in range(2)]
    params = CalibrationManager(tcfg, 2).calibrate_all_precisions(
        bridge.params_from_numpy(jp, "cpu"), cal)
    return clear_log_ties(bridge.params_to_numpy(params), jcfg.quant)


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    return jcfg, tcfg, calibrated(jcfg, tcfg, seed=3)


def _frozen_and_trainable(tree):
    mask = optim.leaves_with_paths(tst.trainable_mask(tree))
    return [p for p, m in mask if not m], [p for p, m in mask if m]


# ---------------------------------------------------------------------------
# Two vmap steps of both packages
# ---------------------------------------------------------------------------


def test_two_vmap_steps_match_jax(setup):
    """Two vmap steps of both packages from the same parameters and batch,
    the JAX step's student slots and feature layers replayed into the
    port's: the metrics within test_torch_train_step.py's RTOL, each
    trainable leaf's update within UPDATE_TOL of its largest magnitude,
    frozen leaves bit for bit unchanged. These are the scan steps' limits:
    the batched step does the same arithmetic. Measured: loss 5.4e-6,
    teacher loss 8.6e-8, student loss 4.4e-4, grad_norm 4.1e-6, updates
    6.6e-4."""
    jcfg, tcfg, jp = setup
    ids = np.random.default_rng(21).integers(0, 256, (B, T))
    jtc, ttc = J.TrainConfig(**VMAP), tc.TrainConfig(**VMAP)
    j_init, j_step = jst.make_sp_train_step(jcfg, jtc)
    t_init, t_step = tst.make_sp_train_step(tcfg, ttc)
    j_state = j_init(jax.tree.map(jnp.asarray, jp))
    t_state = t_init(bridge.params_from_numpy(jp, "cpu"))
    t_params0 = t_state.params
    frozen, trainable = _frozen_and_trainable(jp)
    j_step = jax.jit(j_step)
    seen = set()
    for step in range(2):
        rng = jax.random.PRNGKey(100 + step)
        precs, layers = _replayed_draws(rng, jcfg, jtc)
        seen.update(precs.tolist())
        j_old, t_old = j_state.params, t_state.params
        j_state, jm = j_step(j_state, jnp.asarray(ids), rng)
        t_state, tm = t_step(t_state, torch.tensor(ids), torch.Generator().manual_seed(step),
                             precs=precs, layers=layers)
        np.testing.assert_array_equal(tm["precisions"].numpy(), np.asarray(jm["precisions"]))
        for key, rtol in RTOL.items():
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol,
                                       err_msg=f"step {step} {key}")
        for path in trainable:
            dj = np.asarray(optim.get_leaf(j_state.params, path)) - np.asarray(
                optim.get_leaf(j_old, path))
            dt = (optim.get_leaf(t_state.params, path) - optim.get_leaf(t_old, path)).numpy()
            err = np.abs(dt - dj).max() / np.abs(dj).max()
            assert err <= UPDATE_TOL, f"step {step} {path}: update err {err:.2e}"
        for path in frozen:
            assert optim.get_leaf(t_state.params, path) is optim.get_leaf(t_params0, path)
    assert seen == {0, 1}  # both student kinds ran


# ---------------------------------------------------------------------------
# The port's vmap step against its scan step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("feature_grad", [False, True])
@pytest.mark.parametrize("accumulative", [False, True])
def test_vmap_step_matches_scan(setup, feature_grad, accumulative):
    """One step in each mode from the same state and generator seed, the
    embedding dropout on (p = 0.1) and the slots, layers and masks drawn
    by the step itself, which draws them in the same order in both modes.
    Precisions equal; loss 1e-5 and grad_norm 1e-4 relative, every leaf
    rtol 2e-4 with atol 2e-6: JAX's own limits for its vmap against its
    scan (tests/test_sp_trainer.py::test_vmap_students_match_scan).
    Measured: loss and grad_norm equal to the last bit, leaves within
    7.5e-9 (the bias gradients sum all students' rows at once). The
    feature term is weighted 1 (not 1e-7) so that its gradient
    (`distill_feature_grad`) and its layer choice (`distill_accumulative`)
    move the update."""
    jcfg, tcfg, jp = setup
    tcfg = tcfg.replace(model=dataclasses.replace(tcfg.model, embd_pdrop=0.1))
    ids = torch.tensor(np.random.default_rng(22).integers(0, 256, (B, T)))
    runs = {}
    for mode in ("scan", "vmap"):
        ttc = tc.TrainConfig(**dict(TRAIN, student_mode=mode, gradient_accumulation_steps=4,
                                    distill_alpha_feature=1.0,
                                    distill_feature_grad=feature_grad,
                                    distill_accumulative=accumulative))
        init, step = tst.make_sp_train_step(tcfg, ttc)
        runs[mode] = step(init(bridge.params_from_numpy(jp, "cpu")), ids,
                          torch.Generator().manual_seed(5))
    (s_scan, m_scan), (s_vmap, m_vmap) = runs["scan"], runs["vmap"]
    np.testing.assert_array_equal(m_vmap["precisions"].numpy(), m_scan["precisions"].numpy())
    assert set(m_vmap["precisions"].tolist()) == {0, 1}  # both student kinds ran
    np.testing.assert_allclose(float(m_vmap["loss"]), float(m_scan["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_vmap["grad_norm"]), float(m_scan["grad_norm"]),
                               rtol=1e-4)
    for path, want in optim.leaves_with_paths(s_scan.params):
        got = optim.get_leaf(s_vmap.params, path)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4, atol=2e-6,
                                   err_msg=str(path))


@pytest.mark.parametrize("attention", ["dense", "flash"])
@pytest.mark.parametrize("impl", ["flat", "cond", "fused"])
def test_vmap_step_matches_scan_on_every_path(monkeypatch, impl, attention):
    """The vmap step against the scan step, as above (dropout on, the
    step's own draws, JAX's limits), on each linear path and attention:
    LoRA rank 8 so that the fused gate takes B·T = 256; on the fused path
    the plain #14 ran once per linear, layer and pass, and on the flash
    path the plain #5 once a layer and pass (2 passes under vmap, the
    teacher's and the batched students', accum under scan)."""
    from llm_qat_tpu_torch.ops import attention as tatt

    q = dict(bit_widths=(4, 8, 32), lora_rank_per_bit={b: 8 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=T, n_embd=128, n_layer=1, n_head=2, embd_pdrop=0.1)
    cfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                           linear_impl=impl, attention_impl=attention)
    params = CalibrationManager(cfg, 1).calibrate_all_precisions(
        tsp.init_sp_params(torch.Generator().manual_seed(6), cfg, device="cpu"),
        [torch.tensor(np.random.default_rng(6).integers(0, 256, (B, T)))])
    ids = torch.tensor(np.random.default_rng(24).integers(0, 256, (B, T)))
    calls = {"fused": 0, "flash": 0}

    def counted(name, fn):
        def run(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return run

    monkeypatch.setattr(tfl, "fused_linear_fwd_plain",
                        counted("fused", tfl.fused_linear_fwd_plain))
    monkeypatch.setattr(tatt, "flash_fwd_lse_plain", counted("flash", tatt.flash_fwd_lse_plain))
    runs, seen = {}, {}
    accum = 4
    for mode in ("scan", "vmap"):
        calls.update(fused=0, flash=0)
        init, step = tst.make_sp_train_step(cfg, tc.TrainConfig(**dict(
            TRAIN, student_mode=mode, gradient_accumulation_steps=accum)))
        runs[mode] = step(init(params), ids, torch.Generator().manual_seed(5))
        seen[mode] = dict(calls)
    L = m["n_layer"]
    for mode, passes in (("scan", accum), ("vmap", 2)):
        assert seen[mode] == {"fused": 4 * L * passes if impl == "fused" else 0,
                              "flash": passes * L if attention == "flash" else 0}, seen
    (s_scan, m_scan), (s_vmap, m_vmap) = runs["scan"], runs["vmap"]
    np.testing.assert_array_equal(m_vmap["precisions"].numpy(), m_scan["precisions"].numpy())
    np.testing.assert_allclose(float(m_vmap["loss"]), float(m_scan["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m_vmap["grad_norm"]), float(m_scan["grad_norm"]),
                               rtol=1e-4)
    for path, want in optim.leaves_with_paths(s_scan.params):
        np.testing.assert_allclose(optim.get_leaf(s_vmap.params, path).numpy(), want.numpy(),
                                   rtol=2e-4, atol=2e-6, err_msg=str(path))


# ---------------------------------------------------------------------------
# The fused linear under vmap
# ---------------------------------------------------------------------------


def test_fused_vmap_step_matches_jax(monkeypatch):
    """One vmap step of both packages at linear_impl="fused" (d = 128, one
    layer, LoRA rank 8, dense attention, float32 compute, B = 2, T = 128,
    accum 3: two students), JAX's draws replayed: the limits of
    test_torch_train_step.py. One student's rows (B·T = 256) pass the
    fused gate, and both packages take the fused path: the port's plain
    #14 runs once per linear, layer and pass (4·L·2: the teacher's, then
    one call for all students, as JAX's batched kernel). Measured: loss
    3.4e-6, student loss 3.4e-4, grad_norm equal, updates 4.0e-4."""
    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 8 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=T, n_embd=128, n_layer=1, n_head=2,
             embd_pdrop=0.0)
    kw = dict(attention_impl="dense", linear_impl="fused")
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q), **kw)
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q), **kw)
    jp = calibrated(jcfg, tcfg, seed=4)
    ids = np.random.default_rng(23).integers(0, 256, (B, T))
    jtc, ttc = J.TrainConfig(**VMAP), tc.TrainConfig(**VMAP)
    counts = {"jax": 0, "port": 0}
    jreal, treal = jfl._fwd_call, tfl.fused_linear_fwd_plain

    def jcount(*a, **k):
        counts["jax"] += 1
        return jreal(*a, **k)

    def tcount(*a, **k):
        counts["port"] += 1
        return treal(*a, **k)

    monkeypatch.setattr(jfl, "_fwd_call", jcount)
    monkeypatch.setattr(tfl, "fused_linear_fwd_plain", tcount)
    j_init, j_step = jst.make_sp_train_step(jcfg, jtc)
    t_init, t_step = tst.make_sp_train_step(tcfg, ttc)
    rng = jax.random.PRNGKey(102)
    precs, layers = _replayed_draws(rng, jcfg, jtc)
    j_new, jm = jax.jit(j_step)(j_init(jax.tree.map(jnp.asarray, jp)), jnp.asarray(ids), rng)
    t_new, tm = t_step(t_init(bridge.params_from_numpy(jp, "cpu")), torch.tensor(ids),
                       torch.Generator().manual_seed(0), precs=precs, layers=layers)
    assert counts["port"] == 4 * m["n_layer"] * 2
    assert counts["jax"] > 0
    np.testing.assert_array_equal(tm["precisions"].numpy(), np.asarray(jm["precisions"]))
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, err_msg=key)
    frozen, trainable = _frozen_and_trainable(jp)
    for path in trainable:
        old = optim.get_leaf(jp, path)
        dj = np.asarray(optim.get_leaf(j_new.params, path)) - old
        dt = optim.get_leaf(t_new.params, path).numpy() - old
        err = np.abs(dt - dj).max() / np.abs(dj).max()
        assert err <= UPDATE_TOL, f"{path}: update err {err:.2e}"
    for path in frozen:
        np.testing.assert_array_equal(optim.get_leaf(t_new.params, path).numpy(),
                                      optim.get_leaf(jp, path))


@pytest.mark.parametrize("rows", [256, 128])
def test_fused_gate_sees_one_students_rows(monkeypatch, rows):
    """`sp_linear` at linear_impl="fused" with two students (the 4-bit
    minmax and 8-bit log slots; test_torch_fused_linear.py's linear, K =
    256, N = 384, rank 16, bf16), against JAX's `jax.vmap` of its
    `sp_linear` over the slots and inputs: with 256 rows a student both
    packages take the fused path, with 128 (256 over both students) both
    take the flat one. The output and the gradients of x, w, b and LoRA
    A/B within test_torch_fused_linear.py's limit at the log slot, 2e-2 of
    the largest magnitude (measured: 2.6e-3 at most, x's gradient)."""
    from llm_qat_tpu.models import sp_model as jsp

    jcfg, tcfg = linear_cfgs()
    p, x = _linear(jcfg, seed=5)
    if rows == 256:  # each student all of x's (2, 128) rows, in its own order
        x = np.stack([x.reshape(rows, -1), x[::-1].reshape(rows, -1)])
    prec = np.asarray([0, 1], np.int32)
    cot = np.random.default_rng(96).normal(0, 1, x.shape[:-1] + (p["w"].shape[1],)
                                           ).astype(np.float32)
    calls = []
    treal, jreal = tfl.sp_linear_fused, jfl.sp_linear_fused
    monkeypatch.setattr(tsp, "sp_linear_fused", lambda *a: calls.append("port") or treal(*a))
    monkeypatch.setattr(jfl, "sp_linear_fused",
                        lambda *a, **k: calls.append("jax") or jreal(*a, **k))
    jt = jsp.prec_tables(jcfg.quant)

    def jf(pp, xx):
        return jax.vmap(lambda pr, xs: jsp.sp_linear(xs, pp, pr, jt, jcfg)[0])(
            jnp.asarray(prec), xx)

    @jax.jit
    def jgrads(pp, xx, c):
        out, vjp = jax.vjp(jf, pp, xx)
        return out, vjp(c)

    jout, (jgp, jgx) = jgrads(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cot))
    tp = bridge.params_from_numpy(p, "cpu")
    names = ("w", "b", "lora_A", "lora_B")
    for k in names:
        tp[k].requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    tout, _ = tsp.sp_linear(tx, tp, torch.tensor(prec), tsp.prec_tables(tcfg.quant, "cpu"), tcfg)
    tout.backward(torch.tensor(cot))
    assert sorted(calls) == (["jax", "port"] if rows == 256 else [])
    got = {"out": tout.detach(), "x": tx.grad} | {k: tp[k].grad for k in names}
    want = {"out": jout, "x": jgx} | {k: jgp[k] for k in names}
    for name in got:
        assert rel_np(got[name], want[name]) <= SP_TOL[1], name


# ---------------------------------------------------------------------------
# The batched pieces against a stack of per-slot calls
# ---------------------------------------------------------------------------

# Relative to the largest magnitude: a batched product or sum may add in
# another order than S separate ones (measured: equal to the last bit,
# but a bias gradient's sum over all students' rows, 1.1e-7).
PIECE_REL = 1e-5


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def test_matmul_bf16_per_student_weights():
    """`matmul_bf16` with (S, K, N) weights: the output and da against S
    separate 2-D calls, db (S, K, N) with each student's own sum; and the
    2-D case bit for bit the formulas it had before (float32 product of
    the bf16-rounded operands; g rounded to bf16, da = g·bᵀ, db = aᵀ·g over
    every leading axis)."""
    g = torch.Generator().manual_seed(0)
    S, K, N = 3, 64, 48
    a = torch.randn(S, 2, 5, K, generator=g, requires_grad=True)
    w = torch.randn(S, K, N, generator=g, requires_grad=True)
    cot = torch.randn(S, 2, 5, N, generator=g)
    out = matmul_bf16(a, w)
    out.backward(cot)
    for s in range(S):
        a_s = a.detach()[s].clone().requires_grad_(True)
        w_s = w.detach()[s].clone().requires_grad_(True)
        o_s = matmul_bf16(a_s, w_s)
        o_s.backward(cot[s])
        assert _rel(out[s].detach(), o_s.detach()) <= PIECE_REL
        assert _rel(a.grad[s], a_s.grad) <= PIECE_REL
        assert _rel(w.grad[s], w_s.grad) <= PIECE_REL
    bf, f32 = torch.bfloat16, torch.float32
    a2 = torch.randn(2, 5, K, generator=g, requires_grad=True)
    w2 = torch.randn(K, N, generator=g, requires_grad=True)
    out2 = matmul_bf16(a2, w2)
    out2.backward(cot[0])
    ab, wb, gb = a2.detach().to(bf), w2.detach().to(bf), cot[0].to(bf)
    assert torch.equal(out2, ab.to(f32) @ wb.to(f32))
    assert torch.equal(a2.grad, gb.to(f32) @ wb.T.to(f32))
    assert torch.equal(w2.grad, ab.reshape(-1, K).T.to(f32) @ gb.reshape(-1, N).to(f32))


def _slot_grads(fn, x, leaves, slots, cot):
    """(out, grads of x and `leaves`) of fn(x, slots) against the same of
    fn(x[s], slot) for each slot: outputs and x grads stacked, leaf grads
    summed."""
    for t in (x, *leaves):
        t.grad = None
    out = fn(x, torch.tensor(slots))
    out.backward(cot)
    batched = [out.detach(), x.grad.clone()] + [t.grad.clone() for t in leaves]
    outs, xs, sums = [], [], [torch.zeros_like(t) for t in leaves]
    for s, slot in enumerate(slots):
        for t in leaves:
            t.grad = None
        xs_ = x.detach()[s].clone().requires_grad_(True)
        o = fn(xs_, slot)
        o.backward(cot[s])
        outs.append(o.detach())
        xs.append(xs_.grad)
        sums = [acc + (t.grad if t.grad is not None else 0) for acc, t in zip(sums, leaves)]
    return batched, [torch.stack(outs), torch.stack(xs)] + sums


@pytest.mark.parametrize("impl", ["flat", "cond"])
def test_sp_linear_slots_match_per_slot(setup, impl):
    """`sp_linear` on x (S, B, T, K) with a vector of slots (both student
    kinds, the 32-bit slot and one slot twice), bf16 compute: the output
    and x's gradient against S per-slot calls, and the gradients of w, b,
    LoRA A/B (whose bank rows take each student's sum) against their
    sums, within PIECE_REL."""
    _, tcfg, jp = setup
    cfg = tcfg.replace(linear_impl=impl, compute_dtype="bfloat16")
    tables = tsp.prec_tables(cfg.quant, "cpu")
    p = {k: v[0] for k, v in live(bridge.params_from_numpy(jp, "cpu"))["blocks"]["c_fc"].items()}
    p = {k: v.detach().requires_grad_(k in ("w", "b", "lora_A", "lora_B")) for k, v in p.items()}
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(len(SLOTS), B, 16, 128, generator=gen, requires_grad=True)
    cot = torch.randn(len(SLOTS), B, 16, 512, generator=gen)
    leaves = [p[k] for k in ("w", "b", "lora_A", "lora_B")]
    got, want = _slot_grads(lambda xx, prec: tsp.sp_linear(xx, p, prec, tables, cfg)[0],
                            x, leaves, SLOTS, cot)
    for name, g_, w_ in zip(("out", "x", "w", "b", "lora_A", "lora_B"), got, want):
        assert _rel(g_, w_) <= PIECE_REL, name


def test_switchable_layernorm_slots_match_per_slot(setup):
    """The LayerNorm with (S, d) gamma/beta rows: output, dx, and the
    (P, d) banks' gradients (each student's rows summed into its slot's
    row) against per-slot calls; the same with the autodiff backward."""
    _, _, jp = setup
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(len(SLOTS), B, 16, 128, generator=gen, requires_grad=True)
    cot = torch.randn(x.shape, generator=gen)
    ln = {k: torch.tensor(v[0]) + 0.1 * torch.randn(v[0].shape, generator=gen)
          for k, v in jp["blocks"]["ln1"].items()}
    ln = {k: v.requires_grad_(True) for k, v in ln.items()}
    for impl in ("cvjp", "autodiff"):
        saved, tsp.LN_IMPL = tsp.LN_IMPL, impl
        try:
            got, want = _slot_grads(lambda xx, prec: tsp.switchable_layernorm(xx, ln, prec, 1e-5),
                                    x, [ln["g"], ln["b"]], SLOTS, cot)
        finally:
            tsp.LN_IMPL = saved
        for name, g_, w_ in zip(("out", "x", "g", "b"), got, want):
            assert _rel(g_, w_) <= PIECE_REL, f"{impl} {name}"


def test_sp_forward_slots_match_per_slot(setup):
    """`sp_forward` with a vector of slots, the dropout on: logits (S, B,
    T, V), hidden states (S, L+1, B, T, d) and the per-student losses
    against per-slot forwards that draw their masks from the same
    generator in turn, and every trainable leaf's gradient of the summed
    losses against the sum of the per-slot gradients; the same with
    `remat`. Calibration, stats collection and input pass-through refuse a
    vector."""
    _, tcfg, jp = setup
    cfg = tcfg.replace(model=dataclasses.replace(tcfg.model, embd_pdrop=0.1))
    ids = torch.tensor(np.random.default_rng(3).integers(0, 256, (B, T)))
    kw = dict(labels=ids, deterministic=False, output_hidden_states=True)

    def run(prec, remat=False):
        tp = live(bridge.params_from_numpy(jp, "cpu"))
        out = tsp.sp_forward(tp, ids, prec, cfg, dropout_gen=torch.Generator().manual_seed(4),
                             remat=remat, **kw)
        out["loss"].sum().backward()
        return out, [optim.get_leaf(tp, p).grad for p in tst.trainable_paths(tp)]

    want_out, want_g = [], None
    tp = live(bridge.params_from_numpy(jp, "cpu"))
    gen = torch.Generator().manual_seed(4)
    for slot in SLOTS:
        out = tsp.sp_forward(tp, ids, slot, cfg, dropout_gen=gen, **kw)
        out["loss"].backward()
        want_out.append(out)
    want_g = [optim.get_leaf(tp, p).grad for p in tst.trainable_paths(tp)]
    for remat in (False, True):
        out, grads = run(torch.tensor(SLOTS), remat)
        assert tuple(out["logits"].shape) == (len(SLOTS), B, T, 256)
        assert tuple(out["hidden_states"].shape) == (len(SLOTS), 3, B, T, 128)
        for key in ("logits", "hidden_states", "loss"):
            want = torch.stack([o[key].detach() for o in want_out])
            assert _rel(out[key].detach(), want) <= PIECE_REL, f"remat {remat} {key}"
        for g_, w_ in zip(grads, want_g):
            assert _rel(g_, w_) <= PIECE_REL, f"remat {remat}"
    tp = bridge.params_from_numpy(jp, "cpu")
    for opt in ("calibration_mode", "collect_stats", "input_passthrough"):
        with pytest.raises(ValueError, match=opt):
            tsp.sp_forward(tp, ids, torch.tensor(SLOTS), cfg, **{opt: True})


def test_attention_fn_gets_the_folded_heads(setup):
    """With a vector of S slots a caller's `attention_fn` receives the S·B
    folded heads (S·B, H, T, head_dim); the dense reference given that way
    gives the logits of the built-in dense path."""
    _, tcfg, jp = setup
    cfg = tcfg.replace(attention_impl="dense")
    tp = bridge.params_from_numpy(jp, "cpu")
    ids = torch.tensor(np.random.default_rng(5).integers(0, 256, (B, T)))
    shapes = []

    def attention_fn(q, k, v):
        shapes.append(tuple(q.shape))
        return causal_attention_reference(q, k, v)

    prec = torch.tensor(SLOTS)
    with torch.no_grad():
        got = tsp.sp_forward(tp, ids, prec, cfg, attention_fn=attention_fn)["logits"]
        want = tsp.sp_forward(tp, ids, prec, cfg)["logits"]
    assert shapes == [(len(SLOTS) * B, 2, T, 64)] * cfg.model.n_layer
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The pipelined vmap step
# ---------------------------------------------------------------------------


def test_pp_vmap_step_matches_plain_vmap_step(tmp_path):
    """`parallel.make_pp_sp_train_step` with student_mode="vmap" on two
    gloo ranks (a "pipe" mesh of 2 stages, 2 microbatches, the student
    axis carried in front of each microbatch through the P2P sends)
    against the port's plain vmap step, from the same state and
    generator (dropout on: both draw the same masks): the limits of
    test_torch_parallel_pp.py's distillation step (loss and teacher loss
    1e-4 relative, grad_norm 1e-3, precisions equal, every leaf within
    1e-6), the blocks still sharded over "pipe". Measured: metrics equal to
    the last bit, leaves within 6.3e-8."""
    m = dict(vocab_size=256, n_positions=32, n_embd=32, n_layer=4, n_head=2)
    q = dict(bit_widths=(4, 8, 32), lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    cfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    params = tsp.init_sp_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ids = np.random.default_rng(0).integers(0, 256, (8, 16))
    params = CalibrationManager(cfg, 1).calibrate_all_precisions(params, [torch.tensor(ids)])
    data = {"vmap_cfg": cfg, "vmap_params": bridge.params_to_numpy(params), "vmap_ids": ids,
            "vmap_tcfg": tc.TrainConfig(gradient_accumulation_steps=4, num_iterations=10,
                                        student_mode="vmap")}
    run = RankRun("vmap_pp", 2, data, tmp_path)
    try:
        results = run.results()
    finally:
        run.close()
    for rank, res in enumerate(results):
        case = res["pp_vmap_step"]
        if "error" in case:
            pytest.fail(f"rank {rank}:\n{case['error']}")
        for key, rtol in (("loss", 1e-4), ("teacher_loss", 1e-4), ("grad_norm", 1e-3)):
            np.testing.assert_allclose(*case[key], rtol=rtol, err_msg=key)
        np.testing.assert_array_equal(*case["precisions"])
        assert set(case["precisions"][0].tolist()) == {0, 1}
        assert case["placements"] == ("S(0)",)
        for path, (got, want) in case["params"].items():
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)
        assert res["jax_imported"] == []
