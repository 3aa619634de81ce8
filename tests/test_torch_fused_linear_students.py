"""PyTorch port, the fused QAT linear's student axis (`student_mode="vmap"`):
kernels #14-#16, their weight prologue and `sp_linear_fused` with S
students in one call, against `jax.vmap` of the JAX package's fused core
and `sp_linear_fused` (Pallas in interpret mode) and against the port's
own per-student calls, on the CPU.

Under `jax.vmap` JAX's batched `pallas_call` runs each of #14-#16 once over
all students: xq, xa, bq, the weight scales, the scalars and the cotangent
per student, w and the bias shared; #16 gives each student's dW through
its own STE and the vmap sums them into w's gradient. The port's plain
versions take the same leading student axis.

Sizes: M = 256 rows a student, K = N = 128, LoRA rank 8, S = 3 students at
the slots 4-bit minmax, 8-bit log and 32 bits (bits (4, 8, 32), default
kinds), symmetric, per-channel, bf16 operands. Inputs from numpy seeds.

Limits: `test_torch_fused_linear.py`'s SP_TOL by slot, relative to the
largest magnitude of the reference (4e-3 at the 4-bit and 32-bit slots,
2e-2 at the 8-bit log slot, whose codes go through log2/exp2 that differ
by an ulp between XLA and PyTorch); a gradient summed over all students
(w, the bias) or taken by the LoRA banks takes the log slot's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import sp_model as jsp
from llm_qat_tpu.ops import fused_linear as jfl
from llm_qat_tpu.quant.calibration import calibrate_tensor
from llm_qat_tpu.quant.functional import KIND_LOG, KIND_MINMAX
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.ops import fused_linear as tfl
from test_torch_fused_linear import SP_TOL, off_log_ties

torch.set_num_threads(1)  # beside other xdist workers

M, K, N, R = 256, 128, 128, 8
BITS = (4, 8, 32)
SLOTS = (0, 1, 2)          # one student at each slot
S = len(SLOTS)
SHARED_TOL = max(SP_TOL.values())


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _operands(seed, g_scale=(1.0, 1.0, 1.0)):
    """The batched operands of #14-#16: a shared weight (off the log
    slot's ties) with each slot's calibrated per-column scales, per-student
    bf16 xq, xa, bq and cotangent g (student s's g scaled by g_scale[s]),
    a shared bias and the scalars (bits, kind, scaling 2, 0) per student."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1 / 16, 1 / 16, (K, N)).astype(np.float32)
    ws, wz, scal = [], [], []
    for slot in SLOTS:
        bits = BITS[slot]
        kind = KIND_LOG if bits == 8 else KIND_MINMAX
        s_, z_ = (np.asarray(a).reshape(-1) for a in calibrate_tensor(
            jnp.asarray(w), float(min(bits, 8)), kind, channel_dim=1))
        if kind == KIND_LOG:
            w = off_log_ties(w, s_, z_, bits, True)
        ws.append(s_)
        wz.append(z_)
        scal.append([bits, kind, 2.0, 0.0])
    rnd = lambda *sh: _bf16(rng.normal(0, 1, sh).astype(np.float32))
    g = np.stack([_bf16(f * rng.normal(0, 1, (M, N)).astype(np.float32)) for f in g_scale])
    return dict(xq=rnd(S, M, K), xa=rnd(S, M, R), bq=_bf16(0.1 * rng.normal(0, 1, (S, R, N))),
                w=w, ws=np.stack(ws), wz=np.stack(wz), bias=rng.normal(0, 0.1, N).astype(
                    np.float32), scalars=np.asarray(scal, np.float32), g=g)


def _t(a):
    return bridge.params_from_numpy(np.asarray(a), "cpu")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _jax_core(a):
    """`jax.vmap` of JAX's `_fused_core` over the students (interpret
    mode): the output and the gradients of xq, xa, bq, bias and w for the
    cotangent g (bias and w shared: their gradients summed over the
    students by the vmap)."""
    core = lambda xq, xa, bq, bias, w, ws, wz, sc: jfl._fused_core(
        xq, xa, bq, bias, w, ws, wz, sc, True, 1e-5, True)
    ws, wz, sc = (jnp.asarray(a[k])[:, None, :] for k in ("ws", "wz", "scalars"))

    def f(xq, xa, bq, bias, w):
        return jax.vmap(core, in_axes=(0, 0, 0, None, None, 0, 0, 0))(
            xq, xa, bq, bias, w, ws, wz, sc)

    args = [jnp.asarray(a[k]) for k in ("xq", "xa", "bq")]
    args += [jnp.asarray(a["bias"]).reshape(1, N), jnp.asarray(a["w"])]
    out, vjp = jax.vjp(jax.jit(f), *args)
    grads = vjp(jnp.asarray(a["g"], jnp.float32))
    want = {"out": out} | dict(zip(("xq", "xa", "bq", "bias", "w"), grads))
    want["bias"] = want["bias"].reshape(N)
    return want


def _port_core(a, kernels=None):
    """The port's `_FusedCore` with the student axis on the CPU (the plain
    versions): the output and the gradients of xq, xa, bq, bias and w.
    `kernels` replaces #16's plain version for the call."""
    t = {k: _t(v) for k, v in a.items()}
    leaves = {k: t[k].clone().requires_grad_(True) for k in ("xq", "xa", "bq", "bias", "w")}
    real = tfl.fused_linear_bwd_dw
    if kernels is not None:
        tfl.fused_linear_bwd_dw = kernels
    try:
        out = tfl._FusedCore.apply(leaves["xq"], leaves["xa"], leaves["bq"], leaves["bias"],
                                   leaves["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5)
        out.backward(t["g"].float())
    finally:
        tfl.fused_linear_bwd_dw = real
    return {"out": out.detach()} | {k: v.grad for k, v in leaves.items()}


def _hold(got, want, what):
    """Each student's rows within its slot's SP_TOL of that student's max
    |reference|; the shared gradients within SHARED_TOL."""
    errs = {}
    for name in ("out", "xq", "xa", "bq"):
        for s_, slot in enumerate(SLOTS):
            errs[f"{name}[{s_}]"] = err = _rel(got[name][s_], np.asarray(want[name])[s_])
            assert err <= SP_TOL[slot], (what, name, s_, err)
    for name in ("bias", "w"):
        errs[name] = err = _rel(got[name], want[name])
        assert err <= SHARED_TOL, (what, name, err)
    print(what, {k: f"{v:.2e}" for k, v in errs.items()})


def test_batched_fused_core_matches_jax_vmap():
    """The port's `_FusedCore` on batched operands (the batched plain
    versions of #14, #15 and #16, dbq and dbias) against `jax.vmap` of
    JAX's `_fused_core` in interpret mode: the output (S, M, N) and the
    gradients of xq, xa, bq (per student), bias and w (shared) within
    SP_TOL."""
    a = _operands(0)
    got, want = _port_core(a), _jax_core(a)
    assert tuple(got["out"].shape) == (S, M, N) and tuple(got["w"].shape) == (K, N)
    _hold(got, want, "batched core vs jax.vmap")


def _one_gemm_dw(clamp):
    """#16 as one GEMM over the S·M stacked rows with one clamp (on or
    off), the design a student grid axis must not take."""
    def dw(xq, g_bf, scalars):
        d = tfl._f32_dot(xq.reshape(-1, K).T, g_bf.reshape(-1, N).to(xq.dtype))
        return torch.clamp(d, -10.0, 10.0) if clamp else d
    return dw


def test_dw_clamps_each_student_before_the_sum():
    """The 8-bit log student's g is scaled by 50 so that |xq_sᵀ·g_s|
    exceeds 10 almost everywhere: its dW is clamped to ±10 by its STE
    before the students' sum, the others' are not. The port's batched
    plain #16 matches JAX's batched #16 and vmap sum within SHARED_TOL;
    one GEMM over all students' rows with one clamp, either on or off,
    misses it by more than 10x that."""
    a = _operands(1, g_scale=(1.0, 50.0, 1.0))
    log_dw = a["xq"][1].astype(np.float32).T @ a["g"][1].astype(np.float32)
    assert (np.abs(log_dw) > 10).mean() > 0.5
    want = _jax_core(a)
    got = _port_core(a)
    _hold(got, want, "per-student clamp")
    per = tfl.fused_linear_bwd_dw_plain(_t(a["xq"][1]), _t(a["g"][1]), _t(a["scalars"][1]))
    assert float(per.abs().max()) == 10.0  # the log student's own dW is clamped
    for clamp in (False, True):
        wrong = _port_core(a, kernels=_one_gemm_dw(clamp))
        err = _rel(wrong["w"], want["w"])
        print(f"one GEMM, clamp {clamp}: w {err:.2e}")
        assert err > 10 * SHARED_TOL, (clamp, err)


@pytest.mark.parametrize("transpose", [False, True])
def test_batched_fq_weight_plain_matches_jax_vmap(transpose):
    """`fq_weight_plain` with the student axis against `jax.vmap` of JAX's
    `_fq_tile(...).astype(bf16)`, (S, K, N) or (S, N, K): minmax and 32-bit
    students bit for bit; the log student's bf16 weights one bf16 ulp apart
    for at most test_torch_fused_linear.py's FQ_BF16_ULP_SHARE of them
    (XLA's FMA in exp2's argument)."""
    from test_torch_fused_linear import FQ_BF16_ULP_SHARE

    a = _operands(2)
    fq = lambda ws, wz, sc: jfl._fq_tile(jnp.asarray(a["w"]), ws[None], wz[None], sc[0], sc[1],
                                         True, 1e-5).astype(jnp.bfloat16)
    want = np.asarray(jax.vmap(fq)(*(jnp.asarray(a[k]) for k in ("ws", "wz", "scalars")))
                      .astype(jnp.float32))
    got = tfl.fq_weight_plain(_t(a["w"]), _t(a["ws"]), _t(a["wz"]), _t(a["scalars"]), True,
                              1e-5, transpose)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert tuple(got.shape) == ((S, N, K) if transpose else (S, K, N))
    got = got.float().numpy()
    if transpose:
        got = got.transpose(0, 2, 1)
    for s_, slot in enumerate(SLOTS):
        if BITS[slot] == 8:
            assert (got[s_] != want[s_]).mean() <= FQ_BF16_ULP_SHARE
        else:
            np.testing.assert_array_equal(got[s_], want[s_])


def _unbatched(a, s_):
    """Student s_'s operands of #14-#16 without the student axis."""
    return {k: (_t(v) if k in ("w", "bias") else _t(v[s_])) for k, v in a.items()}


def test_batched_plain_versions_match_per_student_calls():
    """Each batched plain version (#14, #15, #16, the prologue) against the
    same plain version called once per student: #14 and #15 and the
    prologue student by student equal to the last bit (the same
    elementwise fake-quant; a batched float32 product adds in the same
    order as S separate ones here), #16 the sum of the per-student dW
    within float32 rounding (1e-6 of its max)."""
    a = _operands(3, g_scale=(1.0, 50.0, 1.0))
    t = {k: _t(v) for k, v in a.items()}
    out = tfl.fused_linear_fwd_plain(t["xq"], t["xa"], t["w"], t["ws"], t["wz"], t["bq"],
                                     t["bias"], t["scalars"], True, 1e-5)
    dxq, dxa = tfl.fused_linear_bwd_dx_plain(t["g"], t["w"], t["ws"], t["wz"], t["bq"],
                                             t["scalars"], True, 1e-5)
    dw = tfl.fused_linear_bwd_dw_plain(t["xq"], t["g"], t["scalars"])
    wqt = tfl.fq_weight_plain(t["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5, True)
    dw_sum = torch.zeros(K, N)
    for s_ in range(S):
        u = _unbatched(a, s_)
        want = tfl.fused_linear_fwd_plain(u["xq"], u["xa"], u["w"], u["ws"], u["wz"], u["bq"],
                                          u["bias"], u["scalars"], True, 1e-5)
        assert torch.equal(out[s_], want), s_
        wx, wa = tfl.fused_linear_bwd_dx_plain(u["g"], u["w"], u["ws"], u["wz"], u["bq"],
                                               u["scalars"], True, 1e-5)
        assert torch.equal(dxq[s_], wx) and torch.equal(dxa[s_], wa), s_
        assert torch.equal(wqt[s_], tfl.fq_weight_plain(u["w"], u["ws"], u["wz"], u["scalars"],
                                                        True, 1e-5, True)), s_
        dw_sum += tfl.fused_linear_bwd_dw_plain(u["xq"], u["g"], u["scalars"])
    assert (dw - dw_sum).abs().max() <= 1e-6 * dw_sum.abs().max()


def test_batched_wrappers_take_the_plain_versions_on_the_cpu():
    """The four wrappers with the student axis on CPU tensors: the batched
    plain versions' values and shapes, dW (K, N), and no launch counted."""
    a = _operands(4)
    t = {k: _t(v) for k, v in a.items()}
    counters = (tfl.fused_linear_fwd, tfl.fused_linear_bwd_dx, tfl.fused_linear_bwd_dw,
                tfl.fq_weight)
    before = [fn.launches for fn in counters]
    fwd = (t["xq"], t["xa"], t["w"], t["ws"], t["wz"], t["bq"], t["bias"], t["scalars"], True,
           1e-5)
    dx = (t["g"], t["w"], t["ws"], t["wz"], t["bq"], t["scalars"], True, 1e-5)
    assert torch.equal(tfl.fused_linear_fwd(*fwd), tfl.fused_linear_fwd_plain(*fwd))
    for x, y in zip(tfl.fused_linear_bwd_dx(*dx), tfl.fused_linear_bwd_dx_plain(*dx)):
        assert torch.equal(x, y) and tuple(x.shape[:2]) == (S, M)
    dw = tfl.fused_linear_bwd_dw(t["xq"], t["g"], t["scalars"])
    assert tuple(dw.shape) == (K, N)
    assert torch.equal(dw, tfl.fused_linear_bwd_dw_plain(t["xq"], t["g"], t["scalars"]))
    wqt, bqt = tfl.fq_weight(t["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5, True, t["bq"])
    assert tuple(wqt.shape) == (S, N, K) and torch.equal(bqt, t["bq"].transpose(1, 2))
    assert [fn.launches for fn in counters] == before


@pytest.mark.parametrize("M_,K_,N_", [(8192, 768, 2304), (8192, 768, 768), (8192, 768, 3072),
                                      (8192, 3072, 768), (256, 128, 128)])
def test_dw_splits_count_every_students_blocks(M_, K_, N_):
    """#16's plan with S students counts S times the (K, N) tiles in its
    waves (host-side arithmetic, 132 SMs): with one student it is the
    unbatched plan, and with three no count in range has fewer waves x
    (steps per block + DW_BLOCK_COST), each chunk still within
    DW_MAX_CHUNK_STEPS steps."""
    assert tfl.dw_splits(M_, K_, N_, 132, 1) == tfl.dw_splits(M_, K_, N_, 132)
    s = tfl.dw_splits(M_, K_, N_, 132, S)
    steps = -(-M_ // tfl.DW_STEP)
    tiles = S * -(-K_ // tfl.DW_TILE[0]) * -(-N_ // tfl.DW_TILE[1])
    wave = tfl.DW_BLOCKS_PER_SM * 132
    cost = lambda c: -(-tiles * c // wave) * (-(-steps // c) + tfl.DW_BLOCK_COST)
    lo = min(-(-steps // tfl.DW_MAX_CHUNK_STEPS), tfl.DW_MAX_SPLITS, steps)
    hi = max(lo, min(tfl.DW_FAST_SPLITS, steps))
    assert lo <= s <= hi and cost(s) == min(cost(c) for c in range(lo, hi + 1))
    assert -(-steps // s) <= tfl.DW_MAX_CHUNK_STEPS


# ---------------------------------------------------------------------------
# sp_linear_fused with a vector of slots
# ---------------------------------------------------------------------------


def _cfgs():
    q = dict(bit_widths=BITS,
             lora_rank_per_bit={b: R for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * R for b in range(2, 17)} | {32: 0})
    m = dict(n_embd=K, n_layer=1, n_head=2, vocab_size=256)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                            compute_dtype="bfloat16", linear_impl="fused"),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                             compute_dtype="bfloat16", linear_impl="fused"))


def _linear_params(jcfg, seed):
    """One linear's numpy parameters with each slot's calibrated weight and
    input scales (weights off the log slot's ties), LoRA B non-zero, and
    each student's input x (S, 2, M/2, K)."""
    q = jcfg.quant
    rng = np.random.default_rng(seed)
    P = q.n_prec
    w = rng.uniform(-1 / 16, 1 / 16, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (S, 2, M // 2, K)).astype(np.float32)
    enabled = np.asarray([1.0 if s_ > 0 else 0.0 for s_ in q.scaling_table()], np.float32)
    p = {"w": w, "b": rng.normal(0, 0.1, N).astype(np.float32),
         "lora_A": rng.uniform(-0.25, 0.25, (P, K, R)).astype(np.float32)
         * enabled[:, None, None],
         "lora_B": rng.normal(0, 0.05, (P, R, N)).astype(np.float32),
         "wq_scale": np.ones((P, N), np.float32), "wq_zp": np.zeros((P, N), np.float32),
         "iq_scale": np.ones((P, K), np.float32), "iq_zp": np.zeros((P, K), np.float32)}
    kinds = q.kind_table()
    for i, b in enumerate(q.bit_widths):
        ws, wz = calibrate_tensor(jnp.asarray(p["w"]), float(b), int(kinds[i]), channel_dim=1)
        p["wq_scale"][i], p["wq_zp"][i] = np.asarray(ws).reshape(-1), np.asarray(wz).reshape(-1)
        if kinds[i] == KIND_LOG and b < 32:
            p["w"] = off_log_ties(p["w"], p["wq_scale"][i], p["wq_zp"][i], b, True)
        xs, xz = calibrate_tensor(jnp.asarray(x), float(b), int(kinds[i]), channel_dim=-1)
        p["iq_scale"][i], p["iq_zp"][i] = np.asarray(xs).reshape(-1), np.asarray(xz).reshape(-1)
    return p, x


NAMES = ("w", "b", "lora_A", "lora_B")


def _port_linear(tcfg, p, x, cot, prec):
    """The port's `sp_linear` on the fused path: with a slot vector `prec`
    all students in one call, with an int one student (x and cot that
    student's). Returns the output and the gradients of x, w, b and the
    LoRA banks."""
    tp = bridge.params_from_numpy(p, "cpu")
    for k in NAMES:
        tp[k].requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    slots = torch.tensor(prec) if isinstance(prec, np.ndarray) else prec
    out, _ = tsp.sp_linear(tx, tp, slots, tsp.prec_tables(tcfg.quant, "cpu"), tcfg)
    out.backward(torch.tensor(cot))
    return {"out": out.detach(), "x": tx.grad} | {k: tp[k].grad for k in NAMES}


def test_sp_linear_fused_students_match_jax_vmap_and_per_student_calls(monkeypatch):
    """`sp_linear` at linear_impl="fused" with the slot vector (0, 1, 2):
    one batched call of each of #14-#16 (the plain #14 once), against
    `jax.vmap` of JAX's `sp_linear` over the slots and inputs (its fused
    path, interpret mode) and against three per-student calls of the
    port's own single-slot path: the output and x's gradient per student
    within its slot's SP_TOL; the gradients of w, b, lora_A and lora_B
    (summed over, or gathered by, the students) within SHARED_TOL."""
    jcfg, tcfg = _cfgs()
    p, x = _linear_params(jcfg, seed=5)
    prec = np.asarray(SLOTS, np.int32)
    cot = np.random.default_rng(95).normal(0, 1, x.shape[:-1] + (N,)).astype(np.float32)
    jt = jsp.prec_tables(jcfg.quant)
    calls = []
    jreal = jfl._fwd_call
    monkeypatch.setattr(jfl, "_fwd_call", lambda *a, **k: calls.append("jax") or jreal(*a, **k))

    def jf(pp, xx):
        return jax.vmap(lambda pr, xs: jsp.sp_linear(xs, pp, pr, jt, jcfg)[0])(
            jnp.asarray(prec), xx)

    @jax.jit
    def jgrads(pp, xx, c):
        out, vjp = jax.vjp(jf, pp, xx)
        return out, vjp(c)

    jout, (jgp, jgx) = jgrads(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cot))
    assert calls  # JAX took its fused path
    want = {"out": jout, "x": jgx} | {k: jgp[k] for k in NAMES}

    treal = tfl.fused_linear_fwd_plain
    port_calls = []
    monkeypatch.setattr(tfl, "fused_linear_fwd_plain",
                        lambda *a: port_calls.append(a[0].shape) or treal(*a))
    got = _port_linear(tcfg, p, x, cot, prec)
    assert port_calls == [torch.Size((S, M, K))]  # one call for all students
    loop = [_port_linear(tcfg, p, x[s_], cot[s_], int(prec[s_])) for s_ in range(S)]
    assert len(port_calls) == 1 + S
    per = {"out": torch.stack([lp["out"] for lp in loop]),
           "x": torch.stack([lp["x"] for lp in loop])}
    per |= {k: sum(lp[k] for lp in loop) for k in NAMES}
    for ref_name, ref in (("jax.vmap", want), ("per-student calls", per)):
        errs = {}
        for name in ("out", "x"):
            for s_, slot in enumerate(SLOTS):
                errs[f"{name}[{s_}]"] = err = _rel(got[name][s_], np.asarray(ref[name])[s_])
                assert err <= SP_TOL[slot], (ref_name, name, s_, err)
        for name in NAMES:
            errs[name] = err = _rel(got[name], ref[name])
            assert err <= SHARED_TOL, (ref_name, name, err)
        print(ref_name, {k: f"{v:.2e}" for k, v in errs.items()})
