"""PyTorch port, fused QAT linear (`linear_impl="fused"`): the in-tile
weight fake-quant, the bf16 weight prologue of #14/#15 and the plain
versions of kernels #14-#16 against the JAX Pallas kernels (interpret
mode), `sp_linear` of both packages at
"fused" and "cond", the fallbacks by shape, and a whole train step of both
packages on the fused path, on the CPU.

Linear sizes as the JAX package's own fused tests: M = 256, K = 256,
N = 384, LoRA rank 16, bits (4, 8, 32) with the default kinds (4: minmax,
8: log), symmetric, per-channel, bf16 compute. Inputs from numpy seeds."""

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

M, K, N, R = 256, 256, 384, 16
BITS = (4, 8, 32)


def _log_pos(w, scale, zp, bits, symmetric):
    """A weight's position on the log code grid (ties at .5)."""
    la = np.log2(np.maximum(np.abs(w.astype(np.float64)), 1e-5))
    ln = np.clip((la - zp) / np.maximum(scale, 1e-5), 0, 1)
    if symmetric:
        return (ln - 0.5) * 2 * (2.0 ** (bits - 1) - 1)
    return ln * (2.0 ** bits - 1)


def off_log_ties(w, scale, zp, bits, symmetric, margin=0.02):
    """w with every weight within `margin` codes of a log-grid rounding
    boundary moved 2·margin codes off it. XLA's and PyTorch's float32 log2
    may differ by an ulp, which moves such a weight to the neighbouring code
    in one package only. The extremes (codes at the grid's ends) stay."""
    pos = _log_pos(w, scale, zp, bits, symmetric)
    near = np.abs(pos - np.floor(pos) - 0.5) < margin
    per_code = scale / ((2 if symmetric else 1) * (2.0 ** (bits - 1 if symmetric else bits) - 1))
    return np.where(near, w * 2.0 ** (-2 * margin * per_code), w).astype(np.float32)


# ---------------------------------------------------------------------------
# The in-tile weight fake-quant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [3, 4, 8, 32])
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("kind", [KIND_MINMAX, KIND_LOG])
def test_fq_tile_plain_matches_jax(kind, symmetric, bits):
    """`fq_tile_plain` against the JAX `_fq_tile`, with the weights off
    log-grid ties (exact zeros kept by the log kind). minmax: equal. log:
    the same code for every weight, and the value within 1e-6 relative:
    XLA contracts q_norm·log_range + log_min into one FMA, PyTorch (and the
    CUDA kernel) round the product first, which moves exp2's argument by
    an ulp (measured up to 4.9e-7 relative)."""
    rng = np.random.default_rng(10 * bits + 2 * kind + symmetric)
    w = rng.uniform(-0.06, 0.06, (128, 96)).astype(np.float32)
    w[0, :5] = 0.0
    cal_bits = min(bits, 8)
    s, z = (np.asarray(a) for a in calibrate_tensor(jnp.asarray(w), float(cal_bits), kind,
                                                    channel_dim=1, symmetric=symmetric))
    if kind == KIND_LOG:
        w = off_log_ties(w, s, z, cal_bits, symmetric)
    f32 = np.float32
    want = np.asarray(jfl._fq_tile(jnp.asarray(w), jnp.asarray(s), jnp.asarray(z),
                                   f32(bits), f32(kind), symmetric, 1e-5))
    got = tfl.fq_tile_plain(torch.tensor(w), torch.tensor(s), torch.tensor(z),
                            torch.tensor(f32(bits)), torch.tensor(f32(kind)),
                            symmetric, 1e-5).numpy()
    if kind == KIND_MINMAX or bits == 32:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        codes = [np.round(_log_pos(np.abs(o), s, z, bits, symmetric)) for o in (got, want)]
        np.testing.assert_array_equal(codes[0], codes[1])
    if bits < 32:
        assert not np.array_equal(got, w)  # the quantizer did something


# The bf16 weight prologue of #14/#15 rounds each fake-quantized weight to
# bf16 once. At the log slot XLA's FMA in exp2's argument moves the float32
# value by an ulp (test above); where that crosses a bf16 rounding boundary
# the two packages' bf16 weights are one bf16 ulp apart: at most this share.
FQ_BF16_ULP_SHARE = 1e-3


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_fq_weight_plain_matches_jax(slot, transpose):
    """`fq_weight_plain` against the JAX `_fq_tile(...).astype(bf16)`, in
    both layouts (K, N) and (N, K). minmax and 32 bits: bit for bit. The
    8-bit log slot, weights off log ties: the same codes, and a weight
    differs only where the float32 values of the two packages differ (XLA's
    FMA contraction), then by one bf16 ulp, for at most FQ_BF16_ULP_SHARE
    of the weights."""
    a = _kernel_inputs(slot, "bfloat16")
    bits, kind = a["scalars"][0], a["scalars"][1]
    args = (_j(a["w"]), _j(a["ws"]).reshape(1, N), _j(a["wz"]).reshape(1, N), bits, kind,
            True, 1e-5)
    want32 = np.asarray(jfl._fq_tile(*args))
    want = np.asarray(jfl._fq_tile(*args).astype(jnp.bfloat16).astype(jnp.float32))
    got = tfl.fq_weight_plain(_t(a["w"]), _t(a["ws"]), _t(a["wz"]), _t(a["scalars"]), True,
                              1e-5, transpose)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == ((N, K) if transpose else (K, N))
    got = got.float().numpy()
    if transpose:
        got = got.T
    if kind == KIND_MINMAX or bits == 32:
        np.testing.assert_array_equal(got, want)
        return
    codes = [np.round(_log_pos(np.abs(o), a["ws"], a["wz"], 8, True)) for o in (got, want)]
    np.testing.assert_array_equal(codes[0], codes[1])
    got32 = tfl.fq_tile_plain(_t(a["w"]), _t(a["ws"]), _t(a["wz"]), _t(bits), _t(kind), True,
                              1e-5).numpy()
    moved = got != want
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want[moved]))) - 7)
    print(f"bf16 weights one ulp apart: {int(moved.sum())} of {moved.size}")
    assert np.all(got32[moved] != want32[moved])
    np.testing.assert_array_equal(np.abs(got[moved] - want[moved]), ulp)
    assert moved.mean() <= FQ_BF16_ULP_SHARE


def test_fq_weight_takes_the_plain_version_on_the_cpu():
    """The prologue's wrapper on CPU tensors: its plain version, and with
    bq and transpose also bqᵀ; no launch is counted."""
    a = _kernel_inputs(1, "bfloat16")
    t = {k: _t(v) for k, v in a.items()}
    before = tfl.fq_weight.launches
    wq = tfl.fq_weight(t["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5, False)
    wqt, bqt = tfl.fq_weight(t["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5, True, t["bq"])
    assert tfl.fq_weight.launches == before
    plain = tfl.fq_weight_plain(t["w"], t["ws"], t["wz"], t["scalars"], True, 1e-5, False)
    assert torch.equal(wq, plain) and torch.equal(wqt, plain.T)
    assert torch.equal(bqt, t["bq"].T) and bqt.is_contiguous()


# ---------------------------------------------------------------------------
# The plain versions of #14-#16 against the Pallas kernels
# ---------------------------------------------------------------------------


def _kernel_inputs(slot, dtype, seed=0):
    """Operands of one linear at one slot: weights with their calibrated
    per-column scales (off log ties), operand-dtype activations and LoRA
    factors, a bias and the scalars (bits, kind, scaling, 0)."""
    bits = BITS[slot]
    kind = KIND_LOG if bits == 8 else KIND_MINMAX
    rng = np.random.default_rng(seed + slot)
    w = rng.uniform(-1 / 16, 1 / 16, (K, N)).astype(np.float32)
    ws, wz = (np.asarray(a).reshape(-1) for a in calibrate_tensor(
        jnp.asarray(w), float(min(bits, 8)), kind, channel_dim=1))
    if kind == KIND_LOG:
        w = off_log_ties(w, ws, wz, bits, True)
    jd = jnp.dtype(dtype)
    rnd = lambda *s: np.asarray(jnp.asarray(rng.normal(0, 1, s).astype(np.float32), jd))
    xq, xa, bq, g = rnd(M, K), rnd(M, R), 0.1 * rnd(R, N), rnd(M, N)
    bias = rng.normal(0, 0.1, N).astype(np.float32)
    scalars = np.asarray([bits, kind, 2.0, 0.0], np.float32)
    return dict(xq=xq, xa=xa, w=w, ws=ws, wz=wz, bq=np.asarray(bq, xq.dtype), bias=bias,
                scalars=scalars, g=g)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return bridge.params_from_numpy(np.asarray(a), "cpu")


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# Errors relative to max |reference|: float32 sums in another order (the
# products of bf16 operands are exact in both, and the weight codes equal,
# weights off log ties); measured up to 8.5e-7. At the 8-bit log slot with
# bf16 operands a fake-quantized weight one float32 ulp from a bf16
# rounding boundary (XLA's FMA in exp2's argument, see
# test_fq_tile_plain_matches_jax) rounds to the neighbouring bf16 value in
# one package: 2 of the 98304 weights here, moving out and dxq by up to
# 3.2e-4.
KERNEL_TOL = 2e-6
KERNEL_TOL_LOG_BF16 = 1e-3


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("slot", [0, 1, 2])
def test_kernel_plain_versions_match_pallas(slot, dtype):
    """`fused_linear_fwd_plain`, `fused_linear_bwd_dx_plain` and
    `fused_linear_bwd_dw_plain` against `_fwd_call`, `_bwd_dx_call` and
    `_bwd_dw_call` in interpret mode with the JAX package's block sizes,
    within KERNEL_TOL of max |reference|."""
    a = _kernel_inputs(slot, dtype)
    bm, bn = jfl._pick_blocks(M, K, N)
    kw = dict(symmetric=True, eps=1e-5, interpret=True)
    js = _j(a["scalars"]).reshape(1, 4)
    ws, wz, bias = (_j(a[k]).reshape(1, N) for k in ("ws", "wz", "bias"))
    want_out = jfl._fwd_call(_j(a["xq"]), _j(a["xa"]), _j(a["w"]), ws, wz, _j(a["bq"]), bias,
                             js, block_m=bm, block_n=bn, **kw)
    want_dxq, want_dxa = jfl._bwd_dx_call(_j(a["g"]), _j(a["w"]), ws, wz, _j(a["bq"]), js, R,
                                          block_m=bm, block_n=bn, **kw)
    want_dw = jfl._bwd_dw_call(_j(a["xq"]), _j(a["g"]), js, block_k=256, block_n=bn, **kw)
    t = {k: _t(v) for k, v in a.items()}
    out = tfl.fused_linear_fwd(t["xq"], t["xa"], t["w"], t["ws"], t["wz"], t["bq"],
                               t["bias"], t["scalars"], True, 1e-5)
    dxq, dxa = tfl.fused_linear_bwd_dx(t["g"], t["w"], t["ws"], t["wz"], t["bq"],
                                       t["scalars"], True, 1e-5)
    dw = tfl.fused_linear_bwd_dw(t["xq"], t["g"], t["scalars"])
    for name, got, want in (("out", out, want_out), ("dxq", dxq, want_dxq),
                            ("dxa", dxa, want_dxa), ("dw", dw, want_dw)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape, name
        tol = (KERNEL_TOL_LOG_BF16 if slot == 1 and dtype == "bfloat16"
               and name in ("out", "dxq") else KERNEL_TOL)
        err = _rel(got, want)
        assert err <= tol, f"{name}: {err:.2e}"


def test_dw_plain_clamps_like_pallas():
    """At the 8-bit log slot dW passes the ±10 STE clamp: with g scaled up
    most of dW is clamped, in both; at the 4-bit minmax slot nothing is."""
    for slot, clamped in ((1, True), (0, False)):
        a = _kernel_inputs(slot, "bfloat16", seed=5)
        g = np.asarray(jnp.asarray(50.0 * a["g"].astype(np.float32), jnp.bfloat16))
        want = jfl._bwd_dw_call(_j(a["xq"]), _j(g), _j(a["scalars"]).reshape(1, 4),
                                symmetric=True, eps=1e-5, block_k=256, block_n=128,
                                interpret=True)
        got = tfl.fused_linear_bwd_dw(_t(a["xq"]), _t(g), _t(a["scalars"])).numpy()
        assert (np.abs(got).max() == 10.0) == clamped
        assert (np.abs(got) == 10.0).mean() > (0.5 if clamped else -1)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=KERNEL_TOL * np.abs(np.asarray(want)).max())


@pytest.mark.parametrize("M,K,N,n_sm", [(8192, 768, 2304, 132), (8192, 768, 768, 132),
                                         (8192, 768, 3072, 132), (8192, 3072, 768, 132),
                                         (256, 256, 384, 132), (100, 96, 136, 8)])
def test_dw_splits_fill_the_card(M, K, N, n_sm):
    """Kernel #16's chunks of M (host-side arithmetic): between 1 and
    DW_MAX_SPLITS, never more than the 32-row steps of M, and no split
    count has fewer waves x steps per block (blocks two to an SM)."""
    s = tfl.dw_splits(M, K, N, n_sm)
    steps = -(-M // tfl.DW_STEP)
    tiles = -(-K // tfl.DW_TILE) * -(-N // tfl.DW_TILE)
    cost = lambda c: -(-tiles * c // (2 * n_sm)) * -(-steps // c)
    assert 1 <= s <= min(tfl.DW_MAX_SPLITS, steps)
    assert cost(s) == min(cost(c) for c in range(1, min(tfl.DW_MAX_SPLITS, steps) + 1))
    if M == 8192:  # the GPT-2 training shapes on an H100: one (K, N) pass does not fill it
        assert s > 1 and cost(s) < cost(1)


# ---------------------------------------------------------------------------
# sp_linear of both packages
# ---------------------------------------------------------------------------


def _cfgs(rank=R, compute_dtype="bfloat16", impl="fused"):
    q = dict(bit_widths=BITS,
             lora_rank_per_bit={b: rank for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 2 * rank for b in range(2, 17)} | {32: 0})
    m = dict(n_embd=K, n_layer=1, n_head=4, vocab_size=512)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                            compute_dtype=compute_dtype, linear_impl=impl),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                             compute_dtype=compute_dtype, linear_impl=impl))


def _linear(jcfg, seed=0, rank=R):
    """One linear's numpy parameters, calibrated per slot by the JAX
    package (weights per column, inputs per channel on x), LoRA B non-zero,
    weights off the log slot's ties; and an input x (2, 128, K)."""
    q = jcfg.quant
    rng = np.random.default_rng(seed)
    P = q.n_prec
    w = rng.uniform(-1 / 16, 1 / 16, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (2, M // 2, K)).astype(np.float32)
    enabled = np.asarray([1.0 if s > 0 else 0.0 for s in q.scaling_table()], np.float32)
    p = {"w": w, "b": rng.normal(0, 0.1, N).astype(np.float32),
         "lora_A": rng.uniform(-0.25, 0.25, (P, K, rank)).astype(np.float32)
         * enabled[:, None, None],
         "lora_B": rng.normal(0, 0.05, (P, rank, N)).astype(np.float32),
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


def _grads_both(jcfg, tcfg, p, x, prec, cot, **kw):
    """(out, grads of x/w/b/lora_A/lora_B) of each package's sp_linear with
    the output cotangent `cot`."""
    jt, tt = jsp.prec_tables(jcfg.quant), tsp.prec_tables(tcfg.quant, "cpu")

    def jf(pp, xx):
        return jsp.sp_linear(xx, pp, jnp.int32(prec), jt, jcfg, **kw)[0]

    @jax.jit
    def jgrads(pp, xx, c):
        out, vjp = jax.vjp(jf, pp, xx)
        return out, vjp(c)

    jout, (jgp, jgx) = jgrads(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(cot))
    tp = bridge.params_from_numpy(p, "cpu")
    for k in ("w", "b", "lora_A", "lora_B"):
        tp[k].requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    tout, _ = tsp.sp_linear(tx, tp, prec, tt, tcfg, **kw)
    tout.backward(torch.tensor(cot))
    want = {"out": jout, "x": jgx} | {k: jgp[k] for k in ("w", "b", "lora_A", "lora_B")}
    got = {"out": tout.detach(), "x": tx.grad} | {k: tp[k].grad for k in
                                                 ("w", "b", "lora_A", "lora_B")}
    return got, want


# Errors relative to max |JAX|. At the teacher slot and the 4-bit minmax
# slot: float32 summation order, and now and then a gradient element on a
# bf16 rounding boundary (dxq, dxa and the LoRA products are rounded to
# bf16) takes the neighbouring bf16 value, one bf16 ulp of that element.
# At the 8-bit log slot the input's codes go through log2/exp2, whose
# float32 results differ by an ulp between XLA and PyTorch: an activation
# near a code boundary takes the neighbouring code (1.1 % apart) in one
# package, which moves its row of the output and its column of dW.
SP_TOL = {0: 4e-3, 1: 2e-2, 2: 4e-3}


@pytest.mark.parametrize("prec", [0, 1, 2])
def test_sp_linear_fused_matches_jax(monkeypatch, prec):
    """Port `sp_linear` at linear_impl="fused", bf16, against the JAX one:
    the output and the gradients of x, w, b, lora_A and lora_B (LoRA at
    the student slots only) within SP_TOL; both took the fused path."""
    jcfg, tcfg = _cfgs()
    p, x = _linear(jcfg, seed=prec)
    cot = np.random.default_rng(99).normal(0, 1, (2, M // 2, N)).astype(np.float32)
    calls = []
    real = tfl.sp_linear_fused
    monkeypatch.setattr(tsp, "sp_linear_fused", lambda *a: calls.append(1) or real(*a))
    jreal = jfl._fwd_call
    monkeypatch.setattr(jfl, "_fwd_call", lambda *a, **k: calls.append(2) or jreal(*a, **k))
    got, want = _grads_both(jcfg, tcfg, p, x, prec, cot)
    assert sorted(calls) == [1, 2]
    for name in got:
        if prec == 2 and name.startswith("lora"):
            assert float(np.abs(np.asarray(want[name])).max()) == 0.0
            assert float(got[name].abs().max()) == 0.0
            continue
        err = _rel(got[name], want[name])
        assert err <= SP_TOL[prec], f"{name}: {err:.2e}"


# The "cond" path's gradient products take the unrounded float32 g and are
# rounded to bf16 after the product, in both packages; they differ only in
# float32 summation order, so a gradient element differs at all only where
# that moves a product across a bf16 rounding boundary. Measured: 0.07 % of
# elements or fewer (x, w, lora_A, lora_B at slots 0 and 2). Rounding g
# before the products instead (the flat path's rule) moves 33-100 % of
# them.
COND_DIFF_SHARE = 0.02


@pytest.mark.parametrize("prec", [0, 2])
def test_sp_linear_cond_grads_match_jax(prec):
    """Port `sp_linear` at linear_impl="cond", bf16, against the JAX one:
    gradients of x, w, lora_A and lora_B within SP_TOL of max |JAX|, and
    at most COND_DIFF_SHARE of their elements differing by more than
    float32 rounding (2e-6 of the element)."""
    jcfg, tcfg = _cfgs(impl="cond")
    p, x = _linear(jcfg, seed=7)
    cot = np.random.default_rng(98).normal(0, 1, (2, M // 2, N)).astype(np.float32)
    got, want = _grads_both(jcfg, tcfg, p, x, prec, cot)
    np.testing.assert_allclose(got["out"].numpy(), np.asarray(want["out"]), rtol=1e-5,
                               atol=1e-5)
    for name in ("x", "w") + (("lora_A", "lora_B") if prec == 0 else ()):
        g, w = got[name].numpy(), np.asarray(want[name])
        err = np.abs(g - w)
        assert err.max() <= SP_TOL[prec] * np.abs(w).max(), name
        share = (err > 2e-6 * np.abs(w) + 1e-12).mean()
        assert share <= COND_DIFF_SHARE, f"{name}: {share:.3f} of elements differ"


# ---------------------------------------------------------------------------
# Fallbacks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["M=100", "rank 4", "calibration_mode"])
def test_fallbacks_take_the_flat_path_in_both(monkeypatch, case):
    """An unsupported shape or rank, or calibration mode, takes the flat
    path in both packages, decided before any launch; the two agree as
    the flat paths do (the weights' log codes at the 8-bit slot: 1e-5)."""
    rank = 4 if case == "rank 4" else R
    jcfg, tcfg = _cfgs(rank=rank)
    p, x = _linear(jcfg, seed=3, rank=rank)
    if case == "M=100":
        x = x[:1, :100]
    kw = {"calibration_mode": True} if case == "calibration_mode" else {}
    calls = []
    monkeypatch.setattr(tsp, "sp_linear_fused", lambda *a: calls.append(1))
    monkeypatch.setattr(jfl, "sp_linear_fused", lambda *a, **k: calls.append(2))
    cot = np.random.default_rng(97).normal(0, 1, x.shape[:-1] + (N,)).astype(np.float32)
    got, want = _grads_both(jcfg, tcfg, p, x, 1, cot, **kw)
    assert calls == []
    for name in ("out", "x", "w"):
        assert _rel(got[name], want[name]) <= 2e-2, name


def test_quantizer_banks_get_no_gradient():
    """The fused path gives the quantizer scale banks no gradient."""
    jcfg, tcfg = _cfgs()
    p, x = _linear(jcfg, seed=4)
    tp = bridge.params_from_numpy(p, "cpu")
    for k in tp:
        tp[k].requires_grad_(True)
    out, _ = tsp.sp_linear(torch.tensor(x), tp, 0, tsp.prec_tables(tcfg.quant, "cpu"), tcfg)
    out.sum().backward()
    for k in ("wq_scale", "wq_zp", "iq_scale", "iq_zp"):
        assert tp[k].grad is None or not tp[k].grad.any(), k
    assert tp["w"].grad is not None and tp["w"].grad.abs().max() > 0


# ---------------------------------------------------------------------------
# A whole train step of both packages on the fused path
# ---------------------------------------------------------------------------


def test_train_step_fused_matches_jax(monkeypatch):
    """One SP distillation step of both packages at linear_impl="fused"
    (config of test_torch_train_model.py with LoRA rank 8, which the fused
    gate takes; float32 compute), the JAX draws replayed into the port's
    step: metrics and the update of every trainable leaf within the limits
    of test_torch_train_step.py, frozen leaves unchanged. Both packages
    took the fused path: the port's plain #14 ran 4·L times per micro-step,
    and the JAX step traced its fused forward kernel."""
    from llm_qat_tpu.train import sp_trainer as jst
    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train import sp_trainer as tst
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
    from test_torch_train_model import LINEARS, B, T, clear_log_ties
    from test_torch_train_step import RTOL, TRAIN, UPDATE_TOL, _replayed_draws

    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 8 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=T, n_embd=128, n_layer=2, n_head=2,
             embd_pdrop=0.0)
    kw = dict(attention_impl="flash", linear_impl="fused")
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q), **kw)
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q), **kw)
    # JAX init with non-zero LoRA B banks, calibrated by the port (its
    # calibration is held against the JAX package's in
    # test_torch_train_quant.py), clear of log-grid ties
    jp = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for lin in LINEARS:
        b = jp["blocks"][lin]
        b["lora_B"] = rng.normal(0, 0.05, b["lora_B"].shape).astype(np.float32)
    cal = [torch.tensor(rng.integers(0, 256, (B, T))) for _ in range(2)]
    jp = clear_log_ties(bridge.params_to_numpy(CalibrationManager(tcfg, 2).calibrate_all_precisions(
        bridge.params_from_numpy(jp, "cpu"), cal)), jcfg.quant)
    ids = np.random.default_rng(21).integers(0, 256, (B, T))
    jtc, ttc = J.TrainConfig(**TRAIN), tc.TrainConfig(**TRAIN)
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
    j_state = j_init(jax.tree.map(jnp.asarray, jp))
    t_state = t_init(bridge.params_from_numpy(jp, "cpu"))
    rng = jax.random.PRNGKey(101)
    precs, layers = _replayed_draws(rng, jcfg, jtc)
    assert sorted(set(precs.tolist())) == [0, 1]  # both student kinds run
    j_new, jm = jax.jit(j_step)(j_state, jnp.asarray(ids), rng)
    t_new, tm = t_step(t_state, torch.tensor(ids), torch.Generator().manual_seed(0),
                       precs=precs, layers=layers)
    L = jcfg.model.n_layer
    assert counts["port"] == 4 * L * ttc.gradient_accumulation_steps
    assert counts["jax"] > 0 and counts["jax"] % (4 * L) == 0
    np.testing.assert_array_equal(tm["precisions"].numpy(), np.asarray(jm["precisions"]))
    for key, rtol in RTOL.items():
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, err_msg=key)
    mask = tst.trainable_mask(jp)
    for path, trainable in optim.leaves_with_paths(mask):
        old = optim.get_leaf(jp, path)
        dj = np.asarray(optim.get_leaf(j_new.params, path)) - old
        dt = optim.get_leaf(t_new.params, path).numpy() - old
        if not trainable:
            assert not dt.any() and not dj.any(), path
            continue
        err = np.abs(dt - dj).max() / np.abs(dj).max()
        assert err <= UPDATE_TOL, f"{path}: update err {err:.2e}"
