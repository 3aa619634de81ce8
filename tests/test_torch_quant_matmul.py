"""PyTorch port: the int8 / int4 packed-weight product (kernels #10
`quant_matmul_int8` and #11 `quant_matmul_int4`) and the `"int8"` weight
format of the inference path, against the JAX package on the CPU (the
Pallas kernels in interpret mode).

The engines run the tiny config of test_torch_engine.py on float32 trees,
as the JAX package's own engine-equality tests do."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import inference as ji
from llm_qat_tpu.models.inference import InferenceEngine as JEngine
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.models.inference import InferenceEngine as TEngine
from llm_qat_tpu_torch.ops import mega_decode as tm

# the module (llm_qat_tpu.ops exports its function quant_matmul under that name)
jq = importlib.import_module("llm_qat_tpu.ops.quant_matmul")
# the port's `ops` exports JAX's names, `quant_matmul` the function among them
tq = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")
V = 256


@pytest.mark.parametrize("per_channel", [True, False])
def test_packing_is_bit_equal(per_channel):
    """pack_int8, pack_int4 (+8 nibbles, rows interleaved) and unpack_int4
    give the JAX package's codes, bytes and scales bit for bit."""
    w = np.random.default_rng(1).normal(size=(64, 48)).astype(np.float32)
    w[3, 5] = 0.0
    for name in ("pack_int8", "pack_int4"):
        jc, js = getattr(jq, name)(jnp.asarray(w), per_channel)
        tcodes, ts = getattr(tq, name)(torch.tensor(w), per_channel)
        assert str(tcodes.dtype).split(".")[-1] == np.asarray(jc).dtype.name
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    packed = np.asarray(jq.pack_int4(jnp.asarray(w))[0])
    np.testing.assert_array_equal(tq.unpack_int4(torch.tensor(packed)).numpy(),
                                  np.asarray(jq.unpack_int4(jnp.asarray(packed))))
    with pytest.raises(ValueError, match="even K"):
        tq.pack_int4(torch.tensor(w[:63]))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,block_n", [(8, 128, 256, 128), (4, 64, 384, 256),
                                           (33, 96, 100, 64)])
def test_kernel_plain_matches_pallas(bits, M, K, N, block_n):
    """The plain versions of #10 / #11 against the Pallas kernels in
    interpret mode (bf16 operands, float32 sums, scale after the sum),
    ragged N included (N = 384 in blocks of 256, N = 100 in blocks of 64):
    rtol 1e-5 / atol 1e-5 (float32 sums of exact products in another
    order). The wrappers on CPU tensors are the plain versions."""
    rng = np.random.default_rng(M + K + N + bits)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(K, N)).astype(np.float32)
    jpack, jkern = ((jq.pack_int8, jq.quant_matmul_int8) if bits == 8 else
                    (jq.pack_int4, jq.quant_matmul_int4))
    packed, s = jpack(jnp.asarray(w))
    want = np.asarray(jkern(jnp.asarray(x), packed, s, block_n=block_n, interpret=True))
    tkern = tq.quant_matmul_int8 if bits == 8 else tq.quant_matmul_int4
    tplain = tq.quant_matmul_int8_plain if bits == 8 else tq.quant_matmul_int4_plain
    tp, ts = torch.tensor(np.asarray(packed)), torch.tensor(np.asarray(s))
    got = tkern(torch.tensor(x), tp, ts)
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, tplain(torch.tensor(x), tp, ts), rtol=0, atol=0)


@pytest.mark.parametrize("bits", [8, 4])
def test_reference_and_dispatch_match_jax(bits):
    """The float32 references against JAX's (rtol 1e-5: the same products
    of dequantized weights, sums in another order); `quant_matmul` on CPU
    tensors takes the reference, as JAX does off the TPU."""
    rng = np.random.default_rng(20 + bits)
    x = rng.normal(size=(6, 64)).astype(np.float32)
    w = rng.normal(size=(64, 72)).astype(np.float32)
    packed, s = (jq.pack_int8 if bits == 8 else jq.pack_int4)(jnp.asarray(w))
    ref = jq.quant_matmul_int8_reference if bits == 8 else jq.quant_matmul_int4_reference
    want = np.asarray(ref(jnp.asarray(x), packed, s))
    tx, tp, ts = torch.tensor(x), torch.tensor(np.asarray(packed)), torch.tensor(np.asarray(s))
    got = tq.quant_matmul(tx, tp, ts, bits=bits)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    tref = tq.quant_matmul_int8_reference if bits == 8 else tq.quant_matmul_int4_reference
    torch.testing.assert_close(got, tref(tx, tp, ts), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unsupported packed bits"):
        tq.quant_matmul(tx, tp, ts, bits=2)


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


@pytest.mark.parametrize("bits", [8, 4])
def test_int8_weight_format_tree_matches_jax(calibrated, bits):
    """quantize_for_inference(weight_format="int8"): per-layer, per-column
    `pack_int8` of the fake-quantized weight (always re-gridded), no static
    activation scale; every tensor bit-equal to JAX's. The mega layout
    refuses the tree, as in JAX."""
    jcfg, tcfg, jp, tp = calibrated
    want = ji.quantize_for_inference(jp, jcfg, bits, weight_format="int8", lm_head_bits=8)
    got = ti.quantize_for_inference(tp, tcfg, bits, weight_format="int8", lm_head_bits=8)
    assert tuple(want.pop("_static")) == tuple(got.pop("_static"))
    for name in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        jl, tl = want["blocks"][name], got["blocks"][name]
        assert sorted(jl) == sorted(tl) and "w_int8" in tl and "x_s" not in tl
        for k in jl:
            assert str(tl[k].dtype).split(".")[-1] == np.asarray(jl[k]).dtype.name, k
            np.testing.assert_array_equal(tl[k].float().numpy(),
                                          np.asarray(jl[k], np.float32), err_msg=k)
    with pytest.raises(ValueError, match="int8_xla/int4_xla"):
        tm.pack_mega_weights(got, tcfg)


@pytest.mark.parametrize("kv_layout,bits,prompt", [("dense", 8, 20), ("packed", 8, 21),
                                                   ("dense", 4, 20)])
def test_int8_engine_greedy_matches_jax(calibrated, kv_layout, bits, prompt):
    """`InferenceEngine(weight_format="int8")` greedy tokens equal to the
    JAX engine's on float32 trees: every linear through `quant_matmul`,
    whose CPU path is the float32 reference in both packages (the packed
    layout runs #7's plain version against its Pallas kernel)."""
    jcfg, tcfg, jp, tp = calibrated
    kw = dict(bits=bits, max_batch=2, max_len=64, weight_format="int8", lm_head_bits=8,
              kv_layout=kv_layout)
    ids = np.random.default_rng(prompt + bits).integers(0, V, (2, prompt))
    want = np.asarray(JEngine(jp, jcfg, attn_interpret=True, dtype=jnp.float32,
                              **kw).generate(ids, max_new_tokens=8))
    eng = TEngine(tp, tcfg, device="cpu", dtype=torch.float32, **kw)
    assert "w_int8" in eng.iparams["blocks"]["c_fc"]
    np.testing.assert_array_equal(eng.generate(ids, max_new_tokens=8).numpy(), want)


def test_int8_linear_runs_quant_matmul(calibrated, monkeypatch):
    """Each `w_int8` linear calls `quant_matmul` once on the (B·S, K) bf16
    input (4 per layer and forward); `use_kernels=False` calls the kernel's
    plain version instead."""
    _, tcfg, _, tp = calibrated
    tree = ti.quantize_for_inference(tp, tcfg, 8, torch.float32, weight_format="int8")
    st = tree.pop("_static")
    seen = {"quant_matmul": [], "quant_matmul_int8_plain": []}
    for name in seen:
        fn = getattr(ti, name)

        def spy(x, *a, _fn=fn, _name=name, **k):
            seen[_name].append((tuple(x.shape), x.dtype))
            return _fn(x, *a, **k)
        monkeypatch.setattr(ti, name, spy)
    ids = torch.zeros((2, 5), dtype=torch.int64)
    for use_kernels in (True, False):
        caches = ti.init_layer_caches(tcfg, 2, 16, torch.float32, device="cpu")
        ti.infer_forward_unrolled(tree, ids, tcfg, caches, 0, static=st,
                                  use_kernels=use_kernels)
    L = tcfg.model.n_layer
    for name in seen:
        assert len(seen[name]) == 4 * L
        assert all(s[0] == 10 and dt == torch.bfloat16 for s, dt in seen[name])


GPT2_LINEARS = [(768, 2304), (768, 768), (768, 3072), (3072, 768)]  # (K, N)


def _blocks(plan):
    return plan.grid[0] * plan.grid[1]


def _check_k_ranges(plan, K):
    """Each block of a cluster takes a non-empty run of whole K steps, in
    order, and together they cover [0, K) exactly."""
    span = plan.steps * tq.K_STEP
    ranges = [(r * span, min(K, (r + 1) * span)) for r in range(plan.split)]
    assert len(ranges) == plan.split and 1 <= plan.split <= tq.MAX_SPLIT
    assert ranges[0][0] == 0 and ranges[-1][1] == K
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == plan.steps * tq.K_STEP
    assert all(a0 < a1 and a0 % tq.K_STEP == 0 for a0, a1 in ranges)


@pytest.mark.parametrize("K,N", GPT2_LINEARS)
def test_launch_plan_fills_the_card_at_gpt2_decode_shapes(K, N):
    """M = 8 (a decode step): the small-M regime, K split in whole steps
    over a cluster; at least one block per SM of the H100, except where N
    has too few column blocks for a cluster of 8 to make up, which the plan
    says."""
    plan = tq.launch_plan(8, K, N, sms=132)
    assert plan.regime == "small" and (plan.rows, plan.cols) == tq.SMALL_TILE
    _check_k_ranges(plan, K)
    cb = -(-N // plan.cols)
    assert plan.grid == (cb * plan.split, 1)
    if cb * tq.MAX_SPLIT >= 132:
        assert _blocks(plan) >= 132 and plan.why == ""
    else:
        # the fewest K steps per block that a cluster of MAX_SPLIT allows
        assert plan.steps == -(-(-(-K // tq.K_STEP)) // tq.MAX_SPLIT)
        assert f"at most {tq.MAX_SPLIT} blocks" in plan.why


@pytest.mark.parametrize("K,N", GPT2_LINEARS)
@pytest.mark.parametrize("M", [1, tq.SMALL_M_MAX, tq.SMALL_M_MAX + 1, 1024])
def test_launch_plan_regime_by_m(M, K, N):
    """Up to SMALL_M_MAX rows the small-M regime (8 x 64 tiles), above it,
    and at path A's prefill M = 1024, 128 x 128 tiles; K split only where
    the tiles alone leave SMs idle (large M: fewer than two per SM), at
    most MAX_SPLIT ways (large M: LARGE_MAX_SPLIT)."""
    plan = tq.launch_plan(M, K, N, sms=132)
    _check_k_ranges(plan, K)
    small = M <= tq.SMALL_M_MAX
    assert plan.regime == ("small" if small else "large")
    assert (plan.rows, plan.cols) == (tq.SMALL_TILE if small else tq.LARGE_TILE)
    tiles = -(-N // plan.cols) * -(-M // plan.rows)
    assert plan.grid == (-(-N // plan.cols) * plan.split, -(-M // plan.rows))
    want, most = (132, tq.MAX_SPLIT) if small else (2 * 132, tq.LARGE_MAX_SPLIT)
    assert plan.split <= most
    assert (plan.split == 1) == (tiles >= want or K <= tq.K_STEP)
    assert (_blocks(plan) >= 132) == (plan.why == "")
@pytest.mark.parametrize("M,K,N", [(8, 1000, 256), (8, 800, 256), (3, 66, 100), (1, 64, 8),
                                   (16, 2, 8), (8, 32 * 9, 4096)])
def test_launch_plan_ragged_shapes(M, K, N):
    """K not a multiple of the step or of the split, narrow N: the ranges
    still cover K in whole steps, and a plan short of the card's SMs says
    why."""
    plan = tq.launch_plan(M, K, N, sms=132)
    assert plan.regime == "small"
    _check_k_ranges(plan, K)
    assert (_blocks(plan) >= 132) == (plan.why == "")
    if _blocks(plan) < 132:
        assert "K split" in plan.why
