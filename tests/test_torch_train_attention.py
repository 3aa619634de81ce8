"""PyTorch port, training slice: the trainable flash path's plain versions
against the JAX Pallas kernels #5 and #6 (interpret mode) on the CPU, the
route of #5's and #6's kernels on the card (one rule for both) and the
plan of #6's (padding), and the `attention_impl` dispatch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_qat_tpu.ops import attention as ja
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.ops import attention as ta

# Errors relative to max |reference|. float32: sums in another order
# (measured up to 3e-7). bf16: both round P (and dS) to bf16 at the same
# points, P at the running max of the same k-blocks, but a float32 value
# one ulp apart may round to the neighbouring bf16 value, which moves a few
# outputs by one bf16 ulp of their own (measured 8.3e-6 of the largest
# output at T = 256, 5.4e-8 for the gradients).
TOL = {"float32": 2e-6, "bfloat16": 2.0 ** -14}


def _qkv(T, dtype, seed=0, D=64):
    rng = np.random.default_rng(seed)
    qkv = [rng.normal(0, 1.0, (2, 2, T, D)).astype(np.float32) for _ in range(3)]
    do = rng.normal(0, 1.0, (2, 2, T, D)).astype(np.float32)
    jd = jnp.dtype(dtype)
    j = [jnp.asarray(x, jd) for x in qkv + [do]]
    t = [bridge.params_from_numpy(np.asarray(x), "cpu") for x in j]
    return j, t


def _close(got, want, dtype, what):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: rel err {err:.3e} > {TOL[dtype]:.3e}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 256])
def test_flash_fwd_lse_plain_matches_pallas(dtype, T):
    """O and LSE of `flash_fwd_lse_plain` against `_flash_fwd_call` in
    interpret mode with the JAX package's own block sizes (at T = 256 the
    K/V stream has two blocks). Errors relative to max |reference|."""
    (q, k, v, _), (tq, tk, tv, _) = _qkv(T, dtype, seed=T)
    bq, bk = ja.flash_blocks(T)
    jo, jl = ja._flash_fwd_call(q, k, v, bq, bk, True)
    to, tl = ta.flash_fwd_lse_plain(tq, tk, tv)
    assert to.dtype == tq.dtype and tl.dtype == torch.float32
    assert tuple(tl.shape) == jl.shape
    _close(to, jo, dtype, "O")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-6, rtol=0)


def bf16_spread(got, want):
    """(share of outputs that differ, largest difference in bf16 ulps at
    the max |want| of the element's row)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    top = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(top)) - 7)
    return float((got != want).mean()), float((np.abs(got - want) / ulp).max())


@pytest.mark.parametrize("T", [256, 512])
def test_flash_fwd_lse_plain_rounds_p_at_jax_blocks(T):
    """bf16 O of `flash_fwd_lse_plain` (its k-block by default JAX's for T:
    128 keys at T = 256, 256 at T = 512) against `_flash_fwd_call` in
    interpret mode: both round P at the running max of the same k-blocks,
    so at most 0.1 % of the bf16 outputs differ (float32 sums in another
    order; measured 0.006-0.009 %), each by at most one bf16 ulp of its
    row's max. P rounded at the row's final max instead moves 7 % of them."""
    rng = np.random.default_rng(T + 1)
    x = [rng.normal(0, 1, (1, 2, T, 64)).astype(np.float32) for _ in range(3)]
    bq, bk = ja.flash_blocks(T)
    jo, jl = ja._flash_fwd_call(*(jnp.asarray(a, jnp.bfloat16) for a in x), bq, bk, True)
    to, tl = ta.flash_fwd_lse_plain(*(torch.tensor(a).to(torch.bfloat16) for a in x))
    share, ulps = bf16_spread(to, jo)
    print("O share differing", share, "max ulps of the row's max", ulps)
    assert share <= 1e-3 and ulps <= 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-6, rtol=0)


def test_flash_blocks_match_jax():
    """The port's copy of `flash_blocks` equals JAX's for T = 128 .. 2048,
    and `jax_block_k` of a ragged T is the block of T padded to a multiple
    of 128, as the JAX serving prefill pads it."""
    for T in range(128, 2049, 128):
        assert ta.flash_blocks(T) == ja.flash_blocks(T), T
        assert ta.jax_block_k(T) == ja.flash_blocks(T)[1]
    for T, Tp in ((1, 128), (65, 128), (200, 256), (300, 384), (513, 640), (1000, 1024)):
        assert ta.jax_block_k(T) == ja.flash_blocks(Tp)[1]


@pytest.mark.parametrize("T", [128, 200, 384, 512])
def test_flash_wrappers_take_the_jax_k_block(T):
    """On CPU tensors both forwards are the JAX loop over JAX's k-block for
    T (`jax_block_k`: 128 keys up to 256 rows, T padded to a multiple of
    128, 256 above), bit for bit; at T = 512 another block (128 keys)
    gives other bf16 outputs, so the block is the wrappers' own choice."""
    _, (tq, tk, tv, _) = _qkv(T, "bfloat16", seed=T)
    bk = ta.jax_block_k(T)
    assert bk == (256 if T > 384 else 128)
    acc, l, m = ta._flash_loop(tq, tk, tv, bk)
    want = (acc / l).to(torch.bfloat16)
    assert torch.equal(ta.flash_attention(tq, tk, tv), want)
    o, lse = ta.flash_fwd_lse(tq, tk, tv)
    assert torch.equal(o, want) and torch.equal(lse, m + torch.log(l))
    if bk != 128:
        acc, l, _ = ta._flash_loop(tq, tk, tv, 128)
        assert not torch.equal((acc / l).to(torch.bfloat16), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_plain_matches_pallas(dtype):
    """dq, dk, dv through the port's `flash_attention_trainable` (CPU: the
    plain versions) against `jax.vjp` of the JAX `flash_attention_trainable`
    in interpret mode, with a cotangent in the operand dtype."""
    (q, k, v, do), (tq, tk, tv, tdo) = _qkv(128, dtype, seed=7)
    out, vjp = jax.vjp(lambda a, b, c: ja.flash_attention_trainable(a, b, c, 128, 128, True),
                       q, k, v)
    want = vjp(do)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    got_o = ta.flash_attention_trainable(*leaves)
    got_o.backward(tdo)
    _close(got_o.detach(), out, dtype, "O")
    for name, leaf, w in zip("qkv", leaves, want):
        assert leaf.grad.dtype == leaf.dtype
        _close(leaf.grad, w, dtype, "d" + name)


def test_flash_bwd_plain_matches_dense_autograd():
    """In float32 the written-out backward equals autograd of the dense
    reference (the same function) to float32 rounding."""
    _, (q, k, v, do) = _qkv(96, "float32", seed=3)
    a = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ta.causal_attention_reference(*a).backward(do)
    o, lse = ta.flash_fwd_lse_plain(q, k, v)
    for got, leaf in zip(ta.flash_bwd_plain(q, k, v, o, lse, do), a):
        np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=2e-5)


def test_flash_rule_and_constants_match_jax():
    assert ta.FLASH_MIN_T == ja.FLASH_MIN_T
    for T, D, mask in [(128, 64, None), (1024, 128, None), (200, 64, None),
                       (256, 32, None), (256, 64, np.ones((1, 256)))]:
        assert ta.flash_supported(T, D, mask) == ja.flash_supported(T, D, mask)


@pytest.mark.parametrize("dtype,D,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt")])
def test_flash_bwd_plan_routes_by_dtype_and_head_dim(dtype, D, route):
    """Kernel #6 takes the wgmma kernels for bf16 at head_dim 64 (every
    GPT-2 size); float32 (no exact float32 product on the tensor cores)
    and bf16 at head_dim 128 take the float32 SIMT kernels."""
    assert ta.flash_bwd_plan(dtype, 1024, D).route == route


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_fwd_and_bwd_take_the_same_route(dtype, D):
    """Kernels #5 and #6 change route together: the forward's route
    (`flash_route`, which `flash_fwd_lse` takes on the card) is the
    backward's plan's for every operand dtype and head_dim, at every T."""
    for T in (1, 200, 1024):
        assert ta.flash_route(dtype, D) == ta.flash_bwd_plan(dtype, T, D).route
    assert ta.flash_route(dtype, D) == (
        "wgmma" if (dtype, D) == (torch.bfloat16, 64) else "simt")


@pytest.mark.parametrize("T", [1, 64, 128, 200, 1024])
def test_flash_bwd_plan_pads_rows_to_whole_blocks(T):
    """The row vectors are padded to whole 128-row blocks: the bulk copies
    of a block's rows never reach the next head's."""
    t_pad = ta.flash_bwd_plan(torch.bfloat16, T, 64).t_pad
    assert t_pad % ta.BWD_TILE == 0 and T <= t_pad < T + ta.BWD_TILE


def _tiny_cfg(impl, n_positions=128):
    return tc.SPModelConfig(
        model=tc.GPT2Config(vocab_size=64, n_positions=n_positions, n_embd=128,
                            n_layer=1, n_head=2),
        quant=tc.QuantConfig(bit_widths=(4, 32),
                             lora_rank_per_bit={4: 4, 32: 0},
                             lora_alpha_per_bit={4: 8, 32: 0}),
        attention_impl=impl)


@pytest.mark.parametrize("impl,T,flash", [
    ("dense", 128, False), ("flash", 128, True), ("flash", 96, False),
    ("auto", 128, False), ("auto", 1024, False)])
def test_attention_impl_selects_the_path(monkeypatch, impl, T, flash):
    """"flash" forces the trainable flash path where the shape allows it;
    "auto" takes it only for CUDA tensors (from T = 1024), so on the CPU it
    runs dense at every length, as the JAX package does off the TPU."""
    calls = []
    real = ta.flash_attention_trainable
    monkeypatch.setattr(ta, "flash_attention_trainable",
                        lambda *a: calls.append(1) or real(*a))
    cfg = _tiny_cfg(impl, max(T, 128))
    params = tsp.init_sp_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ids = torch.randint(0, 64, (1, T), generator=torch.Generator().manual_seed(1))
    out = tsp.sp_forward(params, ids, 1, cfg)
    assert bool(torch.isfinite(out["logits"]).all())
    assert bool(calls) == flash


def test_fused_linear_and_ring_attention_raise(monkeypatch):
    """linear_impl="fused" runs: the fused linear (here its plain versions)
    where the JAX shape gate passes (M = 256, K = 128, rank 8), the flat
    linear elsewhere (M = 8, and calibration with the input quantizer in
    pass-through), as in the JAX package. Ring attention, whose module is
    not ported, raises instead of running something else."""
    from llm_qat_tpu_torch.ops import fused_linear as tfl

    calls = []
    real = tfl.fused_linear_fwd
    monkeypatch.setattr(tfl, "fused_linear_fwd", lambda *a: calls.append(1) or real(*a))
    cfg = _tiny_cfg("auto").replace(linear_impl="fused")
    cfg = cfg.replace(quant=tc.QuantConfig(bit_widths=(4, 32), lora_rank_per_bit={4: 8, 32: 0},
                                           lora_alpha_per_bit={4: 8, 32: 0}))
    params = tsp.init_sp_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ids = torch.randint(0, 64, (2, 128), generator=torch.Generator().manual_seed(1))
    out = tsp.sp_forward(params, ids, 0, cfg)
    assert bool(torch.isfinite(out["logits"]).all())
    assert len(calls) == 4 * cfg.model.n_layer
    flat = tsp.sp_forward(params, ids, 0, cfg.replace(linear_impl="flat"))
    torch.testing.assert_close(out["logits"], flat["logits"], atol=1e-3, rtol=0)
    for kw, short in (({}, True), ({"calibration_mode": True, "input_passthrough": True}, False)):
        calls.clear()
        x = ids[:1, :8] if short else ids
        out = tsp.sp_forward(params, x, 0, cfg, **kw)
        assert bool(torch.isfinite(out["logits"]).all()) and calls == []
    with pytest.raises(NotImplementedError, match="A.9"):
        tsp.sp_forward(params, ids, 0, _tiny_cfg("auto"), attention_fn=lambda *a: a[0])
