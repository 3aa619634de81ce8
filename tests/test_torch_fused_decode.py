"""PyTorch port: the fused int8 decode layer (kernels #12 `fused_ln_qkv` and
#13 `fused_post_attention`), the dense-cache decode attention (#9
`decode_attention`) and `infer_forward_unrolled(fused_linears=True,
fused_attention=True)` against the JAX package on the CPU (the Pallas
kernels in interpret mode).

Tiny sizes: B = 3 rows, d = 64 / 128, rank 4 LoRA; the decode steps use
the JAX package's own `test_fused_steps_match_unfused` model (L = 2, d = 64,
2 heads, int8_xla float32 tree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models import inference as ji
from llm_qat_tpu.ops import decode_attention as jda
from llm_qat_tpu.ops import fused_decode as jfd
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.ops import decode_attention as tda
from llm_qat_tpu_torch.ops import fused_decode as tfd

B = 3


def test_erf_matches_jax():
    """The A&S erf in the same float32 operations as the JAX `_erf`: within
    2e-7 (XLA's and PyTorch's float32 exp may differ by an ulp); both
    within 5e-7 of the exact erf (the A&S bound 1.5e-7 plus rounding)."""
    x = np.linspace(-6.0, 6.0, 4097, dtype=np.float32)
    want = np.asarray(jfd._erf(jnp.asarray(x)))
    got = tfd._erf(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-7, rtol=0)
    assert np.abs(got - np.asarray(jax.lax.erf(jnp.asarray(x)))).max() < 5e-7
    g = np.asarray(jfd._gelu_exact(jnp.asarray(x)))
    np.testing.assert_allclose(tfd._gelu_exact(torch.tensor(x)).numpy(), g,
                               atol=1e-6, rtol=1e-6)


def _linear(rng, K, N, lora, bank):
    """An int8_xla linear: codes, per-column scales, bias, a static input
    scale, and LoRA banks in `bank` dtype (or none)."""
    lin = {"w_i8": rng.integers(-127, 128, (K, N)).astype(np.int8),
           "w_s": rng.uniform(2e-4, 1e-3, (N,)).astype(np.float32),
           "b": rng.normal(0, 0.1, (N,)).astype(np.float32)}
    if lora:
        lin["lora_A"] = rng.normal(0, 0.3, (K, 4)).astype(np.float32)
        lin["lora_B"] = rng.normal(0, 0.05, (4, N)).astype(np.float32)
    j = {k: jnp.asarray(v, bank if k.startswith("lora") else None) for k, v in lin.items()}
    t = {k: torch.tensor(v).to(getattr(torch, bank) if k.startswith("lora") else None)
         for k, v in lin.items()}
    return j, t


def _close(got, want):
    """rtol 1e-5 / atol 1e-5 on O(1) outputs: the integer dots are exact in
    both packages; LN, LoRA and GELU sums are float32 in another order."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lora,bank", [(True, "bfloat16"), (True, "float32"),
                                       (False, "bfloat16")])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_ln_qkv_plain_matches_pallas(d, lora, bank):
    rng = np.random.default_rng(d + 10 * lora)
    h = rng.normal(0, 1.0, (B, d)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
    b = rng.normal(0, 0.1, (d,)).astype(np.float32)
    jl, tl = _linear(rng, d, 3 * d, lora, bank)
    xs = np.float32(3.0 / 127.0)
    want = jfd.fused_ln_qkv(jnp.asarray(h), jnp.asarray(g), jnp.asarray(b), jl["w_i8"],
                            jl["w_s"], jl["b"], xs, jl.get("lora_A"), jl.get("lora_B"),
                            interpret=True)
    got = tfd.fused_ln_qkv(torch.tensor(h), torch.tensor(g), torch.tensor(b), tl["w_i8"],
                           tl["w_s"], tl["b"], torch.tensor(xs), tl.get("lora_A"),
                           tl.get("lora_B"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, 3 * d)
    _close(got, want)


@pytest.mark.parametrize("lora,bank", [(True, "bfloat16"), (True, "float32"),
                                       (False, "bfloat16")])
@pytest.mark.parametrize("d", [64, 128])
def test_fused_post_attention_plain_matches_pallas(d, lora, bank):
    rng = np.random.default_rng(2 * d + lora)
    attn = rng.normal(0, 1.0, (B, d)).astype(np.float32)
    h = rng.normal(0, 1.0, (B, d)).astype(np.float32)
    g = rng.uniform(0.5, 1.5, (d,)).astype(np.float32)
    b = rng.normal(0, 0.1, (d,)).astype(np.float32)
    lins = [_linear(rng, K, N, lora, bank) for K, N in ((d, d), (d, 4 * d), (4 * d, d))]
    xs = np.array([3.0, 4.0, 2.0], np.float32) / 127.0
    want = jfd.fused_post_attention(jnp.asarray(attn), jnp.asarray(h), jnp.asarray(g),
                                    jnp.asarray(b), *[j for j, _ in lins], jnp.asarray(xs),
                                    interpret=True)
    got = tfd.fused_post_attention(torch.tensor(attn), torch.tensor(h), torch.tensor(g),
                                   torch.tensor(b), *[t for _, t in lins], torch.tensor(xs))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, d)
    _close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(dtype):
    """#9 at a shared position (0, an inner one, T - 1) and per slot: the
    outputs within 2e-6 (float32 softmax sums in another order; values
    O(1)); the caches equal, row pos written in the cache dtype. The rows
    past each position are poisoned with 1e6: masked, they must add exactly
    nothing."""
    H, T, D = 2, 24, 64
    rng = np.random.default_rng(9)
    q, kn, vn = (rng.standard_normal((B, H, 1, D)).astype(np.float32) for _ in range(3))
    kc, vc = (rng.standard_normal((B, H, T, D)).astype(np.float32) for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for pos in (0, 11, T - 1, np.array([3, 0, T - 1], np.int32)):
        p = np.broadcast_to(pos, (B,))
        poison = np.arange(T)[None, None, :, None] > p[:, None, None, None]
        kp, vp = (np.where(poison, 1e6, c).astype(np.float32) for c in (kc, vc))
        jo, jk, jv = jda.decode_attention(jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
                                          jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
                                          jnp.asarray(pos), interpret=True)
        tk, tv = torch.tensor(kp).to(tdt), torch.tensor(vp).to(tdt)
        to, tk2, tv2 = tda.decode_attention(torch.tensor(q), torch.tensor(kn),
                                            torch.tensor(vn), tk, tv, pos)
        assert tk2 is tk and tv2 is tv  # in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-6, rtol=0,
                                   err_msg=f"pos {pos}")
        for a, c in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(a.float().numpy(), np.asarray(c, np.float32))


def test_decode_attention_checks_positions():
    q = torch.zeros((2, 1, 1, 64))
    kc = torch.zeros((2, 1, 8, 64))
    for pos in (8, -1, [0, 8], [1, -1]):
        with pytest.raises(ValueError, match="outside the cache"):
            tda.decode_attention(q, q, q, kc, kc.clone(), pos)


@pytest.fixture(scope="module")
def steps_model():
    """The JAX package's `test_fused_steps_match_unfused` model, its weight
    and input quantizers calibrated in JAX, as float32 int8_xla trees of
    both packages."""
    rng = np.random.default_rng(0)
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"}, per_channel=False,
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=512, n_embd=64, n_layer=2, n_head=2)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q))
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    params = J.init_sp_params(jax.random.PRNGKey(0), jcfg)
    key = jax.random.PRNGKey(7)
    for blk in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        lin = params["blocks"][blk]
        lin["lora_B"] = 0.05 * jax.random.normal(key, lin["lora_B"].shape,
                                                 lin["lora_B"].dtype)
    batches = [jnp.asarray(rng.integers(0, 256, (2, 16))) for _ in range(2)]
    params = jcm.calibrate_weight_quantizers(params, jcfg)
    params = jcm.calibrate_input_quantizers(params, jcfg, batches)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    jt = ji.quantize_for_inference(params, jcfg, 8, jnp.float32, weight_format="int8_xla")
    tt = ti.quantize_for_inference(tp, tcfg, 8, torch.float32, weight_format="int8_xla")
    return jcfg, tcfg, jt, tt, np.asarray(batches[0][:, :8])


@pytest.mark.parametrize("layout,fused_attention", [("packed", False), ("dense", True)])
def test_fused_steps_match_jax(steps_model, layout, fused_attention):
    """An 8-token prefill, then three decode steps with `fused_linears`
    (packed caches: the attention stays #7, as in JAX's own test) and with
    `fused_attention` + `fused_linears` (dense caches: #9, #12, #13 in
    each layer), in both packages on the same tokens: the logits within
    rtol 1e-5 / atol 1e-6 (the tolerance of the JAX package's fused-vs-
    unfused test), and the caches within float32 rounding."""
    jcfg, tcfg, jt, tt, ids = steps_model
    jt, tt = dict(jt), dict(tt)
    jst, tst = jt.pop("_static"), tt.pop("_static")
    jc = ji.init_layer_caches(jcfg, 2, 128, jnp.float32, kv_layout=layout)
    tcs = ti.init_layer_caches(tcfg, 2, 128, torch.float32, kv_layout=layout, device="cpu")
    jl, jc, _ = ji.infer_forward_unrolled(jt, jnp.asarray(ids), jcfg, jc, jnp.int32(0),
                                          static=jst, attn_interpret=True)
    tl, tcs, _ = ti.infer_forward_unrolled(tt, torch.tensor(ids), tcfg, tcs, 0, static=tst)
    tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1))
    flags = dict(fused_linears=True, fused_attention=fused_attention)
    for pos in range(8, 11):
        jl, jc, _ = ji.infer_forward_unrolled(jt, jnp.asarray(tok), jcfg, jc, jnp.int32(pos),
                                              static=jst, attn_interpret=True, **flags)
        tl, tcs, n = ti.infer_forward_unrolled(tt, torch.tensor(tok), tcfg, tcs, pos,
                                               static=tst, **flags)
        assert n == pos + 1
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-6,
                                   err_msg=f"pos {pos}")
        tok = np.asarray(jnp.argmax(jl[:, -1:], axis=-1))
    for a, c in zip(tcs, jc):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-6)


def test_fused_steps_run_the_fused_ops(steps_model, monkeypatch):
    """Each fused step calls #12, #9 and #13 once per layer, and the h
    between fused layers stays float32 (`fused_post_attention`'s output)."""
    _, tcfg, _, tt, ids = steps_model
    tt = dict(tt)
    tst = tt.pop("_static")
    calls = []
    for name in ("fused_ln_qkv", "fused_post_attention", "decode_attention"):
        fn = getattr(ti, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append((_name, a[0].dtype))
            return _fn(*a, **k)
        monkeypatch.setattr(ti, name, spy)
    caches = ti.init_layer_caches(tcfg, 2, 32, torch.bfloat16, device="cpu")
    _, caches, _ = ti.infer_forward_unrolled(tt, torch.tensor(ids), tcfg, caches, 0,
                                             static=tst, fused_attention=True,
                                             fused_linears=True)
    assert calls == []  # S = 8: the fused paths are decode-only
    ti.infer_forward_unrolled(tt, torch.tensor(ids[:, :1]), tcfg, caches, 8, static=tst,
                              fused_attention=True, fused_linears=True)
    L = tcfg.model.n_layer
    assert [c[0] for c in calls] == ["fused_ln_qkv", "decode_attention",
                                     "fused_post_attention"] * L
    assert all(dt == torch.float32 for _, dt in calls)
