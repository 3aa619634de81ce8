"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`; without a card every test here skips (the decision is made in
the `cuda_device` fixture, so every pytest-xdist worker collects the same
tests). On a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py configures JAX, which that machine
need not have.)
"""

import ctypes

import pytest
import torch

from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.inference import (
    InferenceEngine,
    init_layer_caches,
    quantize_for_inference,
)
from llm_qat_tpu_torch.models.sp_model import init_sp_params, sp_forward
from llm_qat_tpu_torch.ops import mega_decode as md
from llm_qat_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_plain,
    flash_bwd,
    flash_bwd_plain,
    flash_fwd_lse,
    flash_fwd_lse_plain,
)
from llm_qat_tpu_torch.train.calibration_manager import (
    calibrate_input_quantizers,
    calibrate_weight_quantizers,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("T", [64, 128, 200, 512])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_matches_plain(cuda_device, T, D):
    """float32, ragged T included: 1e-5 absolute (softmax and PV sums in
    another order; values O(1))."""
    g = torch.Generator(device=cuda_device).manual_seed(T + D)
    q, k, v = (torch.randn((2, 3, T, D), generator=g, device=cuda_device)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(got, flash_attention_plain(q, k, v), atol=1e-5, rtol=0)


@pytest.mark.parametrize("T", [64, 128, 200, 512])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_kernel_bf16_matches_plain(cuda_device, T, D):
    """Kernel #2 with bf16 operands (the serving prefill's dtype; the wgmma
    forward at head_dim 64, the SIMT forward at 128), ragged T = 200
    included, its k-block JAX's for T (128 keys up to T = 256, 256 at
    T = 512): one launch a call, repeat calls bit-equal, and within #5's
    bf16 limits of its plain version over all rows: 2 bf16 ulps at the max
    |plain| of the element's row plus 1e-5 of max |plain|, and at most 2 %
    of the outputs differing (both round P at the same k-block maxima, so
    they differ only by float32 summation order)."""
    g = torch.Generator(device=cuda_device).manual_seed(T + D + 1)
    q, k, v = (torch.randn((2, 3, T, D), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    for _ in range(2):
        assert torch.equal(flash_attention(q, k, v), got)
    want = flash_attention_plain(q, k, v)
    ulps = bf16_row_ulps(got, want, 1e-5 * want.float().abs().max()).max().item()
    share = (got != want).float().mean().item()
    print("out max bf16 ulps of the row's max", ulps, "share differing", share)
    assert ulps <= 2 and share <= 2e-2


def _small_setup(dev, n_embd=256, n_head=4):
    cfg = tc.SPModelConfig(
        model=tc.GPT2Config(vocab_size=512, n_positions=256, n_embd=n_embd,
                            n_layer=2, n_head=n_head),
        quant=tc.QuantConfig(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
                             per_channel=False),
        compute_dtype="bfloat16")
    g = torch.Generator(device=dev).manual_seed(0)
    p = init_sp_params(g, cfg, device=dev)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        lb = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = 0.02 * torch.randn(lb.shape, generator=g, device=dev)
    p = calibrate_weight_quantizers(p, cfg)
    p = calibrate_input_quantizers(
        p, cfg, [torch.randint(0, 512, (2, 64), generator=g, device=dev) for _ in range(2)])
    return cfg, p, g


@pytest.mark.parametrize("grid", [None, 7, 61, 132])
@pytest.mark.parametrize("wbits,kv_bits,lora_i8,act", [
    (4, 4, True, torch.bfloat16), (4, 4, True, torch.float32),
    (8, 8, False, torch.float32), (8, 8, True, torch.bfloat16)])
def test_mega_kernel_matches_plain(cuda_device, wbits, kv_bits, lora_i8, act, grid):
    """Both versions compute in float32 and sum in another order. Per batch
    row, max |kernel - plain| / max |plain h_out| is within float rounding
    (1e-5 in float32, 1e-2 with bf16 `_rt` roundings) for all rows but one
    in ten, where a value sat on a rounding boundary and one activation code
    moved; every row is within 5e-2. Appended K/V codes differ by at most
    one, in at most 1% of them; their row scales to 5e-2 relative (a moved
    code upstream shifts the row's absmax). Other cache rows are untouched.
    At the device's own grid (None) and at forced grids that divide no
    GEMV's work evenly."""
    cfg, p, g = _small_setup(cuda_device)
    d, L, H, B, T = 256, 2, 4, 3, 128
    tree = quantize_for_inference(p, cfg, wbits, weight_format=f"int{wbits}_xla")
    tree.pop("_static")
    mw = md.pack_mega_weights(tree, cfg, lora_int8=lora_i8)
    aq = float(tree["blocks"]["c_attn"]["qmax"][0]) if wbits == 4 else 127.0
    dc = d if kv_bits == 8 else d // 2
    c0 = [torch.randint(-127, 128, (L, B, T, dc), generator=g, device=cuda_device,
                        dtype=torch.int8) for _ in range(2)]
    c0 += [0.01 + 0.04 * torch.rand((L, B, T), generator=g, device=cuda_device)
           for _ in range(2)]
    tight = 1e-5 if act == torch.float32 else 1e-2
    rows, ndiff, ncode = [], 0, 0
    for pos in (0, 1, 63, 64, 100):
        h = 0.5 * torch.randn((B, d), generator=g, device=cuda_device)
        kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=act, aq_max=aq,
                  tbp=32, kv_bits=kv_bits)
        ck, cp = [c.clone() for c in c0], [c.clone() for c in c0]
        out_k = md.mega_decode_step_kv8(h, mw, *ck, pos, grid=grid, **kw)
        out_p = md.mega_decode_step_kv8_plain(h, mw, *cp, pos, **kw)
        rows += ((out_k[0] - out_p[0]).abs().amax(dim=1)
                 / out_p[0].abs().max()).tolist()
        for a, b in zip(out_k[1:3], out_p[1:3]):
            dcode = md._kv_codes(a[:, :, pos], kv_bits) - md._kv_codes(b[:, :, pos], kv_bits)
            assert dcode.abs().max() <= 1, pos
            ndiff, ncode = ndiff + int((dcode != 0).sum()), ncode + dcode.numel()
        for a, b in zip(out_k[3:], out_p[3:]):
            torch.testing.assert_close(a[:, :, pos], b[:, :, pos], rtol=5e-2, atol=0)
        rest = [r for r in range(T) if r != pos]
        for a, c in zip(out_k[1:], c0):
            assert torch.equal(a[:, :, rest], c[:, :, rest])
    print("row errors", sorted(rows), "codes differing", ndiff, "/", ncode)
    assert max(rows) <= 5e-2
    assert sum(e <= tight for e in rows) >= 0.9 * len(rows)
    assert ndiff <= 0.01 * ncode


def test_engine_runs_both_kernels(cuda_device):
    """The mega engine with a 128-token prompt launches the flash kernel once
    per layer in prefill and one mega step per new token; the plain engine
    launches neither. Their prefill logits agree: the mean absolute
    difference is within 0.12 of the logits' standard deviation and the
    argmax agrees at 80% of positions or more. The flash kernel differs
    from its plain version by float32 rounding, which can flip a bf16 rounding
    and so a 4-bit activation code downstream; with random weights the
    logits are nearly flat, so a few such flips already move the mean
    difference to a few hundredths of the standard deviation, while a 1%
    error in the attention output moves it to about a quarter."""
    cfg, p, g = _small_setup(cuda_device)
    kw = dict(bits=4, max_batch=2, max_len=160, weight_format="int4_xla",
              lm_head_bits=4, kv_layout="mega", kv_bits=4)
    prompt = torch.randint(0, 512, (2, 128), generator=g, device=cuda_device)
    eng = InferenceEngine(p, cfg, **kw)
    f0, m0 = flash_attention.launches, md.mega_decode_step_kv8.launches
    out = eng.generate(prompt, max_new_tokens=8)
    assert out.shape == (2, 136) and torch.equal(out[:, :128], prompt)
    assert flash_attention.launches - f0 == cfg.model.n_layer
    assert md.mega_decode_step_kv8.launches - m0 == 8
    ref = InferenceEngine(p, cfg, use_kernels=False, **kw)
    f1, m1 = flash_attention.launches, md.mega_decode_step_kv8.launches
    ref.generate(prompt, 8)
    assert (flash_attention.launches, md.mega_decode_step_kv8.launches) == (f1, m1)
    caches = [init_layer_caches(cfg, 2, 160, e.dtype, device=cuda_device)
              for e in (eng, ref)]
    lk, _ = eng.prefill(prompt, caches[0])
    lp, _ = ref.prefill(prompt, caches[1])
    err = (lk - lp).abs()
    print("prefill logits: mean err / std", (err.mean() / lp.std()).item(),
          "max err", err.max().item(), "argmax agreement",
          (lk.argmax(-1) == lp.argmax(-1)).float().mean().item())
    assert bool(torch.isfinite(lk).all())
    assert err.mean() <= 0.12 * lp.std()
    assert (lk.argmax(-1) == lp.argmax(-1)).float().mean() >= 0.8


def bf16_row_ulps(got, want, atol):
    """(|got - want| - atol) per element, in bf16 ulps at the max |want| of
    the element's row (the last axis): 2^(floor(log2 rowmax) - 7)."""
    top = want.float().abs().amax(dim=-1, keepdim=True).clamp(min=2.0 ** -126)
    err = ((got.float() - want.float()).abs() - atol).clamp(min=0)
    return err / torch.exp2(torch.floor(torch.log2(top)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [65, 128, 129, 200, 1024])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_train_kernels_match_plain(cuda_device, dtype, T, D):
    """Kernels #5 and #6 against their plain versions on the same inputs
    (the backward on the kernel's own o and lse), ragged T = 200 included,
    and lengths whose last 128-row block is nearly empty: T = 65 (one row
    of the second warpgroup) and 129 (one row of the second block), whose
    rows and keys past T the wgmma kernels' tensor maps zero-fill. The
    forward takes JAX's k-block for T (128 keys up to T = 256, 256 at
    T = 1024), as its plain version does.
    float32: O, dq, dk, dv within 1e-5 of max |plain| (sums in another
    order). bf16, element by element: within 2 bf16 ulps at the max |plain|
    of the element's row (a float32 value a rounding apart may round to the
    neighbouring bf16 value), plus 1e-5 of max |plain| (in row 0, dP = D in
    exact arithmetic, so dS and the dq row are float32 cancellation noise
    in both versions). Both round P and dS at the same scale (the forward
    at the running max of the same k-blocks, the backward from the LSE), so
    they differ only by float32 summation order, and at most 2% of the bf16
    outputs may differ at all, over all rows; skipping the rounding of P or
    dS would move a third or more, and rounding P at the running max of
    64-key tiles instead of the k-block moves several percent. LSE
    (float32 in both): 1e-5 absolute."""
    g = torch.Generator(device=cuda_device).manual_seed(T + D)
    q, k, v, do = (torch.randn((2, 3, T, D), generator=g, device=cuda_device).to(dtype)
                   for _ in range(4))
    f0, b0 = flash_fwd_lse.launches, flash_bwd.launches
    o, lse = flash_fwd_lse(q, k, v)
    grads = flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    assert (flash_fwd_lse.launches, flash_bwd.launches) == (f0 + 1, b0 + 1)
    po, plse = flash_fwd_lse_plain(q, k, v)
    pgrads = flash_bwd_plain(q, k, v, o, lse, do)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2, 3, T, 1)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (po, *pgrads)):
        assert got.dtype == dtype, name
        if dtype == torch.float32:
            err = (got - want).abs().max().item()
            assert err <= 1e-5 * want.abs().max().item(), (name, err)
            continue
        ulps = bf16_row_ulps(got, want, 1e-5 * want.float().abs().max()).max().item()
        share = (got != want).float().mean().item()
        print(name, "max bf16 ulps of the row's max", ulps, "share differing", share)
        assert ulps <= 2, (name, ulps)
        assert share <= 2e-2, (name, share)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_fwd_single_row_matches_plain(cuda_device, dtype, D):
    """Kernel #5 at T = 1: one row, one key, so o = v's row and lse = the
    one scaled score; in the wgmma forward the second warpgroup's Q box
    lies wholly past T and is zero-filled. Held to
    `test_flash_train_kernels_match_plain`'s forward limits. (The backward
    has no such hold at T = 1: there dP = D exactly, so dq and dk are zero
    in exact arithmetic and float32 noise in both versions.)"""
    g = torch.Generator(device=cuda_device).manual_seed(D + 1)
    q, k, v = (torch.randn((2, 3, 1, D), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    o, lse = flash_fwd_lse(q, k, v)
    torch.cuda.synchronize()
    po, plse = flash_fwd_lse_plain(q, k, v)
    torch.testing.assert_close(lse, plse, atol=1e-5, rtol=0)
    if dtype == torch.float32:
        assert (o - po).abs().max().item() <= 1e-5 * po.abs().max().item()
    else:
        assert bf16_row_ulps(o, po, 1e-5 * po.float().abs().max()).max().item() <= 2
        assert (o != po).float().mean().item() <= 2e-2


def _bwd_inputs(dev, T, seed=0):
    """bf16 (2, 3, T, 64) operands of kernel #6 and the forward's o and lse."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((2, 3, T, 64), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = flash_fwd_lse(q, k, v)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("T", [1024, 200])
def test_flash_bwd_bf16_is_deterministic(cuda_device, T):
    """Repeat calls of the bf16 backward (the wgmma route) give bit-equal
    dq, dk, dv, ragged T = 200 included: each output element is summed by
    one block in a fixed order, with no atomics."""
    from llm_qat_tpu_torch.ops import attention as att

    args = _bwd_inputs(cuda_device, T, seed=T)
    assert att.flash_bwd_plan(torch.bfloat16, T, 64).route == "wgmma"
    first = flash_bwd(*args)
    for _ in range(2):
        for a, b in zip(flash_bwd(*args), first):
            assert torch.equal(a, b)


def test_flash_bwd_takes_unaligned_views(cuda_device):
    """bf16 operands that start 2 bytes past a 16-byte boundary (contiguous
    views into a larger buffer) give the same bits as aligned copies: the
    wrapper copies what TMA cannot read."""
    args = _bwd_inputs(cuda_device, 200, seed=5)
    views = []
    for t in args[:4] + args[5:]:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 and view.is_contiguous()
        views.append(view)
    q, k, v, o, do = views
    for a, b in zip(flash_bwd(q, k, v, o, args[4], do), flash_bwd(*args)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("T", [1024, 200])
def test_flash_fwd_bf16_is_deterministic(cuda_device, T):
    """Repeat calls of the bf16 forward at head_dim 64 (the wgmma route)
    give bit-equal o and lse, ragged T = 200 included: each output row is
    written by one block in a fixed order, with no atomics."""
    from llm_qat_tpu_torch.ops import attention as att

    q, k, v = _bwd_inputs(cuda_device, T, seed=T + 1)[:3]
    assert att.flash_route(torch.bfloat16, 64) == "wgmma"
    first = flash_fwd_lse(q, k, v)
    for _ in range(2):
        for a, b in zip(flash_fwd_lse(q, k, v), first):
            assert torch.equal(a, b)


def test_flash_fwd_takes_unaligned_views(cuda_device):
    """bf16 q, k, v that start 2 bytes past a 16-byte boundary (contiguous
    views into a larger buffer) give the same o and lse as aligned copies:
    the wrapper copies what TMA cannot read."""
    args = _bwd_inputs(cuda_device, 200, seed=6)[:3]
    views = []
    for t in args:
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda_device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 and view.is_contiguous()
        views.append(view)
    for a, b in zip(flash_fwd_lse(*views), flash_fwd_lse(*args)):
        assert torch.equal(a, b)


def test_flash_train_wrappers_check_their_inputs(cuda_device):
    q = torch.randn((1, 2, 128, 64), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        flash_fwd_lse(*(torch.randn((1, 2, 128, 32), device=cuda_device),) * 3)
    with pytest.raises(ValueError, match="float32 CUDA"):
        flash_fwd_lse(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="contiguous"):
        flash_fwd_lse(q, q.transpose(2, 3).contiguous().transpose(2, 3), q)
    o, lse = flash_fwd_lse(q, q, q)
    with pytest.raises(ValueError, match="lse"):
        flash_bwd(q, q, q, o, lse[..., 0], q)
    for fn in (flash_attention, flash_fwd_lse):
        with pytest.raises(ValueError, match="float32 CUDA"):
            fn(q, q.to(torch.bfloat16), q)
    # the C entries take k-blocks of 64, 128 or 256 keys only
    from llm_qat_tpu_torch.ops import _build

    lib, qb = _build.load("flash_attention"), q.to(torch.bfloat16)
    stream = _build.stream(q)
    for bk in (96, 512):
        assert lib.flash_forward_wgmma(*(qb.data_ptr(),) * 4, None, 2, 128, bk, 0.125,
                                       stream) != 0
        assert lib.flash_forward(*(q.data_ptr(),) * 4, None, 2, 128, 64, 0, bk, 0.125,
                                 stream) != 0
    assert lib.flash_forward_wgmma(qb.data_ptr(), qb.data_ptr(), qb.data_ptr(),
                                   torch.empty_like(qb).data_ptr(), None, 2, 128, 64, 0.125,
                                   stream) == 0


@pytest.mark.parametrize("T,flash", [(512, False), (1024, True)])
def test_auto_attention_takes_flash_from_1024_on_the_card(cuda_device, T, flash):
    """attention_impl="auto" runs kernels #5 (forward) and #6 (backward)
    once per layer for CUDA tensors from T = 1024, and the dense path
    below."""
    cfg = tc.SPModelConfig(
        model=tc.GPT2Config(vocab_size=512, n_positions=1024, n_embd=128, n_layer=2,
                            n_head=2),
        quant=tc.QuantConfig(bit_widths=(4, 32)), compute_dtype="bfloat16")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = init_sp_params(g, cfg, device=cuda_device)
    p["blocks"]["c_attn"]["w"].requires_grad_(True)  # upstream of every attention
    ids = torch.randint(0, 512, (2, T), generator=g, device=cuda_device)
    f0, b0 = flash_fwd_lse.launches, flash_bwd.launches
    sp_forward(p, ids, 1, cfg, labels=ids)["loss"].backward()
    torch.cuda.synchronize()
    n = cfg.model.n_layer if flash else 0
    assert (flash_fwd_lse.launches - f0, flash_bwd.launches - b0) == (n, n)
    assert bool(torch.isfinite(p["blocks"]["c_attn"]["w"].grad).all())


def _fused_inputs(dev, M, K, N, r, slot, dtype, seed=0):
    """Operands of kernels #14-#16 on the card: a weight with its calibrated
    per-column scales at slot (4-bit minmax, 8-bit log, 32-bit), operand-
    dtype activations, LoRA factors and cotangent, a bias and the scalars."""
    from llm_qat_tpu_torch.quant.calibration import calibrate_tensor

    bits, kind = ((4.0, 0), (8.0, 1), (32.0, 0))[slot]
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    w = (torch.rand((K, N), generator=g, device=dev) - 0.5) / 8
    ws, wz = (t.reshape(-1) for t in calibrate_tensor(w, min(bits, 8.0), kind, channel_dim=1))
    scalars = torch.tensor([bits, float(kind), 2.0, 0.0], device=dev)
    return dict(xq=rnd(M, K).to(dtype), xa=rnd(M, r).to(dtype), w=w, ws=ws.contiguous(),
                wz=wz.contiguous(), bq=(0.1 * rnd(r, N)).to(dtype), bias=0.1 * rnd(N),
                scalars=scalars, g=rnd(M, N).to(dtype))


# Kernels #14-#16 against their plain versions: the weight codes are equal
# (the same float32 operations in the same order), the bf16 products exact
# in float32 in both, so outputs differ by float32 summation order only;
# within 1e-5 of max |plain| (dW: of its largest unclamped sum). Measured
# up to 4.4e-6.
FUSED_TOL = 1e-5


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("M,K,N,r", [(256, 256, 384, 16), (200, 96, 136, 8),
                                     (1024, 768, 2304, 64), (512, 3072, 768, 0)])
def test_fused_linear_kernels_match_plain(cuda_device, dtype, slot, M, K, N, r):
    """#14, #15 and #16 against `fused_linear_*_plain` at each slot and
    operand type, ragged tiles (M = 200, K = 96, N = 136) and no LoRA
    (r = 0) included; each wrapper counts one launch."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, M, K, N, r, slot, dtype, seed=M + K + slot)
    fwd_args = (a["xq"], a["xa"], a["w"], a["ws"], a["wz"], a["bq"], a["bias"],
                a["scalars"], True, 1e-5)
    dx_args = (a["g"], a["w"], a["ws"], a["wz"], a["bq"], a["scalars"], True, 1e-5)
    before = (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
              fl.fused_linear_bwd_dw.launches)
    fq_before = fl.fq_weight.launches
    out = fl.fused_linear_fwd(*fwd_args)
    dxq, dxa = fl.fused_linear_bwd_dx(*dx_args)
    dw = fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"])
    torch.cuda.synchronize()
    assert (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
            fl.fused_linear_bwd_dw.launches) == tuple(b + 1 for b in before)
    # bf16: one weight prologue per #14 and per #15 call
    assert fl.fq_weight.launches - fq_before == (2 if dtype == torch.bfloat16 else 0)
    pout = fl.fused_linear_fwd_plain(*fwd_args)
    pdxq, pdxa = fl.fused_linear_bwd_dx_plain(*dx_args)
    pdw = fl.fused_linear_bwd_dw_plain(a["xq"], a["g"], a["scalars"])
    pairs = [("out", out, pout), ("dxq", dxq, pdxq), ("dw", dw, pdw)]
    if r > 0:
        pairs.append(("dxa", dxa, pdxa))
    else:
        assert dxa is None and pdxa is None
    for name, got, want in pairs:
        assert got.dtype == torch.float32 and got.shape == want.shape, name
        # dW's sums round at their unclamped size (the log slot clamps to ±10)
        top = ((a["xq"].float().T @ a["g"].float()) if name == "dw" else want).abs().max()
        err = (got - want).abs().max().item() / top.item()
        print(name, "error / max |plain|", err)
        assert err <= FUSED_TOL, (name, err)


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("K,N,r", [(768, 2304, 64), (96, 136, 8)])
def test_fq_weight_kernel_matches_plain(cuda_device, slot, K, N, r):
    """The weight prologue of #14/#15 bit-equal to `fq_weight_plain` (the
    same float32 operations, none contracted, one bf16 rounding) in both
    layouts at each slot; with transpose it also writes bq^T exactly."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, 8, K, N, r, slot, torch.bfloat16, seed=K + slot)
    args = (a["w"], a["ws"], a["wz"], a["scalars"], True, 1e-5)
    before = fl.fq_weight.launches
    wq = fl.fq_weight(*args, False)
    wqt, bqt = fl.fq_weight(*args, True, a["bq"])
    torch.cuda.synchronize()
    assert fl.fq_weight.launches == before + 2
    assert torch.equal(wq, fl.fq_weight_plain(*args, False))
    assert torch.equal(wqt, fl.fq_weight_plain(*args, True))
    assert torch.equal(bqt, a["bq"].T.contiguous())
    if slot < 2:
        assert not torch.equal(wq.float(), a["w"])  # the quantizer did something


@pytest.mark.parametrize("r", [0, 8])
def test_fused_gemm_one_tile(cuda_device, r):
    """One output tile of each bf16 GEMM against its plain version: #14 at
    (M, K, N) = (64, 64, 128) (one 64-row half of a 128 x 128 tile, one
    64-wide K step) and #15's dxq at (64, 128) over N = 64, with and without
    LoRA."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, 64, 64, 128, r, 0, torch.bfloat16, seed=3)
    out = fl.fused_linear_fwd(a["xq"], a["xa"], a["w"], a["ws"], a["wz"], a["bq"], a["bias"],
                              a["scalars"], True, 1e-5)
    want = fl.fused_linear_fwd_plain(a["xq"], a["xa"], a["w"], a["ws"], a["wz"], a["bq"],
                                     a["bias"], a["scalars"], True, 1e-5)
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= FUSED_TOL * want.abs().max().item()
    b = _fused_inputs(cuda_device, 64, 128, 64, r, 0, torch.bfloat16, seed=4)
    dx_args = (b["g"], b["w"], b["ws"], b["wz"], b["bq"], b["scalars"], True, 1e-5)
    got = fl.fused_linear_bwd_dx(*dx_args)
    want = fl.fused_linear_bwd_dx_plain(*dx_args)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        if y is None:
            assert x is None
            continue
        assert (x - y).abs().max().item() <= FUSED_TOL * y.abs().max().item()


@pytest.mark.parametrize("K,N,r", [(100, 128, 8), (128, 132, 8), (128, 128, 4)])
def test_fused_linear_bf16_kernels_refuse_unaligned_shapes(cuda_device, K, N, r):
    """With bf16 operands #14, #15 and #16 read through TMA, whose strides
    are multiples of 16 bytes: K, N or r not a multiple of 8 raises
    ValueError before any launch (#16 has no r: it runs at r = 4). float
    operands take such shapes."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, 64, K, N, r, 0, torch.bfloat16)
    before = (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
              fl.fq_weight.launches, fl.fused_linear_bwd_dw.launches)
    with pytest.raises(ValueError, match="multiples of 8"):
        fl.fused_linear_fwd(a["xq"], a["xa"], a["w"], a["ws"], a["wz"], a["bq"], a["bias"],
                            a["scalars"], True, 1e-5)
    with pytest.raises(ValueError, match="multiples of 8"):
        fl.fused_linear_bwd_dx(a["g"], a["w"], a["ws"], a["wz"], a["bq"], a["scalars"], True,
                               1e-5)
    dw_ok = K % 8 == 0 and N % 8 == 0
    if not dw_ok:
        with pytest.raises(ValueError, match="multiples of 8"):
            fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"])
    assert (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
            fl.fq_weight.launches, fl.fused_linear_bwd_dw.launches) == before
    if dw_ok:
        dw = fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"])
        want = fl.fused_linear_bwd_dw_plain(a["xq"], a["g"], a["scalars"])
        torch.cuda.synchronize()
        assert (dw - want).abs().max().item() <= FUSED_TOL * want.abs().max().item()
    f = {k: (v.float() if v.dtype == torch.bfloat16 else v) for k, v in a.items()}
    out = fl.fused_linear_fwd(f["xq"], f["xa"], f["w"], f["ws"], f["wz"], f["bq"], f["bias"],
                              f["scalars"], True, 1e-5)
    want = fl.fused_linear_fwd_plain(f["xq"], f["xa"], f["w"], f["ws"], f["wz"], f["bq"],
                                     f["bias"], f["scalars"], True, 1e-5)
    dw = fl.fused_linear_bwd_dw(f["xq"], f["g"], f["scalars"])
    want_dw = fl.fused_linear_bwd_dw_plain(f["xq"], f["g"], f["scalars"])
    torch.cuda.synchronize()
    assert (out - want).abs().max().item() <= FUSED_TOL * want.abs().max().item()
    assert (dw - want_dw).abs().max().item() <= FUSED_TOL * want_dw.abs().max().item()


def _dw_err(a, g, dw):
    """|dw - plain| over the largest unclamped |xq^T g| (dW's sums round at
    their unclamped size)."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    want = fl.fused_linear_bwd_dw_plain(a["xq"], g, a["scalars"])
    top = (a["xq"].float().T @ g.float()).abs().max().item()
    return (dw - want).abs().max().item() / top


@pytest.mark.parametrize("slot", [0, 1])
@pytest.mark.parametrize("M,K,N", [(64, 128, 256), (64, 128, 128), (128, 64, 128),
                                   (200, 128, 128), (256, 96, 136)])
def test_fused_dw_kernel_tiles_match_plain(cuda_device, slot, M, K, N):
    """#16's wgmma GEMM over MN-major operands against its plain version:
    one 128 x 256 tile over one GK step of M (64, 128, 256); half of one
    (N = 128: the tile's last two boxes of g lie past the edge); one
    warpgroup's 64 rows (K = 64, over two steps: a split of 2); M = 200 not
    a multiple of GK (its last step is filled with zeros by TMA); K = 96
    and N = 136 (boxes partly and wholly past the edge)."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, M, K, N, 8, slot, torch.bfloat16, seed=M + K + N)
    g = (4.0 * a["g"].float()).to(torch.bfloat16)  # the log slot clamps some of dW
    before = fl.fused_linear_bwd_dw.launches
    dw = fl.fused_linear_bwd_dw(a["xq"], g, a["scalars"])
    torch.cuda.synchronize()
    assert fl.fused_linear_bwd_dw.launches == before + 1
    assert dw.dtype == torch.float32 and dw.shape == (K, N)
    assert _dw_err(a, g, dw) <= FUSED_TOL


@pytest.mark.parametrize("split", range(1, 9))
def test_fused_dw_every_split_matches_plain(cuda_device, split):
    """#16 launched with each split of M over a cluster (1-8 blocks, the
    plan bypassed; the chunks of `dw_chunks`) at (M, K, N) = (1000, 256,
    384), M ragged (1000 is not a multiple of DW_STEP): every split agrees
    with the plain version, and a repeat launch is bit-equal."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    M, K, N = 1000, 256, 384
    a = _fused_inputs(cuda_device, M, K, N, 8, 1, torch.bfloat16, seed=split)
    outs = []
    for _ in range(2):
        dw = torch.empty((K, N), dtype=torch.float32, device=cuda_device)
        fl.launch_dw_wgmma(a["xq"], a["g"], a["scalars"], dw, split)
        outs.append(dw)
    torch.cuda.synchronize()
    assert _dw_err(a, a["g"], outs[0]) <= FUSED_TOL
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("M,K,N,split", [(64, 256, 256, False), (1024, 768, 768, True)])
def test_fused_dw_kernel_is_deterministic(cuda_device, M, K, N, split):
    """Repeat calls of #16 give bit-equal dW, unsplit (one GK step of M)
    and split over a cluster (the plan's 4 chunks at (1024, 768, 768)):
    the partial tiles are summed in a fixed order, with no atomics."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert (fl.dw_splits(M, K, N, sms) > 1) == split
    a = _fused_inputs(cuda_device, M, K, N, 8, 1, torch.bfloat16, seed=7)
    first = fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"])
    for _ in range(3):
        assert torch.equal(fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"]), first)
    assert _dw_err(a, a["g"], first) <= FUSED_TOL


@pytest.mark.parametrize("rows", [[0, 100, 200], [0, 128, 128, 200], [0, 64, 192],
                                  [64, 200], [0, 64, 128, 192] + [200] * 6])
def test_fused_dw_kernel_refuses_bad_chunks(cuda_device, rows):
    """#16's C entry point takes the chunk bounds from the host and refuses,
    before any launch, bounds that are off a DW_STEP step, empty, not from
    0 to M, or more than a cluster's 8 blocks."""
    from llm_qat_tpu_torch.ops import _build

    M, K, N = 200, 128, 128
    a = _fused_inputs(cuda_device, M, K, N, 8, 1, torch.bfloat16)
    dw = torch.empty((K, N), dtype=torch.float32, device=cuda_device)
    lib = _build.load("fused_linear")
    rc = lib.fused_linear_bwd_dw_wgmma(
        a["xq"].data_ptr(), a["g"].data_ptr(), a["scalars"].data_ptr(), dw.data_ptr(), M, K, N,
        len(rows) - 1, (ctypes.c_int * len(rows))(*rows), _build.stream(dw))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, rc, "fused_linear_bwd_dw")


@pytest.mark.parametrize("M,K,N", [(16384, 768, 2304), (32768, 768, 768),
                                   (65536, 768, 768)])
def test_fused_dw_long_m_keeps_chunks_short(cuda_device, M, K, N):
    """Past GPT-2's M = 8192 the plan takes more chunks (up to 8) so that
    each stays within DW_MAX_CHUNK_STEPS steps, and dW keeps within
    FUSED_TOL of its plain version: 4 chunks at 16384 rows, 8 at 32768.
    Past 8 chunks of DW_MAX_CHUNK_STEPS steps (M > 32768) the plan takes
    the 8 of a full cluster, each longer (128 steps at 65536 rows), and dW
    must still keep within FUSED_TOL."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = fl.dw_splits(M, K, N, sms)
    longest = max(e - b for b, e in fl.dw_chunks(M, splits))
    if M <= fl.DW_MAX_SPLITS * fl.DW_MAX_CHUNK_STEPS * fl.DW_STEP:
        assert longest <= fl.DW_MAX_CHUNK_STEPS * fl.DW_STEP
    else:
        assert splits == fl.DW_MAX_SPLITS
    a = _fused_inputs(cuda_device, M, K, N, 8, 1, torch.bfloat16, seed=M)
    dw = fl.fused_linear_bwd_dw(a["xq"], a["g"], a["scalars"])
    torch.cuda.synchronize()
    err = _dw_err(a, a["g"], dw)
    print(f"dW at M = {M}: {splits} chunks of up to {longest // fl.DW_STEP} steps, "
          f"error / max {err:.3e}")
    assert err <= FUSED_TOL


def test_fused_dw_kernel_clamps(cuda_device):
    """At the 8-bit log slot #16 clamps dW to ±10 (g scaled up so that most
    of dW is clamped), as its plain version does; at the 4-bit minmax slot
    it does not."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    for slot, clamped in ((1, True), (0, False)):
        a = _fused_inputs(cuda_device, 1024, 768, 768, 64, slot, torch.bfloat16, seed=9)
        g = (50.0 * a["g"].float()).to(torch.bfloat16)
        dw = fl.fused_linear_bwd_dw(a["xq"], g, a["scalars"])
        pdw = fl.fused_linear_bwd_dw_plain(a["xq"], g, a["scalars"])
        assert (dw.abs().max().item() == 10.0) == clamped
        if clamped:
            assert (dw.abs() == 10.0).float().mean().item() > 0.5
        # the sums' rounding scales with the unclamped magnitude
        top = (a["xq"].float().T @ g.float()).abs().max().item()
        assert (dw - pdw).abs().max().item() <= FUSED_TOL * top


def test_fused_linear_wrappers_check_their_inputs(cuda_device):
    from llm_qat_tpu_torch.ops import fused_linear as fl

    a = _fused_inputs(cuda_device, 256, 128, 128, 8, 0, torch.bfloat16)
    args = [a[k] for k in ("xq", "xa", "w", "ws", "wz", "bq", "bias", "scalars")]
    with pytest.raises(ValueError, match="w must be"):
        fl.fused_linear_fwd(*args[:2], a["w"].to(torch.bfloat16), *args[3:], True, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        fl.fused_linear_fwd(*args[:2], a["w"].T.contiguous().T, *args[3:], True, 1e-5)
    with pytest.raises(ValueError, match="g_bf must be"):
        fl.fused_linear_bwd_dw(a["xq"].float(), a["g"], a["scalars"])
    with pytest.raises(ValueError, match="CUDA"):
        fl.fused_linear_bwd_dx(a["g"].half(), *[a[k] for k in ("w", "ws", "wz", "bq",
                                                                "scalars")], True, 1e-5)


def test_fused_sp_linear_runs_the_kernels(cuda_device):
    """linear_impl="fused" on the card: one forward and backward of a small
    SP model launches #14, #15 and #16 once per linear (w is trainable)."""
    from llm_qat_tpu_torch.ops import fused_linear as fl

    cfg = tc.SPModelConfig(
        model=tc.GPT2Config(vocab_size=512, n_positions=128, n_embd=128, n_layer=2, n_head=2),
        quant=tc.QuantConfig(bit_widths=(4, 8, 32),
                             lora_rank_per_bit={b: 8 for b in range(2, 17)} | {32: 0}),
        compute_dtype="bfloat16", linear_impl="fused")
    g = torch.Generator(device=cuda_device).manual_seed(0)
    p = init_sp_params(g, cfg, device=cuda_device)
    p = calibrate_weight_quantizers(p, cfg)
    p = calibrate_input_quantizers(
        p, cfg, [torch.randint(0, 512, (2, 128), generator=g, device=cuda_device)])
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        p["blocks"][lin]["w"].requires_grad_(True)
    ids = torch.randint(0, 512, (2, 128), generator=g, device=cuda_device)
    for prec in (0, 1, 2):
        before = (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
                  fl.fused_linear_bwd_dw.launches)
        sp_forward(p, ids, prec, cfg, labels=ids)["loss"].backward()
        torch.cuda.synchronize()
        n = 4 * cfg.model.n_layer
        assert (fl.fused_linear_fwd.launches, fl.fused_linear_bwd_dx.launches,
                fl.fused_linear_bwd_dw.launches) == tuple(b + n for b in before)
    assert bool(torch.isfinite(p["blocks"]["c_fc"]["w"].grad).all())


def _hold_packed(ok, op, dtype, what):
    """#7/#8's hold on the active slots' outputs: float32 within 1e-5;
    bf16-cache outputs within 2 bf16 ulps of their row's max plus 1e-5
    and, rounded to bf16, at most 2 % of them differing."""
    if dtype == torch.float32:
        torch.testing.assert_close(ok, op, atol=1e-5, rtol=0, msg=what)
        return
    ulps = bf16_row_ulps(ok, op, 1e-5).max().item()
    share = (ok.to(dtype) != op.to(dtype)).float().mean().item()
    print(f"out max bf16 ulps of the row's max {ulps} share differing {share} ({what})")
    assert ulps <= 2, what
    assert share <= 2e-2, (what, share)


def _kept_outside_append(new, old, pos, D):
    """Every cache byte outside the appended lane groups (row pos // P,
    lanes (pos % P)·D .. + D of each slot with pos >= 0) as it was."""
    keep = torch.ones(new.shape, dtype=torch.bool, device=new.device)
    P = new.shape[-1] // D
    for b, p in enumerate(pos):
        if p >= 0:
            keep[b, :, p // P, (p % P) * D:(p % P + 1) * D] = False
    return torch.equal(new[keep], old[keep])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 32])
def test_decode_attention_kernels_match_plain(cuda_device, dtype, D):
    """#7 (shared position 0, 17, T - 1) and #8 (positions -1, 0, 17, T - 1)
    against their plain versions on packed caches, through the wrappers and
    at every forced split of the cluster (1-8 blocks, `launch_hbm`), with
    per-slot positions whose prefixes split differently, for JAX blocks of
    16 packed rows and of 8 (4 and 8 JAX blocks at T - 1; below 8 blocks
    a block of the cluster takes several). Both round q·sm_scale and each JAX block's
    probabilities to the cache dtype at the same running maxima, so they
    differ by the order of float32 sums: float32 outputs within 1e-5
    (values O(1)); bf16-cache outputs within 2 bf16 ulps of their row's
    max plus 1e-5, and, rounded to bf16, at most 2 % of them differing (a
    kernel that rounded at another maximum, or skipped a rounding, would
    move more). The caches must be bit-equal after the append, every byte
    outside the appended lane groups untouched (the inactive slot's all);
    a second call on the same inputs gives bit-equal outputs."""
    from llm_qat_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda_device).manual_seed(D)
    P, B, H, Tp = 128 // D, 4, 3, 64
    T = P * Tp
    q, kn, vn = (torch.randn((B, H, 1, D), generator=g, device=cuda_device)
                 for _ in range(3))
    kc, vc = (torch.randn((B, H, Tp, 128), generator=g, device=cuda_device).to(dtype)
              for _ in range(2))
    cases = [(da.decode_attention_hbm, da.decode_attention_hbm_plain, p)
             for p in (0, 17, T - 1)]
    cases.append((da.decode_attention_hbm_multi, da.decode_attention_hbm_multi_plain,
                  [-1, 0, 17, T - 1]))
    for kern, plain, pos in cases:
        before = kern.launches
        ok, ck, cv = kern(q, kn, vn, kc.clone(), vc.clone(), pos, tbp=16)
        assert kern.launches == before + 1
        op, pk, pv = plain(q, kn, vn, kc.clone(), vc.clone(), pos, tbp=16)
        torch.cuda.synchronize()
        assert torch.equal(ck, pk) and torch.equal(cv, pv), pos
        act = torch.tensor(pos, device=cuda_device).expand(B) >= 0
        _hold_packed(ok[act], op[act], dtype, f"{kern.__name__} pos {pos}")
    for tbp in (16, 8):
        for pos in ([-1, 0, 17, T - 1], [1, T - 1, 40, 0], [T - 1, 33, -1, 64]):
            op, pk, pv = da.decode_attention_hbm_multi_plain(
                q, kn, vn, kc.clone(), vc.clone(), pos, tbp=tbp)
            act = torch.tensor(pos, device=cuda_device) >= 0
            before = da.decode_attention_hbm_multi.launches
            for split in range(1, da.MAX_SPLIT + 1):
                ok, ck, cv = da.launch_hbm(q, kn, vn, kc.clone(), vc.clone(), pos, tbp, split)
                again = da.launch_hbm(q, kn, vn, kc.clone(), vc.clone(), pos, tbp, split)[0]
                torch.cuda.synchronize()
                what = f"tbp {tbp} pos {pos} split {split}"
                assert torch.equal(ok, again), what
                assert torch.equal(ck, pk) and torch.equal(cv, pv), what
                assert _kept_outside_append(ck, kc, pos, D), what
                assert _kept_outside_append(cv, vc, pos, D), what
                _hold_packed(ok[act], op[act], dtype, what)
            assert da.decode_attention_hbm_multi.launches == before


def test_decode_attention_wrappers_check_positions(cuda_device):
    """A position at or past the cache end (or below -1 per slot) raises
    before launch: on the card the append would write out of bounds."""
    from llm_qat_tpu_torch.ops import decode_attention as da

    q = torch.zeros((2, 1, 1, 64), device=cuda_device)
    kc = torch.zeros((2, 1, 16, 128), device=cuda_device)
    with pytest.raises(ValueError, match="outside the cache"):
        da.decode_attention_hbm(q, q, q, kc, kc.clone(), 32)
    with pytest.raises(ValueError, match="outside the cache"):
        da.decode_attention_hbm_multi(q, q, q, kc, kc.clone(), [3, 32])
    with pytest.raises(ValueError, match="outside the cache"):
        da.decode_attention_hbm_multi(q, q, q, kc, kc.clone(), [-2, 0])


@pytest.mark.parametrize("grid", [None, 7, 61, 132])
@pytest.mark.parametrize("cache,act,H", [(torch.float32, torch.float32, 4),
                                         (torch.bfloat16, torch.bfloat16, 4),
                                         (torch.bfloat16, torch.float32, 4),
                                         (torch.float32, torch.float32, 2),
                                         (torch.bfloat16, torch.bfloat16, 64)])
def test_mega_float_cache_kernel_matches_plain(cuda_device, cache, act, H, grid):
    """#3 against its plain version, held as #1 is: per batch row max |kernel
    - plain| / max |plain h_out| within float rounding (1e-5 in float32
    activations, 1e-2 with bf16 `_rt` roundings) for nine rows in ten and
    within 5e-2 for all; the appended K/V rows within 5e-2 of their max (a
    moved activation code upstream shifts them); other rows untouched; two
    calls on the same inputs bit-equal. head_dim 64, 128 (float32: seven
    blocks a pass of the attention item) and 4 (bf16 lanes that are not
    16-byte aligned), at the device's own grid (None) and at forced grids."""
    cfg, p, g = _small_setup(cuda_device, n_head=H)
    d, L, B, T = 256, 2, 3, 128
    tree = quantize_for_inference(p, cfg, 8, weight_format="int8_xla")
    tree.pop("_static")
    mw = md.pack_mega_weights(tree, cfg)
    c0 = [torch.randn((L, B, T, d), generator=g, device=cuda_device).to(cache)
          for _ in range(2)]
    tight = 1e-5 if act == torch.float32 else 1e-2
    rows = []
    for pos in (0, 1, 63, 64, 100):
        h = 0.5 * torch.randn((B, d), generator=g, device=cuda_device)
        kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=act, tbp=32)
        before = md.mega_decode_step.launches
        out_k = md.mega_decode_step(h, mw, *[c.clone() for c in c0], pos, grid=grid, **kw)
        assert md.mega_decode_step.launches == before + 1
        again = md.mega_decode_step(h, mw, *[c.clone() for c in c0], pos, grid=grid, **kw)
        for a, b in zip(out_k, again):
            assert torch.equal(a, b)
        out_p = md.mega_decode_step_plain(h, mw, *[c.clone() for c in c0], pos, **kw)
        rows += ((out_k[0] - out_p[0]).abs().amax(dim=1) / out_p[0].abs().max()).tolist()
        rest = [r for r in range(T) if r != pos]
        for a, b, c in zip(out_k[1:], out_p[1:], c0):
            assert torch.equal(a[:, :, rest], c[:, :, rest])
            new_a, new_b = a[:, :, pos].float(), b[:, :, pos].float()
            assert (new_a - new_b).abs().max() <= 5e-2 * new_b.abs().max()
    print("row errors", sorted(rows))
    assert max(rows) <= 5e-2
    assert sum(e <= tight for e in rows) >= 0.9 * len(rows)


@pytest.mark.parametrize("grid", [None, 7, 61, 132])
@pytest.mark.parametrize("kv_bits", [8, 4])
@pytest.mark.parametrize("rpos", [0, 7])
def test_mega_cb_kernel_matches_plain(cuda_device, kv_bits, rpos, grid):
    """#4 against its plain version, slot lengths [40, 0, 100] over a
    128-row main cache and a 32-row recent buffer (tbp 32), held as #1:
    rows within float rounding for nine in ten, all within 5e-2; layer 0's
    appended recent codes differ by at most one in at most 1 % (in layer 1 a
    code moved upstream can shift a whole row's scale); the scales within
    5e-2; main caches and the other recent rows untouched. At the device's
    own grid and at forced ones."""
    cfg, p, g = _small_setup(cuda_device)
    d, L, H, B, T, TR = 256, 2, 4, 3, 128, 32
    wbits = 4 if kv_bits == 4 else 8
    tree = quantize_for_inference(p, cfg, wbits, weight_format=f"int{wbits}_xla")
    tree.pop("_static")
    mw = md.pack_mega_weights(tree, cfg)
    aq = float(tree["blocks"]["c_attn"]["qmax"][0]) if wbits == 4 else 127.0
    dc = d if kv_bits == 8 else d // 2
    codes = lambda n: torch.randint(-127, 128, (L, B, n, dc), generator=g,
                                    device=cuda_device, dtype=torch.int8)
    scales = lambda n: 0.01 + 0.04 * torch.rand((L, B, n), generator=g, device=cuda_device)
    main = [codes(T), codes(T), scales(T), scales(T)]
    rec0 = [codes(TR), codes(TR), scales(TR), scales(TR)]
    lengths = [40, 0, 100]
    tight = 1e-2
    rows = []
    for act in (torch.float32, torch.bfloat16):
        h = 0.5 * torch.randn((B, d), generator=g, device=cuda_device)
        kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=act, aq_max=aq,
                  tbp=32, kv_bits=kv_bits)
        before = md.mega_decode_step_cb.launches
        out_k = md.mega_decode_step_cb(h, mw, *main, *[c.clone() for c in rec0],
                                       lengths, rpos, grid=grid, **kw)
        assert md.mega_decode_step_cb.launches == before + 1
        out_p = md.mega_decode_step_cb_plain(h, mw, *main, *[c.clone() for c in rec0],
                                             lengths, rpos, **kw)
        rows += ((out_k[0] - out_p[0]).abs().amax(dim=1) / out_p[0].abs().max()).tolist()
        rest = [r for r in range(TR) if r != rpos]
        for a, c in zip(out_k[1:], rec0):
            assert torch.equal(a[:, :, rest], c[:, :, rest])
        for a, b in zip(out_k[1:3], out_p[1:3]):  # layer 0: no moved code upstream
            dcode = (md._kv_codes(a[0, :, rpos], kv_bits)
                     - md._kv_codes(b[0, :, rpos], kv_bits))
            assert dcode.abs().max() <= 1 and (dcode != 0).float().mean() <= 0.01
        for a, b in zip(out_k[3:], out_p[3:]):
            torch.testing.assert_close(a[:, :, rpos], b[:, :, rpos], rtol=5e-2, atol=0)
    print("row errors", sorted(rows))
    assert max(rows) <= 5e-2
    assert sum(e <= tight for e in rows) >= 0.9 * len(rows)


def _mega_case(dev, kv_bits, lengths=(40, 0, 100), T=128, TR=32):
    """#1 and #4 operands at the small config: (mw, kw, h, #1 caches, #4 main
    caches, #4 recent caches, lengths)."""
    cfg, p, g = _small_setup(dev)
    d, L, H, B = 256, 2, 4, len(lengths)
    wbits = 4 if kv_bits == 4 else 8
    tree = quantize_for_inference(p, cfg, wbits, weight_format=f"int{wbits}_xla")
    tree.pop("_static")
    mw = md.pack_mega_weights(tree, cfg)
    aq = float(tree["blocks"]["c_attn"]["qmax"][0]) if wbits == 4 else 127.0
    dc = d if kv_bits == 8 else d // 2
    codes = lambda n: torch.randint(-127, 128, (L, B, n, dc), generator=g, device=dev,
                                    dtype=torch.int8)
    scales = lambda n: 0.01 + 0.04 * torch.rand((L, B, n), generator=g, device=dev)
    kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=torch.bfloat16, aq_max=aq,
              tbp=32, kv_bits=kv_bits)
    h = 0.5 * torch.randn((B, d), generator=g, device=dev)
    return (mw, kw, h, [codes(T), codes(T), scales(T), scales(T)],
            [codes(T), codes(T), scales(T), scales(T)],
            [codes(TR), codes(TR), scales(TR), scales(TR)], list(lengths))


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_mega_steps_repeat_bit_equal(cuda_device, kv_bits):
    """Two calls of #1 and of #4 on the same inputs give bit-equal h_out and
    caches: every float sum runs in a fixed order (the int32 atomics are
    exact in any order)."""
    mw, kw, h, c1, main, rec, lengths = _mega_case(cuda_device, kv_bits)
    outs = [md.mega_decode_step_kv8(h, mw, *[c.clone() for c in c1], 77, **kw)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    outs = [md.mega_decode_step_cb(h, mw, *main, *[c.clone() for c in rec], lengths, 5, **kw)
            for _ in range(2)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kv_bits", [8, 4])
def test_mega_cb_empty_and_full_slots(cuda_device, kv_bits):
    """A slot of length 0 and one at the cache's full length T in one batch,
    held against the plain version as test_mega_cb_kernel_matches_plain
    holds its rows (all within 5e-2, nine in ten within 1e-2)."""
    T = 128
    mw, kw, h, _, main, rec, lengths = _mega_case(cuda_device, kv_bits, (0, T, 61), T=T)
    rows = []
    for rpos in (0, 9):
        out_k = md.mega_decode_step_cb(h, mw, *main, *[c.clone() for c in rec], lengths,
                                       rpos, **kw)
        out_p = md.mega_decode_step_cb_plain(h, mw, *main, *[c.clone() for c in rec],
                                             lengths, rpos, **kw)
        rows += ((out_k[0] - out_p[0]).abs().amax(dim=1) / out_p[0].abs().max()).tolist()
    assert max(rows) <= 5e-2
    assert sum(e <= 1e-2 for e in rows) >= 0.9 * len(rows)


def test_mega_step_is_one_launch(cuda_device):
    """One step of #1, one of #4 and one of #3 (float32 and bf16 caches) are
    each one CUDA kernel launch (the persistent k_mega, an instantiation of
    its template), with no copy or memset beside it."""
    mw, kw, h, c1, main, rec, lengths = _mega_case(cuda_device, 4)
    kw_f = {k: v for k, v in kw.items() if k != "kv_bits"}
    f32, bf16 = ([torch.randn(c1[0].shape[:3] + (h.shape[1],), device=cuda_device).to(dt)
                  for _ in range(2)] for dt in (torch.float32, torch.bfloat16))
    steps = (lambda: md.mega_decode_step_kv8(h, mw, *c1, 50, **kw),
             lambda: md.mega_decode_step_cb(h, mw, *main, *rec, lengths, 3, **kw),
             lambda: md.mega_decode_step(h, mw, *f32, 50, **kw_f),
             lambda: md.mega_decode_step(h, mw, *bf16, 50, **kw_f))
    for step in steps:
        step()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        names = [e.key.split("(")[0].split("<")[0].replace("void ", "").strip() for e in evs]
        assert [(n, e.count) for n, e in zip(names, evs)] == [("k_mega", 1)], evs


@pytest.mark.parametrize("layout,kv_bits", [("dense", 8), ("packed", 8), ("mega", 8),
                                            ("mega", 4)])
def test_server_runs_each_layout(cuda_device, layout, kv_bits):
    """A short continuous-batching run per layout (three greedy requests on
    two slots, a 130-token prompt among them, 8 new tokens, chunks of 4):
    every request finishes with 8 tokens in range; the packed layout runs #8
    once per layer and decode step, the mega layout #4 once per decode step,
    and the 130-token prompt the flash prefill #2 once per layer."""
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.serving import ContinuousBatchingEngine

    cfg, p, g = _small_setup(cuda_device)
    bits = 4 if kv_bits == 4 else 8
    eng = ContinuousBatchingEngine(
        p, cfg, bits=bits, n_slots=2, max_len=192, weight_format=f"int{bits}_xla",
        kv_layout=layout, kv_bits=kv_bits, mega_tbp=64)
    prompts = [torch.randint(0, 512, (n,), generator=g, device=cuda_device).tolist()
               for n in (5, 130, 9)]
    counters = (flash_attention, da.decode_attention_hbm_multi, md.mega_decode_step_cb)
    before = [c.launches for c in counters]
    ids = [eng.submit(pr, max_new_tokens=8) for pr in prompts]
    eng.run_until_done(chunk=4)
    torch.cuda.synchronize()
    made = [c.launches - b for c, b in zip(counters, before)]
    assert all(len(eng.finished[i].generated) == 8 for i in ids)
    assert all(0 <= t < 512 for i in ids for t in eng.finished[i].generated)
    assert made[0] == cfg.model.n_layer  # the 130-token prompt's flash prefill
    if layout == "packed":
        assert made[1] > 0 and made[1] % cfg.model.n_layer == 0 and made[2] == 0
    elif layout == "mega":
        assert made[2] > 0 and made[1] == 0
    else:
        assert made[1] == made[2] == 0


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,per_channel", [(8, 768, 2304, True), (1024, 3072, 768, True),
                                               (33, 96, 100, True), (1, 64, 8, False)])
def test_quant_matmul_kernels_match_plain(cuda_device, bits, M, K, N, per_channel):
    """#10 / #11 against their plain versions, ragged M and N and a
    per-tensor scale included: the codes are exact in bf16 and bf16 x bf16
    products exact in float32 in both, so they differ by the order of the
    float32 sums: within 1e-5 of max |plain|."""
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=cuda_device).manual_seed(M + K + N + bits)
    x = torch.randn((M, K), generator=g, device=cuda_device)
    w = torch.randn((K, N), generator=g, device=cuda_device)
    pack, kern, plain = ((qm.pack_int8, qm.quant_matmul_int8, qm.quant_matmul_int8_plain)
                         if bits == 8 else
                         (qm.pack_int4, qm.quant_matmul_int4, qm.quant_matmul_int4_plain))
    codes, s = pack(w, per_channel)
    before = kern.launches
    got = kern(x, codes, s)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    want = plain(x, codes, s)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got - want).abs().max().item() / want.abs().max().item()
    print("quant_matmul error / max |plain|", err)
    assert err <= 1e-5
    assert torch.equal(qm.quant_matmul(x, codes, s, bits=bits), kern(x, codes, s))


def test_quant_matmul_wrappers_check_their_inputs(cuda_device):
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    x = torch.randn((4, 64), device=cuda_device)
    codes, s = qm.pack_int8(torch.randn((64, 32), device=cuda_device))
    with pytest.raises(ValueError, match="does not match K"):
        qm.quant_matmul_int8(x[:, :32], codes, s)
    with pytest.raises(ValueError, match="K must be even"):
        qm.quant_matmul_int8(x[:, :63], codes[:63], s)
    with pytest.raises(ValueError, match="int8"):
        qm.quant_matmul_int8(x, codes.float(), s)
    with pytest.raises(ValueError, match="scale"):
        qm.quant_matmul_int8(x, codes, s[:5])


def _qmm_operands(dev, bits, M, K, N, per_channel=True, seed=0):
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(seed + M + K + N + bits)
    x = torch.randn((M, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev)
    pack, kern, plain = ((qm.pack_int8, qm.quant_matmul_int8, qm.quant_matmul_int8_plain)
                         if bits == 8 else
                         (qm.pack_int4, qm.quant_matmul_int4, qm.quant_matmul_int4_plain))
    codes, s = pack(w, per_channel)
    return x, codes, s, kern, plain


def _qmm_rel_err(got, want):
    assert got.dtype == torch.float32 and got.shape == want.shape
    return (got - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N", [(8, 768, 2304), (8, 3072, 768), (1024, 768, 768)])
def test_quant_matmul_kernels_are_deterministic(cuda_device, bits, M, K, N):
    """#10 / #11 sum in a fixed order (split K over a cluster at small M,
    no atomics): two calls on the same inputs give bit-equal outputs."""
    x, codes, s, kern, _ = _qmm_operands(cuda_device, bits, M, K, N)
    a = kern(x, codes, s)
    b = kern(x, codes, s)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M,K,N,per_channel", [
    (16, 768, 768, True),     # the small-M regime's widest M
    (17, 768, 768, True),     # one above: the large-M regime
    (8, 768, 100, True),      # N not a multiple of 16
    (8, 768, 8, False),       # one narrow column block, per-tensor scale
    (8, 1000, 256, True),     # K ragged against the step and the split
    (8, 800, 512, True),      # 25 K steps over a split of 7
    (5, 66, 100, True),       # K not a multiple of 8: x read byte by byte
    (40, 1000, 100, True),    # the large-M regime, every edge ragged
])
def test_quant_matmul_kernel_edges_match_plain(cuda_device, bits, M, K, N, per_channel):
    """#10 / #11 at the regime threshold, ragged M, N and K and a
    per-tensor scale: within 1e-5 of max |plain| (the sums' order only)."""
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    x, codes, s, kern, plain = _qmm_operands(cuda_device, bits, M, K, N, per_channel)
    plan = qm.launch_plan(M, K, N)
    assert plan.regime == ("small" if M <= qm.SMALL_M_MAX else "large")
    before = kern.launches
    got = kern(x, codes, s)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    err = _qmm_rel_err(got, plain(x, codes, s))
    print("quant_matmul error / max |plain|", plan, err)
    assert err <= 1e-5


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("M", [8, 64])
def test_quant_matmul_kernels_take_unaligned_views(cuda_device, bits, M):
    """A bf16 x view 2 bytes past a 16-byte boundary (the wrapper clones it)
    and a code view 3 bytes past one (the kernel reads it byte by byte):
    the same outputs as on aligned copies, within 1e-5 of max |plain|."""
    K, N = 768, 256
    x, codes, s, kern, plain = _qmm_operands(cuda_device, bits, M, K, N, seed=7)
    xbuf = torch.empty(M * K + 8, dtype=torch.bfloat16, device=cuda_device)
    xv = xbuf[1:1 + M * K].view(M, K)
    xv.copy_(x.to(torch.bfloat16))
    cbuf = torch.empty(codes.numel() + 16, dtype=codes.dtype, device=cuda_device)
    cv = cbuf[3:3 + codes.numel()].view(codes.shape)
    cv.copy_(codes)
    assert xv.data_ptr() % 16 and cv.data_ptr() % 16 and cv.is_contiguous()
    got = kern(xv, cv, s)
    want = kern(xv.contiguous().clone(), codes, s)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert _qmm_rel_err(got, plain(xv, cv, s)) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 32])
def test_dense_decode_attention_kernel_matches_plain(cuda_device, dtype, D):
    """#9 against its plain version at shared positions 0, 17, T - 1 and
    per-slot ones, through the wrapper and at every forced split of the
    cluster (1-8 blocks, `launch_dense`), with per-slot positions whose
    prefixes split differently: outputs within 1e-5 (float32 scores and
    probabilities in both; sums in another order; values O(1)); the caches
    bit-equal, with only row pos of each slot written; a second call on the
    same inputs gives bit-equal outputs."""
    from llm_qat_tpu_torch.ops import decode_attention as da

    g = torch.Generator(device=cuda_device).manual_seed(D)
    B, H, T = 4, 3, 200
    q, kn, vn = (torch.randn((B, H, 1, D), generator=g, device=cuda_device)
                 for _ in range(3))
    kc, vc = (torch.randn((B, H, T, D), generator=g, device=cuda_device).to(dtype)
              for _ in range(2))

    def held(ok, ck, cv, op, pk, pv, pos, what):
        assert torch.equal(ck, pk) and torch.equal(cv, pv), what
        p = torch.tensor(pos, device=cuda_device).expand(B)
        rest = (torch.arange(T, device=cuda_device)[None] != p[:, None])[:, None].expand(B, H, T)
        assert torch.equal(ck[rest], kc[rest]) and torch.equal(cv[rest], vc[rest]), what
        torch.testing.assert_close(ok, op, atol=1e-5, rtol=0, msg=what)

    for pos in (0, 17, T - 1, [5, 0, T - 1, 100]):
        before = da.decode_attention.launches
        ok, ck, cv = da.decode_attention(q, kn, vn, kc.clone(), vc.clone(), pos)
        assert da.decode_attention.launches == before + 1
        op, pk, pv = da.decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pos)
        torch.cuda.synchronize()
        held(ok, ck, cv, op, pk, pv, pos, f"pos {pos}")
    for pos in ([5, 0, T - 1, 100], [1, 23, 24, T - 2], [160] * B):
        op, pk, pv = da.decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pos)
        before = da.decode_attention.launches
        for split in range(1, da.MAX_SPLIT + 1):
            ck, cv = kc.clone(), vc.clone()
            ok = da.launch_dense(q, kn, vn, ck, cv, pos, split)
            again = da.launch_dense(q, kn, vn, kc.clone(), vc.clone(), pos, split)
            torch.cuda.synchronize()
            what = f"pos {pos} split {split}"
            assert torch.equal(ok, again), what
            held(ok, ck, cv, op, pk, pv, pos, what)
        assert da.decode_attention.launches == before


def _fused_layer(dev, g, d, dff, lora):
    """Random int8_xla linears (codes, per-column scales, biases, rank-16
    LoRA banks of dtype `lora` or none) of one layer, LN parameters and the
    static input scales, on dev."""
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)

    def lin(K, N):
        out = {"w_i8": torch.randint(-127, 128, (K, N), generator=g, device=dev,
                                     dtype=torch.int8),
               "w_s": 2e-4 + 8e-4 * torch.rand((N,), generator=g, device=dev),
               "b": 0.1 * rnd(N)}
        if lora is not None:
            out["lora_A"] = (0.3 * rnd(K, 16)).to(lora)
            out["lora_B"] = (0.05 * rnd(16, N)).to(lora)
        return out
    ln = [(0.5 + torch.rand((d,), generator=g, device=dev), 0.1 * rnd(d)) for _ in range(2)]
    return ((lin(d, 3 * d), lin(d, d), lin(d, dff), lin(dff, d)), ln,
            torch.tensor([3.0, 3.0, 4.0, 2.0], device=dev) / 127.0)


@pytest.mark.parametrize("lora", [torch.bfloat16, torch.float32, None])
def test_fused_decode_kernels_match_plain(cuda_device, lora):
    """#12 and #13 against their plain versions, held as the decode steps
    are: per batch row, max |kernel - plain| / max |plain| within float32
    rounding (1e-5) for nine rows in ten (the int8 dots are exact; LN and
    LoRA sum in another order, and where a value sits on a rounding
    boundary of q8 an activation code moves), every row within 2e-2."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device=cuda_device).manual_seed(5)
    B, d, dff = 5, 256, 1024
    rows = {"qkv": [], "post": []}
    for _ in range(4):
        (qkv, proj, fc, mlp), ((g1, b1), (g2, b2)), xs = _fused_layer(cuda_device, g, d,
                                                                       dff, lora)
        h = torch.randn((B, d), generator=g, device=cuda_device)
        attn = torch.randn((B, d), generator=g, device=cuda_device)
        args = (h, g1, b1, qkv["w_i8"], qkv["w_s"], qkv["b"], xs[0], qkv.get("lora_A"),
                qkv.get("lora_B"))
        before = (fd.fused_ln_qkv.launches, fd.fused_post_attention.launches)
        ok = fd.fused_ln_qkv(*args)
        pk = fd.fused_post_attention(attn, h, g2, b2, proj, fc, mlp, xs[1:])
        torch.cuda.synchronize()
        assert (fd.fused_ln_qkv.launches, fd.fused_post_attention.launches) == (
            before[0] + 1, before[1] + 1)
        op = fd.fused_ln_qkv_plain(*args)
        pp = fd.fused_post_attention_plain(attn, h, g2, b2, proj, fc, mlp, xs[1:])
        for name, got, want in (("qkv", ok, op), ("post", pk, pp)):
            assert got.dtype == torch.float32 and got.shape == want.shape
            rows[name] += ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()
    print("row errors", {k: sorted(v) for k, v in rows.items()})
    for name, rs in rows.items():
        assert max(rs) <= 2e-2, name
        assert sum(e <= 1e-5 for e in rs) >= 0.9 * len(rs), name


def _fused_gpt2(dev, B, seed, rank=64):
    """#12's and #13's operands at GPT-2 124M width (d = 768, dff = 3072),
    bf16 LoRA banks of `rank` (64, as the bench's quant config):
    (qkv args, post args)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    (qkv, proj, fc, mlp), ((g1, b1), (g2, b2)), xs = _fused_layer(dev, g, 768, 3072,
                                                                   torch.bfloat16)
    for lin in (qkv, proj, fc, mlp):
        K, N = lin["w_i8"].shape
        lin["lora_A"] = (0.3 * torch.randn((K, rank), generator=g, device=dev)).bfloat16()
        lin["lora_B"] = (0.05 * torch.randn((rank, N), generator=g, device=dev)).bfloat16()
    h = torch.randn((B, 768), generator=g, device=dev)
    attn = torch.randn((B, 768), generator=g, device=dev)
    return ((h, g1, b1, qkv["w_i8"], qkv["w_s"], qkv["b"], xs[0], qkv["lora_A"],
             qkv["lora_B"]), (attn, h, g2, b2, proj, fc, mlp, xs[1:]))


@pytest.mark.parametrize("B", [1, 8, 16])
def test_fused_decode_gpt2_width_matches_plain(cuda_device, B):
    """#12 and #13 at GPT-2 width against their plain versions, held as
    test_fused_decode_kernels_match_plain holds them (rows within 1e-5 for
    nine in ten, every row within 2e-2), over four draws; each call one
    launch of the wrapper's counter and a second call bit-equal."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    rows = {"qkv": [], "post": []}
    for seed in range(4):
        qa, pa = _fused_gpt2(cuda_device, B, seed)
        for name, kern, plain, args in (("qkv", fd.fused_ln_qkv, fd.fused_ln_qkv_plain, qa),
                                        ("post", fd.fused_post_attention,
                                         fd.fused_post_attention_plain, pa)):
            before = kern.launches
            got, again = kern(*args), kern(*args)
            torch.cuda.synchronize()
            assert kern.launches == before + 2
            assert torch.equal(got, again), name
            want = plain(*args)
            rows[name] += ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()
    print("row errors", {k: max(v) for k, v in rows.items()})
    for name, rs in rows.items():
        assert max(rs) <= 2e-2, name
        assert sum(e <= 1e-5 for e in rs) >= 0.9 * len(rs), name


@pytest.mark.parametrize("B,rank", [(32, 64), (17, 64), (8, 128)])
def test_fused_decode_beyond_one_launch_matches_plain(cuda_device, B, rank):
    """#12 and #13 at GPT-2 width with more than 16 batch rows (32: two
    launches of 16 rows; 17: 16 and 1) and at LoRA rank 128, against their
    plain versions over two draws, held as
    test_fused_decode_kernels_match_plain holds them; each call one launch
    per 16 rows of the wrapper's counter, a second call bit-equal."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    rows = {"qkv": [], "post": []}
    for seed in range(2):
        qa, pa = _fused_gpt2(cuda_device, B, seed, rank)
        for name, kern, plain, args in (("qkv", fd.fused_ln_qkv, fd.fused_ln_qkv_plain, qa),
                                        ("post", fd.fused_post_attention,
                                         fd.fused_post_attention_plain, pa)):
            before = kern.launches
            got, again = kern(*args), kern(*args)
            torch.cuda.synchronize()
            assert kern.launches == before + 2 * -(-B // fd.MAX_B)
            assert torch.equal(got, again), name
            want = plain(*args)
            assert got.shape == want.shape
            rows[name] += ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()
    print("row errors", {k: max(v) for k, v in rows.items()})
    for name, rs in rows.items():
        assert max(rs) <= 2e-2, name
        assert sum(e <= 1e-5 for e in rs) >= 0.9 * len(rs), name


@pytest.mark.parametrize("lora", [torch.bfloat16, None])
def test_fused_decode_pads_odd_widths(cuda_device, lora):
    """Output widths that are not a multiple of 32 (#12's N = 200, #13's
    MLP width 1000) run on operands padded with zeros and are sliced:
    against the plain versions on the originals, held as
    test_fused_decode_kernels_match_plain holds them."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, d, dff = 16, 256, 1000
    (qkv, proj, fc, mlp), ((g1, b1), (g2, b2)), xs = _fused_layer(cuda_device, g, d, dff, lora)
    qkv = {k: (v[..., :200] if k != "lora_A" else v) for k, v in qkv.items()}
    qkv = {k: v.contiguous() for k, v in qkv.items()}
    h = torch.randn((B, d), generator=g, device=cuda_device)
    attn = torch.randn((B, d), generator=g, device=cuda_device)
    args = (h, g1, b1, qkv["w_i8"], qkv["w_s"], qkv["b"], xs[0], qkv.get("lora_A"),
            qkv.get("lora_B"))
    rows = []
    for got, want in ((fd.fused_ln_qkv(*args), fd.fused_ln_qkv_plain(*args)),
                      (fd.fused_post_attention(attn, h, g2, b2, proj, fc, mlp, xs[1:]),
                       fd.fused_post_attention_plain(attn, h, g2, b2, proj, fc, mlp, xs[1:]))):
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.is_contiguous()
        rows += ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()
    print("row errors", rows)
    assert max(rows) <= 2e-2 and sum(e <= 1e-5 for e in rows) >= 0.9 * len(rows)


def test_fused_decode_is_one_launch_and_refuses_a_large_grid(cuda_device):
    """A call of #12 or #13 is one CUDA kernel launch (the persistent
    k_fused; five calls profiled), with no copy or memset beside it; half
    the plan's grid holds
    and repeats bit-equal; two blocks per SM, more than the card holds at
    once, is refused by the runtime and raises."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    qa, pa = _fused_gpt2(cuda_device, 8, 0)
    nsm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for kern, args in ((fd.fused_ln_qkv, qa), (fd.fused_post_attention, pa)):
        ref = kern(*args)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kern(*args)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.count]
        names = [e.key.split("(")[0].split("<")[0].replace("void ", "").strip() for e in evs]
        assert [(n, e.count) for n, e in zip(names, evs)] == [("k_fused", 5)], evs
        assert fd.fused_grid(cuda_device) == nsm
        half, again = kern(*args, grid=nsm // 2), kern(*args, grid=nsm // 2)
        torch.cuda.synchronize()
        assert torch.equal(half, again)
        torch.testing.assert_close(half, ref, atol=2e-2 * ref.abs().max().item(), rtol=0)
        with pytest.raises(RuntimeError, match="cooperative"):
            kern(*args, grid=2 * nsm)
        torch.cuda.synchronize()


def test_fused_decode_wrappers_check_their_inputs(cuda_device):
    from llm_qat_tpu_torch.ops import fused_decode as fd

    g = torch.Generator(device=cuda_device).manual_seed(0)
    (qkv, proj, fc, mlp), ((g1, b1), (g2, b2)), xs = _fused_layer(cuda_device, g, 64, 256,
                                                                   torch.bfloat16)
    h = torch.randn((17, 64), device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 32"):  # d, the LN width
        fd.fused_ln_qkv(torch.randn((2, 72), device=cuda_device), g1, b1, qkv["w_i8"],
                        qkv["w_s"], qkv["b"], xs[0], None, None)
    with pytest.raises(ValueError, match="int8"):
        fd.fused_ln_qkv(h[:2], g1, b1, qkv["w_i8"].float(), qkv["w_s"], qkv["b"], xs[0],
                        None, None)
    with pytest.raises(ValueError, match="share"):
        fd.fused_post_attention(h[:2], h[:2], g2, b2, proj, dict(fc, lora_A=fc["lora_A"].float(),
                                lora_B=fc["lora_B"].float()), mlp, xs[1:])


def test_int8_and_fused_decode_paths_run_their_kernels(cuda_device):
    """On the card, `weight_format="int8"` runs #10 for each of the 4
    linears per layer and forward (prefill and decode; "auto" is the packed
    layout there, so decode runs #7), and the fused decode step on an
    int8_xla tree with dense bf16 caches runs #12, #9 and #13 once per layer
    and no #10; its logits against the plain versions' within 0.12 of their
    standard deviation (mean absolute difference), argmax agreeing at 80 %
    or more (an activation code moved by a float32 difference shifts them,
    as in test_engine_runs_both_kernels)."""
    from llm_qat_tpu_torch.models.inference import infer_forward_unrolled
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import fused_decode as fd
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    cfg, p, g = _small_setup(cuda_device)
    L = cfg.model.n_layer
    eng = InferenceEngine(p, cfg, bits=8, max_batch=2, max_len=64, weight_format="int8",
                          lm_head_bits=8)
    assert eng.kv_layout == "packed"
    prompt = torch.randint(0, 512, (2, 16), generator=g, device=cuda_device)
    q0, a0 = qm.quant_matmul_int8.launches, da.decode_attention_hbm.launches
    out = eng.generate(prompt, max_new_tokens=4)
    torch.cuda.synchronize()
    assert out.shape == (2, 20) and torch.equal(out[:, :16], prompt)
    assert qm.quant_matmul_int8.launches - q0 == 4 * L * 5   # prefill + 4 decode calls
    assert da.decode_attention_hbm.launches - a0 == L * 4

    tree = quantize_for_inference(p, cfg, 8, weight_format="int8_xla", lm_head_bits=8)
    st = tree.pop("_static")
    logits = []
    for use_kernels in (True, False):
        caches = init_layer_caches(cfg, 2, 32, torch.bfloat16, device=cuda_device)
        _, caches, _ = infer_forward_unrolled(tree, prompt, cfg, caches, 0, static=st,
                                              use_kernels=use_kernels)
        before = (fd.fused_ln_qkv.launches, da.decode_attention.launches,
                  fd.fused_post_attention.launches, qm.quant_matmul_int8.launches)
        lg, _, _ = infer_forward_unrolled(tree, out[:, 16:17], cfg, caches, 16, static=st,
                                          fused_attention=True, fused_linears=True,
                                          use_kernels=use_kernels)
        torch.cuda.synchronize()
        made = tuple(a - b for a, b in zip(
            (fd.fused_ln_qkv.launches, da.decode_attention.launches,
             fd.fused_post_attention.launches, qm.quant_matmul_int8.launches), before))
        assert made == ((L, L, L, 0) if use_kernels else (0, 0, 0, 0))
        logits.append(lg)
    lk, lp = logits
    err = (lk - lp).abs()
    print("fused step logits: mean err / std", (err.mean() / lp.std()).item())
    assert bool(torch.isfinite(lk).all())
    assert err.mean() <= 0.12 * lp.std()
    assert (lk.argmax(-1) == lp.argmax(-1)).float().mean() >= 0.8
