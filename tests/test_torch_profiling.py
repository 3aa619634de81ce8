"""PyTorch port: `utils/profiling.py` against the JAX package's: the step
timer's warm-up rule, the roofline estimates (equal to JAX's when handed
JAX's own TPU constants, read from `llm_qat_tpu.utils.profiling`), the
H100 defaults, and a trace on the CPU."""

import json
import os

import pytest

import llm_qat_tpu.utils.profiling as J
import llm_qat_tpu_torch.utils as tutils
import llm_qat_tpu_torch.utils.profiling as T


def test_utils_exports_the_jax_names():
    import llm_qat_tpu.utils as jutils

    assert set(tutils.__all__) == set(jutils.__all__)
    for name in ("trace", "StepTimer", "matmul_roofline", "gpt2_decode_roofline"):
        assert getattr(tutils, name) is getattr(T, name)


@pytest.mark.parametrize("warmup,steps", [(0, 3), (2, 5), (3, 2)])
def test_step_timer_counts_like_jax(warmup, steps):
    """The same warm-up rule: the first `warmup` steps are not kept."""
    tt, jt = T.StepTimer(warmup=warmup, device="cpu"), J.StepTimer(warmup=warmup)
    for _ in range(steps):
        for timer in (tt, jt):
            with timer:
                pass
    assert len(tt.times) == len(jt.times) == max(steps - warmup, 0)
    assert all(t >= 0.0 for t in tt.times)
    if not tt.times:
        assert tt.mean != tt.mean and jt.mean != jt.mean  # both NaN


def test_step_timer_needs_a_card_unless_asked_for_the_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.StepTimer()


@pytest.mark.parametrize("m,k,n,bits,act", [(8, 768, 2304, 8, 2), (1, 3072, 768, 4, 2),
                                            (1024, 768, 768, 16, 4), (4096, 64, 50257, 8, 1)])
def test_matmul_roofline_matches_jax_at_jax_constants(m, k, n, bits, act):
    kw = dict(peak_flops=J.V5E_PEAK_BF16_FLOPS, hbm_bw=J.V5E_HBM_BW)
    got = T.matmul_roofline(m, k, n, bits, act, **kw)
    want = J.matmul_roofline(m, k, n, bits, act)
    assert (got.flops, got.bytes, got.compute_time_s, got.memory_time_s, got.bound,
            got.time_s) == (want.flops, want.bytes, want.compute_time_s,
                            want.memory_time_s, want.bound, want.time_s)


@pytest.mark.parametrize("kw", [dict(batch=1), dict(batch=8, weight_bits=4, context=512),
                                dict(batch=64, n_layer=2, d=128, vocab=1000)])
def test_gpt2_decode_roofline_matches_jax_at_jax_constants(kw):
    got = T.gpt2_decode_roofline(**kw, peak_flops=J.V5E_PEAK_BF16_FLOPS,
                                 hbm_bw=J.V5E_HBM_BW)
    assert got == J.gpt2_decode_roofline(**kw)


def test_h100_defaults():
    """The defaults are one H100 SXM's peaks; no TPU figure is carried
    over."""
    assert (T.H100_PEAK_BF16_FLOPS, T.H100_PEAK_INT8_OPS, T.H100_PEAK_F32_FLOPS,
            T.H100_HBM_BW) == (989e12, 1979e12, 67e12, 3.35e12)
    assert not [n for n in vars(T) if "V5E" in n or "TPU" in n.upper()]
    r = T.matmul_roofline(8, 768, 2304)
    assert r.compute_time_s == 2.0 * 8 * 768 * 2304 / 989e12
    assert r.memory_time_s == (768 * 2304 + (8 * 768 + 8 * 2304) * 2) / 3.35e12
    assert r.bound == "memory"
    d = T.gpt2_decode_roofline(8)
    mm = lambda m, k, n, b: T.matmul_roofline(m, k, n, b).time_s
    step = (12 * (mm(8, 768, 2304, 8) + mm(8, 768, 768, 8) + mm(8, 768, 3072, 8)
                  + mm(8, 3072, 768, 8)) + mm(8, 768, 50257, 16)
            + 2 * 12 * 192 * 768 * 2 * 8 / 3.35e12)
    assert d["step_time_us"] == pytest.approx(step * 1e6, rel=1e-12)
    assert d["tokens_per_sec"] == pytest.approx(8 / step, rel=1e-12)


def test_trace_on_the_cpu_writes_a_chrome_trace(tmp_path):
    import torch

    log_dir = tmp_path / "trace"
    with T.trace(str(log_dir), device="cpu") as d:
        assert d == str(log_dir)
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    with pytest.raises(ValueError):
        with T.trace(str(tmp_path), device="cpu"):
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1
