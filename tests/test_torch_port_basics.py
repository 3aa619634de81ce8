"""PyTorch port: import isolation, device policy, bridge, quantizer math,
sampling filters — each held against the JAX package on the CPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.models.generate import _filter_logits as j_filter
from llm_qat_tpu.quant import calibration as jcal
from llm_qat_tpu.quant import functional as jf
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.device import resolve_device
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.generate import _filter_logits as t_filter
from llm_qat_tpu_torch.quant import calibration as tcal
from llm_qat_tpu_torch.quant import functional as tf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module (the training slice's, the fused linear's, the
    decode attention's, the server's, the packed-weight product's, the
    fused decode layer's, the command line's data, deploy, utils, cli
    and HF-import modules, the CPT and SQuAD modules, and the robustness
    modules, `run_rpi` and `utils.profiling` among them, and the six
    `parallel` modules) and chip_smoke.py import without JAX or
    llm_qat_tpu."""
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import llm_qat_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, 'llm_qat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        "want = {'llm_qat_tpu_torch.train.' + n for n in\n"
        "        ('sp_trainer', 'distillation', 'optim', 'calibration_manager')}\n"
        "want |= {'llm_qat_tpu_torch.ops.' + n for n in\n"
        "         ('attention', 'matmul', 'fused_linear', 'decode_attention',\n"
        "          'quant_matmul', 'fused_decode')}\n"
        "want |= {'llm_qat_tpu_torch.serving', 'llm_qat_tpu_torch.serving.engine'}\n"
        "want |= {'llm_qat_tpu_torch.' + n for n in\n"
        "         ('data', 'data.lm_datasets', 'data.native', 'deploy',\n"
        "          'deploy.checkpoint', 'deploy.elastic', 'utils', 'utils.stats',\n"
        "          'cli', 'cli.main_sp', 'cli.check_init', 'models.hf_import')}\n"
        "want |= {'llm_qat_tpu_torch.' + n for n in\n"
        "         ('models.cpt_model', 'models.qa', 'train.cpt_trainer',\n"
        "          'train.squad_trainer', 'data.squad', 'evals.squad_eval',\n"
        "          'cli.main_cpt', 'cli.eval_cpt', 'cli.main_squad')}\n"
        "want |= {'llm_qat_tpu_torch.' + n for n in\n"
        "         ('robustness', 'robustness.attacks', 'robustness.random_switching',\n"
        "          'robustness.defense_eval', 'cli.run_rpi', 'utils.profiling')}\n"
        "want |= {'llm_qat_tpu_torch.parallel' + n for n in\n"
        "         ('', '.mesh', '.multihost', '._comm', '.ring_attention',\n"
        "          '.cp_forward', '.pipeline')}\n"
        "assert want <= names, want - names\n"
        "runpy.run_path('chip_smoke.py', run_name='not_main')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'llm_qat_tpu' or m.startswith('llm_qat_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


@pytest.mark.parametrize("package", ["ops", "quant", "train", "parallel"])
def test_package_exports_match_jax(package):
    """A.10: `ops`, `quant`, `train` and `parallel` export the JAX
    package's names (9, 13, 3 and 18), each an attribute of the port's
    package."""
    import importlib

    want = importlib.import_module(f"llm_qat_tpu.{package}").__all__
    got = importlib.import_module(f"llm_qat_tpu_torch.{package}")
    assert sorted(got.__all__) == sorted(want)
    assert len(want) == {"ops": 9, "quant": 13, "train": 3, "parallel": 18}[package]
    for name in want:
        assert getattr(got, name) is not None, name


def test_importing_ops_builds_nothing():
    """Importing `llm_qat_tpu_torch.ops` (and the parallel layer above it)
    compiles no kernel and loads no library: `_build` starts nvcc only at
    a kernel's first launch."""
    code = (
        "import subprocess\n"
        "started = []\n"
        "real = subprocess.Popen\n"
        "subprocess.Popen = lambda *a, **k: started.append(a) or real(*a, **k)\n"
        "from llm_qat_tpu_torch.ops import _build\n"
        "loads = []\n"
        "_build.load = lambda name: loads.append(name)\n"
        "import llm_qat_tpu_torch.ops, llm_qat_tpu_torch.parallel\n"
        "assert not started and not loads, (started, loads)\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr


def test_cuda_request_without_a_card_raises(monkeypatch):
    """device="cuda" (the default) raises when no card is present; the CPU is
    used only when asked for; `prec_tables` and `init_stats` follow the same
    policy."""
    from llm_qat_tpu_torch.models.inference import init_layer_caches
    from llm_qat_tpu_torch.models.sp_model import init_sp_params, prec_tables
    from llm_qat_tpu_torch.quant.calibration import init_stats

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tc.tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_sp_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_layer_caches(cfg, 1, 8, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prec_tables(cfg.quant)
    assert resolve_device("cpu").type == "cpu"
    assert prec_tables(cfg.quant, "cpu").bits.device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_stats((1, 8))
    assert init_stats((1, 8), "cpu").running_min.device.type == "cpu"


def test_kernel_builds_hash_the_shared_headers(tmp_path, monkeypatch):
    """A kernel library's name carries a hash of its source and of every
    shared header in csrc/: an edited header rebuilds the sources that
    include it."""
    from llm_qat_tpu_torch.ops import _build

    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build._lib_path("k") != first


def test_bridge_round_trip_is_exact():
    cfg = J.tiny_test_config((4, 8, 32))
    params = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(0), cfg))
    params["extra_bf16"] = np.asarray(jnp.asarray(params["wte"], jnp.bfloat16))
    tp = bridge.params_from_numpy(params, "cpu")
    assert tp["extra_bf16"].dtype == torch.bfloat16
    assert tp["blocks"]["c_attn"]["lora_A"].shape == (2, 3, 32, 4)
    back = bridge.params_to_numpy(tp)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, a in flat_a:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_config_tables_match():
    jq = J.QuantConfig(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"})
    tq = tc.QuantConfig(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"})
    for name in ("bits_table", "kind_table", "rank_table", "scaling_table"):
        np.testing.assert_array_equal(getattr(jq, name)(), getattr(tq, name)())
    assert (jq.max_rank, jq.prec_index(8), jq.kind_name(4)) == (
        tq.max_rank, tq.prec_index(8), tq.kind_name(4))
    assert (tf.KIND_MINMAX, tf.KIND_LOG) == (jf.KIND_MINMAX, jf.KIND_LOG)


def _quant_inputs(kind, bits):
    rng = np.random.default_rng(bits * 10 + kind)
    x = rng.normal(0, 1.0, (6, 16)).astype(np.float32)
    x[0, :3] = 0.0  # exact zeros (kept by the log kind)
    if kind == jf.KIND_LOG:
        la = np.log2(np.maximum(np.abs(x), 1e-5))
        zp = la.min(axis=0, keepdims=True)           # log_min
        scale = la.max(axis=0, keepdims=True) - zp   # log_range
    else:
        scale = np.abs(x).max(axis=0, keepdims=True) / (2.0 ** (bits - 1) - 1)
        zp = np.zeros_like(scale)
    return x, scale.astype(np.float32), zp.astype(np.float32)


@pytest.mark.parametrize("fn", ["fake_quant", "fake_quant_flat"])
@pytest.mark.parametrize("kind", [jf.KIND_MINMAX, jf.KIND_LOG])
@pytest.mark.parametrize("bits", [4, 8, 32])
def test_fake_quant_matches_jax(fn, kind, bits):
    """Tolerance: minmax is exact (same round-half-even grid); log goes
    through log2/exp2, whose float32 results may differ by an ulp between
    XLA and PyTorch, so 1e-6 relative."""
    x, scale, zp = _quant_inputs(kind, bits)
    want = np.asarray(getattr(jf, fn)(jnp.asarray(x), scale, zp, float(bits), kind))
    got = getattr(tf, fn)(torch.tensor(x), torch.tensor(scale), torch.tensor(zp),
                          float(bits), kind).numpy()
    if kind == jf.KIND_MINMAX:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", [jf.KIND_MINMAX, jf.KIND_LOG])
@pytest.mark.parametrize("channel_dim", [None, 1])
def test_dynamic_scale_flat_matches_jax(kind, channel_dim):
    """Exact for minmax; log2 may differ by an ulp, so 1e-6 relative."""
    x = np.random.default_rng(3).normal(0, 0.3, (3, 32, 4)).astype(np.float32)
    ws, wz = jax.vmap(lambda a: jcal.dynamic_scale_flat(a, 4.0, kind,
                                                        channel_dim))(x)
    ts, tz = tcal.dynamic_scale_flat(torch.tensor(x), 4.0, kind, channel_dim,
                                     batch_dims=1)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(wz), rtol=1e-6)


@pytest.mark.parametrize("kind", [jf.KIND_MINMAX, jf.KIND_LOG])
@pytest.mark.parametrize("channel_dim", [None, 1])
@pytest.mark.parametrize("symmetric", [True, False])
def test_sp_model_dynamic_scale_matches_jax(kind, channel_dim, symmetric):
    """sp_model.dynamic_scale (the JAX `lax.switch` version's counterpart)
    on a LoRA-bank-shaped (in, r) tensor: exact for minmax, 1e-6 relative
    for log (log2 may differ by an ulp)."""
    from llm_qat_tpu.models import sp_model as jsp
    from llm_qat_tpu_torch.models import sp_model as tsp

    x = np.random.default_rng(4).normal(0, 0.3, (32, 4)).astype(np.float32)
    ws, wz = jsp.dynamic_scale(jnp.asarray(x), jnp.float32(4.0), jnp.int32(kind),
                               channel_dim, symmetric)
    ts, tz = tsp.dynamic_scale(torch.tensor(x), 4.0, kind, channel_dim, symmetric)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_allclose(tz.numpy(), np.asarray(wz), rtol=1e-6)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.9), (0.9, 20, 0.8)])
def test_filter_logits_matches_jax(temperature, top_k, top_p):
    """Kept/removed sets must agree exactly and kept logits to float32
    rounding (same division); the top-p cumsum is summed in another order,
    which this seeded input does not bring to a tie at the threshold."""
    logits = np.random.default_rng(7).normal(0, 3.0, (4, 64)).astype(np.float32)
    want = np.asarray(j_filter(jnp.asarray(logits), temperature, top_k, top_p))
    got = t_filter(torch.tensor(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(got <= -1e29, want <= -1e29)
    np.testing.assert_allclose(got, want, rtol=1e-6)
