"""PyTorch port: the SP evaluation command `eval_sp` (`--synthetic-tasks`,
offline, `device="cpu"`) against the JAX package's on the same checkpoint,
in both directions: a tiny calibrated model written by the JAX package's
`save_checkpoint` and by the port's. Both commands must give the same
`results.json` keys, zero-shot accuracies and size sweep, and perplexities
within 1e-5 relative before `results.json` rounds them; `--per-tensor`
must reduce the banks as JAX's `_reduce_to_per_tensor` does. Both commands
score the first 20 documents of the offline corpus (the WikiText load's
limit of 200 set to 20 in both packages: about 2000 windows of 32 tokens,
so that the file stays near a minute beside other files)."""

import contextlib
import dataclasses
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.data as jdata
import llm_qat_tpu.deploy as JD
import llm_qat_tpu.evals as JE
import llm_qat_tpu.models as J
from llm_qat_tpu.cli import eval_sp as jeval
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch import evals as TE
from llm_qat_tpu_torch.cli import eval_sp as teval
from llm_qat_tpu_torch.deploy import save_checkpoint
from llm_qat_tpu_torch.models import config as tc

ARGS = ["--synthetic-tasks", "--max-length", "32", "--stride", "16"]
DOCS = 20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one intra-op thread
    each (restored after the module), as pytest-xdist runs several files
    side by side and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def offline_hub():
    """Stand-ins for `transformers` and `datasets` whose loads fail as an
    offline load does, so neither command asks the hub (the hub libraries
    read HF_HUB_OFFLINE once, at their import): the byte tokenizer and the
    synthetic corpus, as offline."""
    def fail(*a, **k):
        raise OSError("offline")

    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "transformers", types.SimpleNamespace(
            GPT2TokenizerFast=types.SimpleNamespace(from_pretrained=fail)))
        m.setitem(sys.modules, "datasets", types.SimpleNamespace(
            load_dataset=fail, DownloadConfig=lambda **k: k))
        for mod in (jdata, teval):
            m.setattr(mod, "load_wikitext", lambda version, split, limit=None, f=mod.load_wikitext:
                      f(version, split, limit=DOCS))
        yield m


def _calibrated(per_channel=True, symmetric=True, bits=(4, 8, 32)):
    cfg = J.tiny_test_config(bits)
    cfg = cfg.replace(quant=dataclasses.replace(cfg.quant, per_channel=per_channel,
                                                symmetric=symmetric))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(8), cfg))
    rng = np.random.default_rng(8)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), cfg)
    p = jcm.calibrate_input_quantizers(
        p, cfg, [jnp.asarray(rng.integers(0, 256, (2, 32))) for _ in range(2)])
    return cfg, jax.tree.map(np.asarray, p)


def writable_jax_scores(m):
    """The JAX `ZeroShotEvaluator` sets an empty span's score to -inf in
    `np.asarray` of its jitted scorer's output, which is read-only: the
    assignment raises, and the example is counted as an error instead of
    scored (at `--max-length 32` every BoolQ context is cut, so the task
    stops after `max_errors`). The port scores such a choice -inf, as the
    JAX docstrings and the reference say; the reference is held to that by
    handing its caller a writable copy."""
    init = JE.ZeroShotEvaluator.__init__

    def patched(self, *a, **k):
        init(self, *a, **k)
        inner = self._choice_scores
        self._choice_scores = lambda *x: np.array(inner(*x))

    m.setattr(JE.ZeroShotEvaluator, "__init__", patched)


def _record_perplexities(m, ppl):
    """Records each package's unrounded perplexities into ppl["jax"] and
    ppl["port"]."""
    for name, cls in (("jax", JE.PerplexityEvaluator), ("port", TE.PerplexityEvaluator)):
        inner = cls.calculate_perplexity
        m.setattr(cls, "calculate_perplexity",
                  lambda self, seqs, inner=inner, name=name:
                  ppl[name].append(inner(self, seqs)) or ppl[name][-1])


def _jax_main(path, out, m):
    writable_jax_scores(m)
    return jeval.main(["--model-path", str(path), "--output-dir", str(out), *ARGS])


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    """The 8-bit checkpoint of the tiny model written by the JAX package,
    evaluated by both commands: (dir, params, JAX results, port results, JAX
    perplexities, port perplexities)."""
    cfg, p = _calibrated()
    tmp = tmp_path_factory.mktemp("eval_sp")
    path = tmp / "sp_8bit.npz"
    JD.save_checkpoint(path, jax.tree.map(jnp.asarray, p), cfg, bit_width=8)
    ppl = {"jax": [], "port": []}
    with offline_hub() as m:
        _record_perplexities(m, ppl)
        want = _jax_main(path, tmp / "jax", m)
        got = teval.main(["--model-path", str(path), "--output-dir", str(tmp / "port"),
                          *ARGS], device="cpu")
    return tmp, p, want, got, ppl["jax"], ppl["port"]


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_results_match_jax(evaluated):
    tmp, _, want, got, _, _ = evaluated
    on_disk = json.loads((tmp / "port" / "results.json").read_text())
    assert _keys(on_disk) == _keys(json.loads((tmp / "jax" / "results.json").read_text()))
    assert _keys(got) == _keys(want)
    assert got["bit_width"] == want["bit_width"] == 8
    assert got["zero_shot"] == want["zero_shot"]
    assert got["model_size_sweep"] == want["model_size_sweep"]
    for k in ("model_size_gb", "compression_ratio"):
        assert got[k] == want[k]
    assert set(got["zero_shot"]) == {"BoolQ", "HellaSwag", "WinoGrande", "ARC-e", "ARC-c",
                                     "OBQA", "Average"}
    # the tables land beside results.json, as the JAX command writes them
    assert sorted(p.name for p in (tmp / "port").iterdir()) == sorted(
        p.name for p in (tmp / "jax").iterdir())


def test_perplexity_matches_jax_unrounded(evaluated):
    _, _, want, got, jppl, tppl = evaluated
    assert len(jppl) == len(tppl) == 1 and np.isfinite(tppl[0])
    np.testing.assert_allclose(tppl[0], jppl[0], rtol=1e-5)
    assert got["perplexity"] == {"wikitext2": round(tppl[0], 1)}


def test_jax_command_reads_the_ports_checkpoint(evaluated):
    """The other direction: the port's `save_checkpoint` writes the same
    parameters; the JAX command's results on that file equal its results
    on the JAX-written one, the unrounded perplexity bit for bit."""
    tmp, p, want, _, jppl, _ = evaluated
    path = tmp / "port_written" / "sp_8bit.npz"
    save_checkpoint(path, bridge.params_from_numpy(p, "cpu"), tc.tiny_test_config((4, 8, 32)),
                    bit_width=8)
    ppl = {"jax": [], "port": []}
    with offline_hub() as m:
        _record_perplexities(m, ppl)
        again = _jax_main(path, tmp / "port_written" / "out", m)
    assert ppl["jax"] == jppl and again == want


def test_calibration_status_matches_jax():
    cfg, p = _calibrated()
    tp = bridge.params_from_numpy(p, "cpu")
    assert teval.verify_calibration_status(tp) == jeval.verify_calibration_status(
        jax.tree.map(jnp.asarray, p))
    fresh = J.init_sp_params(jax.random.PRNGKey(0), cfg)
    assert teval.verify_calibration_status(bridge.params_from_numpy(
        jax.tree.map(np.asarray, fresh), "cpu")) == jeval.verify_calibration_status(fresh)


@pytest.mark.parametrize("symmetric", [True, False])
def test_per_tensor_banks_match_jax(tmp_path, symmetric):
    """`--per-tensor` on a per-channel checkpoint (log kind at 8 bits, minmax
    at 4, symmetric and asymmetric): the reduced banks equal JAX's, and the
    config both commands rebuild is per-tensor."""
    cfg, p = _calibrated(symmetric=symmetric)
    tcfg = tc.tiny_test_config((4, 8, 32))
    jr = jeval._reduce_to_per_tensor(jax.tree.map(jnp.asarray, p), cfg.quant)
    tr = teval._reduce_to_per_tensor(bridge.params_from_numpy(p, "cpu"),
                                     dataclasses.replace(tcfg.quant, symmetric=symmetric))
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        for key in ("wq_scale", "wq_zp", "iq_scale", "iq_zp"):
            want = np.asarray(jr["blocks"][lin][key])
            got = tr["blocks"][lin][key].numpy()
            assert got.shape == want.shape and want.shape[-1] == 1
            np.testing.assert_array_equal(got, want, err_msg=f"{lin}.{key}")
        np.testing.assert_array_equal(tr["blocks"][lin]["w"].numpy(), p["blocks"][lin]["w"])
    path = tmp_path / "sp_4bit.npz"
    JD.save_checkpoint(path, jax.tree.map(jnp.asarray, p), cfg, bit_width=4)
    tparams, tcfg2, bits = teval.load_switchable_model(path, True, device="cpu")
    jparams, jcfg2, jbits = jeval.load_switchable_model(path, True)
    assert bits == jbits == 4 and not tcfg2.quant.per_channel and not jcfg2.quant.per_channel
    np.testing.assert_array_equal(tparams["blocks"]["c_fc"]["iq_zp"].numpy(),
                                  np.asarray(jparams["blocks"]["c_fc"]["iq_zp"]))


def test_empty_spans_score_minus_inf_where_jax_raises():
    """Without `writable_jax_scores` the JAX evaluator raises on an empty
    span (the read-only assignment); the port scores the choice -inf and
    picks among the others."""
    cfg, p = _calibrated()
    jfn = lambda ids: J.sp_forward(jax.tree.map(jnp.asarray, p), ids, 1, cfg)["logits"]
    tp = bridge.params_from_numpy(p, "cpu")
    from llm_qat_tpu_torch.models.sp_model import sp_forward

    tcfg = tc.tiny_test_config((4, 8, 32))
    tfn = lambda ids: sp_forward(tp, ids, 1, tcfg)["logits"]
    from llm_qat_tpu.data import ByteTokenizer

    ctx, choices = "x" * 40, [" True", " False"]
    with pytest.raises(ValueError, match="read-only"):
        JE.ZeroShotEvaluator(jfn, ByteTokenizer(), max_length=32).compute_choice_likelihood(
            ctx, choices)
    tz = TE.ZeroShotEvaluator(tfn, ByteTokenizer(), max_length=32, device="cpu")
    assert np.isneginf(tz.score_choices(ctx, choices)).all()
    assert tz.compute_choice_likelihood(ctx, choices) == 0


def test_flags_and_help_match_jax(capsys):
    for main in (jeval.main, lambda a: teval.main(a, device="cpu")):
        with pytest.raises(SystemExit):
            main(["--help"])
    jhelp, thelp = capsys.readouterr().out.split("usage:")[1:]
    assert thelp == jhelp


def test_main_runs_on_the_card_by_default(monkeypatch, tmp_path):
    cfg, p = _calibrated()
    path = tmp_path / "sp_8bit.npz"
    JD.save_checkpoint(path, jax.tree.map(jnp.asarray, p), cfg, bit_width=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        teval.main(["--model-path", str(path), "--output-dir", str(out), *ARGS])
    assert not out.exists()
