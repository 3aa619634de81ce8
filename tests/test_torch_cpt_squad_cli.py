"""PyTorch port: the CPT and SQuAD command lines (`main_cpt --tiny`,
`eval_cpt`, `main_squad --tiny`, on the CPU) against the JAX package's,
from the same initial parameters, offline (stand-ins for `transformers`
and `datasets` whose loads fail), and the checkpoints each package writes
loaded by the other.

`main_cpt --tiny` trains a vocabulary of 256 under `ByteTokenizer`, whose
eos id (256) as a label makes the loss NaN in both packages (the JAX
package's rule, which `test_torch_cpt.py::test_ids_past_the_vocabulary`
holds). The runs compared number for number therefore use a byte
tokenizer whose eos is a byte (10); the run with the default tokenizer is
held to the NaN rule."""

import contextlib
import dataclasses
import io
import json
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.data as jdata
import llm_qat_tpu.evals as jevals
import llm_qat_tpu.models as J
from llm_qat_tpu.cli import eval_cpt as jeval
from llm_qat_tpu.cli import main_cpt as jmain
from llm_qat_tpu.cli import main_squad as jsquad
from llm_qat_tpu.deploy import load_checkpoint as jload
from llm_qat_tpu.models import cpt_model as jcm
from llm_qat_tpu.models import qa as jqa
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.cli import eval_cpt as teval
from llm_qat_tpu_torch.cli import main_cpt as tmain
from llm_qat_tpu_torch.cli import main_squad as tsquad
from llm_qat_tpu_torch.data import ByteTokenizer
from llm_qat_tpu_torch.deploy import load_checkpoint as tload
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.train import optim

CPT_ARGS = ["--tiny", "--total-epochs", "1", "--total-cycles", "1", "--batch-size", "64",
            "--max-seq-length", "32"]
SQUAD_ARGS = ["--tiny", "--num-iterations", "2", "--batch-size", "4", "--bit-widths", "4",
              "32"]
DOCS = 20  # documents `eval_cpt` reads (its default 100)


class NewlineEosTokenizer(ByteTokenizer):
    """ByteTokenizer whose eos and pad are bytes, inside a vocabulary of 256."""

    eos_token_id = 10
    pad_token_id = 0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (restored
    after the module): pytest-xdist runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def offline_hub():
    """Stand-ins for `transformers` and `datasets` whose loads fail as an
    offline load does, so no command asks the hub (the hub libraries read
    HF_HUB_OFFLINE once, at their import); `eval_cpt` reads DOCS documents
    in both packages."""
    def fail(*a, **k):
        raise OSError("offline")

    with pytest.MonkeyPatch.context() as m:
        m.setitem(sys.modules, "transformers", types.SimpleNamespace(
            GPT2TokenizerFast=types.SimpleNamespace(from_pretrained=fail)))
        m.setitem(sys.modules, "datasets", types.SimpleNamespace(
            load_dataset=fail, DownloadConfig=lambda **k: k))
        for mod in (jdata, teval):
            m.setattr(mod, "load_wikitext", lambda version, split, limit=None,
                      f=mod.load_wikitext: f(version, split, limit=DOCS))
        yield m


def _jax_cpt_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["model"] = J.GPT2Config(**dataclasses.asdict(cfg.model))
    return J.CPTConfig(**d)


def _cfg_from_meta(meta):
    c = dict(meta["config"])
    return tc.CPTConfig(**{**c, "model": tc.GPT2Config(**c["model"]),
                           "bit_widths": tuple(c["bit_widths"])})


def _jax_init_cpt(gen, cfg, device):
    """The port's `init_cpt_params` replaced by JAX's init at the command's
    seed (0), so both commands start from the same parameters."""
    p = jcm.init_cpt_params(jax.random.PRNGKey(0), _jax_cpt_cfg(cfg))
    return bridge.params_from_numpy(jax.tree.map(np.asarray, p), device)


def _printed(main, argv):
    """main(argv) and the lines it printed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return result, buf.getvalue().splitlines()


def _run_cpt(m, out, tokenizer=None):
    """JAX's `main_cpt` then the port's, from JAX's init. Returns
    {package: (stats, printed lines)}."""
    if tokenizer is not None:
        m.setattr(jdata, "get_gpt2_tokenizer", tokenizer)
        m.setattr(tmain, "get_gpt2_tokenizer", tokenizer)
    m.setattr(tmain, "init_cpt_params", _jax_init_cpt)
    runs = {}
    for name, main in (("jax", jmain.main),
                       ("port", lambda a: tmain.main(a, device="cpu"))):
        (_, stats), lines = _printed(main, CPT_ARGS + ["--output-dir", str(out / name)])
        runs[name] = (stats, lines)
    return runs


@pytest.fixture(scope="module")
def cpt_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cpt")
    with offline_hub() as m:
        runs = _run_cpt(m, out, NewlineEosTokenizer)
    return out, runs


def _flat(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}, json.loads(str(z["__meta__"]))


# The saved parameters after one epoch (21 steps) from the same init.
# Frozen leaves bit for bit; weight scale banks within 4e-6 (2 ulps at 16).
# Input banks within 0.2 in log2 units: log_min is log2 of the smallest
# |activation| over 20k tokens, a cancellation residue whose value moves by
# 10 % or more when a float32 ulp (or a weight code on a log-grid boundary)
# moves upstream (measured 6.8e-2). Trained leaves (the LayerNorm affines
# and LoRA pairs): the update's relative L2 error within CKPT_TRAIN_TOL.
# Adam with eps 1e-8 moves every element by about ±lr whatever its
# gradient, and the LoRA gradients are 8-bit codes: an element whose code
# is 0 in one package and ±1 in the other moves by lr in one only
# (measured 4.5e-2 on mlp_proj's lora_A, 2.8e-3 at most on the LayerNorms).
CKPT_TRAIN_TOL, WQ_TOL, IQ_TOL = 0.15, 4e-6, 0.2


def _update_err(t, a, init):
    """|t - a| / |a - init| in L2 (the update's relative error)."""
    return float(np.linalg.norm((t - a).ravel()) / np.linalg.norm((a - init).ravel()))


def test_main_cpt_tiny_matches_jax(cpt_runs):
    """The printed lines (gradient-quantizer calibration, PRT bounds, the
    epoch's bits), the epoch loss (within 1e-5 relative; measured 3.7e-6),
    the precision counts, the checkpoint's meta and leaves, and the stats
    JSON's keys."""
    out, runs = cpt_runs
    (js, jl), (ts, tl) = runs["jax"], runs["port"]
    strip = lambda lines: [x.split(" loss=")[0] for x in lines if not x.startswith("saved")]
    assert strip(tl) == strip(jl)
    assert any(x.startswith("PRT bounds") for x in tl) and len(tl) == 4
    assert all(np.isfinite(ts.iteration_losses)) and len(ts.iteration_losses) == 1
    np.testing.assert_allclose(ts.iteration_losses, js.iteration_losses, rtol=1e-5)
    assert dict(ts.precision_counts) == dict(js.precision_counts)
    (jp, jmeta), (tp, tmeta) = (_flat(out / n / "cpt_target_5bit.npz") for n in ("jax", "port"))
    assert tmeta["config"] == jmeta["config"] and tmeta["bit_width"] == jmeta["bit_width"] == 5
    assert sorted(tp) == sorted(jp)
    mask = {"/".join(p): m for p, m in optim.leaves_with_paths(jcm_mask(jp))}
    init = {"/".join(p): v for p, v in optim.leaves_with_paths(jax.tree.map(
        np.asarray, jcm.init_cpt_params(jax.random.PRNGKey(0),
                                        _jax_cpt_cfg(_cfg_from_meta(jmeta)))))}
    for k, a in jp.items():
        t = tp[k]
        assert t.shape == a.shape and t.dtype == a.dtype, k
        name = k.split("/")[-1]
        if name.startswith("wq"):
            assert np.abs(t - a).max() <= WQ_TOL, k
        elif name.startswith("iq"):
            assert np.abs(t - a).max() <= IQ_TOL, k
        elif name.startswith("gq"):  # from one 32-bit backward: float32 sums
            np.testing.assert_allclose(t, a, rtol=1e-5, err_msg=k)
        elif mask[k]:
            assert _update_err(t, a, init[k]) <= CKPT_TRAIN_TOL, k
        else:
            np.testing.assert_array_equal(t, a, err_msg=k)
    (jstats,), (tstats,) = ((out / n).glob("cpt_stats_*.json") for n in ("jax", "port"))
    jd, td = json.loads(jstats.read_text()), json.loads(tstats.read_text())
    assert set(td) == set(jd) and td["model_config"] == jd["model_config"]


def jcm_mask(flat):
    """JAX's CPT trainable mask over a flat checkpoint's tree."""
    from llm_qat_tpu.train.cpt_trainer import cpt_trainable_mask

    tree = {}
    for k, v in flat.items():
        d = tree
        *head, last = k.split("/")
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return cpt_trainable_mask(tree)


def test_main_cpt_default_tokenizer_gives_jaxs_nan(tmp_path):
    """With the default (byte) tokenizer the eos label 256 is past the
    vocabulary of 256: the loss is NaN from the first epoch, as in JAX, and
    the command still writes its checkpoint, with the frozen leaves
    untouched."""
    with offline_hub() as m:
        m.setattr(tmain, "init_cpt_params", _jax_init_cpt)
        _, stats = tmain.main(CPT_ARGS + ["--output-dir", str(tmp_path), "--skip-prt"],
                              device="cpu")
    assert np.isnan(stats.iteration_losses).all()
    flat, meta = _flat(tmp_path / "cpt_target_5bit.npz")
    init = jax.tree.map(np.asarray, jcm.init_cpt_params(
        jax.random.PRNGKey(0), _jax_cpt_cfg(_cfg_from_meta(meta))))
    np.testing.assert_array_equal(flat["wte"], init["wte"])
    np.testing.assert_array_equal(flat["blocks/c_fc/w"], init["blocks"]["c_fc"]["w"])


def _eval_both(m, ckpt, out, *extra):
    """JAX's then the port's `eval_cpt` on one checkpoint: {package:
    (results, printed lines, results.json, unrounded perplexities)}."""
    got = {}
    for name, main, evaluator in (("jax", jeval.main, jevals.PerplexityEvaluator),
                                  ("port", lambda a: teval.main(a, device="cpu"),
                                   teval.PerplexityEvaluator)):
        ppl = []
        m.setattr(evaluator, "calculate_perplexity",
                  lambda self, seqs, f=evaluator.calculate_perplexity, ppl=ppl:
                  ppl.append(f(self, seqs)) or ppl[-1])
        res, lines = _printed(main, ["--model-path", str(ckpt), "--output-dir",
                                     str(out / name), "--max-length", "64", "--stride",
                                     "32", *extra])
        got[name] = (res, lines, json.loads((out / name / "results.json").read_text()), ppl)
    return got


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_eval_cpt_reads_either_packages_checkpoint(cpt_runs, tmp_path, writer):
    """Both evaluation commands on the checkpoint each package's `main_cpt`
    wrote: the config read back from its meta as a `CPTConfig`, the same
    forensics and bit-width, and the same perplexity (the port's
    `results.json` equal to JAX's; unrounded within 1e-4 relative)."""
    out, _ = cpt_runs
    ckpt = out / writer / "cpt_target_5bit.npz"
    with offline_hub() as m:
        got = _eval_both(m, ckpt, tmp_path)
    (jr, jl, jdisk, jppl), (tr, tl, tdisk, tppl) = got["jax"], got["port"]
    assert tdisk == jdisk and tr == jr
    assert jr["bit_width"] == 5 and jr["calibration_forensics"]["5"]
    assert not any("emergency" in x for x in tl) and tl == jl
    assert len(tppl) == 1 and np.isfinite(tppl[0])
    np.testing.assert_allclose(tppl, jppl, rtol=1e-4)
    params, meta = tload(ckpt, device="cpu")
    cfg = _cfg_from_meta(meta)
    assert cfg.bit_widths == (3, 4, 5, 6, 7, 8, 32) and cfg.lora_rank == 4
    assert teval.calibration_forensics(params, cfg) == jeval.calibration_forensics(
        jax.tree.map(jnp.asarray, jload(ckpt)[0]), _jax_cpt_cfg(cfg))


def test_eval_cpt_emergency_recalibration_matches_jax(cpt_runs, tmp_path):
    """`--bits` at a slot the checkpoint left uncalibrated: both commands
    re-calibrate it from four (2, 64) batches and report the same
    forensics (the slot still uncalibrated in the checkpoint) and
    perplexity (unrounded within 1e-3 relative: the re-calibrated input
    scales carry log2 ulps; measured 2e-5)."""
    out, _ = cpt_runs
    ckpt = out / "port" / "cpt_target_5bit.npz"
    params, meta = tload(ckpt, device="cpu")
    cfg = _cfg_from_meta(meta)
    missing = [b for b, ok in teval.calibration_forensics(params, cfg).items() if not ok]
    assert missing
    with offline_hub() as m:
        got = _eval_both(m, ckpt, tmp_path, "--bits", str(missing[0]))
    (jr, jl, _, jppl), (tr, tl, _, tppl) = got["jax"], got["port"]
    assert f"emergency re-calibration at {missing[0]} bits" in tl
    assert f"emergency re-calibration at {missing[0]} bits" in jl
    assert tr["bit_width"] == jr["bit_width"] == missing[0]
    assert tr["calibration_forensics"] == jr["calibration_forensics"]
    assert not tr["calibration_forensics"][str(missing[0])]
    np.testing.assert_allclose(tppl, jppl, rtol=1e-3)


def _replaying_step(make):
    """The port's `make_squad_train_step` with JAX's draws replayed: each
    call takes the next key of `main_squad`'s chain (PRNGKey(seed + 1),
    split once an iteration) and hands the step the slots, layers and
    dropout uniforms that JAX's step draws from it."""
    def make_replaying(cfg, tcfg, tables=None):
        init_state, step = make(cfg, tcfg, tables)
        chain = [jax.random.PRNGKey(1)]
        slots = jnp.asarray([cfg.quant.prec_index(b) for b in cfg.quant.student_bits])
        n = tcfg.gradient_accumulation_steps - 1

        def train_step(state, batch, gen):
            chain[0], sub = jax.random.split(chain[0])
            rng_t, rng_p, rng_l, rng_d = jax.random.split(sub, 4)
            precs = np.array(jax.random.choice(rng_p, slots, shape=(n,)))
            layers = np.array(jax.random.randint(rng_l, (n,), 0, cfg.model.n_layer + 1))
            shape = tuple(batch["input_ids"].shape) + (cfg.model.n_embd,)
            uniforms = [torch.tensor(np.asarray(jax.random.uniform(k, shape)))
                        for k in [rng_t] + list(jax.random.split(rng_d, n))]
            return step(state, batch, gen, precs=precs, layers=layers, uniforms=uniforms)

        return init_state, train_step

    return make_replaying


@pytest.fixture(scope="module")
def squad_runs(tmp_path_factory):
    """JAX's `main_squad --tiny` and the port's from JAX's init with JAX's
    draws replayed."""
    out = tmp_path_factory.mktemp("squad")
    results = {}
    with offline_hub() as m:
        m.setattr(tsquad, "init_qa_params", lambda gen, cfg, device: bridge.params_from_numpy(
            jax.tree.map(np.asarray, jqa.init_qa_params(
                jax.random.PRNGKey(0), J.tiny_test_config((4, 32)))), device))
        m.setattr(tsquad, "make_squad_train_step", _replaying_step(tsquad.make_squad_train_step))
        results["jax"] = jsquad.main(SQUAD_ARGS + ["--output-dir", str(out / "jax")])
        results["port"] = tsquad.main(SQUAD_ARGS + ["--output-dir", str(out / "port")],
                                      device="cpu")
    return out, results


def test_main_squad_tiny_matches_jax(squad_runs):
    """EM/F1 at both bit-widths equal JAX's (`squad_results.json` too), and
    the per-bit checkpoint `squad_4bit.npz`: the same meta, untouched
    leaves bit for bit, each trained leaf's update within 1e-2 relative in
    L2 after two steps (Adam with eps 1e-8 moves an element whose gradient
    is near eps by a fraction of lr that a float32 difference shifts;
    measured 3.3e-3 on c_attn's bias, 1.5e-5 on the weights). The QA
    biases' gradients are 0 in exact arithmetic (Σ softmax − one-hot) and
    float32 noise in both packages, so each step moves them by up to ±lr
    (3e-5) in either direction: within 2·lr a step."""
    out, res = squad_runs
    assert res["port"] == res["jax"] and set(res["port"]) == {4, 32}
    assert res["port"][4]["total"] == 16
    disk = [json.loads((out / n / "squad_results.json").read_text()) for n in ("jax", "port")]
    assert disk[0] == disk[1]
    (jp, jmeta), (tp, tmeta) = (_flat(out / n / "squad_4bit.npz") for n in ("jax", "port"))
    assert tmeta["config"] == jmeta["config"] and tmeta["bit_width"] == 4
    assert not (out / "port" / "squad_32bit.npz").exists()
    init = {"/".join(p): v for p, v in optim.leaves_with_paths(jax.tree.map(
        np.asarray, jqa.init_qa_params(jax.random.PRNGKey(0), J.tiny_test_config((4, 32)))))}
    assert sorted(tp) == sorted(jp) == sorted(init)
    for k, a in jp.items():
        if np.array_equal(a, init[k]):
            np.testing.assert_array_equal(tp[k], a, err_msg=k)
        elif k.startswith("qa_") and k.endswith("/b"):
            assert np.abs(tp[k] - a).max() <= 2 * 3e-5 * 2, k
        else:
            assert _update_err(tp[k], a, init[k]) <= 1e-2, k


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_squad_checkpoints_load_in_the_other_package(squad_runs, tmp_path, writer, reader):
    """`--eval-only --checkpoint` on the other package's `squad_4bit.npz`
    gives the EM/F1 the writer's own run reported."""
    out, res = squad_runs
    args = SQUAD_ARGS + ["--eval-only", "--checkpoint", str(out / writer / "squad_4bit.npz"),
                         "--output-dir", str(tmp_path)]
    with offline_hub():
        got = (jsquad.main(args) if reader == "jax" else tsquad.main(args, device="cpu"))
    assert got == res[writer]


@pytest.mark.parametrize("name", ["main_cpt", "eval_cpt", "main_squad"])
def test_flags_and_help_match_jax(capsys, name):
    jax_main = {"main_cpt": jmain.main, "eval_cpt": jeval.main, "main_squad": jsquad.main}[name]
    port_main = {"main_cpt": tmain.main, "eval_cpt": teval.main, "main_squad": tsquad.main}[name]
    for main in (jax_main, lambda a: port_main(a, device="cpu")):
        with pytest.raises(SystemExit):
            main(["--help"])
    jhelp, thelp = capsys.readouterr().out.split("usage:")[1:]
    assert thelp == jhelp


def test_mains_run_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, args in ((tmain.main, CPT_ARGS), (tsquad.main, SQUAD_ARGS),
                       (teval.main, ["--model-path", str(tmp_path / "x.npz")])):
        out = tmp_path / "out"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args + ["--output-dir", str(out)])
        assert not out.exists()
