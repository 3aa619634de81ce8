"""PyTorch port: the evaluation harness (`evals/`) against the JAX package on
the CPU. Both packages score the same tiny calibrated model (carried across
with `bridge.params_from_numpy`): sliding windows, perplexity (rel 1e-5,
with a batch whose loss is not finite skipped in both), zero-shot choice
scores (abs 1e-5) and accuracies (equal), few-shot MMLU on stub subject
dicts and TriviaQA with a stub `generate_fn`, metrics, tables,
`BaselineComparison`, the task loaders and the SQuAD metrics."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.evals as JE
import llm_qat_tpu.models as J
from llm_qat_tpu.data import ByteTokenizer, synthetic_corpus
from llm_qat_tpu.evals import squad_metrics as jsq
from llm_qat_tpu.evals import task_loading as jtl
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch import evals as TE
from llm_qat_tpu_torch.evals import squad_metrics as tsq
from llm_qat_tpu_torch.evals import task_loading as ttl
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.sp_model import prec_tables, sp_forward

V = 256
TOK = ByteTokenizer()


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU forwards here are many small ops: one intra-op thread
    each (restored after the module), as pytest-xdist runs several files
    side by side and more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_hub(monkeypatch):
    """A `datasets` stand-in whose loads fail as an offline load does (the
    hub library reads HF_HUB_OFFLINE once, at its import). Records each
    load's keyword arguments."""
    calls = []

    def fail(*a, **k):
        calls.append(k)
        raise OSError("offline")

    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=fail, DownloadConfig=lambda **k: k))
    return calls


@pytest.fixture(scope="module")
def model():
    """A tiny SP model (256 positions, so that 256-token choice rows fit),
    calibrated by the JAX package; (JAX logits_fn, port logits_fn) at the
    4-bit slot."""
    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=V, n_positions=256, n_embd=32, n_layer=2, n_head=2)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q))
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(6)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, V, (2, 32))) for _ in range(2)])
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")
    jt, tt = J.prec_tables(jcfg.quant), prec_tables(tcfg.quant, "cpu")
    jfn = lambda ids: J.sp_forward(p, ids, 0, jcfg, tables=jt)["logits"]
    tfn = lambda ids: sp_forward(tp, ids, 0, tcfg, tables=tt)["logits"]
    return jfn, tfn, p, tp


@pytest.mark.parametrize("n,max_length,stride", [(100, 32, 32), (100, 32, 16), (7, 8, 3),
                                                 (33, 32, 32), (2, 8, 8), (1, 8, 4)])
def test_windows_match_jax(n, max_length, stride):
    assert list(TE.iter_windows(n, max_length, stride)) == list(
        JE.iter_windows(n, max_length, stride))
    toks = np.arange(1, n + 1, dtype=np.int32)
    jw = JE.PerplexityEvaluator(lambda i: i, max_length, stride)._windows_for(toks)
    tw = TE.PerplexityEvaluator(lambda i: i, max_length, stride, device="cpu").windows([toks])
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]


@pytest.mark.parametrize("max_length,stride", [(64, 64), (64, 32)])
def test_perplexity_matches_jax(model, max_length, stride):
    jfn, tfn, _, _ = model
    docs = [np.asarray(TOK(t), np.int32) for t in synthetic_corpus(6, 3)]
    docs.append(np.asarray([5], np.int32))  # too short: skipped by both
    want = JE.PerplexityEvaluator(jfn, max_length, stride).calculate_perplexity(docs)
    got = TE.PerplexityEvaluator(tfn, max_length, stride, device="cpu").calculate_perplexity(
        docs)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_non_finite_batches_are_skipped_as_in_jax(model):
    """A logits_fn that returns NaN for some batches (those whose ids sum to
    a multiple of 3): both packages skip them and agree on the rest."""
    jfn, tfn, _, _ = model
    docs = [np.asarray(TOK(t), np.int32) for t in synthetic_corpus(4, 5)]
    jbad = lambda ids: jfn(ids) + jnp.where(ids.sum() % 3 == 0, jnp.nan, 0.0)
    tbad = lambda ids: tfn(ids) + torch.where(ids.sum() % 3 == 0, torch.nan, 0.0)
    te = TE.PerplexityEvaluator(tbad, 32, 32, batch_size=4, device="cpu")
    windows = te.windows(docs)
    sums = [sum(int(w[0].sum()) for w in windows[i:i + 4]) for i in range(0, len(windows), 4)]
    assert any(s % 3 == 0 for s in sums) and not all(s % 3 == 0 for s in sums)
    want = JE.PerplexityEvaluator(jbad, 32, 32, batch_size=4).calculate_perplexity(docs)
    got = te.calculate_perplexity(docs)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    clean = TE.PerplexityEvaluator(tfn, 32, 32, batch_size=4, device="cpu")
    assert got != clean.calculate_perplexity(docs)
    assert TE.PerplexityEvaluator(tfn, device="cpu").calculate_perplexity([]) == float("inf")


def _recording(jz):
    """Wraps the JAX evaluator's jitted scorer; returns the list of score
    rows it produced (the -inf rule applied as JAX's caller applies it).
    The wrapper hands the caller a writable copy: JAX's own caller assigns
    -inf into `np.asarray` of the jitted output, which is read-only and
    raises (tests/test_torch_eval_sp.py::writable_jax_scores)."""
    seen, inner = [], jz._choice_scores

    def wrapped(ids, starts, ends):
        out = np.array(inner(ids, starts, ends))
        for i, (s, e) in enumerate(zip(np.asarray(starts), np.asarray(ends))):
            if not (s < e and e > 0):
                out[i] = -np.inf
        seen.append(out)
        return out

    jz._choice_scores = wrapped
    return seen


@pytest.mark.parametrize("max_length", [256, 48])
def test_zero_shot_scores_and_accuracies_match_jax(model, max_length):
    """Every choice score of every example of the six synthetic tasks (at
    48 tokens the BoolQ contexts are cut, so some spans are empty and score
    -inf in both), and the accuracy table."""
    jfn, tfn, _, _ = model
    tasks = jtl.synthetic_tasks(n=4, seed=1)
    jz = JE.ZeroShotEvaluator(jfn, TOK, max_length=max_length)
    tz = TE.ZeroShotEvaluator(tfn, TOK, max_length=max_length, device="cpu")
    seen = _recording(jz)
    want = jz.evaluate_all_tasks(tasks)
    got_scores = []
    inner = tz.score_choices
    tz.score_choices = lambda c, ch: got_scores.append(inner(c, ch)) or got_scores[-1]
    got = tz.evaluate_all_tasks(tasks)
    assert got == want
    assert len(got_scores) == len(seen) == sum(len(v) for v in tasks.values())
    for g, w in zip(got_scores, seen):
        assert g.dtype == np.float32
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-5)
        assert np.argmax(g) == np.argmax(w)
    if max_length == 48:
        assert any(np.isinf(w).any() for w in seen)


def test_zero_shot_formatters_and_errors_match_jax(model):
    jfn, tfn, _, _ = model
    tasks = jtl.synthetic_tasks(n=3, seed=2)
    for name, fmt in JE.TASK_FORMATTERS.items():
        for ex in tasks[name]:
            assert TE.TASK_FORMATTERS[name](ex) == fmt(ex)
    wino = {"sentence": "a _ b _ c", "option1": "x", "option2": "y", "answer": "2"}
    assert TE.TASK_FORMATTERS["WinoGrande"](wino) == JE.TASK_FORMATTERS["WinoGrande"](wino)
    # examples that raise are counted as errors up to max_errors, then the
    # loop stops; an unknown answer key counts as a miss
    bad = [{"question": "q?"}] * 3 + jtl.synthetic_tasks(n=2)["ARC-e"]
    bad[-1] = dict(bad[-1], answerKey="Z")
    kw = dict(max_length=64, max_errors=1)
    assert TE.ZeroShotEvaluator(tfn, TOK, device="cpu", **kw).evaluate_task("ARC-e", bad) == \
        JE.ZeroShotEvaluator(jfn, TOK, **kw).evaluate_task("ARC-e", bad)
    assert TE.ZeroShotEvaluator(tfn, TOK, device="cpu").evaluate_task("BoolQ", None) == 0.0


def _mmlu():
    rng = np.random.default_rng(4)
    words = ["ring", "group", "field", "law", "virtue", "norm", "city", "trade"]

    def ex():
        return {"question": " ".join(rng.choice(words, 5).tolist()) + "?",
                "choices": [" ".join(rng.choice(words, 2).tolist()) for _ in range(4)],
                "answer": int(rng.integers(4))}

    return {s: {"test": [ex() for _ in range(3)], "dev": [ex() for _ in range(2)]}
            for s in ("abstract_algebra", "philosophy", "sociology", "cooking")}


def test_few_shot_matches_jax(model):
    jfn, tfn, _, _ = model
    trivia = [{"question": f"who wrote book {i}?", "answers": [f"Author {i}", f"A{i}"]}
              for i in range(4)]
    shots = [{"question": "capital of x?", "answers": ["Y"]}]
    gen = lambda prompt, n: ["The author 0\n", "a1.", "nobody", ""][len(prompt) % 4]
    kw = dict(max_length=256, max_samples=2, n_shots=1)
    jf = JE.FewShotEvaluator(jfn, TOK, generate_fn=gen, **kw)
    tf = TE.FewShotEvaluator(tfn, TOK, generate_fn=gen, device="cpu", **kw)
    want = jf.evaluate_all(mmlu_subjects=_mmlu(), triviaqa=trivia, triviaqa_shots=shots)
    got = tf.evaluate_all(mmlu_subjects=_mmlu(), triviaqa=trivia, triviaqa_shots=shots)
    assert got == want and set(got["MMLU"]) == {"Humanities", "STEM", "Social Sciences",
                                                "Other", "Average"}
    for s in ("formal_logic", "astronomy", "sociology", "cooking"):
        assert TE.mmlu_category(s) == JE.mmlu_category(s)
    ex = _mmlu()["philosophy"]
    from llm_qat_tpu.evals.few_shot import format_mmlu_prompt as jfmt
    from llm_qat_tpu_torch.evals.few_shot import format_mmlu_prompt as tfmt
    assert tfmt(ex["test"][0], ex["dev"]) == jfmt(ex["test"][0], ex["dev"])
    with pytest.raises(ValueError, match="generate_fn"):
        TE.FewShotEvaluator(tfn, TOK, device="cpu").evaluate_triviaqa(trivia)


def test_loaders_offline_return_none(no_hub):
    """Offline, the task and MMLU loaders ask for local files only, fail and
    give None, as the JAX loaders give None; the synthetic tasks equal
    JAX's."""
    assert ttl.load_task("BoolQ") is None and ttl.load_task("nope") is None
    assert no_hub and all(k["download_config"] == {"local_files_only": True} for k in no_hub)
    assert ttl.load_all_tasks(["ARC-e", "OBQA"]) == {"ARC-e": None, "OBQA": None}
    assert ttl.load_all_tasks() == jtl.load_all_tasks()
    assert TE.load_mmlu(["philosophy"]) is None and JE.load_mmlu(["philosophy"]) is None
    assert ttl.synthetic_tasks(5, 3) == jtl.synthetic_tasks(5, 3)
    assert ttl.TASK_SOURCES == jtl.TASK_SOURCES


def test_metrics_match_jax(model):
    _, _, jp, tp = model
    assert TE.STANDARD_CONFIGS == JE.STANDARD_CONFIGS
    for c in TE.STANDARD_CONFIGS.values():
        assert TE.get_config_string(c) == JE.get_config_string(c)
        assert TE.compression_ratio(c, TE.STANDARD_CONFIGS["FP16"]) == JE.compression_ratio(
            c, JE.STANDARD_CONFIGS["FP16"])
        for args in ((124.4, 12, 12, 64, c), (0.1, 2, 2, 16, c, 256, 4)):
            assert TE.model_size_gb(*args) == JE.model_size_gb(*args)
    assert TE.parse_config_string("4-8-8") == JE.parse_config_string("4-8-8")
    for bad in ("4-8", "a-b-c"):
        with pytest.raises(ValueError):
            TE.parse_config_string(bad)
    assert TE.validate_bits_supported((4, 8), {"W": 4}) == 4
    with pytest.raises(ValueError, match="not in supported"):
        TE.validate_bits_supported((4, 8), {"W": 6})
    with pytest.raises(ValueError, match="baseline_config"):
        TE.compression_ratio({"W": 4, "A": 4, "KV": 4}, None)
    assert TE.count_parameters_m(tp) == JE.count_parameters_m(jp)
    mask = jax.tree.map(lambda a: a.ndim >= 3, jp)
    tmask = jax.tree.map(lambda a: bool(a.ndim >= 3), jp)
    assert TE.count_trainable_parameters_m(tp, tmask) == \
        JE.count_trainable_parameters_m(jp, mask) > 0


def _results():
    return {
        "FP16": {"bits": 16, "model_size_gb": 0.25,
                 "zero_shot": {"BoolQ": 61.2, "ARC-e": 40.0, "Average": 50.6},
                 "perplexity": {"WikiText2": 30.1, "WikiText103": 33.3},
                 "few_shot": {"MMLU": {"STEM": 25.0, "Average": 26.0}, "TriviaQA": 5.0}},
        "INT4": {"bits": 4, "model_size_gb": 0.06,
                 "zero_shot": {"BoolQ": 55.0, "HellaSwag": 30.5, "Average": 42.75},
                 "perplexity": {"WikiText2": 41.9}},
        "INT8": {"bits": 8, "zero_shot": None, "perplexity": {"WikiText2": 30.4}},
    }


@pytest.mark.parametrize("fmt", ["ascii", "markdown"])
def test_tables_and_baseline_match_jax(tmp_path, fmt):
    jg = JE.ResultTableGenerator(_results(), output_dir=str(tmp_path / "j"))
    tg = TE.ResultTableGenerator(_results(), output_dir=str(tmp_path / "t"))
    for name in ("generate_table_1_zero_shot", "generate_table_2_perplexity"):
        assert getattr(tg, name)(fmt) == getattr(jg, name)(fmt)
    assert tg.generate_table_7_few_shot() == jg.generate_table_7_few_shot()
    assert tg.export_to_latex() == jg.export_to_latex()
    files = sorted(p.name for p in (tmp_path / "t").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "j").iterdir())
    for name in files:
        assert (tmp_path / "t" / name).read_text() == (tmp_path / "j" / name).read_text()
    assert TE.ResultTableGenerator({}).generate_table_1_zero_shot() == \
        "No zero-shot results available"
    for base in ("FP16", "INT4", "missing"):
        assert TE.BaselineComparison(base).compare(_results()) == \
            JE.BaselineComparison(base).compare(_results())


def test_squad_metrics_match_jax():
    preds = {"a": "The Eiffel tower!", "b": "", "c": "in Paris, France", "d": "x"}
    refs = {"a": ["eiffel tower"], "b": [], "c": ["Paris", "France"], "e": ["y"]}
    for fn in ("normalize_answer",):
        for s in ("An  apple, the  PEAR.", "a", ""):
            assert getattr(tsq, fn)(s) == getattr(jsq, fn)(s)
    for p_ in preds.values():
        for r in refs.values():
            assert tsq.exact_match_score(p_, r) == jsq.exact_match_score(p_, r)
            assert tsq.f1_score(p_, r) == jsq.f1_score(p_, r)
    assert tsq.evaluate_squad(preds, refs) == jsq.evaluate_squad(preds, refs)
