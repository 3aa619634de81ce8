"""PyTorch port: the RPI command line `run_rpi --tiny --num-samples 2`
against the JAX package's, on the CPU, offline (stand-ins for
`transformers`, `datasets` and `nltk` whose loads fail: the byte
tokenizer, the synthetic corpus, the static synonym table and MLM
stand-in in both packages).

Both commands read one calibrated tiny checkpoint written by the JAX
package's `save_checkpoint` through `--model-path`, so they attack the same
parameters. Each text of the offline corpus is cut to its first WORDS words
in both packages (the attacks score every word, so the full 271-word first
text would take some 3,700 forwards of the port's eager tiny forward, about
80 s); the cut texts still pass the tiny model's 64 positions, so words
past the cut score an importance of exactly 0 in both.

Every forward's token metrics are recorded in call order. The two runs must
make the same calls, with losses within LOSS_RTOL, except after a near-tie
(two scores within NEAR_TIE of each other, where float32 rounding may pick
either): the test names each such divergence, and none is expected at
these inputs. The adversarial texts must then be equal, the accuracies
within ACC_TOL and the switch-derived report entries equal."""

import json
import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.data as jdata
import llm_qat_tpu.deploy as JD
import llm_qat_tpu.models as J
from llm_qat_tpu.cli import run_rpi as jrun
from llm_qat_tpu.robustness import defense_eval as jdefense
from llm_qat_tpu.robustness import random_switching as jswitch
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch.cli import run_rpi as trun
from llm_qat_tpu_torch.robustness import defense_eval as tdefense

WORDS = 30
ARGS = ["--tiny", "--num-samples", "2"]
# a forward's mean loss, port against JAX on the same ids (float32 sums in
# another order; measured: at most 3.1e-7 over the run's 697 forwards)
LOSS_RTOL = 1e-5
# two scores closer than this (relative) are a near-tie
NEAR_TIE = 1e-5
# an accuracy (a mean over texts of each text's share of correct tokens):
# within one token of a 64-token text
ACC_TOL = 1 / 63
# the tied head's preference for the space and 'e' bytes (`_checkpoint`):
# clean accuracies of 0.16 and 0.14 on the two texts, and BERT-Attack
# lowers both below 0.1
BIAS_SPACE, BIAS_E = 0.1, 0.05


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (restored
    after the module): pytest-xdist runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _offline(m):
    """Stand-ins for `transformers`, `datasets` and `nltk` (no WordNet
    corpus) whose loads fail as offline loads do; each package's corpus cut
    to WORDS words a text."""
    def fail(*a, **k):
        raise OSError("offline")

    def no_corpus(word):
        raise LookupError("Resource wordnet not found.")

    loader = types.SimpleNamespace(from_pretrained=fail)
    m.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2TokenizerFast=loader, BertTokenizer=loader, BertForMaskedLM=loader))
    m.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=fail, DownloadConfig=lambda **k: k))
    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = types.SimpleNamespace(synsets=no_corpus)
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    m.setitem(sys.modules, "nltk", nltk)
    m.setitem(sys.modules, "nltk.corpus", corpus)
    for mod in (jdata, trun):
        m.setattr(mod, "load_wikitext", lambda *a, f=mod.load_wikitext, **k: [
            " ".join(t.split()[:WORDS]) for t in f(*a, **k)])


def _record(m, mod, name, calls):
    """Wraps mod.name (a token-metrics function) to record (ids, mean loss,
    accuracy) of each call."""
    inner = getattr(mod, name)

    def wrapped(logits, labels):
        out = inner(logits, labels)
        ids = tuple(int(i) for i in np.asarray(labels).reshape(-1))
        calls.append((ids, out[0] / max(out[2], 1), out[1] / max(out[2], 1)))
        return out
    m.setattr(mod, name, wrapped)


def _record_attacks(m, mod, results):
    cls = mod.AttackEvaluator

    class Recording(cls):
        def evaluate(self, texts, max_samples=30):
            res = super().evaluate(texts, max_samples)
            results.append(res)
            return res
    m.setattr(mod, "AttackEvaluator", Recording)


def _checkpoint(path):
    """A calibrated tiny model (bits 4/8/32) saved by the JAX package."""
    cfg = J.tiny_test_config((4, 8, 32))
    p = jax.tree.map(np.array, J.init_sp_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    # a preference for the space and 'e' bytes through the tied head (the
    # final LN's bias along their embedding rows), so that a random model
    # predicts some bytes right and an attack can lower its accuracy
    for byte, scale in ((32, BIAS_SPACE), (101, BIAS_E)):
        d = rng.normal(0, 1, p["wte"].shape[1]).astype(np.float32)
        p["wte"][byte] += 0.5 * d
        p["ln_f"]["b"] += scale * d
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), cfg)
    p = jcm.calibrate_input_quantizers(
        p, cfg, [jnp.asarray(rng.integers(0, 256, (2, 32))) for _ in range(2)])
    JD.save_checkpoint(path, p, cfg)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both commands on one JAX checkpoint: {package: (report, report on
    disk, metric calls, attack results)}."""
    tmp = tmp_path_factory.mktemp("run_rpi")
    ckpt = tmp / "sp.npz"
    _checkpoint(ckpt)
    out = {}
    for name, main, kw, metrics_mod, defense_mod in (
            ("jax", jrun.main, {}, jswitch, jdefense),
            ("port", trun.main, {"device": "cpu"}, trun, tdefense)):
        calls, attacks = [], []
        with pytest.MonkeyPatch.context() as m:
            _offline(m)
            _record(m, metrics_mod, "token_level_metrics", calls)
            _record_attacks(m, defense_mod, attacks)
            report = main(ARGS + ["--model-path", str(ckpt),
                                  "--output-dir", str(tmp / name)], **kw)
        with open(tmp / name / "rpi_report.json") as f:
            out[name] = (report, json.load(f), calls, attacks)
    return out


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__


def _divergence(jcalls, tcalls):
    """Index of the first call whose ids differ, or None; the calls before
    it hold losses within LOSS_RTOL."""
    for i, (j, t) in enumerate(zip(jcalls, tcalls)):
        if j[0] != t[0]:
            return i
        assert t[1] == pytest.approx(j[1], rel=LOSS_RTOL), (i, t[1], j[1])
    assert len(jcalls) == len(tcalls)
    return None


def _near_ties(calls):
    """Pairs of distinct inputs among `calls` whose mean losses lie within
    NEAR_TIE of each other."""
    seen = {}
    for ids, loss, _ in calls:
        seen.setdefault(ids, loss)
    items = sorted(seen.items(), key=lambda kv: kv[1])
    return [(a[1], b[1]) for a, b in zip(items, items[1:])
            if abs(a[1] - b[1]) <= NEAR_TIE * abs(b[1])]


def test_run_rpi_tiny_matches_jax(runs):
    jreport, jdisk, jcalls, jattacks = runs["jax"]
    treport, tdisk, tcalls, tattacks = runs["port"]
    assert tdisk == json.loads(json.dumps(treport))
    assert jdisk == json.loads(json.dumps(jreport))
    assert _keys(tdisk) == _keys(jdisk)
    assert set(tdisk["attacks"]) == {"TextFooler", "BERT-Attack"}
    assert set(tdisk["defense"]["TextFooler"]["by_probability"]) == {"0.0", "0.3", "0.5", "0.7"}
    assert len(jcalls) > 300  # both texts attacked word by word
    # the comparison has something to compare: tokens predicted right, and
    # an attack that lowers their share
    assert jdisk["clean"]["accuracy"] > 0.1
    assert jdisk["attacks"]["BERT-Attack"]["n_successful"] == 2

    where = _divergence(jcalls, tcalls)
    if where is not None:
        ties = _near_ties(jcalls[:where])
        pytest.fail(f"the commands diverge at metric call {where} of {len(jcalls)}; "
                    f"near-ties before it: {ties}" if not ties else
                    f"the commands diverge at call {where} after the near-ties {ties}: "
                    f"compare no further")
    for jr, tr in zip(jattacks, tattacks):
        assert [d["adversarial_text"] for d in tr["details"]] == [
            d["adversarial_text"] for d in jr["details"]]
        assert [d["num_changes"] for d in tr["details"]] == [
            d["num_changes"] for d in jr["details"]]
        assert tr["successful_attacks"] == jr["successful_attacks"]

    assert abs(tdisk["clean"]["accuracy"] - jdisk["clean"]["accuracy"]) <= ACC_TOL
    for name in ("TextFooler", "BERT-Attack"):
        assert tdisk["attacks"][name] == jdisk["attacks"][name]
        jd, td = jdisk["defense"][name], tdisk["defense"][name]
        for k in ("orig_accuracy", "adv_accuracy"):
            assert abs(td[k] - jd[k]) <= ACC_TOL, (name, k)
        for p, jp in jd["by_probability"].items():
            tp = td["by_probability"][p]
            assert abs(tp["switched_accuracy"] - jp["switched_accuracy"]) <= ACC_TOL
            assert tp["success"] == jp["success"]
            assert math.isfinite(tp["recovery_ratio"])
        assert td["optimal_p"] == jd["optimal_p"]


def test_run_rpi_default_init_and_device(tmp_path, monkeypatch):
    """Without `--model-path` the port initialises from seed 0 (random and
    uncalibrated, as JAX's PRNGKey(0) init; the numbers differ with the
    generator) and writes the JAX command's report keys; without a card the
    default device raises."""
    seeds = []
    init = trun.init_sp_params

    def recording(gen, cfg, device=None):
        seeds.append((gen.initial_seed(), str(device)))
        return init(gen, cfg, device=device)

    _offline(monkeypatch)
    monkeypatch.setattr(trun, "load_wikitext", lambda *a, **k: [
        "the big model runs the old layer fast today", "tiny"])
    monkeypatch.setattr(trun, "init_sp_params", recording)
    report = trun.main(["--tiny", "--num-samples", "1", "--switch-probs", "0.5",
                        "--output-dir", str(tmp_path)], device="cpu")
    assert seeds == [(0, "cpu")]
    with open(tmp_path / "rpi_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert set(report) == {"clean", "attacks", "defense"}
    for name in ("TextFooler", "BERT-Attack"):
        d = report["defense"][name]
        assert set(d) == {"by_probability", "optimal_p", "orig_accuracy", "adv_accuracy"}
        assert set(d["by_probability"]) == {"0.5"} and d["optimal_p"] == 0.5
        assert 0.0 <= d["by_probability"]["0.5"]["switched_accuracy"] <= 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trun.main(["--tiny", "--output-dir", str(tmp_path)])
