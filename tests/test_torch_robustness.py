"""PyTorch port: the robustness modules (`llm_qat_tpu_torch/robustness/`)
against the JAX package's, on the CPU: the precision draws and switch
statistics for one seed, `token_level_metrics`, `DefenseEvaluator` over the
SP forward of both packages on one calibrated tiny model, the greedy
attacks, `AttackEvaluator` and `run_rpi_evaluation` through one shared
deterministic toy victim, the gradient word importance, and the WordNet and
BERT providers through stand-in `nltk` / `transformers` modules.

Every test runs under stand-ins for `transformers`, `datasets` and `nltk`
whose loads fail as offline loads do, so no load reaches the hub and no
local WordNet corpus changes which provider either package takes."""

import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
import llm_qat_tpu.robustness as JR
from llm_qat_tpu.robustness import attacks as jattacks
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch import robustness as TR
from llm_qat_tpu_torch.data import ByteTokenizer
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models.sp_model import prec_tables, sp_forward
from llm_qat_tpu_torch.robustness import attacks as tattacks

BITS = (4, 8, 32)
# `DefenseEvaluator` over both packages' SP forwards: perplexity and average
# loss within METRIC_RTOL relative (float32 sums in another order; the
# 8-bit slot is log-kind, where XLA's and PyTorch's log2 may differ by an
# ulp and move an activation code), accuracy within one token of the
# samples' total
METRIC_RTOL = 1e-5
# the gradient word importance (float32 backward through both packages'
# STEs and attention), relative to the largest score
IMPORTANCE_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (restored
    after the module): pytest-xdist runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _missing_wordnet():
    """An `nltk` whose WordNet corpus is not installed, as here."""
    def synsets(word):
        raise LookupError("Resource wordnet not found.")

    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = types.SimpleNamespace(synsets=synsets)
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    return nltk, corpus


@pytest.fixture(autouse=True)
def no_hub(monkeypatch):
    """Stand-ins for `transformers`, `datasets` and `nltk` whose loads fail
    as offline loads do. Records each load's keyword arguments."""
    calls = []

    def fail(*a, **k):
        calls.append(k)
        raise OSError("offline")

    loader = types.SimpleNamespace(from_pretrained=fail)
    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2TokenizerFast=loader, BertTokenizer=loader, BertForMaskedLM=loader))
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=fail, DownloadConfig=lambda **k: k))
    nltk, corpus = _missing_wordnet()
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)
    return calls


def test_robustness_exports_the_jax_names():
    assert TR.__all__ == JR.__all__
    for name in TR.__all__:
        assert hasattr(TR, name)


# ---------------------------------------------------------------------------
# Precision switching and token metrics
# ---------------------------------------------------------------------------


def _recording_forward(calls, V=8):
    def forward_fn(ids, prec):
        calls.append((tuple(np.asarray(ids).shape), int(prec)))
        return {"logits": np.zeros(np.asarray(ids).shape + (V,), np.float32)}
    return forward_fn


@pytest.mark.parametrize("p,seed", [(0.3, 0), (0.7, 11), (1.0, 3), (0.0, 5)])
def test_switch_history_and_statistics_match_jax(p, seed):
    """One seed gives the same precision history, statistics and forward
    calls in both packages (Python's `random.Random` in both)."""
    bits, idx = [8, 32, 4], {4: 0, 8: 1, 32: 2}
    jcalls, tcalls = [], []
    js = JR.SimplifiedRandomSwitching(_recording_forward(jcalls), bits, idx, p, seed)

    def tforward(ids, prec):
        assert ids.dtype == torch.int64 and ids.device.type == "cpu"
        assert isinstance(prec, int)
        return _recording_forward(tcalls)(ids.numpy(), prec)

    ts = TR.SimplifiedRandomSwitching(tforward, bits, idx, p, seed, device="cpu")
    ids = np.arange(12, dtype=np.int32).reshape(2, 6)
    for i in range(40):
        _, jp = js.forward_with_switching(ids)
        _, tp = ts.forward_with_switching(ids)
        assert jp == tp
        if i % 10 == 0:
            js.forward_without_switching(ids, 4)
            ts.forward_without_switching(ids, 4)
    assert ts.precision_history == js.precision_history
    assert ts.get_statistics() == js.get_statistics()
    assert tcalls == jcalls
    empty = TR.SimplifiedRandomSwitching(tforward, bits, idx, p, seed, device="cpu")
    assert empty.get_statistics() == JR.SimplifiedRandomSwitching(
        tforward, bits, idx, p, seed).get_statistics()


def _logits_and_labels(seed, B, T, V, masked_share, ties=False):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 3, (B, T, V)).astype(np.float32)
    if ties:  # coarse values: rows with several equal maxima
        logits = np.round(logits / 2).astype(np.float32)
    labels = rng.integers(0, V, (B, T))
    labels[rng.random((B, T)) < masked_share] = -100
    return logits, labels


@pytest.mark.parametrize("seed,B,T,V,masked,ties", [
    (0, 1, 9, 37, 0.3, False), (1, 3, 17, 256, 0.1, False), (2, 2, 33, 50, 0.5, True),
    (3, 1, 64, 1000, 0.0, False), (4, 2, 5, 11, 1.0, False)])
def test_token_level_metrics_match_jax(seed, B, T, V, masked, ties):
    """n and correct exact, the loss sum within 1e-6 relative, -100
    masked; the port computes on the logits' device and returns host
    scalars."""
    logits, labels = _logits_and_labels(seed, B, T, V, masked, ties)
    want = JR.token_level_metrics(logits, labels)
    got = TR.token_level_metrics(torch.from_numpy(logits), torch.from_numpy(labels))
    assert type(got[0]) is float and type(got[1]) is int and type(got[2]) is int
    assert got[1:] == want[1:]
    assert got[0] == pytest.approx(want[0], rel=1e-6, abs=0.0)
    if masked == 1.0:
        assert got == (0.0, 0, 0)
    # numpy labels, as callers pass them, give the same
    assert TR.token_level_metrics(torch.from_numpy(logits), labels) == got


@pytest.fixture(scope="module")
def tiny():
    """A calibrated tiny model (bits 4/8/32, per-channel), LoRA-B drawn:
    (JAX cfg, JAX params, port cfg, port params)."""
    jcfg = J.tiny_test_config(BITS)
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(4), jcfg))
    rng = np.random.default_rng(4)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    p = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    p = jcm.calibrate_input_quantizers(
        p, jcfg, [jnp.asarray(rng.integers(0, 256, (2, 32))) for _ in range(2)])
    p = jax.tree.map(np.asarray, p)
    return jcfg, p, tc.tiny_test_config(BITS), bridge.params_from_numpy(p, "cpu")


def _forwards(tiny):
    jcfg, jp, tcfg, tp = tiny
    jtables = J.prec_tables(jcfg.quant)
    jparams = jax.tree.map(jnp.asarray, jp)
    jfwd = jax.jit(lambda ids, prec: {"logits": J.sp_forward(
        jparams, ids, prec, jcfg, tables=jtables)["logits"]})
    ttables = prec_tables(tcfg.quant, "cpu")

    def tfwd(ids, prec):
        with torch.no_grad():
            return {"logits": sp_forward(tp, ids, prec, tcfg, tables=ttables)["logits"]}
    return jfwd, tfwd


def _samples():
    rng = np.random.default_rng(9)
    out = []
    for B, T in ((1, 32), (2, 24), (1, 48)):
        ids = rng.integers(0, 256, (B, T))
        labels = ids.copy()
        labels[:, -3:] = -100
        out.append({"input_ids": ids, "labels": labels})
    out.append({"input_ids": rng.integers(0, 256, (40,))})  # 1-D, labels = ids
    return out


def test_defense_evaluator_matches_jax_over_the_sp_forward(tiny):
    """Fixed precision at every width and switched at p = 0.5 (seed 2),
    over both packages' SP forward on the same calibrated parameters."""
    jfwd, tfwd = _forwards(tiny)
    idx = {b: i for i, b in enumerate(BITS)}
    je = JR.DefenseEvaluator(jfwd, list(BITS), idx)
    te = TR.DefenseEvaluator(tfwd, list(BITS), idx, device="cpu")
    samples = _samples()
    for bits in BITS:
        want = je.evaluate_fixed_precision(samples, bits)
        got = te.evaluate_fixed_precision(samples, bits)
        n = want["total_tokens"]
        assert got["total_tokens"] == n and got["precision"] == bits
        for k in ("perplexity", "avg_loss"):
            assert got[k] == pytest.approx(want[k], rel=METRIC_RTOL), (bits, k)
        assert abs(got["accuracy"] - want["accuracy"]) <= 1 / n, bits
    want = je.evaluate_with_switching(samples, 0.5, seed=2)
    got = te.evaluate_with_switching(samples, 0.5, seed=2)
    assert got["statistics"] == want["statistics"]
    assert got["perplexity"] == pytest.approx(want["perplexity"], rel=METRIC_RTOL)
    assert abs(got["accuracy"] - want["accuracy"]) <= 1 / n


def test_defense_success_rate_matches_jax():
    for args in ((0.5, 0.1, 0.3), (0.5, 0.1, 0.12), (0.3, 0.3, 0.5), (0.4, 0.6, 0.2),
                 (0.5, 0.1, 0.16, 0.15), (0.9, 0.2, 0.8, 0.9)):
        assert TR.defense_success_rate(*args) == JR.defense_success_rate(*args)


# ---------------------------------------------------------------------------
# Attacks through one deterministic toy victim
# ---------------------------------------------------------------------------


class ToyVictim:
    """Deterministic toy LM shared by both packages' attacks: the loss
    grows with rarer words (a word's byte sum), the accuracy falls with
    them; the embedding is a bag of byte buckets (no Python `hash`, which
    varies between processes)."""

    BAD = {"feline", "canine", "sprint", "large", "huge", "network", "rounding",
           "storage", "thing", "place", "kind", "array"}

    def metrics(self, text):
        words = text.split()
        bad = sum(1 for w in words if w.lower() in self.BAD)
        spread = sum(sum(w.encode()) % 7 for w in words) / (10.0 * max(len(words), 1))
        return 1.0 + 0.5 * bad + spread, max(0.0, 0.8 - 0.2 * bad)

    def embed(self, text):
        v = np.zeros(16)
        for w in text.split():
            v[sum(w.encode()) % 16] += 1
        return v

    def importance(self, words):
        return [float(len(w) % 5) + 0.1 * i for i, w in enumerate(words)]


TEXTS = ["the big cat can run", "a small dog sat by the old house",
         "the model layer scale and the memory precision", "hello world today",
         "single", "the big cat and the big dog run fast",
         "training the language model with attention to quantization"]


def _proposer():
    class Proposer:
        def propose(self, words, idx, k=8):
            return ["feline", "canine", "thing", "place", words[idx]][:k]
    return Proposer()


@pytest.mark.parametrize("kind", ["textfooler", "textfooler_embed", "textfooler_importance",
                                  "bert_static", "bert_custom_embed"])
def test_greedy_attacks_and_evaluator_match_jax(kind):
    """The same adversarial texts, counts and scores from both packages'
    attacks and `AttackEvaluator` on one toy victim."""
    v = ToyVictim()

    def build(mod):
        if kind.startswith("textfooler"):
            return mod.TextFoolerAttack(
                v.metrics, embed_fn=v.embed if kind == "textfooler_embed" else None,
                synonyms=mod.StaticSynonyms(), sim_threshold=0.5,
                importance_fn=v.importance if kind == "textfooler_importance" else None)
        return mod.BERTAttack(v.metrics, embed_fn=v.embed if "embed" in kind else None,
                              proposer=(mod.StaticMLMProposer() if kind == "bert_static"
                                        else _proposer()), top_k=4)

    jatk, tatk = build(JR), build(TR)
    for text in TEXTS:
        assert tatk.generate_adversarial(text) == jatk.generate_adversarial(text)
    assert (tatk.generate_adversarial(TEXTS[5], max_perturb_ratio=0.1)
            == jatk.generate_adversarial(TEXTS[5], max_perturb_ratio=0.1))
    assert (TR.AttackEvaluator(build(TR)).evaluate(TEXTS, max_samples=6)
            == JR.AttackEvaluator(build(JR)).evaluate(TEXTS, max_samples=6))


def test_run_rpi_evaluation_matches_jax():
    v = ToyVictim()

    def switched(text, p, seed):
        loss, acc = v.metrics(text)
        return loss, min(0.8, acc + 0.3 * p + 0.01 * (seed % 3))

    def attacks(mod):
        return {"TextFooler": mod.TextFoolerAttack(v.metrics, v.embed,
                                                   synonyms=mod.StaticSynonyms()),
                "BERT-Attack": mod.BERTAttack(v.metrics, v.embed, proposer=_proposer())}

    texts = [t for t in TEXTS if len(t.split()) >= 2] + ["  "]
    for probs, n in (((0.0, 0.3, 0.5, 0.7), 30), ((0.7, 0.3), 4), ((0.5,), 1)):
        want = JR.run_rpi_evaluation(v.metrics, switched, attacks(JR), texts,
                                     switch_probs=probs, max_samples=n)
        got = TR.run_rpi_evaluation(v.metrics, switched, attacks(TR), texts,
                                    switch_probs=probs, max_samples=n)
        assert got == want
    # a one-word text: the attack's early return has no accuracies, and the
    # report's mean over them raises in both packages (run_rpi keeps texts
    # of five words or more)
    for mod in (JR, TR):
        with pytest.raises(KeyError, match="orig_accuracy"):
            mod.run_rpi_evaluation(v.metrics, switched, attacks(mod), ["single"])


# ---------------------------------------------------------------------------
# Gradient word importance
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec_idx,n_words", [(0, 9), (2, 9), (1, 40)])
def test_gradient_importance_matches_jax(tiny, prec_idx, n_words):
    """Per-word mean gradient norms of the LM loss at `inputs_embeds`; the
    40-word text passes `n_positions` (64), whose words past the cut score
    0 in both."""
    jcfg, jp, tcfg, tp = tiny
    words = ("the model layer scale and the memory precision of attention training "
             "gradient tensor compute language quantization big small cat").split()
    words = (words * 3)[:n_words]
    want = jattacks.make_gradient_importance_fn(
        jax.tree.map(jnp.asarray, jp), jcfg, ByteTokenizer(), prec_idx=prec_idx)(words)
    got = tattacks.make_gradient_importance_fn(tp, tcfg, ByteTokenizer(),
                                               prec_idx=prec_idx)(words)
    assert len(got) == len(want) == n_words
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=IMPORTANCE_RTOL * max(abs(x) for x in want))
    assert [g == 0.0 for g in got] == [w == 0.0 for w in want]
    if n_words == 40:
        assert got[-1] == 0.0
    assert tattacks.make_gradient_importance_fn(tp, tcfg, ByteTokenizer())(["a"]) == [0.0]


# ---------------------------------------------------------------------------
# WordNet and BERT providers
# ---------------------------------------------------------------------------


def test_offline_providers_are_the_static_ones(no_hub):
    """Without WordNet's corpus and BERT's files both packages take the
    static providers; the port's BERT load asks for local files only."""
    for mod in (jattacks, tattacks):
        assert type(mod.make_synonym_provider()).__name__ == "StaticSynonyms"
    assert isinstance(jattacks.make_mlm_proposer(), jattacks.StaticMLMProposer)
    no_hub.clear()
    assert isinstance(tattacks.make_mlm_proposer(), tattacks.StaticMLMProposer)
    assert no_hub == [{"local_files_only": True}]
    assert tattacks.StaticSynonyms.TABLE == jattacks.StaticSynonyms.TABLE
    assert tattacks.StaticMLMProposer.COMMON == jattacks.StaticMLMProposer.COMMON
    for words, idx, k in ((["the", "big", "cat"], 1, 8), (["The", "way"], 0, 3),
                          (["x"], 0, 20)):
        assert (tattacks.StaticMLMProposer().propose(words, idx, k)
                == jattacks.StaticMLMProposer().propose(words, idx, k))
    for w in ("big", "Model", "absent", "run"):
        for n in (1, 2, 10):
            assert (tattacks.StaticSynonyms().get_synonyms(w, n)
                    == jattacks.StaticSynonyms().get_synonyms(w, n))


def test_wordnet_synonyms_match_jax(monkeypatch):
    """Through one stand-in WordNet: the same synonyms, de-duplicated and
    cut at `max_candidates`."""
    table = {
        "big": [["big", "large"], ["bad", "big", "large", "great_big"], ["boastful"]],
        "run": [["run", "tally"], ["run", "go_for", "test"], ["running", "Run"]],
        "test": [["test", "trial"]],
    }

    class Lemma:
        def __init__(self, n):
            self._n = n

        def name(self):
            return self._n

    class Synset:
        def __init__(self, names):
            self._l = [Lemma(n) for n in names]

        def lemmas(self):
            return self._l

    corpus = types.ModuleType("nltk.corpus")
    corpus.wordnet = types.SimpleNamespace(
        synsets=lambda w: [Synset(s) for s in table.get(w, [])])
    nltk = types.ModuleType("nltk")
    nltk.corpus = corpus
    monkeypatch.setitem(sys.modules, "nltk", nltk)
    monkeypatch.setitem(sys.modules, "nltk.corpus", corpus)
    jw, tw = jattacks.make_synonym_provider(), tattacks.make_synonym_provider()
    assert type(jw).__name__ == type(tw).__name__ == "WordNetSynonyms"
    for w in ("big", "run", "absent", "test"):
        for n in (1, 2, 3, 10):
            assert tw.get_synonyms(w, n) == jw.get_synonyms(w, n)
    assert tw.get_synonyms("big") == ["large", "bad", "great big", "boastful"]


BERT_TEXTS = ["the big cat can run", "a small dog sat by the old house",
              "model layer scale memory precision thing place way"]


def _stand_in_bert(calls):
    """A `transformers` with a word-level BertTokenizer and a deterministic
    masked LM (logits from a seeded table over the token and its left
    neighbour)."""
    vocab = ["[PAD]", "[CLS]", "[SEP]", "[MASK]"] + sorted(
        {w for ws in BERT_TEXTS for w in ws.split()})

    class Tokenizer:
        mask_token, mask_token_id = "[MASK]", 3

        def __call__(self, text, return_tensors=None, truncation=False, max_length=None):
            assert return_tensors == "pt"
            ids = [1] + [vocab.index(w) if w in vocab else 0 for w in text.split()] + [2]
            ids = ids[:max_length] if truncation else ids
            return {"input_ids": torch.tensor([ids]),
                    "attention_mask": torch.ones((1, len(ids)), dtype=torch.int64)}

        def decode(self, ids):
            return f" {vocab[ids[0]]} "

    class Model:
        table = torch.randn((len(vocab), len(vocab)), generator=torch.Generator().manual_seed(0))

        def eval(self):
            return self

        def to(self, device):
            calls.append({"to": str(device)})
            return self

        def __call__(self, input_ids, attention_mask=None):
            return types.SimpleNamespace(
                logits=self.table[input_ids] + 0.5 * self.table[input_ids.roll(1, -1)])

    def loader(obj):
        def from_pretrained(name, **k):
            calls.append({"name": name, **k})
            return obj
        return types.SimpleNamespace(from_pretrained=from_pretrained)

    return types.SimpleNamespace(BertTokenizer=loader(Tokenizer()),
                                 BertForMaskedLM=loader(Model()))


def test_bert_proposer_matches_jax(monkeypatch):
    """Through one stand-in masked LM: the same proposals; the port loads
    with `local_files_only` while the hub is off, and keeps the model on
    the device it was given (the CPU by default)."""
    calls = []
    monkeypatch.setitem(sys.modules, "transformers", _stand_in_bert(calls))
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    jp = jattacks.make_mlm_proposer()
    assert isinstance(jp, jattacks.BertMLMProposer)
    assert calls == [{"name": "bert-base-uncased"}] * 2
    calls.clear()
    tp = tattacks.make_mlm_proposer()
    assert isinstance(tp, tattacks.BertMLMProposer) and tp.device == torch.device("cpu")
    assert calls == [{"name": "bert-base-uncased", "local_files_only": True}] * 2 + [
        {"to": "cpu"}]
    for text in BERT_TEXTS:
        words = text.split()
        for idx in range(len(words)):
            for k in (1, 4, 8):
                assert tp.propose(words, idx, k) == jp.propose(words, idx, k)
    # with the hub on, the load may ask it
    monkeypatch.setenv("HF_HUB_OFFLINE", "0")
    calls.clear()
    tattacks.BertMLMProposer()
    assert calls[0] == {"name": "bert-base-uncased", "local_files_only": False}
