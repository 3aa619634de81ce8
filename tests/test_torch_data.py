"""PyTorch port: the data layer (`llm_qat_tpu_torch/data/`) against the JAX
package's, bit for bit: the offline corpora and tokenizers, `chunk_tokens`
on the native and the Python path, `LMDataset.batches` under shuffle seeds,
and the native library's build, which stays out of `native/`."""

import os
import sys
import types

import numpy as np
import pytest

import llm_qat_tpu.data as J
from llm_qat_tpu.data import native as jnative
import llm_qat_tpu_torch.data as T
from llm_qat_tpu_torch.data import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def no_hub(monkeypatch):
    """Stand-ins for `transformers` and `datasets` whose loads fail as an
    offline load does: a test never asks the hub, whatever the process
    imported before (the hub libraries read HF_HUB_OFFLINE once, at their
    import). Records each load's keyword arguments."""
    calls = []

    def fail(*a, **k):
        calls.append(k)
        raise OSError("offline")

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2TokenizerFast=types.SimpleNamespace(from_pretrained=fail)))
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=fail, DownloadConfig=lambda **k: k))
    return calls


@pytest.mark.parametrize("n_docs,seed", [(64, 0), (16, 1), (5, 12345)])
def test_synthetic_corpus_matches_jax(n_docs, seed):
    assert T.synthetic_corpus(n_docs, seed) == J.synthetic_corpus(n_docs, seed)


@pytest.mark.parametrize("kw", [dict(), dict(n_docs=9, seed=3, vocab_size=40,
                                             branching=4, table_seed=7,
                                             doc_len=(10, 30))])
def test_synthetic_markov_corpus_matches_jax(kw):
    assert T.synthetic_markov_corpus(**kw) == J.synthetic_markov_corpus(**kw)
    with pytest.raises(ValueError):
        T.synthetic_markov_corpus(order=3)


@pytest.mark.parametrize("version,split,limit", [
    ("wikitext-2-raw-v1", "train", 12), ("wikitext-103-raw-v1", "validation", 7)])
def test_load_wikitext_fallback_matches_jax(no_hub, version, split, limit):
    """Offline, both fall back to the same synthetic corpus; the port's load
    asks for local files only."""
    assert T.load_wikitext(version, split, limit) == J.load_wikitext(version, split, limit)
    assert no_hub[0]["download_config"] == {"local_files_only": True}


def test_tokenizers_match_jax(no_hub):
    text = "the model — quantization ü layer\n"
    tb, jb = T.ByteTokenizer(), J.ByteTokenizer()
    assert tb(text) == jb(text)
    assert tb.decode(tb(text) + [256, 257]) == jb.decode(jb(text) + [256, 257])
    assert (tb.vocab_size, tb.eos_token_id, tb.pad_token_id) == (
        jb.vocab_size, jb.eos_token_id, jb.pad_token_id)
    corpus = J.synthetic_markov_corpus(n_docs=4, vocab_size=20)
    for tw, jw in ((T.WordTokenizer(corpus), J.WordTokenizer(corpus)),
                   (T.WordTokenizer(vocab_size=20), J.WordTokenizer(vocab_size=20))):
        assert tw(corpus[0] + " unseen") == jw(corpus[0] + " unseen")
        assert tw.decode(tw(corpus[1])) == jw.decode(jw(corpus[1]))
        assert (tw.vocab_size, tw.eos_token_id, tw.pad_token_id) == (
            jw.vocab_size, jw.eos_token_id, jw.pad_token_id)
    tg, jg = T.get_gpt2_tokenizer(), J.get_gpt2_tokenizer()
    assert type(tg).__name__ == type(jg).__name__ == "ByteTokenizer"
    assert tg(text) == jg(text)
    assert no_hub[0] == {"local_files_only": True}


CHUNK_CASES = [(100, 16, 8, False), (100, 16, 16, False), (100, 16, 16, True),
               (10, 4, 4, False), (3, 8, 8, False), (1, 8, 8, False),
               (257, 32, 13, False), (257, 32, 0, True), (1000, 64, 128, False)]


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("n,ml,stride,drop", CHUNK_CASES)
def test_chunk_tokens_matches_jax(monkeypatch, path, n, ml, stride, drop):
    """Both `drop_partial` modes, several strides, on the port's native
    library and on its Python fallback, against the JAX package's Python
    loop (its own fallback)."""
    if path == "python":
        monkeypatch.setattr(tnative, "chunk_tokens_native", lambda *a, **k: None)
    else:
        assert tnative.is_available()
    monkeypatch.setattr(jnative, "chunk_tokens_native", lambda *a, **k: None)
    tokens = np.random.default_rng(n).integers(0, 300, n).astype(np.int32)
    got = T.chunk_tokens(tokens, ml, stride, 299, drop)
    want = J.chunk_tokens(tokens, ml, stride, 299, drop)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_gather_rows_native():
    data = np.arange(40, dtype=np.int32).reshape(10, 4)
    idx = np.asarray([7, 0, 3, 7], np.int64)
    np.testing.assert_array_equal(tnative.gather_rows_native(data, idx), data[idx])
    with pytest.raises(IndexError):
        tnative.gather_rows_native(data, np.asarray([10], np.int64))


@pytest.mark.parametrize("shuffle,seed,drop_last", [
    (False, 0, True), (True, 0, True), (True, 1, True), (True, 7, False)])
def test_lmdataset_batches_match_jax(shuffle, seed, drop_last):
    """create_dataloaders on the offline corpora as `main_sp --tiny` builds
    them, then every batch of an epoch in order."""
    tok = T.ByteTokenizer()
    tr, tv = T.create_dataloaders(tok, T.synthetic_corpus(64, 0),
                                  T.synthetic_corpus(16, 1), max_length=32)
    jr, jv = J.create_dataloaders(J.ByteTokenizer(), J.synthetic_corpus(64, 0),
                                  J.synthetic_corpus(16, 1), max_length=32)
    for t_ds, j_ds in ((tr, jr), (tv, jv)):
        assert len(t_ds) == len(j_ds)
        np.testing.assert_array_equal(t_ds.input_ids, j_ds.input_ids)
        np.testing.assert_array_equal(t_ds.labels, j_ds.labels)
        tb = list(t_ds.batches(3, shuffle=shuffle, seed=seed, drop_last=drop_last))
        jb = list(j_ds.batches(3, shuffle=shuffle, seed=seed, drop_last=drop_last))
        assert len(tb) == len(jb)
        for (ti, tl), (ji, jl) in zip(tb, jb):
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)


def test_lmdataset_word_tokenizer_drop_partial_matches_jax():
    corpus = J.synthetic_markov_corpus(n_docs=6, vocab_size=30)
    t = T.LMDataset(corpus, T.WordTokenizer(vocab_size=30), 16, 16, drop_partial=True)
    j = J.LMDataset(corpus, J.WordTokenizer(vocab_size=30), 16, 16, drop_partial=True)
    np.testing.assert_array_equal(t.input_ids, j.input_ids)
    np.testing.assert_array_equal(t.labels, j.labels)
    assert (t.labels != -100).all()


def test_native_build_stays_out_of_native_dir():
    """The port builds its library under build/native/ and writes nothing
    under native/ (whose libfastdata.so belongs to the JAX package)."""
    native_dir = os.path.join(ROOT, "native")
    build_dir = os.path.join(ROOT, "build", "native")
    assert os.path.dirname(str(tnative.lib_path())) == build_dir

    def snapshot():
        out = {}
        for name in os.listdir(native_dir):
            if name in ("libfastdata.so", "__pycache__"):
                continue  # the JAX package's own build, which other tests run
            st = os.stat(os.path.join(native_dir, name))
            out[name] = (st.st_size, st.st_mtime_ns)
        return out

    before = snapshot()
    src = open(os.path.join(native_dir, "fast_data.cpp"), "rb").read()
    out = tnative.lib_path().with_name(f"libfastdata-test-{os.getpid()}.so")
    try:
        assert tnative._build(out)
        assert out.exists()
    finally:
        out.unlink(missing_ok=True)
    assert snapshot() == before
    assert open(os.path.join(native_dir, "fast_data.cpp"), "rb").read() == src


@pytest.mark.parametrize("vocab_size,eos,want", [(0, None, "ByteTokenizer"),
                                                 (5, None, "ByteTokenizer"),
                                                 (5, 4, "_Wrap")])
def test_gpt2_tokenizer_without_files_falls_back(monkeypatch, vocab_size, eos, want):
    """A transformers release that, without the tokenizer's files, hands back
    an empty tokenizer instead of raising still gets the byte tokenizer."""

    class Empty:
        eos_token_id = eos

        def __init__(self):
            self.vocab_size = vocab_size

        def __call__(self, text):
            return {"input_ids": [1, 2]}

    calls = []

    def from_pretrained(name, **k):
        calls.append(k)
        return Empty()

    fake = types.SimpleNamespace(GPT2TokenizerFast=types.SimpleNamespace(
        from_pretrained=from_pretrained))
    monkeypatch.setitem(sys.modules, "transformers", fake)
    tok = T.get_gpt2_tokenizer()
    assert calls == [{"local_files_only": True}]
    assert type(tok).__name__ == want
    if want == "ByteTokenizer":
        assert tok("ab") == [97, 98]
