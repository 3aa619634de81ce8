"""Language-modeling datasets: WikiText chunking + offline fallbacks.

Counterpart of `llm_qat_tpu/data/lm_datasets.py`, a copy of its numpy code
(the port imports nothing of the JAX package), so windows, labels and batch
orders are bit-equal to the JAX package's:
- part1 semantics: WikiText-103 tokenized, chunked into `max_length`
  windows with `doc_stride` overlap, padded, labels = input_ids with -100
  on padding;
- part2 semantics: WikiText-2, non-overlapping full windows only.

The hub may be unreachable, so every loader takes an injectable tokenizer
and falls back to a deterministic synthetic corpus (and `ByteTokenizer`)
when it is: the command lines run offline.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ByteTokenizer:
    """Offline fallback tokenizer: UTF-8 bytes (+special tokens at 256+).

    Not GPT-2 BPE — perplexities are not comparable to hub numbers — but it
    exercises the full pipeline deterministically without network access.
    """

    vocab_size = 258
    eos_token_id = 256
    pad_token_id = 257

    def __call__(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")


def _offline_env_defaults() -> bool:
    """Fail fast instead of hanging on hub retries in zero-egress
    environments; users with network can export HF_HUB_OFFLINE=0.

    Returns whether the hub is off, for the `local_files_only` of a load:
    the hub libraries read these variables once, when they are imported,
    which may have happened before they were set."""
    import os

    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    os.environ.setdefault("HF_DATASETS_OFFLINE", "1")
    return os.environ["HF_HUB_OFFLINE"].strip().lower() in ("1", "true", "yes", "on")


def get_gpt2_tokenizer():
    """GPT-2 BPE tokenizer if available (hub/cache), else ByteTokenizer
    (also when what loads has no vocabulary)."""
    offline = _offline_env_defaults()
    try:
        from transformers import GPT2TokenizerFast

        tok = GPT2TokenizerFast.from_pretrained("gpt2", local_files_only=offline)
        if not tok.vocab_size or tok.eos_token_id is None:
            # without the files some transformers releases hand back an
            # empty tokenizer instead of raising
            raise OSError("GPT-2 tokenizer files not found")

        class _Wrap:
            vocab_size = tok.vocab_size
            eos_token_id = tok.eos_token_id
            pad_token_id = tok.eos_token_id

            def __call__(self, text):
                return tok(text)["input_ids"]

            def decode(self, ids):
                return tok.decode(ids)

        return _Wrap()
    except Exception:
        return ByteTokenizer()


def synthetic_corpus(n_docs: int = 64, seed: int = 0) -> List[str]:
    """Deterministic pseudo-text corpus for offline runs."""
    rng = np.random.default_rng(seed)
    words = [
        "the", "of", "and", "to", "in", "a", "is", "that", "for", "it",
        "model", "precision", "quantization", "tensor", "layer", "training",
        "gradient", "attention", "language", "compute", "memory", "scale",
    ]
    docs = []
    for i in range(n_docs):
        n = int(rng.integers(50, 400))
        docs.append(" ".join(rng.choice(words, n).tolist()) + ".")
    return docs


def synthetic_markov_corpus(n_docs: int = 64, seed: int = 0,
                            vocab_size: int = 128, order: int = 2,
                            branching: int = 8, table_seed: int = 0,
                            doc_len=(80, 240)) -> List[str]:
    """Deterministic order-`order` Markov corpus with real structure.

    The plain `synthetic_corpus` is i.i.d. words over a 22-word vocabulary
    — a 4-layer model saturates it, so capacity-sensitive ablations
    (feature-distillation variants, RPI transfer) show no difference. Here
    each token is
    drawn from a MIXTURE of per-order transition tables: with prob ~0.4
    from an order-1 table (V contexts — quickly learnable, provides the
    gradient on-ramp), else from an order-`order` table (V^order contexts
    x `branching` Zipf successors — pure memorization). A pure order-2
    table has a uniform unigram/bigram marginal BY CONSTRUCTION, so an
    under-capacity model sees zero gradient signal (measured: loss stuck
    at log V); the mixture gives a graded entropy ladder — order-0 ~
    log V, order-1 models capture the on-ramp term, and the remaining
    gap (~0.6 x the order-2 entropy) is pure capacity.

    `table_seed` fixes the transition TABLES; `seed` only drives the doc
    sampling — train/val/held-out splits share tables by construction.
    Words are "w0".."w{V-1}"; tokenize with `WordTokenizer`.
    """
    if order != 2:
        raise ValueError("synthetic_markov_corpus implements order=2")
    V = vocab_size
    tg = np.random.default_rng(table_seed ^ 0xBEEF)
    t2 = tg.integers(0, V, size=(V * V, branching))   # order-2 table
    t1 = tg.integers(0, V, size=(V, branching))       # order-1 on-ramp
    zipf = 1.0 / (1.0 + np.arange(branching)) ** 1.2
    zipf = zipf / zipf.sum()

    rng = np.random.default_rng(seed ^ 0x5EED)
    max_len = int(doc_len[1])
    lens = rng.integers(doc_len[0], doc_len[1] + 1, size=n_docs)
    toks = np.zeros((n_docs, max_len), np.int64)
    toks[:, :2] = rng.integers(0, V, (n_docs, 2))
    # lockstep vectorized generation over all docs
    for t in range(2, max_len):
        use_o1 = rng.random(n_docs) < 0.4
        pick = rng.choice(branching, size=n_docs, p=zipf)
        o1 = t1[toks[:, t - 1], pick]
        o2 = t2[toks[:, t - 2] * V + toks[:, t - 1], pick]
        toks[:, t] = np.where(use_o1, o1, o2)
    words = np.asarray([f"w{i}" for i in range(V)])
    return [" ".join(words[toks[i, :lens[i]]]) for i in range(n_docs)]


class WordTokenizer:
    """Whitespace word-level tokenizer over a fixed vocabulary.

    Built from a corpus (or a vocab size for the synthetic Markov words);
    id 0 is reserved for <pad>/<unk>, the last id is <eos> — mirroring the
    interface of `ByteTokenizer`/the GPT-2 wrapper used elsewhere."""

    def __init__(self, texts=None, vocab_size: int = None):
        if texts is not None:
            seen = {}
            for t in texts:
                for w in t.split():
                    seen.setdefault(w, len(seen))
            self._vocab = {w: i + 1 for w, i in seen.items()}
        else:
            self._vocab = {f"w{i}": i + 1 for i in range(vocab_size)}
        self.vocab_size = len(self._vocab) + 2
        self.pad_token_id = 0
        self.eos_token_id = self.vocab_size - 1
        self._inv = {i: w for w, i in self._vocab.items()}

    def __call__(self, text):
        return [self._vocab.get(w, 0) for w in text.split()]

    def decode(self, ids):
        return " ".join(self._inv.get(int(i), "<unk>") for i in ids)


def load_wikitext(version: str = "wikitext-2-raw-v1", split: str = "train",
                  limit: Optional[int] = None) -> List[str]:
    """WikiText via HF datasets, falling back to the synthetic corpus.

    Reference: part1 uses `wikitext-103-raw-v1` train[:80000]
    (`config_sp.py:44`), part2 uses `wikitext-2-raw-v1`
    (`part2 dataset.py:12-15`), eval uses test/validation splits
    (`part3 perplexity_eval.py:21-27`).
    """
    offline = _offline_env_defaults()
    try:
        from datasets import DownloadConfig, load_dataset

        ds = load_dataset("wikitext", version, split=split,
                          download_config=DownloadConfig(local_files_only=offline))
        texts = [t["text"] for t in ds if t["text"].strip()]
        return texts[:limit] if limit else texts
    except Exception:
        return synthetic_corpus(n_docs=limit or 64,
                                seed=int(hashlib.md5(
                                    f"{version}{split}".encode()
                                ).hexdigest(), 16) % (2**31))


def chunk_tokens(tokens: np.ndarray, max_length: int, doc_stride: int,
                 pad_id: int, drop_partial: bool = False):
    """Split a token stream into windows.

    `drop_partial=False` + stride: part1 semantics (`dataset.py:35-60` —
    overlapping windows, last partial window padded, labels -100 on pads).
    `drop_partial=True` + stride == max_length: part2 semantics
    (`part2 dataset.py:24-34` — non-overlapping full windows only).
    Returns (input_ids (N, max_length), labels (N, max_length)).

    Uses the native C++ kernel (native/fast_data.cpp, built into `build/`
    by `data/native.py`) when available; the Python loop below is the
    reference implementation and the fallback without `g++`.
    """
    tokens = np.asarray(tokens, np.int32)
    from . import native as _native

    nat = _native.chunk_tokens_native(tokens, max_length, doc_stride, pad_id,
                                      drop_partial)
    if nat is not None:
        return nat
    ids_rows, label_rows = [], []
    step = doc_stride if doc_stride > 0 else max_length
    for start in range(0, max(len(tokens) - 1, 0), step):
        window = tokens[start : start + max_length]
        if len(window) < 2:
            break
        if len(window) < max_length:
            if drop_partial:
                break
            ids = np.full((max_length,), pad_id, np.int32)
            ids[: len(window)] = window
            labels = np.full((max_length,), -100, np.int32)
            labels[: len(window)] = window
        else:
            ids = window.copy()
            labels = window.copy()
        ids_rows.append(ids)
        label_rows.append(labels)
        if start + max_length >= len(tokens):
            break
    if not ids_rows:
        return (np.zeros((0, max_length), np.int32),
                np.zeros((0, max_length), np.int32))
    return np.stack(ids_rows), np.stack(label_rows)


class LMDataset:
    """Tokenized + chunked LM dataset with batch iteration.

    Mirrors `create_dataloaders` (part1 `dataset.py:83-141`): tokenize the
    corpus, concatenate, chunk with stride, batch with labels.
    """

    def __init__(self, texts: Sequence[str], tokenizer, max_length: int = 256,
                 doc_stride: int = 128, drop_partial: bool = False):
        self.tokenizer = tokenizer
        stream: List[int] = []
        eos = getattr(tokenizer, "eos_token_id", None)
        for t in texts:
            if not t.strip():
                continue
            stream.extend(tokenizer(t))
            if eos is not None:
                stream.append(eos)
        pad = getattr(tokenizer, "pad_token_id", 0) or 0
        self.input_ids, self.labels = chunk_tokens(
            np.asarray(stream, np.int32), max_length, doc_stride, pad,
            drop_partial,
        )

    def __len__(self):
        return len(self.input_ids)

    def batches(self, batch_size: int, shuffle: bool = False,
                seed: int = 0, drop_last: bool = True
                ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = np.arange(len(self.input_ids))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(0, end, batch_size):
            j = idx[i : i + batch_size]
            yield self.input_ids[j], self.labels[j]


def create_dataloaders(tokenizer=None, train_texts=None, val_texts=None,
                       max_length: int = 256, doc_stride: int = 128,
                       dataset: str = "wikitext-103-raw-v1",
                       train_limit: int = 80000, val_limit: int = 5000):
    """Build (train_ds, val_ds) like the reference `create_dataloaders`
    (part1 `dataset.py:83-141`; splits from `config_sp.py:44-45`)."""
    tokenizer = tokenizer or get_gpt2_tokenizer()
    if train_texts is None:
        train_texts = load_wikitext(dataset, "train", train_limit)
    if val_texts is None:
        val_texts = load_wikitext(dataset, "validation", val_limit)
    train = LMDataset(train_texts, tokenizer, max_length, doc_stride)
    val = LMDataset(val_texts, tokenizer, max_length, doc_stride)
    return train, val
