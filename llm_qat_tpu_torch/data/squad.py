"""SQuAD v1.1/v2.0 dataset preprocessing (framework-free).

Counterpart of `llm_qat_tpu/data/squad.py`, window for window and span for
span:
- input packing `question <eos> context_chunk <eos>` padded to max_length;
- a sliding window over long contexts by `doc_stride`;
- char-offset → token-span conversion via the offset mapping, (0, 0) when
  the answer is outside the window or the example is unanswerable (v2.0).

The tokenizer is injected and must provide `tokenize_with_offsets(text) ->
(ids, [(char_start, char_end)])`; `OffsetByteTokenizer` is the offline
fallback. `load_squad_examples` reads the HF squad sets from the local
cache only when the hub is off (`local_files_only`), and falls back to
`synthetic_squad`.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class OffsetByteTokenizer:
    """Byte-level tokenizer with char offsets (offline testing path)."""

    vocab_size = 258
    eos_token_id = 256
    pad_token_id = 257

    def __call__(self, text: str) -> List[int]:
        return [min(ord(c), 255) for c in text]

    def tokenize_with_offsets(self, text: str):
        ids = [min(ord(c), 255) for c in text]
        offsets = [(i, i + 1) for i in range(len(text))]
        return ids, offsets

    def decode(self, ids: Sequence[int]) -> str:
        return "".join(chr(i) for i in ids if i < 256)


def find_answer_span(answers: Dict, offsets: List[Tuple[int, int]],
                     chunk_start: int, chunk_end: int,
                     context_offset: int) -> Tuple[int, int]:
    """Char span → token span within a window.

    Returns (0, 0) if unanswerable or the answer lies outside the window.
    """
    texts = answers.get("text") or []
    starts = answers.get("answer_start") or []
    if not texts or not starts:
        return 0, 0
    answer_text = texts[0]
    char_start = starts[0]
    char_end = char_start + len(answer_text)

    tok_start = tok_end = None
    for i in range(chunk_start, chunk_end):
        s, e = offsets[i]
        if s <= char_start < e:
            tok_start = i
        if s < char_end <= e:
            tok_end = i
    if tok_start is None or tok_end is None or tok_start > tok_end:
        return 0, 0
    # positions are relative to the packed input sequence
    return (tok_start - chunk_start + context_offset,
            tok_end - chunk_start + context_offset)


def preprocess_squad_examples(examples: Sequence[Dict], tokenizer,
                              max_length: int = 384, doc_stride: int = 128,
                              max_query_length: int = 64) -> List[Dict]:
    """Examples → packed windows."""
    eos = tokenizer.eos_token_id
    pad = tokenizer.pad_token_id
    processed = []
    for ex in examples:
        q_ids = tokenizer(ex["question"])[:max_query_length]
        c_ids, offsets = tokenizer.tokenize_with_offsets(ex["context"])
        max_context = max_length - len(q_ids) - 2
        if max_context <= 0:
            continue
        context_offset = len(q_ids) + 1
        for chunk_start in range(0, max(len(c_ids), 1), doc_stride):
            chunk_end = min(chunk_start + max_context, len(c_ids))
            input_ids = (list(q_ids) + [eos] + list(c_ids[chunk_start:chunk_end])
                         + [eos])
            if len(input_ids) < max_length:
                input_ids = input_ids + [pad] * (max_length - len(input_ids))
            else:
                input_ids = input_ids[:max_length]
            attention_mask = [1 if t != pad else 0 for t in input_ids]
            start_pos, end_pos = find_answer_span(
                ex.get("answers", {}), offsets, chunk_start, chunk_end,
                context_offset,
            )
            processed.append({
                "input_ids": np.asarray(input_ids, np.int32),
                "attention_mask": np.asarray(attention_mask, np.float32),
                "start_positions": start_pos,
                "end_positions": end_pos,
                "example_id": ex.get("id", ""),
                "question_length": len(q_ids) + 1,
            })
            if chunk_end >= len(c_ids):
                break
    return processed


class SQuADDataset:
    """Processed SQuAD windows with batching (numpy arrays; the shuffle is
    `np.random.default_rng(seed)`'s, as in JAX)."""

    def __init__(self, examples: Sequence[Dict], tokenizer,
                 max_length: int = 384, doc_stride: int = 128,
                 max_query_length: int = 64):
        self.tokenizer = tokenizer
        self.features = preprocess_squad_examples(
            examples, tokenizer, max_length, doc_stride, max_query_length
        )

    def __len__(self):
        return len(self.features)

    def __getitem__(self, i):
        return self.features[i]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.arange(len(self.features))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        end = len(idx) - (len(idx) % batch_size) if drop_last else len(idx)
        for i in range(0, end, batch_size):
            feats = [self.features[j] for j in idx[i : i + batch_size]]
            yield {
                "input_ids": np.stack([f["input_ids"] for f in feats]),
                "attention_mask": np.stack([f["attention_mask"] for f in feats]),
                "start_positions": np.asarray(
                    [f["start_positions"] for f in feats], np.int32
                ),
                "end_positions": np.asarray(
                    [f["end_positions"] for f in feats], np.int32
                ),
                "example_ids": [f["example_id"] for f in feats],
                "question_lengths": np.asarray(
                    [f["question_length"] for f in feats], np.int32
                ),
            }


def load_squad_examples(version: str = "v1", split: str = "train",
                        limit: Optional[int] = None) -> List[Dict]:
    """HF squad/squad_v2 loader with synthetic offline fallback."""
    from .lm_datasets import _offline_env_defaults

    offline = _offline_env_defaults()
    try:
        from datasets import DownloadConfig, load_dataset

        name = "squad" if version in ("v1", "v1.1", "squad") else "squad_v2"
        ds = load_dataset(name, split=split,
                          download_config=DownloadConfig(local_files_only=offline))
        out = []
        for i, ex in enumerate(ds):
            if limit and i >= limit:
                break
            out.append({"id": ex["id"], "question": ex["question"],
                        "context": ex["context"], "answers": ex["answers"]})
        return out
    except Exception:
        return synthetic_squad(n=limit or 32, unanswerable=version not in
                               ("v1", "v1.1", "squad"))


def synthetic_squad(n: int = 32, seed: int = 0,
                    unanswerable: bool = False) -> List[Dict]:
    """Deterministic offline SQuAD-format examples."""
    rng = np.random.default_rng(seed)
    subjects = ["the cat", "a dog", "the model", "the chip", "a bird"]
    verbs = ["sat on", "ran to", "computed", "found", "ate"]
    objects = ["the mat", "the hill", "the result", "the answer", "the seed"]
    out = []
    for i in range(n):
        s = subjects[int(rng.integers(len(subjects)))]
        v = verbs[int(rng.integers(len(verbs)))]
        o = objects[int(rng.integers(len(objects)))]
        context = f"Yesterday {s} {v} {o} in the park. Everyone watched."
        if unanswerable and i % 4 == 0:
            answers = {"text": [], "answer_start": []}
        else:
            answers = {"text": [o], "answer_start": [context.index(o)]}
        out.append({
            "id": f"syn-{i}",
            "question": f"What did {s} {v.split()[0]}?",
            "context": context,
            "answers": answers,
        })
    return out
