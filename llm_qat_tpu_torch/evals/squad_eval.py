"""SQuAD answer extraction and end-to-end evaluation.

Counterpart of `llm_qat_tpu/evals/squad_eval.py`:
- `extract_answer` (numpy): the best span over the top-N start × top-N end
  logits with start <= end, length <= max_answer_length and, given a
  question length, no start inside the question; score = start_logit +
  end_logit; the N × N outer sum masked to -inf, one argmax;
- `evaluate_squad_model`: runs the QA logits function over the dataset's
  windows (as tensors on `device`, the card unless the caller asks for the
  CPU), keeps each example's highest-scoring span across its windows, and
  scores the predictions with the official EM/F1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .squad_metrics import evaluate_squad


def extract_answer(start_logits, end_logits, input_ids, tokenizer,
                   max_answer_length: int = 30, n_best_size: int = 20,
                   question_length: Optional[int] = None) -> Dict:
    """Best valid span of one window."""
    start_logits = np.asarray(start_logits)
    end_logits = np.asarray(end_logits)
    seq_len = start_logits.shape[0]
    n = min(n_best_size, seq_len)

    s_idx = np.argsort(start_logits)[::-1][:n]
    e_idx = np.argsort(end_logits)[::-1][:n]

    s_pos = s_idx[:, None]  # (n, 1)
    e_pos = e_idx[None, :]  # (1, n)
    scores = start_logits[s_idx][:, None] + end_logits[e_idx][None, :]

    valid = e_pos >= s_pos
    valid &= (e_pos - s_pos + 1) <= max_answer_length
    if question_length:
        valid &= s_pos >= question_length
    scores = np.where(valid, scores, -np.inf)

    if not np.isfinite(scores).any():
        best_start = best_end = 0
        best_score = float("-inf")
    else:
        flat = int(np.argmax(scores))
        best_start = int(s_idx[flat // n])
        best_end = int(e_idx[flat % n])
        best_score = float(scores.flat[flat])

    ids = np.asarray(input_ids)[best_start : best_end + 1]
    text = tokenizer.decode(ids)
    return {"text": text.strip(), "start": best_start, "end": best_end,
            "score": best_score}


def evaluate_squad_model(qa_logits_fn: Callable, dataset, tokenizer,
                         references: Dict[str, List[str]],
                         batch_size: int = 8, max_answer_length: int = 30,
                         n_best_size: int = 20, device=None) -> Dict[str, float]:
    """End-to-end EM/F1.

    `qa_logits_fn(input_ids, attention_mask) -> (start_logits, end_logits)`
    takes int64 / float32 tensors on `device` and returns tensors.
    Multiple windows of one example keep the highest-scoring span.
    """
    dev = resolve_device(device)
    best: Dict[str, Dict] = {}
    for batch in dataset.batches(batch_size, drop_last=False):
        with torch.no_grad():
            s_logits, e_logits = qa_logits_fn(
                torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev),
                torch.as_tensor(batch["attention_mask"], device=dev),
            )
        s_logits = s_logits.float().cpu().numpy()
        e_logits = e_logits.float().cpu().numpy()
        for i, ex_id in enumerate(batch["example_ids"]):
            ans = extract_answer(
                s_logits[i], e_logits[i], batch["input_ids"][i], tokenizer,
                max_answer_length, n_best_size,
                question_length=int(batch["question_lengths"][i]),
            )
            if ex_id not in best or ans["score"] > best[ex_id]["score"]:
                best[ex_id] = ans
    predictions = {ex_id: a["text"] for ex_id, a in best.items()}
    return evaluate_squad(predictions, references)
