"""Official SQuAD metrics: normalization, EM, F1, corpus scoring.

Re-implements `part5_squad/squad_metrics.py:13-197`: normalization
(lowercase, strip punctuation, remove articles, collapse whitespace), EM =
any-ground-truth exact match, F1 = max token-overlap F1, corpus scoring by
example-id lookup.

Counterpart of `llm_qat_tpu/evals/squad_metrics.py`: pure Python, the same code.
"""

from __future__ import annotations

import re
import string
from collections import Counter
from typing import Dict, List, Sequence


def normalize_answer(s: str) -> str:
    """Reference normalization chain (`squad_metrics.py:13-43`)."""

    def remove_articles(text):
        return re.sub(r"\b(a|an|the)\b", " ", text)

    def white_space_fix(text):
        return " ".join(text.split())

    def remove_punc(text):
        exclude = set(string.punctuation)
        return "".join(ch for ch in text if ch not in exclude)

    return white_space_fix(remove_articles(remove_punc(s.lower())))


def exact_match_score(prediction: str, ground_truths: Sequence[str]) -> float:
    """1.0 if normalized prediction matches any ground truth
    (`squad_metrics.py:46-66`)."""
    p = normalize_answer(prediction)
    return float(any(p == normalize_answer(gt) for gt in ground_truths))


def f1_score(prediction: str, ground_truths: Sequence[str]) -> float:
    """Max token-overlap F1 over ground truths (`squad_metrics.py:69-118`)."""
    pred_tokens = normalize_answer(prediction).split()
    if not pred_tokens:
        return 0.0
    best = 0.0
    for gt in ground_truths:
        gt_tokens = normalize_answer(gt).split()
        if not gt_tokens:
            continue
        common = Counter(pred_tokens) & Counter(gt_tokens)
        n = sum(common.values())
        if n == 0:
            f1 = 0.0
        else:
            precision = n / len(pred_tokens)
            recall = n / len(gt_tokens)
            f1 = 2 * precision * recall / (precision + recall)
        best = max(best, f1)
    return best


def evaluate_squad(predictions: Dict[str, str],
                   references: Dict[str, List[str]]) -> Dict[str, float]:
    """Corpus EM/F1 by id lookup (`squad_metrics.py:121-180`).

    predictions: {example_id: predicted_text};
    references: {example_id: [ground truths]} (empty list = unanswerable —
    correct iff the prediction is empty).
    """
    em_sum = f1_sum = 0.0
    n = 0
    for ex_id, gts in references.items():
        pred = predictions.get(ex_id, "")
        if not gts:  # unanswerable (v2.0)
            score = float(normalize_answer(pred) == "")
            em_sum += score
            f1_sum += score
        else:
            em_sum += exact_match_score(pred, gts)
            f1_sum += f1_score(pred, gts)
        n += 1
    n = max(n, 1)
    return {
        "exact_match": 100.0 * em_sum / n,
        "f1": 100.0 * f1_sum / n,
        "total": n,
    }
