"""Zero-shot likelihood-based multiple-choice evaluation.

Counterpart of `llm_qat_tpu/evals/zero_shot.py`, which re-implements the
reference `ZeroShotEvaluator` (`part3_eval_sp/zero_shot_tasks.py:8-238`):
per example, score each choice by the mean per-token log-prob of the
choice continuation given the context (`zero_shot_tasks.py:158-199`), pick
the argmax. Task formatters for BoolQ (passage truncated to 150 chars,
' True'/' False'), HellaSwag (ctx + endings), WinoGrande (split on '_'),
ARC-e/ARC-c and OBQA (lettered choices) follow `zero_shot_tasks.py:75-156`.
The error-tolerant loop with `max_errors` mirrors `zero_shot_tasks.py:55-69`.

Tokenization is injected (`tokenizer(text) -> list[int]`). The choices of
one example are scored in one padded (n_choices, max_length) batch on the
evaluator's device (the card unless the caller asks for the CPU); a choice
whose span is empty scores -inf.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def format_boolq(example) -> Tuple[str, List[str], int]:
    passage = example["passage"]
    if len(passage) > 150:
        passage = passage[:150] + "..."
    ctx = f"Passage: {passage}\nQuestion: {example['question']}\nAnswer:"
    label = 0 if example["answer"] else 1
    return ctx, [" True", " False"], label


def format_hellaswag(example) -> Tuple[str, List[str], int]:
    ctx = example["ctx"].strip()
    if not ctx.endswith(" "):
        ctx += " "
    return ctx, list(example["endings"]), int(example["label"])


def format_winogrande(example) -> Tuple[str, List[str], int]:
    s = example["sentence"]
    o1, o2 = example["option1"], example["option2"]
    if "_" in s:
        parts = s.split("_")
        if len(parts) == 2:
            ctx, suffix = parts[0], parts[1]
            choices = [o1 + suffix, o2 + suffix]
        else:
            ctx = ""
            choices = [s.replace("_", o1), s.replace("_", o2)]
    else:
        ctx = s + " "
        choices = [o1, o2]
    label = int(example["answer"]) - 1
    return ctx, choices, label


def _format_lettered(question: str, choices, answer_key: str):
    ctx = f"Question: {question}\nAnswer:"
    texts, label = [], -1
    for i, (t, lab) in enumerate(zip(choices["text"], choices["label"])):
        texts.append(f" {lab}. {t}")
        if lab == answer_key:
            label = i
    return ctx, texts, label


def format_arc(example) -> Tuple[str, List[str], int]:
    return _format_lettered(example["question"], example["choices"],
                            example["answerKey"])


def format_obqa(example) -> Tuple[str, List[str], int]:
    return _format_lettered(example["question_stem"], example["choices"],
                            example["answerKey"])


TASK_FORMATTERS = {
    "BoolQ": format_boolq,
    "HellaSwag": format_hellaswag,
    "WinoGrande": format_winogrande,
    "ARC-e": format_arc,
    "ARC-c": format_arc,
    "OBQA": format_obqa,
}


class ZeroShotEvaluator:
    """Likelihood scorer over `logits_fn(ids) -> (B, T, V)`, ids int64 on
    `device`."""

    def __init__(self, logits_fn: Callable, tokenizer: Callable,
                 max_length: int = 256, context_max_tokens: int = 200,
                 max_samples: int = 500, max_errors: int = 10,
                 pad_id: int = 0, device=None):
        self.logits_fn = logits_fn
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.context_max_tokens = context_max_tokens
        self.max_samples = max_samples
        self.max_errors = max_errors
        self.pad_id = pad_id
        self.device = resolve_device(device)

    @torch.no_grad()
    def _choice_scores(self, ids, choice_start, choice_end):
        """Mean log-prob of tokens in (choice_start, choice_end] given the
        prefix (reference `zero_shot_tasks.py:176-195`)."""
        logits = self.logits_fn(ids).to(torch.float32)
        logp = torch.log_softmax(logits, dim=-1)
        T = ids.shape[1]
        pos = torch.arange(T - 1, device=ids.device)[None, :]
        # token at position p+1 predicted from logits at p, for p in
        # [choice_start, choice_end)
        mask = (pos >= choice_start[:, None]) & (pos < choice_end[:, None])
        tok_logp = torch.gather(logp[:, :-1], -1, ids[:, 1:][..., None])[..., 0]
        tot = torch.where(mask, tok_logp, torch.zeros_like(tok_logp)).sum(dim=1)
        n = torch.clamp(mask.sum(dim=1), min=1)
        return tot / n

    def score_choices(self, context: str, choices: List[str]) -> np.ndarray:
        """Each choice's mean log-prob (float32), -inf where its span is
        empty."""
        rows, starts, ends = [], [], []
        for choice in choices:
            if not context or not context.strip():
                full = self.tokenizer(choice)[: self.max_length]
                c_len = 0
            else:
                ctx_tokens = self.tokenizer(context)[: self.context_max_tokens]
                full = self.tokenizer(context + choice)[: self.max_length]
                c_len = len(ctx_tokens)
            ids = np.full((self.max_length,), self.pad_id, np.int64)
            ids[: len(full)] = full
            rows.append(ids)
            starts.append(max(0, c_len - 1))
            ends.append(len(full) - 1)
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        scores = self._choice_scores(as_t(np.stack(rows)), as_t(starts), as_t(ends))
        scores = scores.cpu().numpy()
        # choices whose span is empty get -inf (reference returns -inf)
        for i, (s, e) in enumerate(zip(starts, ends)):
            if not (s < e and e > 0):
                scores[i] = -np.inf
        return scores

    def compute_choice_likelihood(self, context: str, choices: List[str]) -> int:
        """Argmax choice index (reference `_compute_choice_likelihood`)."""
        return int(np.argmax(self.score_choices(context, choices)))

    def evaluate_task(self, task_name: str, dataset) -> float:
        """Accuracy% over a dataset of example dicts
        (reference `evaluate_task`, `zero_shot_tasks.py:40-73`)."""
        if dataset is None:
            return 0.0
        fmt = TASK_FORMATTERS[task_name]
        correct, total, errors = 0.0, 0, 0
        for example in dataset:
            try:
                ctx, choices, label = fmt(example)
                if label < 0:
                    total += 1
                    continue
                pred = self.compute_choice_likelihood(ctx, choices)
                correct += float(pred == label)
                total += 1
            except Exception:
                errors += 1
                if errors > self.max_errors:
                    break
                continue
            if total >= self.max_samples:
                break
        return correct / max(total, 1) * 100.0

    def evaluate_all_tasks(self, tasks: Dict[str, Sequence]) -> Dict[str, float]:
        results = {}
        for name, ds in tasks.items():
            if ds is None:
                continue
            results[name] = round(self.evaluate_task(name, ds), 1)
        results["Average"] = (
            round(float(np.mean(list(results.values()))), 1) if results else 0.0
        )
        return results
