"""Sliding-window perplexity evaluation.

Counterpart of `llm_qat_tpu/evals/perplexity.py`, which re-implements the
reference `PerplexityEvaluator` (`part3_eval_sp/perplexity_eval.py:8-95`)
with exact window/target semantics: windows of `max_length` advanced by
`stride`; per window, loss is summed only over the target region
`[max(prev_end, begin), end)` so overlapping context tokens are never
double-counted; PPL = exp(total_loss / total_tokens).

As in JAX, windows are right-padded to `max_length`, annotated with
(valid_len, target_start, target_end) and evaluated in fixed-shape batches
of `batch_size` (a short last batch is padded with rows whose target mask is
empty); a batch whose summed loss is not finite is skipped. The batches are
built on the evaluator's device (the card unless the caller asks for the
CPU), and `logits_fn` takes and returns tensors there.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from ..device import resolve_device


def iter_windows(n_tokens: int, max_length: int, stride: int):
    """Yield (begin, end, target_start, target_end) per reference
    `perplexity_eval.py:52-75`."""
    prev_end = 0
    for begin in range(0, n_tokens, stride):
        end = min(begin + max_length, n_tokens)
        if end - begin < 2:
            break
        t_start = max(prev_end, begin)
        t_end = end
        if t_end <= t_start:
            continue
        yield begin, end, t_start, t_end
        prev_end = t_end


class PerplexityEvaluator:
    """Corpus perplexity with the reference's sliding-window accounting.

    `logits_fn(ids)` maps int64 (B, max_length) → (B, max_length, V) on
    `device`; bind params/precision with a closure (e.g. over
    `sp_forward`).
    """

    def __init__(self, logits_fn: Callable, max_length: int = 256,
                 stride: int = 256, batch_size: int = 16, pad_id: int = 0,
                 device=None):
        self.logits_fn = logits_fn
        self.max_length = max_length
        self.stride = stride
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.device = resolve_device(device)

    @torch.no_grad()
    def _batch_loss(self, ids, t_start, t_end, valid_len):
        logits = self.logits_fn(ids)  # (B, T, V)
        shift_logits = logits[:, :-1].to(torch.float32)
        shift_labels = ids[:, 1:]
        T = shift_labels.shape[1]
        pos = torch.arange(T, device=ids.device)[None, :]
        # target region in shifted coordinates (reference
        # perplexity_eval.py:60-67): [t_start - begin, t_end - begin - 1)
        mask = (pos >= t_start[:, None]) & (pos < (t_end - 1)[:, None])
        mask = mask & (pos < (valid_len - 1)[:, None])
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logp, -1, shift_labels[..., None])[..., 0]
        nll = torch.where(mask, nll, torch.zeros_like(nll))
        return nll.sum(), mask.sum()

    def _windows_for(self, tokens: np.ndarray):
        n = len(tokens)
        out = []
        for begin, end, t_start, t_end in iter_windows(n, self.max_length,
                                                       self.stride):
            ids = np.full((self.max_length,), self.pad_id, np.int64)
            ids[: end - begin] = tokens[begin:end]
            out.append((ids, t_start - begin, t_end - begin, end - begin))
        return out

    def windows(self, token_sequences: Sequence[np.ndarray]):
        """Every (ids, target_start, target_end, valid_len) window of the
        documents, in order (documents shorter than 2 tokens skipped)."""
        windows = []
        for toks in token_sequences:
            toks = np.asarray(toks, np.int64)
            if len(toks) < 2:
                continue
            windows.extend(self._windows_for(toks))
        return windows

    def calculate_perplexity(self, token_sequences: Sequence[np.ndarray]) -> float:
        """PPL over pre-tokenized documents (reference loops raw texts through
        its tokenizer first; tokenization is decoupled here)."""
        windows = self.windows(token_sequences)
        if not windows:
            return float("inf")

        total_loss = 0.0
        total_tokens = 0
        B = self.batch_size
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        for i in range(0, len(windows), B):
            chunk = windows[i : i + B]
            n = len(chunk)
            if n < B:  # pad the batch; padded rows have empty target masks
                chunk = chunk + [
                    (np.full((self.max_length,), self.pad_id, np.int64), 0, 0, 0)
                ] * (B - n)
            loss, ntok = self._batch_loss(as_t(np.stack([c[0] for c in chunk])),
                                          *(as_t([c[j] for c in chunk]) for j in (1, 2, 3)))
            l, t = float(loss), int(ntok)
            if math.isfinite(l):
                total_loss += l
                total_tokens += t

        if total_tokens == 0:
            return float("inf")
        return math.exp(total_loss / total_tokens)

    def evaluate_all_datasets(self, datasets: Dict[str, Sequence[np.ndarray]]
                              ) -> Dict[str, float]:
        """{name: token_sequences} → {name: ppl} (reference
        `evaluate_all_datasets`, `perplexity_eval.py:83-95`)."""
        return {
            name: round(self.calculate_perplexity(seqs), 1)
            for name, seqs in datasets.items()
        }
