"""Random Precision Inference (RPI): precision switching as a defence.

Counterpart of `llm_qat_tpu/robustness/random_switching.py`
(reference `part4_randomSwitching/simplified_random_switching.py`):
- `SimplifiedRandomSwitching` (`:156-238`): before each forward, with
  probability p pick a uniformly random bit-width; precision history and
  switch-rate statistics.
- `DefenseEvaluator.evaluate_fixed_precision` (`:240-304`): token-level
  perplexity and accuracy at a pinned precision.

The precision is an index into the parameter banks, so a switch costs
nothing: the same forward serves every draw. The draw itself stays on the
host in Python's `random.Random(seed)`, as in the JAX package, so a seed
gives the same precision history in both packages and on either device.
`token_level_metrics` computes on the logits' device and returns three
host scalars.
"""

from __future__ import annotations

import random
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _on(x, device, dtype=None) -> torch.Tensor:
    """`x` (a tensor, array or nested list) as a tensor on `device`."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x))
    return x.to(device=device, dtype=dtype)


def _ids_on(ids, device) -> torch.Tensor:
    return _on(ids, device, torch.int64)


class SimplifiedRandomSwitching:
    """Host-side precision draw around a forward.

    `forward_fn(input_ids, prec_idx) -> {"logits", "loss"?}`, with the ids
    an int64 tensor on the switcher's device (the card unless the caller
    asks for the CPU) and `prec_idx` an int; `bits_to_idx` maps bit-width →
    bank slot.
    """

    def __init__(self, forward_fn: Callable, bit_widths: Sequence[int],
                 bits_to_idx: Dict[int, int],
                 switch_probability: float = 0.3, seed: Optional[int] = None,
                 device=None):
        self.forward_fn = forward_fn
        self.bit_widths = sorted(bit_widths)
        self.bits_to_idx = dict(bits_to_idx)
        self.switch_prob = switch_probability
        self.device = resolve_device(device)
        self._rng = random.Random(seed)

        self.current_precision = max(self.bit_widths)
        self.precision_history: List[int] = []
        self.switch_count = 0
        self.total_forwards = 0

    def select_next_precision(self) -> int:
        """(`simplified_random_switching.py:174-199`)"""
        if self._rng.random() < self.switch_prob:
            new_precision = self._rng.choice(self.bit_widths)
            if new_precision != self.current_precision:
                self.switch_count += 1
            self.current_precision = new_precision
        self.precision_history.append(self.current_precision)
        return self.current_precision

    def forward_with_switching(self, input_ids, labels=None):
        precision = self.select_next_precision()
        self.total_forwards += 1
        out = self.forward_fn(_ids_on(input_ids, self.device),
                              int(self.bits_to_idx[precision]))
        return out, precision

    def forward_without_switching(self, input_ids, precision: Optional[int] = None):
        if precision is None:
            precision = self.current_precision
        return self.forward_fn(_ids_on(input_ids, self.device),
                               int(self.bits_to_idx[precision]))

    def get_statistics(self) -> Dict:
        """(`simplified_random_switching.py:217-238`)"""
        if not self.precision_history:
            return {"total_forwards": 0, "switch_count": 0,
                    "switch_rate": 0.0, "precision_distribution": {}}
        counts = Counter(self.precision_history)
        return {
            "total_forwards": self.total_forwards,
            "switch_count": self.switch_count,
            "switch_rate": self.switch_count / max(self.total_forwards - 1, 1),
            "precision_distribution": {
                b: c / len(self.precision_history) for b, c in counts.items()
            },
            "precision_counts": dict(counts),
        }


def token_level_metrics(logits, labels) -> Tuple[float, int, int]:
    """(sum_loss, n_correct, n_tokens) over labels != -100
    (`simplified_random_switching.py:283-296`).

    Computed in float32 on the logits' device: the max-shifted log-sum-exp
    of each row, the label's log-probability taken from it, and the
    argmax; only the three scalars come back to the host."""
    logits = _on(logits, None)
    labels = _on(labels, logits.device)
    shift_logits = logits[:, :-1].to(torch.float32)
    shift_labels = labels[:, 1:].to(torch.int64)
    mask = shift_labels != -100
    mx = shift_logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(shift_logits - mx).sum(-1, keepdim=True))
    # the label's log-probability: the same element-wise steps as the whole
    # row's logp = x - lse - max, taken at one element
    picked = torch.take_along_dim(
        shift_logits, torch.where(mask, shift_labels, 0)[..., None], dim=-1)
    nll = -((picked - lse - mx)[..., 0])
    sum_loss = torch.where(mask, nll, 0.0).sum()
    preds = shift_logits.argmax(-1)
    correct = ((preds == shift_labels) & mask).sum()
    host = torch.stack([sum_loss.double(), correct.double(),
                        mask.sum().double()]).tolist()
    n = int(host[2])
    if n == 0:
        return 0.0, 0, 0
    return float(host[0]), int(host[1]), n


class DefenseEvaluator:
    """Fixed-precision and switched evaluation (`:240-304`). The forward
    gets its ids on `device` (the card unless the caller asks for the
    CPU)."""

    def __init__(self, forward_fn: Callable, bit_widths: Sequence[int],
                 bits_to_idx: Dict[int, int], device=None):
        self.forward_fn = forward_fn
        self.bit_widths = list(bit_widths)
        self.bits_to_idx = dict(bits_to_idx)
        self.device = resolve_device(device)

    def evaluate_fixed_precision(self, samples: Sequence[Dict],
                                 precision: int) -> Dict:
        total_loss = total_correct = total_tokens = 0
        for s in samples:
            ids = np.atleast_2d(np.asarray(s["input_ids"]))
            labels = np.atleast_2d(np.asarray(s.get("labels", ids)))
            out = self.forward_fn(_ids_on(ids, self.device),
                                  int(self.bits_to_idx[precision]))
            l, c, n = token_level_metrics(out["logits"], labels)
            total_loss += l
            total_correct += c
            total_tokens += n
        avg_loss = total_loss / max(total_tokens, 1)
        return {
            "precision": precision,
            "perplexity": float(np.exp(avg_loss)),
            "avg_loss": avg_loss,
            "accuracy": total_correct / max(total_tokens, 1),
            "total_tokens": total_tokens,
        }

    def evaluate_with_switching(self, samples: Sequence[Dict],
                                switch_probability: float,
                                seed: Optional[int] = 0) -> Dict:
        """Accuracy/PPL under random switching (the defence condition of
        `run_evaluation.py:136-169`)."""
        switcher = SimplifiedRandomSwitching(
            self.forward_fn, self.bit_widths, self.bits_to_idx,
            switch_probability, seed, device=self.device,
        )
        total_loss = total_correct = total_tokens = 0
        for s in samples:
            ids = np.atleast_2d(np.asarray(s["input_ids"]))
            labels = np.atleast_2d(np.asarray(s.get("labels", ids)))
            out, _ = switcher.forward_with_switching(ids)
            l, c, n = token_level_metrics(out["logits"], labels)
            total_loss += l
            total_correct += c
            total_tokens += n
        avg_loss = total_loss / max(total_tokens, 1)
        return {
            "perplexity": float(np.exp(avg_loss)),
            "accuracy": total_correct / max(total_tokens, 1),
            "statistics": switcher.get_statistics(),
        }


def defense_success_rate(orig_acc: float, adv_acc: float,
                         switched_acc: float, threshold: float = 0.15) -> Dict:
    """Recovery-ratio defence criterion (`run_evaluation.py:136-141,169`):
    success iff (switched - adv) / (orig - adv) > threshold."""
    denom = orig_acc - adv_acc
    recovery = (switched_acc - adv_acc) / denom if denom > 1e-9 else 0.0
    return {"recovery_ratio": recovery, "success": recovery > threshold}
