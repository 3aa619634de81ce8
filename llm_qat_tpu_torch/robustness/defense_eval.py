"""RPI defence evaluation pipeline.

Counterpart of `llm_qat_tpu/robustness/defense_eval.py`, the same report
keys. Re-implements `part4_randomSwitching/run_evaluation.py:136-268,
270-409`: clean baseline at max bits → run both attacks → replay the successful
adversarial texts under random switching at p ∈ {0, 0.3, 0.5, 0.7} →
"defense success" = recovery ratio (switched_acc - adv_acc) /
(orig_acc - adv_acc) > 0.15 → JSON-able report with the optimal p.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

from .attacks import AttackEvaluator
from .random_switching import defense_success_rate


def _accuracy_over_texts(metrics_fn, texts: Sequence[str]) -> float:
    accs = [metrics_fn(t)[1] for t in texts if t.strip()]
    return float(np.mean(accs)) if accs else 0.0


def _switched_accuracy(switched_metrics_fn, texts: Sequence[str],
                       switch_prob: float, seed: int = 0) -> float:
    accs = [switched_metrics_fn(t, switch_prob, seed + i)[1]
            for i, t in enumerate(texts) if t.strip()]
    return float(np.mean(accs)) if accs else 0.0


def run_rpi_evaluation(metrics_fn: Callable, switched_metrics_fn: Callable,
                       attacks: Dict[str, object], texts: Sequence[str],
                       switch_probs: Sequence[float] = (0.0, 0.3, 0.5, 0.7),
                       recovery_threshold: float = 0.15,
                       max_samples: int = 30) -> Dict:
    """Full part4 pipeline.

    - `metrics_fn(text) -> (loss, acc)`: fixed max-bits forward.
    - `switched_metrics_fn(text, p, seed) -> (loss, acc)`: forward with
      random precision switching at probability p.
    - `attacks`: {"TextFooler": TextFoolerAttack, "BERT-Attack": BERTAttack}.
    """
    report: Dict = {"clean": {}, "attacks": {}, "defense": {}}
    texts = [t for t in texts[:max_samples] if t.strip()]
    report["clean"]["accuracy"] = _accuracy_over_texts(metrics_fn, texts)

    for name, attack in attacks.items():
        res = AttackEvaluator(attack).evaluate(texts, max_samples)
        report["attacks"][name] = {
            "attack_success_rate": res["attack_success_rate"],
            "n_successful": res["successful_attacks"],
        }
        adv_texts = [d["adversarial_text"] for d in res["details"]]
        orig_acc = float(np.mean([d["orig_accuracy"] for d in res["details"]])
                         ) if res["details"] else 0.0
        adv_acc = float(np.mean([d["adv_accuracy"] for d in res["details"]])
                        ) if res["details"] else 0.0

        defense = {}
        for p in switch_probs:
            switched_acc = _switched_accuracy(switched_metrics_fn, adv_texts, p)
            d = defense_success_rate(orig_acc, adv_acc, switched_acc,
                                     recovery_threshold)
            defense[str(p)] = {
                "switched_accuracy": switched_acc,
                "recovery_ratio": d["recovery_ratio"],
                "success": d["success"],
            }
        best_p = max(defense, key=lambda k: defense[k]["recovery_ratio"])
        report["defense"][name] = {
            "by_probability": defense,
            "optimal_p": float(best_p),
            "orig_accuracy": orig_acc,
            "adv_accuracy": adv_acc,
        }
    return report
