"""Evaluation harness: perplexity, zero-shot, metrics, tables, baselines
(counterpart of `llm_qat_tpu/evals/`)."""

from typing import Dict

from .metrics import (
    STANDARD_CONFIGS,
    compression_ratio,
    count_parameters_m,
    count_trainable_parameters_m,
    get_config_string,
    model_size_gb,
    parse_config_string,
    validate_bits_supported,
)
from .few_shot import FewShotEvaluator, load_mmlu, mmlu_category
from .perplexity import PerplexityEvaluator, iter_windows
from .tables import ResultTableGenerator
from .zero_shot import TASK_FORMATTERS, ZeroShotEvaluator


class BaselineComparison:
    """Degradation vs a baseline config (reference
    `part3_eval_sp/baseline_comparison.py:4-42`)."""

    def __init__(self, baseline_name: str = "FP16"):
        self.baseline_name = baseline_name

    def compare(self, results: Dict) -> Dict:
        base = results.get(self.baseline_name)
        if not base:
            return {}
        out = {}
        for name, r in results.items():
            if name == self.baseline_name:
                continue
            entry = {}
            if r.get("zero_shot") and base.get("zero_shot"):
                entry["zero_shot_delta"] = round(
                    r["zero_shot"].get("Average", 0)
                    - base["zero_shot"].get("Average", 0), 2
                )
            if r.get("perplexity") and base.get("perplexity"):
                deltas = {}
                for ds, v in r["perplexity"].items():
                    if ds in base["perplexity"]:
                        deltas[ds] = round(v - base["perplexity"][ds], 2)
                entry["perplexity_delta"] = deltas
            out[name] = entry
        return out


__all__ = [
    "STANDARD_CONFIGS",
    "compression_ratio",
    "count_parameters_m",
    "count_trainable_parameters_m",
    "get_config_string",
    "model_size_gb",
    "parse_config_string",
    "validate_bits_supported",
    "FewShotEvaluator",
    "load_mmlu",
    "mmlu_category",
    "PerplexityEvaluator",
    "iter_windows",
    "ResultTableGenerator",
    "TASK_FORMATTERS",
    "ZeroShotEvaluator",
    "BaselineComparison",
]
