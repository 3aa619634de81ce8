"""Training statistics tracking and JSON export.

Counterpart of `llm_qat_tpu/utils/stats.py`: per-iteration losses,
per-precision loss series, learning rate, memory, precision-usage counts,
serialized to `training_stats_*.json` together with the config dicts, under
the JAX package's keys. Memory is `torch.cuda.memory_allocated()` of the
current CUDA device, and 0.0 where no card is in use.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch


def device_memory_mb(device=None) -> float:
    """Memory held by tensors on `device` (the current CUDA device by
    default) in MB; 0.0 on the CPU or without a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    return float(torch.cuda.memory_allocated(dev)) / 1e6


class StatsTracker:
    def __init__(self, bit_widths=None, device=None):
        self.device = device
        self.bit_widths = list(bit_widths) if bit_widths else []
        self.iteration_losses: List[float] = []
        self.precision_losses: Dict[int, List[float]] = defaultdict(list)
        self.learning_rates: List[float] = []
        self.memory_mb: List[float] = []
        self.precision_counts: Dict[int, int] = defaultdict(int)
        self.eval_results: List[Dict] = []
        self.start_time = time.time()

    def record_iteration(self, loss: float, lr: float,
                         precision_losses: Optional[Dict[int, float]] = None):
        self.iteration_losses.append(float(loss))
        self.learning_rates.append(float(lr))
        self.memory_mb.append(device_memory_mb(self.device))
        if precision_losses:
            for bits, l in precision_losses.items():
                self.precision_losses[int(bits)].append(float(l))

    def record_precision_usage(self, precision: int):
        self.precision_counts[int(precision)] += 1

    def record_eval(self, iteration: int, results: Dict):
        self.eval_results.append({"iteration": iteration, **results})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "iteration_losses": self.iteration_losses,
            "precision_losses": {str(k): v
                                 for k, v in self.precision_losses.items()},
            "learning_rates": self.learning_rates,
            "memory_mb": self.memory_mb,
            "precision_counts": {str(k): v
                                 for k, v in self.precision_counts.items()},
            "eval_results": self.eval_results,
            "wall_time_s": time.time() - self.start_time,
        }

    def save(self, filepath: str, model_config=None, training_config=None):
        """JSON export with the config dicts."""
        data = self.to_dict()
        for name, cfg in (("model_config", model_config),
                          ("training_config", training_config)):
            if cfg is None:
                continue
            if dataclasses.is_dataclass(cfg):
                def clean(v):
                    if dataclasses.is_dataclass(v):
                        return {k: clean(x) for k, x in
                                dataclasses.asdict(v).items()}
                    if isinstance(v, dict):
                        return {str(k): clean(x) for k, x in v.items()}
                    if isinstance(v, tuple):
                        return list(v)
                    return v
                data[name] = clean(cfg)
            else:
                data[name] = {
                    k: v for k, v in vars(cfg).items()
                    if isinstance(v, (int, float, str, bool, list, tuple))
                }
        with open(filepath, "w") as f:
            json.dump(data, f, indent=2)
        return filepath
