"""Model-size / compression metrics and bit configurations.

Re-implements the reference `BitConfigurations`
(`part3_eval_sp/bit_configurations.py:4-62`) and `SPEvaluation`'s size math
(`part3_eval_sp/sp_metrics.py:38-49`): weight GB = params(M) · W_bits/(8·1024)
and KV-cache GB = 2·L·H·d_head·2048·KV_bits/(8·1024³) — the reference's exact
formulas (including the params-in-millions convention) so reported numbers are
comparable. `CPTEvaluation`'s simpler size metric
(`part3_eval_cpt/cpt_metrics.py:8-37`) is `model_size_mb`.

Counterpart of `llm_qat_tpu/evals/metrics.py`: the parameter counts walk
nested dicts (and lists, tuples) of tensors or arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

# reference `bit_configurations.py:4` (13 named W-A-KV configurations)
STANDARD_CONFIGS: Dict[str, Dict] = {
    "FP32": {"W": 32, "A": 32, "KV": 32, "name": "32-32-32",
             "description": "Full FP32 precision (teacher)"},
    "FP16": {"W": 16, "A": 16, "KV": 16, "name": "16-16-16",
             "description": "Full precision baseline"},
    "INT8": {"W": 8, "A": 8, "KV": 8, "name": "8-8-8",
             "description": "8-bit integer quantization"},
    "INT6": {"W": 6, "A": 6, "KV": 6, "name": "6-6-6",
             "description": "6-bit integer quantization"},
    "INT4": {"W": 4, "A": 4, "KV": 4, "name": "4-4-4",
             "description": "4-bit integer quantization"},
    "INT2": {"W": 2, "A": 2, "KV": 2, "name": "2-2-2",
             "description": "2-bit integer quantization (extreme)"},
    "W4A8KV8": {"W": 4, "A": 8, "KV": 8, "name": "4-8-8",
                "description": "4-bit weights, 8-bit activations and KV cache"},
    "W4A8KV4": {"W": 4, "A": 8, "KV": 4, "name": "4-8-4",
                "description": "4-bit weights and KV cache, 8-bit activations"},
    "W4A16KV16": {"W": 4, "A": 16, "KV": 16, "name": "4-16-16",
                  "description": "4-bit weights only"},
    "W8A8KV4": {"W": 8, "A": 8, "KV": 4, "name": "8-8-4",
                "description": "8-bit weights and activations, 4-bit KV cache"},
    "W4A6KV16": {"W": 4, "A": 6, "KV": 16, "name": "4-6-16",
                 "description": "Mixed precision configuration"},
    "W2A16KV16": {"W": 2, "A": 16, "KV": 16, "name": "2-16-16",
                  "description": "Extreme weight quantization"},
    "W3A8KV8": {"W": 3, "A": 8, "KV": 8, "name": "3-8-8",
                "description": "3-bit weight quantization"},
}


def get_config_string(config: Dict) -> str:
    return f"{config['W']}-{config['A']}-{config['KV']}"


def parse_config_string(config_str: str) -> Dict:
    """'4-8-8' → {'W':4,'A':8,'KV':8,'name':...} (`bit_configurations.py:49-55`)."""
    parts = config_str.split("-")
    if len(parts) != 3:
        raise ValueError(
            f"Invalid config string: {config_str}. Expected W-A-KV (e.g. '4-8-8')"
        )
    return {"W": int(parts[0]), "A": int(parts[1]), "KV": int(parts[2]),
            "name": config_str}


def compression_ratio(config: Dict, baseline_config: Dict) -> float:
    """Sum-of-bits ratio (`bit_configurations.py:58-62`)."""
    if baseline_config is None:
        raise ValueError("baseline_config is required - no defaults allowed")
    return (
        (baseline_config["W"] + baseline_config["A"] + baseline_config["KV"])
        / (config["W"] + config["A"] + config["KV"])
    )


def validate_bits_supported(bit_widths, config: Dict):
    """Raise if the requested W bits aren't in the trained bank
    (`bit_configurations.py:apply_config_to_model`, `:7-39`)."""
    w = config.get("W", 8)
    if w not in bit_widths:
        raise ValueError(
            f"Requested bit-width {w} not in supported bit-widths "
            f"{tuple(bit_widths)}. Model must be trained with this bit-width."
        )
    return w


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _size(leaf) -> int:
    return int(np.prod(tuple(getattr(leaf, "shape", ()))))


def count_parameters_m(params) -> float:
    """Total parameter count in millions (reference `sp_metrics.py:21-22`)."""
    return sum(_size(l) for l in _leaves(params)) / 1e6


def count_trainable_parameters_m(params, mask) -> float:
    """Trainable (unfrozen) parameter count in millions (report's
    trainable-vs-total census, BASELINE.md CPT-vs-SP table); `mask` has
    the structure of `params` with a bool at each leaf."""
    return sum(_size(l) for l, m in zip(_leaves(params), _leaves(mask)) if m) / 1e6


def model_size_gb(params_m: float, n_layer: int, n_head: int, head_dim: int,
                  config: Dict, max_seq_len: int = 2048,
                  batch_size: int = 1) -> float:
    """Reference size formula (`sp_metrics.py:38-49`), conventions preserved."""
    weight_gb = params_m * config.get("W", 16) / (8 * 1024)
    kv_gb = (2 * n_layer * n_head * head_dim * max_seq_len * batch_size
             * config.get("KV", 16)) / (8 * 1024**3)
    return round(weight_gb + kv_gb, 2)
