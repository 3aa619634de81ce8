"""Checkpointing and deployment export.

Counterpart of `llm_qat_tpu/deploy/checkpoint.py`, in its file format key
for key, so a checkpoint either package writes loads in the other:
- per-bit SP checkpoints: one file per student bit-width with the params,
  the config dict and the bit, saved with retries and a reload-verify;
- true-INT8 export: every linear's weights re-quantized to int8 with one
  float scale (per tensor), LoRA and LayerNorm kept in float, with a
  compression report.

Format: numpy `.npz`, one array per leaf under its "/"-joined dict keys and
list indices (sorted dict keys, as JAX flattens a tree), plus `__meta__`,
a JSON string with the bit, a timestamp, the config and extras. Every
array round-trips exactly.
"""

from __future__ import annotations

import dataclasses
import json
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..bridge import params_from_numpy, params_to_numpy


def tree_leaves_with_keys(tree, prefix=()):
    """(key path, leaf) pairs: dicts by sorted keys, lists and tuples
    (NamedTuples too) by position, None as no leaf (the order of JAX's tree
    flattening). Keys and positions are given as strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_keys(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_keys(v, prefix + (str(i),))
    elif tree is not None:
        yield prefix, tree


def _flatten(params) -> Dict[str, np.ndarray]:
    return {"/".join(path): np.asarray(leaf)
            for path, leaf in tree_leaves_with_keys(params_to_numpy(params))}


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = val
    return out


def _config_to_dict(cfg) -> Dict:
    if dataclasses.is_dataclass(cfg):
        return {
            k: _config_to_dict(v) if dataclasses.is_dataclass(v) else
            (dict(v) if isinstance(v, dict) else
             list(v) if isinstance(v, tuple) else v)
            for k, v in dataclasses.asdict(cfg).items()
        }
    return cfg


def _npz_path(path) -> str:
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def save_checkpoint(path, params, config=None, bit_width: Optional[int] = None,
                    extra: Optional[Dict] = None, max_retries: int = 3) -> bool:
    """Save with retries and a reload-verify of every array."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = _flatten(params)
    meta = {
        "bit_width": bit_width,
        "timestamp": time.time(),
        "config": _config_to_dict(config) if config is not None else None,
        "extra": extra or {},
    }
    for attempt in range(max_retries):
        try:
            np.savez(path, __meta__=json.dumps(meta), **flat)
            with np.load(_npz_path(path), allow_pickle=False) as loaded:
                for k, v in flat.items():
                    if not np.array_equal(loaded[k], v):
                        raise IOError(f"verify failed for {k}")
            return True
        except (OSError, ValueError, zipfile.BadZipFile):
            if attempt == max_retries - 1:
                raise
            time.sleep(0.1)
    return False


def load_checkpoint(path, device=None) -> Tuple[Dict[str, Any], Dict]:
    """Returns (params, meta): the params as the port's tensors on `device`
    (the card by default; `bridge.params_from_numpy`'s conversion). Marks
    nothing calibrated: the banks carry their scales inline, and callers
    decide."""
    with np.load(_npz_path(path), allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    return params_from_numpy(_unflatten(flat), device), meta


def save_per_bit_checkpoints(out_dir, params, cfg, prefix: str = "sp",
                             bits_list=None) -> Dict[int, str]:
    """One checkpoint per student bit. The banks already hold every
    precision, so each file tags its target bit in the metadata (the
    loader then pins that precision index)."""
    out_dir = Path(out_dir)
    bits_list = bits_list or [b for b in cfg.quant.bit_widths if b < 32]
    flat_params = params_to_numpy(params)  # one device-to-host copy
    paths = {}
    for bits in bits_list:
        p = out_dir / f"{prefix}_{bits}bit.npz"
        save_checkpoint(p, flat_params, cfg, bit_width=bits)
        paths[bits] = str(p)
    return paths


def export_int8(params, cfg) -> Tuple[Dict[str, Any], Dict]:
    """True-INT8 export: per-tensor symmetric int8 weights + float scale;
    LoRA/LN stay float. Returns (export tree of numpy arrays, report) with
    the compression ratio against float32."""
    report = {"orig_bytes": 0, "int8_bytes": 0}

    def convert(tree, key=None):
        if isinstance(tree, dict):
            return {k: convert(v, k) for k, v in tree.items()}
        arr = np.asarray(tree)
        report["orig_bytes"] += arr.nbytes
        if key == "w":
            abs_max = max(float(np.abs(arr).max()), 1e-8)
            scale = abs_max / 127.0
            q = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
            report["int8_bytes"] += q.nbytes + 4
            return {"int8": q, "scale": np.float32(scale)}
        report["int8_bytes"] += arr.nbytes
        return arr

    tree = convert(params_to_numpy(params))
    report["compression_ratio"] = report["orig_bytes"] / max(
        report["int8_bytes"], 1
    )
    return tree, report
