"""Moves parameter trees between the JAX package and the port.

The JAX package's trees are converted to numpy first
(`jax.tree.map(np.asarray, params)`); this module never imports JAX. Dicts,
lists, tuples and NamedTuples keep their structure, arrays become tensors
with the same dtype and shape, and anything else (Python scalars, static
metadata) passes through. bfloat16 arrays (numpy's `ml_dtypes.bfloat16`)
are carried bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    if _is_bf16(a):
        bits = np.ascontiguousarray(a).view(np.uint16).astype(np.int16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16 dtype

        return t.view(torch.int16).numpy().view(np.uint16).view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, leaf, is_leaf):
    if is_leaf(tree):
        return leaf(tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, leaf, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf, is_leaf) for v in tree)
    return tree


def params_from_numpy(tree, device=None):
    """numpy tree (JAX names and layouts) → the port's tree of tensors."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _to_tensor(np.asarray(a), dev),
                lambda x: isinstance(x, (np.ndarray, np.generic)))


def params_to_numpy(params):
    """The port's tree of tensors → numpy tree (bf16 as ml_dtypes.bfloat16)."""
    return _map(params, _to_array, lambda x: isinstance(x, torch.Tensor))
