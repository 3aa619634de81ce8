"""Clip by global norm, then AdamW, over the trainable leaves of a tree.

The port's counterpart of the optax chain the JAX trainer builds
(`optax.multi_transform({"train": chain(clip_by_global_norm, adamw),
"freeze": set_to_zero()})`), written out in plain tensor code that follows
optax's formulas, not `torch.optim`'s:
- clip: g / norm * max_norm when norm >= max_norm, with no epsilon (unlike
  `torch.nn.utils.clip_grad_norm_`); the norm is over the trainable leaves;
- AdamW: mu = (1-b1) g + b1 mu, nu = (1-b2) g² + b2 nu, bias correction by
  1 - b^t with t counted from 1, u = mu_hat / (sqrt(nu_hat) + eps) + wd p,
  then p + (-lr) u, with lr read at the count before the increment;
- frozen leaves get no update at all (they stay the same tensors).

Trees are nested dicts; a leaf is addressed by its tuple of keys. Updates
are out of place, so the tree passed in stays valid.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from ..ops.sharded import is_dtensor

Path = Tuple[str, ...]


def leaves_with_paths(tree, prefix: Path = ()) -> List[Tuple[Path, object]]:
    """(path, leaf) pairs in sorted-key order (the order of JAX's trees)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaves_with_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def get_leaf(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def replace_leaves(tree, new: Dict[Path, object], prefix: Path = ()):
    """A copy of the dict structure with the leaves at `new`'s paths
    replaced; every other leaf is the same object."""
    out = {}
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            out[k] = replace_leaves(v, new, p)
        else:
            out[k] = new.get(p, v)
    return out


class AdamWState(NamedTuple):
    count: torch.Tensor  # int32 scalar: optimizer steps taken
    mu: Dict[Path, torch.Tensor]
    nu: Dict[Path, torch.Tensor]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over tensors of their summed squares."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float):
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def adamw_init(params, paths: Sequence[Path]) -> AdamWState:
    zeros = {p: torch.zeros_like(get_leaf(params, p)) for p in paths}
    dev = next(iter(zeros.values())).device if zeros else None
    return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros, nu={p: z.clone() for p, z in zeros.items()})


def _layout_of(t, like):
    """t with `like`'s placements when `like` is a DTensor (a gradient may
    come back partial or otherwise placed); else t."""
    if is_dtensor(like) and tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


@torch.no_grad()
def clip_adamw_update(params, grads: Dict[Path, torch.Tensor],
                      state: AdamWState, lr, *, max_norm: float, b1: float,
                      b2: float, eps: float, weight_decay: float):
    """One optimizer step over the trainable leaves in `grads`; returns
    (new params tree, new state). DTensor leaves (`parallel`) keep their
    placements: the gradients are brought to them first, and the moments
    and the updated leaves keep them."""
    paths = list(grads)
    grads = {p: _layout_of(grads[p], get_leaf(params, p)) for p in paths}
    clipped = dict(zip(paths, clip_by_global_norm([grads[p] for p in paths],
                                                  max_norm)))
    count = state.count + 1
    f32 = torch.float32
    bc1 = 1 - torch.tensor(b1, dtype=f32, device=count.device) ** count
    bc2 = 1 - torch.tensor(b2, dtype=f32, device=count.device) ** count
    step = -torch.as_tensor(lr, dtype=f32).to(count.device)
    mu, nu, new = {}, {}, {}
    for p in paths:
        g, w = clipped[p], get_leaf(params, p)
        mu[p] = _layout_of((1 - b1) * g + b1 * state.mu[p], w)
        nu[p] = _layout_of((1 - b2) * g ** 2 + b2 * state.nu[p], w)
        u = (mu[p] / bc1) / (torch.sqrt(nu[p] / bc2) + eps)
        u = u + weight_decay * w
        new[p] = _layout_of(w + step * u, w)
    return replace_leaves(params, new), AdamWState(count, mu, nu)
