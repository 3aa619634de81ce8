"""The comparisons that decide `correct`, and their limits.

Training: each of the first steps' teacher and student losses as a
relative gap to the reference's; the norm of the first clipped gradient
and of the change after the followed steps, leaf by leaf, as the gap
between the program's norm and the reference's over the larger of the
reference's norm of that leaf and of the median leaf, the worst leaf
kept. Leaves whose first gradient in the reference lies under a
thousandth of the median leaf's move by round-off alone and are left out;
so are, from the change, the elements whose gradient in the reference
lies under a thousandth of the median leaf's root mean square at every
followed step (a key's bias under softmax: Adam scales its round-off to
steps of the learning rate's size, of their own sign in each program).

Serving: the widest gap by which a served token's logit lies below the
reference's best at its position, over the sampled requests.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

from ..reference.sp_train import ROUNDOFF_SHARE


def rel_gap(p: float, r: float) -> float:
    return abs(p - r) / max(abs(r), 1e-30)


def leaf_gaps(prog: Dict, ref: Dict, grad_ref: Dict) -> Tuple[Dict, List[str]]:
    """({leaf: gap}, the leaves left out) of per-leaf norms."""
    med_g = statistics.median(grad_ref.values())
    out = [p for p in ref if grad_ref[p] < ROUNDOFF_SHARE * med_g]
    keep = [p for p in ref if p not in out]
    med = statistics.median(ref[p] for p in keep)
    return ({p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30) for p in keep},
            ["/".join(p) for p in out])


def train_numbers(prog: dict, ref: dict) -> Dict[str, dict]:
    """{number: {"value", "at"}} from the program's and the reference's
    readings (`reference.sp_train.follow`'s keys)."""
    out = {}
    for k in ("teacher_loss", "student_loss"):
        gaps = [rel_gap(p, r) for p, r in zip(prog[k], ref[k])]
        if len(prog[k]) != len(ref[k]) or not all(math.isfinite(g) for g in gaps):
            gaps = [math.inf]
        i = max(range(len(gaps)), key=gaps.__getitem__)
        out[k] = {"value": gaps[i], "at": f"step {i + 1}"}
    for k in ("grad1", "change"):
        gaps, left_out = leaf_gaps(prog[k], ref[k], ref["grad1"])
        worst = max(gaps, key=gaps.get)
        g = gaps[worst]
        out[k] = {"value": g if math.isfinite(g) else math.inf, "at": "/".join(worst),
                  "median_leaf": statistics.median(gaps.values()), "left_out": left_out}
    if "keep" in ref:
        n_out = sum(int((~m).sum()) for m in ref["keep"].values())
        out["change"]["left_out_elements"] = n_out
    return out


def served_gap(gaps_per_request) -> float:
    return max(float(g.max()) for g in gaps_per_request)
