"""Plain reference of the SP distillation step, for the training cells.

One step on a batch: the teacher micro-step at the 32-bit slot (shifted
cross-entropy / accum), whose logits and hidden states are the teacher
cache; then each student at its slot and feature layer (temperature-T KL
on the shifted logits, times T², plus alpha_feature times the hidden-state
MSE of its layer, which carries no gradient) / accum; the summed gradients
clipped to a global norm, then AdamW, at a cosine learning rate read at
step · accum. The embedding dropout draws (B, T, d) uniforms from one
generator: the teacher's, then each student's in order.

Students run one at a time, each block recomputed in the backward, so the
reference fits beside nothing else at the timed sizes.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch

from .sp_model import Dims, calibrate, forward

ROUNDOFF_SHARE = 1e-3   # a gradient under this share of the median leaf's is round-off
FROZEN = {"wq_scale", "wq_zp", "iq_scale", "iq_zp"}
Path = Tuple[str, ...]


def trainable_paths(params, prefix: Path = ()) -> List[Path]:
    """Linear weights and biases, LoRA factors, LayerNorm banks; not the
    embeddings nor the quantizer banks."""
    out = []
    for k in sorted(params):
        v = params[k]
        if isinstance(v, dict):
            out += trainable_paths(v, prefix + (k,))
        elif not (k in FROZEN or prefix + (k,) in (("wte",), ("wpe",))):
            out.append(prefix + (k,))
    return out


def get(tree, path: Path):
    for k in path:
        tree = tree[k]
    return tree


def with_leaves(tree, leaves: Dict[Path, torch.Tensor], prefix: Path = ()):
    out = {}
    for k, v in tree.items():
        p = prefix + (k,)
        out[k] = with_leaves(v, leaves, p) if isinstance(v, dict) else leaves.get(p, v)
    return out


def roundoff_kept(grads: Dict) -> Dict:
    """{leaf: bool mask of the elements whose gradient is no round-off}:
    |g| at least ROUNDOFF_SHARE times the median over leaves of the leaf's
    root mean square."""
    rms = sorted(float(g.norm()) / math.sqrt(max(1, g.numel())) for g in grads.values())
    n = len(rms)
    rms = 0.5 * (rms[(n - 1) // 2] + rms[n // 2])
    return {p: g.abs() >= ROUNDOFF_SHARE * rms for p, g in grads.items()}


def shifted_ce(logits, ids):
    lp = torch.log_softmax(logits[:, :-1], dim=-1)
    return -lp.gather(-1, ids[:, 1:, None])[..., 0].mean()


def lr_at(step: int, opt: dict, accum: int) -> torch.Tensor:
    total = opt["num_iterations"] * accum
    t = torch.tensor(min(step * accum, total), dtype=torch.float32)
    return 0.5 * opt["learning_rate"] * (1.0 + torch.cos(math.pi * t / total))


def follow(params, dims: Dims, traffic: dict, cal_batches: Sequence[torch.Tensor],
           steps: Sequence[tuple], dropout_seed: int, precision: str = "bf16",
           half_batch: bool = False, lr_scale: float = 1.0, keep=None) -> dict:
    """Calibrate, then run `steps`, each (ids (B, T), student slots, feature
    layers), from `params`. Returns {"teacher_loss": [...], "student_loss":
    [...] (the mean over students), "grad1": {path: norm of the first
    step's clipped gradient}, "keep": {path: the leaf's elements whose
    gradient is no round-off (`roundoff_kept`) at some step}, "change": {path:
    norm of the leaf's change over its kept elements after the last
    step}}. `half_batch` and `lr_scale` are planted faults: each step sees
    the first half of its rows; the learning rate is scaled. `keep` (a
    control's or a fault's run) takes another run's kept elements."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(params, dims, traffic, cal_batches, steps, dropout_seed,
                       precision, half_batch, lr_scale, keep)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _follow(params, dims, traffic, cal_batches, steps, dropout_seed, precision,
            half_batch, lr_scale, keep):
    opt, dist = traffic["optimizer"], traffic["distill"]
    accum = traffic["accum"]
    dev = params["wte"].device
    quant = calibrate(params, dims, cal_batches, precision)
    paths = trainable_paths(params)
    start = {p: get(params, p).detach().to(torch.float32) for p in paths}
    w = dict(start)
    mu = {p: torch.zeros_like(v) for p, v in w.items()}
    nu = {p: torch.zeros_like(v) for p, v in w.items()}
    gen = torch.Generator(device=dev).manual_seed(dropout_seed)
    teacher_slot = dims.slot(32)
    temp = dist["temperature"]
    out = {"teacher_loss": [], "student_loss": [], "grad1": {}, "change": {}}
    for i, (ids, slots, layers) in enumerate(steps):
        B, T = ids.shape
        draws = [torch.rand((B, T, dims.d), generator=gen, device=dev)
                 for _ in range(1 + len(slots))]
        if half_batch:
            ids, draws = ids[: B // 2], [u[: B // 2] for u in draws]
        live = {p: v.clone().requires_grad_(True) for p, v in w.items()}
        tree = with_leaves(params, live)
        leaves = [live[p] for p in paths]
        grads = [torch.zeros_like(v) for v in leaves]

        logits, t_hidden = forward(tree, ids, teacher_slot, dims, quant, precision,
                                   dropout_u=draws[0], remat=True)
        ce = shifted_ce(logits, ids)
        for acc, g in zip(grads, torch.autograd.grad(ce / accum, leaves, allow_unused=True)):
            if g is not None:
                acc.add_(g)
        with torch.no_grad():
            t_logp = torch.log_softmax(logits.detach()[:, :-1] / temp, dim=-1)
            p_t = t_logp.exp()
            neg_ent = (p_t * t_logp).sum(-1).mean()
        del logits, t_logp

        s_sum = 0.0
        for s, (slot, layer) in enumerate(zip(slots, layers)):
            s_logits, s_hidden = forward(tree, ids, int(slot), dims, quant, precision,
                                         dropout_u=draws[1 + s], remat=True)
            cross = (p_t * torch.log_softmax(s_logits[:, :-1] / temp, dim=-1)).sum(-1).mean()
            loss = dist["alpha_kl"] * (neg_ent - cross) * temp * temp
            feat = ((s_hidden[int(layer)] - t_hidden[int(layer)]) ** 2).mean()
            loss = (loss + dist["alpha_feature"] * feat) / accum
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
                if g is not None:
                    acc.add_(g)
            s_sum += float(loss.detach())
            del s_logits, s_hidden, loss, cross
        out["teacher_loss"].append(float(ce.detach()))
        out["student_loss"].append(s_sum * accum / max(len(slots), 1))
        del p_t, t_hidden

        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            if norm >= opt["max_grad_norm"]:
                grads = [g / norm * opt["max_grad_norm"] for g in grads]
            if i == 0:
                out["grad1"] = {p: float(g.norm()) for p, g in zip(paths, grads)}
            if keep is None:
                step_keep = roundoff_kept(dict(zip(paths, grads)))
                out["keep"] = {p: m | out["keep"][p] if "keep" in out else m
                               for p, m in step_keep.items()}
            b1, b2 = opt["adam_b1"], opt["adam_b2"]
            count = i + 1
            bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** count
            bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** count
            lr = lr_at(i, opt, accum) * lr_scale
            for p, g in zip(paths, grads):
                mu[p] = (1 - b1) * g + b1 * mu[p]
                nu[p] = (1 - b2) * g * g + b2 * nu[p]
                u = (mu[p] / bc1.to(dev)) / (torch.sqrt(nu[p] / bc2.to(dev)) + opt["adam_epsilon"])
                w[p] = w[p] - lr.to(dev) * (u + opt["weight_decay"] * w[p])
        del live, tree, leaves, grads
    if keep is not None:
        out["keep"] = keep
    out["change"] = {p: float((w[p] - start[p])[out["keep"][p]].norm()) for p in paths}
    return out
