"""Cyclic Precision Training: scheduler, precision range test, calibration, step.

Counterpart of `llm_qat_tpu/train/cpt_trainer.py`:
- `CyclicPrecisionScheduler` maps an epoch to a bit-width by a cosine
  `min + ½(max-min)(1-cos(2πt))` or triangular ramp over
  `total_epochs/total_cycles` epochs a cycle, rounded to the nearest
  configured bit-width; `PrecisionRangeTest` sweeps the bits upward on an
  injected `eval_fn` (pure Python, as in JAX);
- `CPTCalibrationManager` fills the weight and input scale banks per bit
  (lazily, `ensure_calibrated`) and the LoRA gradient-quantizer scales from
  one 32-bit backward of the LoRA pair;
- `make_cpt_train_step`: one CE step at one precision slot with the LoRA
  gradients quantized, clipped and AdamW-updated over the trainable leaves
  (the LayerNorm affines and the shared LoRA pair) only, at lr =
  0.5·lr·(1+cos(π·min(n,T)/T)) of optimizer step n.

`grad_norm` is JAX's `optax.global_norm` over every gradient of the tree:
the frozen base `w`/`b`, `lm_head` and `wte`/`wpe` included (the quantizer
banks' gradients are exact zeros there and are left out here). So the step
takes those gradients too, for the metric alone; they update nothing.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Sequence, Tuple

import torch

from ..models.config import CPTConfig
from ..models.cpt_model import cpt_forward, cpt_tables, prec_index
from ..quant.calibration import QuantStats, batch_min_max, finalize
from ..quant.functional import KIND_LOG, KIND_MINMAX
from . import optim

CPT_LINEAR_NAMES = ("c_attn", "attn_proj", "c_fc", "mlp_proj")
_QUANTIZER_LEAVES = {"wq_scale", "wq_zp", "iq_scale", "iq_zp",
                     "gq_scale_A", "gq_zp_A", "gq_scale_B", "gq_zp_B"}


class CyclicPrecisionScheduler:
    """Epoch → bit-width map."""

    def __init__(self, bit_widths: Sequence[int] = (4, 6, 8),
                 schedule_type: str = "cosine", total_epochs: int = 160,
                 total_cycles: int = 32):
        self.bit_widths = sorted(bit_widths)
        self.min_bits = min(bit_widths)
        self.max_bits = max(bit_widths)
        self.schedule_type = schedule_type
        self.total_epochs = total_epochs
        self.total_cycles = total_cycles
        self.epochs_per_cycle = total_epochs / total_cycles

    def get_precision_for_epoch(self, epoch: int) -> int:
        position = epoch % self.epochs_per_cycle
        t = float(position) / self.epochs_per_cycle
        if self.schedule_type == "cosine":
            p = self.min_bits + 0.5 * (self.max_bits - self.min_bits) * (
                1 - math.cos(t * 2 * math.pi)
            )
        elif self.schedule_type == "triangular":
            if t < 0.5:
                p = self.min_bits + (self.max_bits - self.min_bits) * (2 * t)
            else:
                p = self.max_bits - (self.max_bits - self.min_bits) * (
                    2 * (t - 0.5)
                )
        else:
            raise ValueError(f"Unknown schedule type: {self.schedule_type}")
        return self._round_to_nearest(p)

    def _round_to_nearest(self, precision: float) -> int:
        return min(self.bit_widths, key=lambda bw: abs(precision - bw))


class PrecisionRangeTest:
    """Lower/upper bit-bound search.

    `eval_fn(bits, batch) -> (n_correct, n_total, loss)` is injected, so the
    test is model-agnostic.
    """

    def __init__(self, eval_fn, start_bits: int, max_bits: int,
                 threshold: float, test_iterations: int, target_bits: int):
        self.eval_fn = eval_fn
        self.start_bits = start_bits
        self.max_bits = max_bits
        self.threshold = threshold
        self.test_iterations = test_iterations
        self.target_bits = target_bits

    def find_lower_bound(self, batches: Sequence) -> int:
        metrics: Dict[int, Dict] = {}
        early_stop = 0.005
        for bits in range(self.start_bits, self.max_bits + 1):
            correct = total = 0
            total_loss, n_batches = 0.0, 0
            for i, batch in enumerate(batches):
                if i >= self.test_iterations:
                    break
                c, t, loss = self.eval_fn(bits, batch)
                correct += int(c)
                total += int(t)
                total_loss += float(loss)
                n_batches += 1
            acc = correct / total if total else 0.0
            metrics[bits] = {
                "accuracy": acc,
                "loss": total_loss / n_batches if n_batches else float("inf"),
            }
            if bits > self.start_bits:
                prev = metrics[bits - 1]["accuracy"]
                improvement = (acc - prev) / max(prev, 1e-6)
                if improvement > self.threshold:
                    return bits
                if improvement < early_stop and bits >= self.start_bits + 3:
                    return bits
        # fallback: biggest absolute jump within start+1..start+3
        best_imp, optimal = 0.0, self.start_bits
        for bits in range(self.start_bits + 1,
                          min(self.start_bits + 4, self.max_bits + 1)):
            if bits in metrics and bits - 1 in metrics:
                imp = metrics[bits]["accuracy"] - metrics[bits - 1]["accuracy"]
                if imp > best_imp:
                    best_imp, optimal = imp, bits
        return optimal

    def find_bounds(self, batches: Sequence) -> Tuple[int, int]:
        lower = self.find_lower_bound(batches)
        upper = min(self.target_bits + 4, self.max_bits)
        return min(lower, self.target_bits), upper


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _weight_stats(w, kind, per_channel, eps, stacked: bool):
    """(min, max) of w in the quantizer domain: over the input axis per
    channel (stacked (L, in, out) → (L, out); the head's (in, out) →
    (out,)), over every axis but the layer's per tensor."""
    axes = ((1,) if per_channel else (1, 2)) if stacked else (
        (0,) if per_channel else (0, 1))
    mn, mx = batch_min_max(w, axes, kind, eps)
    keep = (0,) if stacked else ()
    shape = [w.shape[a] for a in range(w.ndim) if a not in axes or a in keep]
    return mn.reshape(shape), mx.reshape(shape)


def _set_slot(bank, slot, value, stacked: bool):
    out = bank.clone()
    if stacked:
        out[:, slot] = value
    else:
        out[slot] = value
    return out


def _copy_tree(params):
    out = dict(params)
    out["blocks"] = {k: dict(v) for k, v in params["blocks"].items()}
    out["lm_head"] = dict(params["lm_head"])
    return out


class CPTCalibrationManager:
    """Weight, input and gradient-quantizer calibration. Every method
    returns a new dict and leaves the banks of the one passed in as they
    were."""

    def __init__(self, cfg: CPTConfig, calibration_batches: int = 10):
        self.cfg = cfg
        self.calibration_batches = calibration_batches
        self.calibrated: set = set()
        self._kind = KIND_LOG if cfg.quantizer_kind == "log" else KIND_MINMAX

    def _tables(self, params):
        return cpt_tables(self.cfg, params["wte"].device)

    def _write(self, params, prefix, stats_of, precisions):
        """Writes `prefix`_scale/_zp of every linear at each bit < 32 from
        `stats_of(linear name) -> (min, max)` (per channel)."""
        cfg = self.cfg
        params = _copy_tree(params)
        lins = [(params["blocks"][n], n, True) for n in CPT_LINEAR_NAMES]
        for lin, name, stacked in lins + [(params["lm_head"], "lm_head", False)]:
            mn, mx = stats_of(name)
            for bits in precisions:
                if bits >= 32:
                    continue
                s, z = finalize(QuantStats(mn, mx, None), float(bits), self._kind,
                                cfg.symmetric, cfg.eps)
                p = prec_index(cfg, bits)
                lin[prefix + "_scale"] = _set_slot(lin[prefix + "_scale"], p, s, stacked)
                lin[prefix + "_zp"] = _set_slot(lin[prefix + "_zp"], p, z, stacked)
        return params

    # -- weights -----------------------------------------------------------
    def calibrate_weights(self, params, precisions: Iterable[int]):
        cfg = self.cfg

        def stats_of(name):
            stacked = name != "lm_head"
            w = (params["blocks"][name] if stacked else params["lm_head"])["w"]
            mn, mx = _weight_stats(w, self._kind, cfg.per_channel, cfg.eps, stacked)
            if not cfg.per_channel:
                mn, mx = mn[..., None], mx[..., None]
            return mn, mx

        return self._write(params, "wq", stats_of, list(precisions))

    # -- inputs ------------------------------------------------------------
    @torch.no_grad()
    def _collect_input_stats(self, params, batches):
        """Stat-collecting forwards (slot 0, LoRA off, inputs passing
        through), folded over the first `calibration_batches` batches:
        {linear or "lm_head": {stat: (L, ch) or (ch,)}}."""
        cfg, tables = self.cfg, self._tables(params)
        agg = None
        for ids in list(batches)[: self.calibration_batches]:
            out = cpt_forward(params, ids, 0, cfg, tables=tables,
                              calibration_mode=True, collect_stats=True)
            cur = dict(out["stats"], lm_head=out["lm_head_stats"])
            if agg is None:
                agg = cur
            else:
                agg = {n: {k: (torch.minimum if "min" in k else torch.maximum)(v, cur[n][k])
                           for k, v in s.items()} for n, s in agg.items()}
        return agg

    def calibrate_inputs(self, params, batches, precisions: Iterable[int]):
        """Input scales from the folded stat-collection forwards, finalized
        per bit."""
        cfg = self.cfg
        agg = self._collect_input_stats(params, batches)
        dom = "lg" if self._kind == KIND_LOG else "mm"

        def stats_of(name):
            mn, mx = agg[name][f"{dom}_min"], agg[name][f"{dom}_max"]
            if not cfg.per_channel:
                mn = torch.amin(mn, dim=-1, keepdim=True)
                mx = torch.amax(mx, dim=-1, keepdim=True)
            return mn, mx

        return self._write(params, "iq", stats_of, list(precisions))

    # -- gradient quantizers ----------------------------------------------
    def calibrate_gradient_quantizers(self, params, batch_ids):
        """One forward and backward at 32 bits (no gradient quantization)
        for the LoRA gradients alone; each (1, 1) scale is max(|g|, eps) /
        (2^(gradient_bits-1) - 1), zero points 0. With `lora_B` = 0, as at
        init, A's gradient is 0 and its scale eps/127."""
        cfg = self.cfg
        params = _copy_tree(params)
        owners = [params["blocks"][n] for n in CPT_LINEAR_NAMES] + [params["lm_head"]]
        names = ("lora_A", "lora_B")
        for lin in owners:
            for n in names:
                lin[n] = lin[n].detach().requires_grad_(True)
        loss = cpt_forward(params, batch_ids, prec_index(cfg, 32), cfg,
                           tables=self._tables(params), labels=batch_ids)["loss"]
        leaves = [lin[n] for lin in owners for n in names]
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        qmax = 2.0 ** (float(cfg.gradient_bits) - 1.0) - 1.0
        for i, lin in enumerate(owners):
            stacked = lin is not params["lm_head"]
            for j, n in enumerate(names):
                lin[n] = lin[n].detach()
                g = grads[2 * i + j]
                dims = tuple(range(1, g.ndim)) if stacked else tuple(range(g.ndim))
                am = torch.clamp(torch.amax(g.abs(), dim=dims), min=cfg.eps)
                s = (am / qmax).reshape((-1, 1, 1) if stacked else (1, 1))
                suffix = n[-1]
                lin["gq_scale_" + suffix] = s
                lin["gq_zp_" + suffix] = torch.zeros_like(s)
        return params

    # -- public API --------------------------------------------------------
    def ensure_calibrated(self, params, bits: int, batches):
        """Lazy per-bit calibration: the weight scales, then the input
        scales."""
        if bits >= 32 or bits in self.calibrated:
            return params
        params = self.calibrate_weights(params, [bits])
        params = self.calibrate_inputs(params, batches, [bits])
        self.calibrated.add(bits)
        return params


# ---------------------------------------------------------------------------
# Training step
# ---------------------------------------------------------------------------


def cpt_trainable_mask(params, _keys=()):
    """Tree of bools: only the LayerNorm affines and the shared LoRA pair
    train. wte/wpe, every base linear `w`/`b` (the head's too) and the
    quantizer banks are frozen."""
    out = {}
    linears = {"c_attn", "attn_proj", "c_fc", "mlp_proj", "lm_head"}
    for k, v in params.items():
        keys = _keys + (k,)
        if isinstance(v, dict):
            out[k] = cpt_trainable_mask(v, keys)
        elif keys[0] in ("wte", "wpe") or k in _QUANTIZER_LEAVES:
            out[k] = False
        else:
            out[k] = not (k in ("w", "b") and any(n in linears for n in keys))
    return out


def _gradient_paths(params):
    """(trainable paths, frozen paths that carry a gradient in JAX)."""
    train, frozen = [], []
    for path, m in optim.leaves_with_paths(cpt_trainable_mask(params)):
        if m:
            train.append(path)
        elif path[-1] not in _QUANTIZER_LEAVES:
            frozen.append(path)
    return train, frozen


def cpt_lr(learning_rate: float, total_steps: int):
    """lr of optimizer step n: 0.5·lr·(1+cos(π·min(n,T)/T)), float32."""

    def schedule(count: int) -> torch.Tensor:
        t = torch.tensor(min(int(count), total_steps), dtype=torch.float32)
        return 0.5 * learning_rate * (1.0 + torch.cos(math.pi * t / total_steps))

    return schedule


def make_cpt_train_step(cfg: CPTConfig, learning_rate: float = 1e-4,
                        total_steps: int = 10000, max_grad_norm: float = 1.0,
                        weight_decay: float = 0.01):
    """(init_state, train_step): one CE step at slot `prec` with the LoRA
    gradients quantized; clip by the trainable leaves' global norm, then
    AdamW (0.9, 0.999, 1e-8, `weight_decay`) over them. The state is a dict
    {"params", "opt_state", "step"}; frozen leaves come out of a step as
    the same tensors."""
    schedule = cpt_lr(learning_rate, total_steps)

    def init_state(params):
        train, _ = _gradient_paths(params)
        return {"params": params, "opt_state": optim.adamw_init(params, train),
                "step": 0}

    def train_step(state, ids, prec):
        params = state["params"]
        train, frozen = _gradient_paths(params)
        paths = train + frozen
        live = optim.replace_leaves(params, {
            p: optim.get_leaf(params, p).detach().requires_grad_(True) for p in paths})
        loss = cpt_forward(live, ids, prec, cfg, tables=cpt_tables(cfg, ids.device),
                           labels=ids, grad_quant=True)["loss"]
        grads = torch.autograd.grad(loss, [optim.get_leaf(live, p) for p in paths],
                                    materialize_grads=True)
        lr = schedule(state["step"])
        new_params, opt_state = optim.clip_adamw_update(
            params, dict(zip(train, grads[: len(train)])), state["opt_state"], lr,
            max_norm=max_grad_norm, b1=0.9, b2=0.999, eps=1e-8,
            weight_decay=weight_decay)
        metrics = {"loss": loss.detach(), "grad_norm": optim.global_norm(grads),
                   "lr": lr}
        return ({"params": new_params, "opt_state": opt_state,
                 "step": state["step"] + 1}, metrics)

    return init_state, train_step
