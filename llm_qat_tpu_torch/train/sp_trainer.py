"""Switchable-precision distillation training: one multi-precision step.

Counterpart of `llm_qat_tpu/train/sp_trainer.py`. One train step runs, on
the same batch:
- the teacher micro-step at the 32-bit slot (shifted CE / accum), whose
  logits and hidden states are the teacher cache;
- `accum - 1` student micro-steps, each at a student precision slot with a
  random feature layer in [0, L], on the distillation loss / accum;
- the summed gradients, clipped to `max_grad_norm`, then AdamW over the
  trainable leaves (`train.optim`), at lr = cosine(step · accum).

`student_mode` "scan" and "unroll" run the students one forward and
backward at a time; "vmap" runs them all in one forward over the vector of
their slots (a student axis in front of every activation, `sp_forward`)
and one backward of the summed losses, as JAX's `jax.vmap` does.

Frozen leaves (wte/wpe and the quantizer scale banks) never require grad,
so no gradient work is done for them (the (vocab, d) tied-head gradient is
never formed) and they come out of a step as the same tensors. The LoRA
quantizer scales are computed inline from the live A/B in `sp_linear`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..models.config import SPModelConfig, TrainConfig
from ..models.sp_model import PrecTables, is_slots, prec_tables, sp_forward, torch_dtype
from ..ops.sharded import replicating
from . import optim
from .distillation import (TeacherOutputs, distillation_loss, prepare_teacher,
                           students_distillation_loss)

FROZEN_NAMES = {"wq_scale", "wq_zp", "iq_scale", "iq_zp"}


def trainable_mask(params, _keys=()) -> Dict[str, Any]:
    """Tree of bools, True for trainable leaves. Frozen: wte/wpe and the
    quantizer scale/zero-point banks. Trainable: linear w/b, LoRA A/B,
    LayerNorm banks."""
    out = {}
    for k, v in params.items():
        keys = _keys + (k,)
        if isinstance(v, dict):
            out[k] = trainable_mask(v, keys)
        else:
            out[k] = not ("wte" in keys or "wpe" in keys or k in FROZEN_NAMES)
    return out


def trainable_paths(params):
    return [p for p, m in optim.leaves_with_paths(trainable_mask(params)) if m]


def cosine_lr(base_lr: float, total_micro_steps: int, accum: int):
    """LR of optimizer step i: a cosine annealing stepped once per
    micro-step, read at t = i · accum (float32, as in the JAX package)."""

    def schedule(count: int) -> torch.Tensor:
        t = torch.tensor(min(int(count) * accum, total_micro_steps),
                         dtype=torch.float32)
        return 0.5 * base_lr * (1.0 + torch.cos(math.pi * t / total_micro_steps))

    return schedule


class SPTrainState(NamedTuple):
    params: Any
    opt_state: optim.AdamWState
    step: int


def make_sp_train_step(cfg: SPModelConfig, tcfg: TrainConfig,
                       tables: Optional[PrecTables] = None,
                       attention_fn=None, forward_fn=None):
    """Build (init_state, train_step) for the SP multi-precision loop.

    `train_step(state, ids, generator, *, precs=None, layers=None)` returns
    (state, metrics). The student slots and feature layers are drawn from
    `generator` (which also draws the embedding dropout) unless given, so
    one step can be replayed across packages.

    `attention_fn` goes to `sp_forward` (`partial(ring_attention,
    mesh=mesh, axis_name=...)` trains with context-parallel attention).
    `forward_fn` replaces `sp_forward` wholesale and takes its keyword
    subset (tables, labels, deterministic, dropout_gen,
    output_hidden_states): `partial(pipeline_sp_forward, mesh=mesh)` runs
    the same step through the GPipe schedule
    (`parallel.make_pp_sp_train_step`). The two exclude each other; under
    `student_mode="vmap"` `forward_fn` gets the vector of the student slots
    as `prec`. A state of DTensors (`parallel.shard_params`) is stepped
    under `replication_scope`, backwards included, and keeps its
    placements.
    """
    if forward_fn is not None and attention_fn is not None:
        raise ValueError("forward_fn and attention_fn are mutually exclusive")
    mode = tcfg.student_mode or ("unroll" if tcfg.unroll_students else "scan")
    if mode not in ("scan", "unroll", "vmap"):
        raise ValueError(f"student_mode must be scan/unroll/vmap; got {mode!r}")
    q = cfg.quant
    teacher_slot = q.prec_index(q.teacher_bits)
    student_slots = [q.prec_index(b) for b in q.student_bits]
    accum = tcfg.gradient_accumulation_steps
    n_students = accum - 1
    n_feature_layers = cfg.model.n_layer + 1
    schedule = cosine_lr(tcfg.learning_rate, tcfg.num_iterations * accum, accum)

    def init_state(params) -> SPTrainState:
        return SPTrainState(params=params,
                            opt_state=optim.adamw_init(params, trainable_paths(params)),
                            step=0)

    def forward(params, ids, prec, gen, labels, tabs):
        if forward_fn is not None:
            return forward_fn(params, ids, prec, cfg, tables=tabs, labels=labels,
                              deterministic=False, dropout_gen=gen,
                              output_hidden_states=True)
        return sp_forward(params, ids, prec, cfg, tables=tabs, labels=labels,
                          deterministic=False, dropout_gen=gen,
                          output_hidden_states=True,
                          hidden_states_grad=tcfg.distill_feature_grad,
                          attention_fn=attention_fn)

    def grads_of(loss, leaves):
        if not loss.requires_grad:  # every term skipped or detached
            return [torch.zeros_like(x) for x in leaves]
        return list(torch.autograd.grad(loss, leaves, materialize_grads=True))

    @replicating
    def train_step(state: SPTrainState, ids, generator: torch.Generator, *,
                   precs=None, layers=None):
        dev = state.params["wte"].device
        tabs = tables if tables is not None else prec_tables(q, dev)
        paths = trainable_paths(state.params)
        live = optim.replace_leaves(state.params, {
            p: optim.get_leaf(state.params, p).detach().requires_grad_(True)
            for p in paths})
        leaves = [optim.get_leaf(live, p) for p in paths]

        # micro-step 0: the teacher (CE, and the cache)
        out = forward(live, ids, teacher_slot, generator, ids, tabs)
        t_loss = out["loss"] / accum
        grads = grads_of(t_loss, leaves)
        teacher = TeacherOutputs(logits=out["logits"].detach(),
                                 hidden_states=out["hidden_states"].detach())
        del out
        if tcfg.distill_alpha_kl:
            teacher = prepare_teacher(teacher.logits, teacher.hidden_states,
                                      tcfg.distill_temperature,
                                      cache_dtype=torch_dtype(tcfg.distill_cache_dtype))

        # micro-steps 1..accum-1: sampled student slots and feature layers
        gdev = generator.device
        if precs is None:
            pick = torch.randint(len(student_slots), (n_students,),
                                 generator=generator, device=gdev)
            precs = torch.as_tensor(student_slots, device=gdev)[pick]
        if layers is None:
            layers = torch.randint(n_feature_layers, (n_students,),
                                   generator=generator, device=gdev)
        precs = torch.as_tensor(precs, dtype=torch.int32)
        layers = torch.as_tensor(layers).tolist()
        loss_kw = dict(alpha_kl=tcfg.distill_alpha_kl,
                       alpha_feature=tcfg.distill_alpha_feature,
                       temperature=tcfg.distill_temperature,
                       accumulative=tcfg.distill_accumulative)

        def student_loss(prec, layer):
            out = forward(live, ids, prec, generator, None, tabs)
            loss_fn = students_distillation_loss if is_slots(prec) else distillation_loss
            return loss_fn(out["logits"], out["hidden_states"], teacher, layer,
                           **loss_kw) / accum

        if mode == "vmap":  # one forward over the (S,) slots, one backward of the sum
            runs = [(precs, layers)] if n_students else []
        else:
            runs = zip(precs.tolist(), layers)
        s_sum = torch.zeros((), device=dev)
        for prec, layer in runs:
            loss = student_loss(prec, layer)
            for acc, g in zip(grads, grads_of(loss, leaves)):
                acc.add_(g)
            s_sum = s_sum + loss.detach()

        grad_map = dict(zip(paths, grads))
        lr = schedule(state.step)
        params, opt_state = optim.clip_adamw_update(
            state.params, grad_map, state.opt_state, lr,
            max_norm=tcfg.max_grad_norm, b1=tcfg.adam_b1, b2=tcfg.adam_b2,
            eps=tcfg.adam_epsilon, weight_decay=tcfg.weight_decay)
        t_loss = t_loss.detach()
        metrics = {
            "loss": t_loss + s_sum,
            "teacher_loss": t_loss * accum,
            "student_loss_mean": s_sum * accum / max(n_students, 1),
            "grad_norm": optim.global_norm(grads),
            "lr": lr,
            "precisions": precs,
        }
        return SPTrainState(params, opt_state, state.step + 1), metrics

    return init_state, train_step


def make_eval_step(cfg: SPModelConfig, tables: Optional[PrecTables] = None):
    """Eval loss at any precision slot (no gradient)."""

    @torch.no_grad()
    def eval_step(params, ids, prec):
        return sp_forward(params, ids, prec, cfg, tables=tables, labels=ids)["loss"]

    return eval_step
