"""SQuAD QA training with self-distillation.

Counterpart of `llm_qat_tpu/train/squad_trainer.py`: the SP loop with the
QA loss. One step runs, on the same batch, the teacher micro-step at the
32-bit slot (QA loss / accum, whose start/end logits and hidden states are
the teacher cache), then `accum - 1` students at sampled student slots,
each on task loss + distillation / accum, where distillation = alpha_kl ·
½(KL(start) + KL(end)) over sequence positions at temperature T, scaled by
T², + alpha_feature · hidden-state MSE at a sampled layer. The summed
gradients are clipped and AdamW-updated over SP's `trainable_mask` (so the
QA heads train) at SP's `cosine_lr`.

`grad_norm` is JAX's `optax.global_norm` over every gradient of the tree,
`wte`/`wpe` included (the quantizer banks' gradients are exact zeros there
and are left out here). The hidden states are detached whatever
`distill_feature_grad` says: JAX's `qa_forward` never passes it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..models.config import SPModelConfig, TrainConfig
from ..models.qa import qa_forward
from ..models.sp_model import PrecTables, prec_tables
from . import optim
from .distillation import feature_distillation_loss
from .sp_trainer import cosine_lr, trainable_paths


class QATeacherOutputs(NamedTuple):
    start_logits: torch.Tensor  # (B, T)
    end_logits: torch.Tensor
    hidden_states: torch.Tensor  # (L+1, B, T, d)


def qa_kl_loss(student_logits, teacher_logits, temperature: float):
    """KL over sequence positions for one head, mean over the batch, × T²."""
    T = temperature
    t = teacher_logits.detach().to(torch.float32) / T
    s = student_logits.to(torch.float32) / T
    t_logp = torch.log_softmax(t, dim=-1)
    s_logp = torch.log_softmax(s, dim=-1)
    kl = torch.sum(torch.exp(t_logp) * (t_logp - s_logp), dim=-1)  # (B,)
    return torch.mean(kl) * (T * T)


def qa_distillation_loss(student, teacher: QATeacherOutputs, layer_idx, *,
                         alpha_kl: float, alpha_feature: float,
                         temperature: float, accumulative: bool = False):
    kl = 0.5 * (
        qa_kl_loss(student["start_logits"], teacher.start_logits, temperature)
        + qa_kl_loss(student["end_logits"], teacher.end_logits, temperature)
    )
    feat = feature_distillation_loss(
        student["hidden_states"], teacher.hidden_states, layer_idx, accumulative)
    return alpha_kl * kl + alpha_feature * feat


class QATrainState(NamedTuple):
    params: Any
    opt_state: optim.AdamWState
    step: int


def make_squad_train_step(cfg: SPModelConfig, tcfg: TrainConfig,
                          tables: Optional[PrecTables] = None):
    """(init_state, train_step) for the QA multi-precision loop.

    `train_step(state, batch, generator, *, precs=None, layers=None,
    uniforms=None)` returns (state, metrics). `batch` holds `input_ids`,
    `attention_mask`, `start_positions` and `end_positions` tensors. The
    student slots and feature layers are drawn from `generator` unless
    given; each micro-step's dropout uniforms ((B, T, n_embd), teacher
    first) are drawn from it unless `uniforms` gives them, so one step can
    be replayed across packages.
    """
    q = cfg.quant
    teacher_slot = q.prec_index(q.teacher_bits)
    student_slots = [q.prec_index(b) for b in q.student_bits]
    accum = tcfg.gradient_accumulation_steps
    n_students = accum - 1
    n_layers = cfg.model.n_layer + 1
    schedule = cosine_lr(tcfg.learning_rate, tcfg.num_iterations * accum, accum)

    def init_state(params) -> QATrainState:
        return QATrainState(params, optim.adamw_init(params, trainable_paths(params)), 0)

    def forward(params, batch, prec, drop, tabs):
        return qa_forward(
            params, batch["input_ids"], prec, cfg, tables=tabs,
            attention_mask=batch["attention_mask"],
            start_positions=batch["start_positions"],
            end_positions=batch["end_positions"],
            deterministic=False, dropout_gen=drop, output_hidden_states=True)

    def train_step(state: QATrainState, batch, generator: torch.Generator, *,
                   precs=None, layers=None, uniforms=None):
        dev = state.params["wte"].device
        tabs = tables if tables is not None else prec_tables(q, dev)
        train = trainable_paths(state.params)
        paths = train + [("wpe",), ("wte",)]
        live = optim.replace_leaves(state.params, {
            p: optim.get_leaf(state.params, p).detach().requires_grad_(True)
            for p in paths})
        leaves = [optim.get_leaf(live, p) for p in paths]
        drops = list(uniforms) if uniforms is not None else [generator] * accum

        # micro-step 0: the teacher (QA loss, and the cache)
        out = forward(live, batch, teacher_slot, drops[0], tabs)
        t_loss = out["loss"] / accum
        grads = list(torch.autograd.grad(t_loss, leaves, materialize_grads=True))
        teacher = QATeacherOutputs(out["start_logits"].detach(),
                                   out["end_logits"].detach(),
                                   out["hidden_states"].detach())
        del out

        gdev = generator.device
        if precs is None:
            pick = torch.randint(len(student_slots), (n_students,),
                                 generator=generator, device=gdev)
            precs = torch.as_tensor(student_slots, device=gdev)[pick]
        if layers is None:
            layers = torch.randint(n_layers, (n_students,), generator=generator,
                                   device=gdev)
        precs = torch.as_tensor(precs, dtype=torch.int32)
        s_sum = torch.zeros((), device=dev)
        for i, (prec, layer) in enumerate(zip(precs.tolist(),
                                              torch.as_tensor(layers).tolist())):
            out = forward(live, batch, prec, drops[i + 1], tabs)
            distill = qa_distillation_loss(
                out, teacher, layer, alpha_kl=tcfg.distill_alpha_kl,
                alpha_feature=tcfg.distill_alpha_feature,
                temperature=tcfg.distill_temperature,
                accumulative=tcfg.distill_accumulative)
            loss = (out["loss"] + distill) / accum
            del out
            for acc, g in zip(grads, torch.autograd.grad(loss, leaves,
                                                         materialize_grads=True)):
                acc.add_(g)
            s_sum = s_sum + loss.detach()

        lr = schedule(state.step)
        params, opt_state = optim.clip_adamw_update(
            state.params, dict(zip(train, grads[: len(train)])), state.opt_state, lr,
            max_norm=tcfg.max_grad_norm, b1=tcfg.adam_b1, b2=tcfg.adam_b2,
            eps=tcfg.adam_epsilon, weight_decay=tcfg.weight_decay)
        t_loss = t_loss.detach()
        metrics = {"loss": t_loss + s_sum, "teacher_loss": t_loss * accum,
                   "grad_norm": optim.global_norm(grads), "lr": lr,
                   "precisions": precs}
        return QATrainState(params, opt_state, state.step + 1), metrics

    return init_state, train_step
