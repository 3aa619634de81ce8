"""Self-distillation losses for switchable-precision training.

Counterpart of `llm_qat_tpu/train/distillation.py`. The teacher's outputs
for the batch are carried as values (`TeacherOutputs`), so every student
micro-step of an iteration reads the same cache.

- KL term: logits shifted by one (the last position dropped), temperature
  T, `kl_div(student_logp, teacher_logp, log_target=True,
  reduction="batchmean") * T²`, batchmean over B·(T−1) rows. It decomposes
  as Σ p_t·logp_t − Σ p_t·logp_s; the first term is the same for every
  student and is computed once (`prepare_teacher`), the cross term per
  student by `_kl_cross`.
- Feature term: MSE of one hidden layer (or the mean over all of them when
  `accumulative`). The model detaches the hidden states it collects, for
  teacher and student alike, so by default this term adds loss value and no
  gradient.
- total = alpha_kl · kl + alpha_feature · feature; a zero alpha skips its
  term entirely.
- `students_distillation_loss`: the sum of the students' totals over the
  student axis of one batched forward (`student_mode="vmap"`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class _KLCross(torch.autograd.Function):
    """mean over rows of Σ_v p_t · log_softmax(s/T)_v.

    Forward by the identity Σ p_t·(s/T − lse) = (Σ p_t·s)/T − P·lse with
    P = Σ p_t, so log_softmax(s/T) is never formed; backward
    ds = g/(N·T) · (p_t − softmax(s/T)·P), the softmax recomputed from the
    saved (B, T) logsumexp. `p_t` takes no gradient."""

    @staticmethod
    def forward(ctx, s, p_t, temperature):
        st = s / temperature
        lse = torch.logsumexp(st, dim=-1)
        pf = p_t.to(torch.float32)
        P = pf.sum(dim=-1)
        rows = (pf * st).sum(dim=-1) - P * lse
        ctx.save_for_backward(s, p_t, lse, P)
        ctx.temperature = temperature
        return rows.mean()

    @staticmethod
    def backward(ctx, g):
        s, p_t, lse, P = ctx.saved_tensors
        t = ctx.temperature
        q = torch.exp(s / t - lse[..., None])
        ds = (g / (lse.numel() * t)) * (p_t.to(torch.float32) - q * P[..., None])
        return ds.to(s.dtype), None, None


def _kl_cross(s, p_t, temperature: float):
    return _KLCross.apply(s, p_t, temperature)


class TeacherOutputs(NamedTuple):
    """The teacher cache of one batch. `probs` ((B, T−1, V) softmax(t/T) in
    the cache dtype) and `neg_entropy` (mean over rows of Σ p_t·logp_t) are
    filled by `prepare_teacher`, once per train step."""

    logits: torch.Tensor  # (B, T, V)
    hidden_states: torch.Tensor  # (L+1, B, T, d)
    probs: Optional[torch.Tensor] = None
    neg_entropy: Optional[torch.Tensor] = None


def prepare_teacher(logits, hidden_states, temperature: float,
                    cache_dtype=torch.bfloat16) -> TeacherOutputs:
    """Precompute the student-independent pieces of the KL term."""
    t = logits.detach()[:, :-1].to(torch.float32)
    t_logp = torch.log_softmax(t / temperature, dim=-1)
    p_t = torch.exp(t_logp)
    neg_ent = torch.mean(torch.sum(p_t * t_logp, dim=-1))
    return TeacherOutputs(logits=logits, hidden_states=hidden_states,
                          probs=p_t.to(cache_dtype), neg_entropy=neg_ent)


def kl_distillation_loss(student_logits, teacher, temperature: float):
    """Temperature-scaled KL on shifted logits. `teacher` is a prepared
    `TeacherOutputs` (cached-probs path) or raw logits / an unprepared
    `TeacherOutputs` (everything computed inline)."""
    T = temperature
    s = student_logits[:, :-1].to(torch.float32)
    if isinstance(teacher, TeacherOutputs) and teacher.probs is not None:
        return (teacher.neg_entropy - _kl_cross(s, teacher.probs, T)) * (T * T)
    t_raw = teacher.logits if isinstance(teacher, TeacherOutputs) else teacher
    t = t_raw.detach()[:, :-1].to(torch.float32)
    t_logp = torch.log_softmax(t / T, dim=-1)
    p_t = torch.exp(t_logp)
    neg_ent = torch.mean(torch.sum(p_t * t_logp, dim=-1))
    cross = torch.mean(torch.sum(p_t * torch.log_softmax(s / T, dim=-1), dim=-1))
    return (neg_ent - cross) * (T * T)


def feature_distillation_loss(student_hidden, teacher_hidden, layer_idx: int,
                              accumulative: bool = False):
    """Hidden-state MSE at `layer_idx`, or over all layers when
    `accumulative`. The teacher side is detached."""
    t = teacher_hidden.detach()
    if accumulative:
        return torch.mean(torch.square(student_hidden - t))
    return torch.mean(torch.square(student_hidden[layer_idx] - t[layer_idx]))


def distillation_loss(student_logits, student_hidden, teacher: TeacherOutputs,
                      layer_idx: int, *, alpha_kl: float, alpha_feature: float,
                      temperature: float, accumulative: bool = False):
    """Total student loss. A zero alpha skips its term (the KL term alone
    forms two (B, T, vocab) float32 stacks)."""
    total = torch.zeros((), device=student_logits.device)
    if alpha_kl:
        total = total + alpha_kl * kl_distillation_loss(
            student_logits, teacher, temperature)
    if alpha_feature:
        total = total + alpha_feature * feature_distillation_loss(
            student_hidden, teacher.hidden_states, layer_idx, accumulative)
    return total


def students_distillation_loss(student_logits, student_hidden, teacher: TeacherOutputs,
                               layer_idxs, **kw):
    """Sum over the students of `distillation_loss`, student s taking its
    slice of the batched logits (S, B, T, V) and hidden states (S, L+1, B,
    T, d) and its own feature layer `layer_idxs[s]` (`kw`: the
    `distillation_loss` options). `jax.vmap` of the loss, summed."""
    total = torch.zeros((), device=student_logits.device)
    for logits, hidden, layer in zip(student_logits, student_hidden, layer_idxs):
        total = total + distillation_loss(logits, hidden, teacher, int(layer), **kw)
    return total
