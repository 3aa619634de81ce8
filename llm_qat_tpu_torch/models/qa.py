"""Switchable-precision extractive QA model (SQuAD).

Counterpart of `llm_qat_tpu/models/qa.py`: the SP transformer trunk, a
dropout of 0.1 and two Linear(n_embd, 1) heads (start/end, N(0, 0.02²)
init) on the live ln_f output; QA loss = mean of the start and end CE with
positions of -1 ignored. Forward returns {loss?, start_logits, end_logits,
hidden_states?}.

The QA dropout mask comes from the same uniforms as the trunk's embedding
dropout (JAX draws both with one key over one (B, T, d) shape): the
uniforms are drawn once from `dropout_gen`, or given as a tensor, and
handed to `sp_forward`. The tied LM head is never computed: nothing reads
its logits.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .config import SPModelConfig
from .sp_model import PrecTables, dropout_uniforms, init_sp_params, prec_tables, sp_forward

QA_KEEP = 0.9  # qa_dropout(0.1)


def init_qa_params(gen: torch.Generator, cfg: SPModelConfig,
                   device=None) -> Dict[str, Any]:
    """`init_sp_params` plus the two heads, from a `torch.Generator`."""
    params = init_sp_params(gen, cfg, device)
    dev = params["wte"].device
    d = cfg.model.n_embd
    for name in ("qa_start", "qa_end"):
        params[name] = {
            "w": 0.02 * torch.randn((d, 1), generator=gen, device=dev),
            "b": torch.zeros((1,), device=dev),
        }
    return params


def qa_loss_fn(start_logits, end_logits, start_positions, end_positions):
    """Mean of the start/end CE over positions >= 0 (-1 is ignored)."""

    def ce(logits, positions):
        valid = positions >= 0
        safe = torch.where(valid, positions, torch.zeros_like(positions))
        logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        nll = -torch.gather(logp, -1, safe[:, None].long())[:, 0]
        nll = torch.where(valid, nll, torch.zeros_like(nll))
        return nll.sum() / torch.clamp(valid.sum(), min=1)

    return (ce(start_logits, start_positions) + ce(end_logits, end_positions)) / 2.0


def qa_forward(params, input_ids, prec, cfg: SPModelConfig, *,
               tables: Optional[PrecTables] = None, attention_mask=None,
               start_positions=None, end_positions=None,
               deterministic: bool = True, dropout_gen=None,
               calibration_mode: bool = False, collect_stats: bool = False,
               input_passthrough: bool = False,
               output_hidden_states: bool = False):
    """QA forward over `sp_forward(mask=attention_mask)`; the heads read its
    `trunk`. With `deterministic=False` and a `dropout_gen` (a generator, or
    the (B, T, n_embd) uniforms), the embedding dropout and the QA dropout
    share the uniforms. `hidden_states` are detached."""
    if tables is None:
        tables = prec_tables(cfg.quant, params["wte"].device)
    drop = not deterministic and dropout_gen is not None
    u = None
    if drop:
        B, T = input_ids.shape
        u = dropout_uniforms(dropout_gen, (B, T, cfg.model.n_embd),
                             params["wte"].device)
    out = sp_forward(
        params, input_ids, prec, cfg, tables=tables, mask=attention_mask,
        deterministic=deterministic, dropout_gen=u,
        calibration_mode=calibration_mode, collect_stats=collect_stats,
        input_passthrough=input_passthrough, output_hidden_states=True,
        _skip_head=True,
    )
    h = out["trunk"]
    if drop:
        h = torch.where(u < QA_KEEP, h / QA_KEEP, torch.zeros_like(h))

    start_logits = (h @ params["qa_start"]["w"] + params["qa_start"]["b"])[..., 0]
    end_logits = (h @ params["qa_end"]["w"] + params["qa_end"]["b"])[..., 0]

    result = {"start_logits": start_logits, "end_logits": end_logits}
    if output_hidden_states:
        result["hidden_states"] = out["hidden_states"]
    if collect_stats:
        result["stats"] = out.get("stats")
    if start_positions is not None and end_positions is not None:
        result["loss"] = qa_loss_fn(start_logits, end_logits,
                                    start_positions, end_positions)
    return result
