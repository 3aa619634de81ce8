"""Sampling filters (counterpart of `llm_qat_tpu/models/generate.py`'s
`_filter_logits` and `_filter_logits_vec`).

The KV-cache `generate` and `forward_with_cache` of the JAX module run on
SP parameters rather than the served tree and are not ported yet; the
engines' sampling uses only the filters below.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / top-p filtering (reference semantics).

    Top-k keeps logits >= the k-th largest; top-p keeps the smallest set of
    sorted tokens whose cumulative probability passes `top_p`, the first
    token above the threshold included. Removed entries become -1e30.
    """
    logits = logits / max(float(temperature), 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                           dim=-1)
        thresh = torch.where(remove, torch.full_like(sorted_logits, float("inf")),
                             sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                             logits)
    return logits


def _filter_logits_vec(logits, temperature, top_k, top_p):
    """Per-row temperature / top-k / top-p filtering (the JAX
    `_filter_logits_vec`): each row of `logits` (B, V) has its own
    temperature (B,), top_k (B,) int (0 disables) and top_p (B,) float (1.0
    disables), as continuous batching mixes requests in one step. Top-p acts
    on the top-k-filtered row, as the reference chains the filters."""
    V = logits.shape[-1]
    logits = logits / torch.clamp(temperature[:, None], min=1e-6)
    srt = torch.sort(logits, dim=-1).values  # ascending
    idx = torch.clamp(V - top_k, 0, V - 1).to(torch.int64)
    kth = torch.gather(srt, -1, idx[:, None])
    neg = torch.full_like(logits, NEG_INF)
    logits = torch.where((top_k[:, None] > 0) & (logits < kth), neg, logits)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    remove = cum > top_p[:, None]
    remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]], dim=-1)
    thresh = torch.where(remove, torch.full_like(sorted_desc, float("inf")),
                         sorted_desc).amin(dim=-1, keepdim=True)
    return torch.where((top_p[:, None] < 1.0) & (logits < thresh), neg, logits)
