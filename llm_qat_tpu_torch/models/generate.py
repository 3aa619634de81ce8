"""Sampling filters (counterpart of `llm_qat_tpu/models/generate.py::_filter_logits`).

The KV-cache `generate` and `forward_with_cache` of the JAX module come
with the generation/serving slice; the engine's sampling uses only the
filters below.
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
