"""Context-parallel SP forward: the sequence axis sharded over a mesh
dimension.

Counterpart of `llm_qat_tpu/parallel/cp_forward.py`. The ids go in as a
DTensor sharded on T; every position-wise piece of the SP model (LN, the
quantized linears, LoRA, the embeddings) runs on the shards under DTensor's
sharding propagation, and attention, the only op across positions, runs as
`ring_attention`. Two things GSPMD does for JAX come from DTensor here:
`wpe[:T]` takes the global T (a DTensor's shape is the global one), and
the shifted cross-entropy, whose last label of a shard is the next shard's
first token, slices the global logits.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..models.config import SPModelConfig
from ..models.sp_model import PrecTables, prec_tables, sp_forward
from ..ops.sharded import is_dtensor
from .ring_attention import ring_attention


def sp_forward_context_parallel(params, input_ids, prec, cfg: SPModelConfig,
                                mesh, axis_name: str = "data", *,
                                tables: Optional[PrecTables] = None,
                                labels=None):
    """SP forward with the sequence sharded over `axis_name`.

    `input_ids` (B, T), T divisible by the dimension's size, plain or a
    DTensor. Returns `sp_forward`'s dict; the logits are a DTensor (gather
    with `full_tensor()`), the loss is over the global sequence.
    """
    if tables is None:
        tables = prec_tables(cfg.quant, mesh.device_type)
    seq = [Shard(1) if name == axis_name else Replicate()
           for name in mesh.mesh_dim_names]
    if is_dtensor(input_ids):
        ids = input_ids.redistribute(mesh, seq)
    else:
        ids = distribute_tensor(torch.as_tensor(input_ids).to(mesh.device_type), mesh, seq)
    return sp_forward(params, ids, prec, cfg, tables=tables, labels=labels,
                      attention_fn=partial(ring_attention, mesh=mesh,
                                           axis_name=axis_name))

