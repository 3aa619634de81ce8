"""Multi-device parallelism on `torch.distributed`: the (data, model) mesh
with DTensor TP/DP placements, ring-attention context parallelism, GPipe
pipeline parallelism and the multi-process helpers."""

from .mesh import (
    batch_sharding,
    infer_param_specs,
    kv_cache_sharding,
    make_mesh,
    replicated,
    shard_infer_params,
    shard_params,
    sp_param_specs,
)
from .multihost import (
    host_local_batch_slice,
    initialize_multihost,
    make_global_batch,
)
from .cp_forward import sp_forward_context_parallel
from .pipeline import (make_pp_sp_train_step, make_pp_train_step,
                       pipeline_sp_forward, pp_param_specs,
                       shard_params_pp)
from .ring_attention import ring_attention

__all__ = [
    "batch_sharding",
    "infer_param_specs",
    "kv_cache_sharding",
    "make_mesh",
    "shard_infer_params",
    "replicated",
    "shard_params",
    "sp_param_specs",
    "make_pp_sp_train_step",
    "make_pp_train_step",
    "pipeline_sp_forward",
    "pp_param_specs",
    "ring_attention",
    "shard_params_pp",
    "sp_forward_context_parallel",
    "host_local_batch_slice",
    "initialize_multihost",
    "make_global_batch",
]
