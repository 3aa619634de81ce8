"""Device mesh and tensor-parallel placements for SP training and serving.

Counterpart of `llm_qat_tpu/parallel/mesh.py`. Where the JAX package
annotates arrays with `PartitionSpec`s and lets GSPMD insert the
collectives, the port places parameters on a `torch.distributed`
`DeviceMesh` with dimensions ("data", "model") as DTensors, and DTensor's
sharding propagation inserts them. Every leaf's placements are a tuple with
one entry per mesh dimension, `Replicate()` or `Shard(d)`.

TP layout (Megatron's, adapted to the quantized banks), as in JAX:
- c_attn / c_fc are column-parallel: the (L, in, out) weight shards `out`
  on "model", and so do the bias, LoRA B and the per-channel
  weight-quantizer bank (L, P, out), which must shard with its channels;
- attn_proj / mlp_proj are row-parallel: the weight shards `in` (the
  contraction then sums over "model"), and so do LoRA A and the
  per-channel input-quantizer bank (L, P, in);
- wte shards the vocabulary on "model" (a vocab-parallel head); wpe and
  the LayerNorm banks are replicated.
Nothing shards over "data": that dimension carries the batch
(`batch_sharding`).
"""

from __future__ import annotations

import os
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ..device import resolve_device

MESH_DIMS = ("data", "model")


def _init_default_group(device_type: str) -> None:
    """Initialise the default process group if there is none: NCCL for
    CUDA, gloo for the CPU. With WORLD_SIZE in the environment it reads
    torch's env:// variables (MASTER_ADDR, MASTER_PORT, RANK); else it is a
    group of one process."""
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              devices: Optional[Sequence[int]] = None, *, device=None) -> DeviceMesh:
    """A (data, model) `DeviceMesh` over the ranks `devices` (default: every
    rank of the default group, which is initialised if there is none).

    Defaults as in JAX: every rank on "data" unless told otherwise. For a
    single rank both dimensions are 1 and the placements change nothing,
    so the same code runs everywhere. `device` is the device type: the
    card by default (`resolve_device`: it raises without one), "cpu" for
    gloo.
    """
    dev = resolve_device(device)
    _init_default_group(dev.type)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    if n_data is None and n_model is None:
        n_data, n_model = n, 1
    elif n_data is None:
        n_data = n // n_model
    elif n_model is None:
        n_model = n // n_data
    if n_data * n_model != n:
        raise ValueError(f"{n_data}x{n_model} != {n} ranks")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(n_data, n_model)
    return DeviceMesh(dev.type, mesh, mesh_dim_names=MESH_DIMS)


# Column-parallel linears shard the out axis; the others (attn_proj,
# mlp_proj) are row-parallel and shard the in axis.
_COL_LINEAR = {"c_attn", "c_fc"}

# A spec names, per tensor dimension, the mesh dimension it shards over
# (None: not sharded), as a JAX PartitionSpec does; `placements` turns it
# into one placement per mesh dimension.
Spec = Tuple[Optional[str], ...]
_REP: Spec = (None,)


def placements(spec: Spec, mesh_dims: Sequence[str] = MESH_DIMS) -> tuple:
    """One placement per mesh dimension: Shard(d) where the spec's tensor
    dimension d names it, Replicate() elsewhere."""
    out = []
    for name in mesh_dims:
        dims = [d for d, s in enumerate(spec) if s == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _linear_spec(linear_name: str, leaf_name: str, per_channel: bool) -> Spec:
    col = linear_name in _COL_LINEAR
    if leaf_name == "w":  # (L, in, out)
        return (None, None, "model") if col else (None, "model", None)
    if leaf_name == "b":  # (L, out)
        return (None, "model") if col else _REP
    if leaf_name in ("wq_scale", "wq_zp"):  # (L, P, out-ch) or (L, P, 1)
        return (None, None, "model") if per_channel and col else _REP
    if leaf_name in ("iq_scale", "iq_zp"):  # (L, P, in-ch) or (L, P, 1)
        return (None, None, "model") if per_channel and not col else _REP
    if leaf_name == "lora_A":  # (L, P, in, r)
        return _REP if col else (None, None, "model", None)
    if leaf_name == "lora_B":  # (L, P, r, out)
        return (None, None, None, "model") if col else _REP
    return _REP


def _map_with_keys(tree, fn, keys=()):
    if isinstance(tree, dict):
        return {k: _map_with_keys(v, fn, keys + (k,)) for k, v in tree.items()}
    return fn(keys, tree)


def _sp_spec(keys, leaf, per_channel) -> Spec:
    if keys[0] == "wte":
        return ("model", None)
    if keys[0] == "blocks" and len(keys) >= 3:
        return _linear_spec(keys[1], keys[2], per_channel)
    return _REP  # wpe, ln_f and the blocks' LayerNorm banks


def sp_param_specs(params, per_channel: bool = True) -> Any:
    """Placements ((data, model) mesh) for every leaf of an SP params tree;
    the same tree shape."""
    return _map_with_keys(params, lambda k, x: placements(_sp_spec(k, x, per_channel)))


def _distribute(tree, specs, mesh):
    def put(keys, leaf):
        spec = specs
        for k in keys:
            spec = spec[k]
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return distribute_tensor(leaf.to(mesh.device_type), mesh, spec)

    return _map_with_keys(tree, put)


def shard_params(params, mesh: DeviceMesh, per_channel: bool = True):
    """(the params as DTensors with TP placements, their placements)."""
    specs = sp_param_specs(params, per_channel)
    return _distribute(params, specs, mesh), specs


def _infer_linear_spec(linear_name: str, leaf_name: str) -> Spec:
    """One linear of the serving tree (`quantize_for_inference`): the same
    Megatron layout as `_linear_spec` over the serving leaves (int8 codes
    with per-out-channel scales, factored or folded LoRA, static
    activation scales)."""
    col = linear_name in _COL_LINEAR
    if leaf_name in ("w_q", "w_i8", "w_int8", "lora_AB"):  # (L, in, out)
        return (None, None, "model") if col else (None, "model", None)
    if leaf_name in ("b", "w_s"):  # (L, out); w_s also (L,)/(L, 1)
        return (None, "model") if col else _REP
    if leaf_name in ("iq_scale", "iq_zp"):  # (L, in) or (L,)
        return (None, "model") if not col else _REP
    if leaf_name == "lora_A":  # (L, in, r)
        return _REP if col else (None, "model", None)
    if leaf_name == "lora_B":  # (L, r, out)
        return (None, None, "model") if col else _REP
    return _REP  # x_s and the other per-layer scalars


def _infer_spec(keys, leaf) -> Spec:
    if leaf.ndim == 0:  # _bits / _kind
        return ()
    if keys[0] in ("wte", "head_i8"):  # (V, d): vocab-parallel head
        return ("model", None)
    if keys[0] == "head_s":  # (V,)
        return ("model",)
    if keys[0] == "blocks" and len(keys) >= 3:
        spec = _infer_linear_spec(keys[1], keys[2])
        # per-tensor scale vectors are (L,) or (L, 1): replicated by shape
        if len(spec) > leaf.ndim or (leaf.ndim >= 2 and leaf.shape[-1] == 1):
            return _REP
        return spec
    return _REP


def infer_param_specs(iparams, per_channel: bool = True) -> Any:
    """Placements ((data, model) mesh) for a `quantize_for_inference` tree
    (TP decode): the int8 codes column- or row-parallel with their scale
    vectors on the same channel axis, per-tensor leaves replicated by their
    shape. `per_channel` is not read, as in JAX: the shapes decide. Leaves
    that are not tensors (the `_static` metadata) keep their value."""
    del per_channel
    return _map_with_keys(iparams, lambda k, x: placements(_infer_spec(k, x))
                          if isinstance(x, torch.Tensor) else x)


def shard_infer_params(iparams, mesh: DeviceMesh, per_channel: bool = True):
    """(the serving tree as DTensors with TP placements, their placements)."""
    specs = infer_param_specs(iparams, per_channel)
    return _distribute(iparams, specs, mesh), specs


def kv_cache_sharding(mesh: DeviceMesh) -> tuple:
    """KV caches (B, H, T, D), or packed (B, H, T/P, P·D): batch over
    "data", heads over "model", so each rank holds its heads' cache and
    attention stays local."""
    return placements(("data", "model", None, None), mesh.mesh_dim_names)


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Input batch (B, T): rows over "data"."""
    return placements(("data", None), mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> tuple:
    return tuple(Replicate() for _ in mesh.mesh_dim_names)
