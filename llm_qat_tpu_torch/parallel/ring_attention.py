"""Ring-attention context parallelism over a mesh dimension.

Counterpart of `llm_qat_tpu/parallel/ring_attention.py`. The sequence axis
is sharded over a mesh dimension: each rank holds a Q/K/V shard, the K/V
shards go round the ring (`_comm.ring_shift`) while an online softmax
builds each query shard's exact causal attention, so a rank's memory for
attention stays O(T/n). The float32 order is the JAX body's: q scaled
before the product, masked scores at -1e30, at step s the resident K/V
from rank (i - s) mod n, the same update order, and acc / max(l, 1e-30)
cast back to q's dtype. Plain tensor products, as the JAX version is plain
`einsum` work; differentiable through the rotation's transpose.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops.sharded import contiguous_stride, is_dtensor
from . import _comm

NEG_INF = -1e30


def _ring_attention_local(q, k, v, group, n: int, idx: int):
    """Per-rank body: q, k, v are (B, H, T_local, D) sequence shards."""
    B, H, Tl, D = q.shape
    f32 = torch.float32
    scale = 1.0 / math.sqrt(D)
    qf = q.to(f32) * scale
    m = torch.full((B, H, Tl, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, H, Tl, 1), dtype=f32, device=q.device)
    acc = torch.zeros((B, H, Tl, D), dtype=f32, device=q.device)
    q_pos = idx * Tl + torch.arange(Tl, device=q.device)
    # K and V travel together: one rotation a step
    kv = torch.stack([k, v])
    for step in range(n):
        src = (idx - step) % n
        k_pos = src * Tl + torch.arange(Tl, device=q.device)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kv[0].to(f32))
        causal = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(causal[None, None], s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, kv[1].to(f32))
        m = m_new
        if step + 1 < n:  # the last rotation's result would go unread
            kv = _comm.ring_shift(kv, group)
    out = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def ring_attention(q, k, v, mesh, axis_name: str = "data"):
    """Causal attention with the sequence axis sharded over `axis_name`.

    q, k, v: (B, H, T, D) with T divisible by the dimension's size. DTensors
    are redistributed to T sharded over `axis_name` (their batch and head
    shards on other dimensions stay), and the result is a DTensor with those
    placements; plain tensors count as replicated, and the result is then
    a plain tensor. Numerically dense causal attention.
    """
    group, n, idx = _comm.group_of(mesh, axis_name)
    T = q.shape[2]
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the {n} ranks "
                         f"of {axis_name!r}")
    dims = mesh.mesh_dim_names
    lead = q if is_dtensor(q) else None
    target = []
    for d, name in enumerate(dims):
        p = lead.placements[d] if lead is not None else Replicate()
        if name == axis_name:
            target.append(Shard(2))
        else:
            target.append(p if isinstance(p, Shard) and p.dim in (0, 1) else Replicate())
    rep = [Replicate()] * len(dims)

    def local(t):
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        return t.redistribute(mesh, target).to_local()

    out = _ring_attention_local(local(q), local(k), local(v), group, n, idx)
    out = DTensor.from_local(out, mesh, target, run_check=False, shape=q.shape,
                             stride=contiguous_stride(q.shape))
    return out if lead is not None else out.full_tensor()
