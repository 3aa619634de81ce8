"""Collectives over one mesh dimension, with the transposes autograd needs.

The JAX package gets these from `lax.ppermute` and `lax.psum` inside
`shard_map`; here they are explicit `torch.distributed` calls on the
process group of one `DeviceMesh` dimension:
- `ring_shift`: every rank sends to the next rank of the ring and receives
  from the previous one, in one `batch_isend_irecv`; its backward rotates
  the cotangent the other way (ppermute's transpose is the inverse
  permutation);
- `sum_to_replicated`: a sum over the group whose result every rank then
  uses in the same replicated computation (the pipeline's masked psum); its
  backward is the identity, since each rank already holds the whole
  cotangent of that computation;
- `gather_to_replicated`: the same for a concatenation (the pipeline's
  data-parallel microbatch rows); its backward takes this rank's part;
- `rotate`, `all_gather_cat` and `all_reduce_`, without autograd, for code
  that runs its own backward.

P2P ops address global ranks (`dist.get_global_rank`). With one rank in
the group a rotation is the identity (NCCL cannot send to itself, and JAX's
ppermute over `[(0, 0)]` is the identity too), and a sum is the tensor.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def group_of(mesh, axis_name: str):
    """(process group, size, this rank's index) of one mesh dimension."""
    group = mesh.get_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def rotate(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """x from rank i goes to rank i + shift of the group's ring; returns
    what rank i - shift sent. Not differentiable."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    i = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    to = dist.get_global_rank(group, (i + shift) % n)
    frm = dist.get_global_rank(group, (i - shift) % n)
    ops = [dist.P2POp(dist.isend, x, to, group), dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return rotate(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return rotate(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable rotation by one step of the group's ring."""
    return _RingShift.apply(x, group)


class _SumToReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        if dist.get_world_size(group) == 1:
            return x.clone()
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_to_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group, on every rank. The backward passes the
    cotangent through unchanged: the caller feeds the sum into a
    computation that every rank runs alike, so each rank's cotangent is
    already the whole one."""
    return _SumToReplicated.apply(x, group)


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        return all_gather_cat(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.n, ctx.n), None, None


def gather_to_replicated(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, on every rank. Like
    `sum_to_replicated` it feeds a computation that every rank runs alike,
    so the backward takes this rank's part of the cotangent and sends
    nothing."""
    return _GatherReplicated.apply(x, group, dim)


def all_gather_cat(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The group's tensors concatenated along `dim` in rank order. Not
    differentiable."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(x: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of x over the group. Not differentiable."""
    if dist.get_world_size(group) > 1:
        dist.all_reduce(x, group=group)
    return x
