"""DTensor at the edges of the port's code: implicit replication and the
kernel boundary.

The parallel layer (`llm_qat_tpu_torch.parallel`) places parameters and
activations on a `DeviceMesh` as DTensors, and the port's model code runs
on them unchanged, as GSPMD runs the JAX package's. Two things need help:
- tensors made inside a forward (causal masks, positions, precision
  tables, dropout uniforms) are plain tensors, the same on every rank;
  `replication_scope` lets DTensor treat them as replicated;
- a kernel wrapper passes raw pointers to its kernel, and a DTensor has no
  storage of its own; `local_call` hands the kernel the local shards.

Plain tensors go straight through both, so the single-device path is
unchanged. Nothing here imports `torch.distributed` until a DTensor is met.
"""

from __future__ import annotations

import contextlib
import functools


def is_dtensor(t) -> bool:
    if not type(t).__name__ == "DTensor":
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def any_dtensor(tree) -> bool:
    """True when a DTensor is among the leaves of nested dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(any_dtensor(v) for v in tree)
    return is_dtensor(tree)


@contextlib.contextmanager
def replication_scope(*trees):
    """Inside, DTensor ops treat plain tensors as replicated, when a DTensor
    is among `trees`' leaves (else a no-op). Re-entrant: an inner scope
    leaves the outer one's setting as it found it, so a train step can hold
    one around its forwards and their backwards."""
    if not any_dtensor(trees):
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    if getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False):
        yield
        return
    with implicit_replication():
        yield


def replicating(fn):
    """`fn` run inside `replication_scope` of its arguments."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with replication_scope(args, kwargs):
            return fn(*args, **kwargs)

    return run


def local_call(fn, tensors, local_dims=()):
    """fn(*tensors) for a kernel wrapper that takes plain tensors.

    Without a DTensor among `tensors` this is fn(*tensors). Otherwise every
    operand is redistributed to one set of placements: the first DTensor's
    shards on `local_dims` stay (attention is local along batch and heads),
    everything else is replicated (a plain operand counts as replicated);
    fn runs on the local shards, so the kernel launches on them, and its
    output (one tensor) comes back as a DTensor with those placements.
    Differentiable: the redistributions and the wrapping carry gradients.
    """
    if not any(is_dtensor(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    lead = next(t for t in tensors if is_dtensor(t))
    mesh = lead.device_mesh
    target = [p if isinstance(p, Shard) and p.dim in local_dims else Replicate()
              for p in lead.placements]
    local = []
    for t in tensors:
        if not is_dtensor(t):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
        local.append(t.redistribute(mesh, target).to_local())
    out = fn(*local)
    if all(isinstance(p, Replicate) for p in target):
        return DTensor.from_local(out, mesh, target, run_check=False)
    if out.shape != local[0].shape:
        raise ValueError("local_call: a sharded call must return its first "
                         "operand's shape")
    return DTensor.from_local(out, mesh, target, run_check=False,
                              shape=lead.shape, stride=contiguous_stride(lead.shape))


def contiguous_stride(shape):
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def rows_split(x, *weights) -> bool:
    """True for a DTensor x sharded on a leading dimension past the first
    (the sequence of (B, T, d) activations under context parallelism),
    nowhere on its last, and never partial, with every weight replicated
    (plain, or a DTensor replicated everywhere). A product over x's last
    dimension then runs row by row on the local shards (`rows_local`):
    DTensor's matmul flattens (B, T), which a sequence shard forbids."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(x) or x.ndim < 3:
        return False
    if not all(isinstance(p, Replicate) or (isinstance(p, Shard) and p.dim < x.ndim - 1)
               for p in x.placements):
        return False
    if not any(isinstance(p, Shard) and p.dim >= 1 for p in x.placements):
        return False
    return all(not is_dtensor(w) or all(isinstance(p, Replicate) for p in w.placements)
               for w in weights)


def rows_local(fn, x, *weights):
    """fn(x, *weights) for an fn whose output rows each depend on the same
    row of x alone (a product over x's last dimension), on the local rows
    of a DTensor x (`rows_split`): the weights are used whole on every
    rank, and their gradients, each rank's sum over its own rows, are summed
    over the mesh dimensions that shard x. The output keeps x's placements."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    grads = [Partial() if isinstance(p, Shard) else Replicate() for p in x.placements]
    local = []
    for w in weights:
        if not is_dtensor(w):
            w = DTensor.from_local(w, mesh, rep, run_check=False)
        local.append(w.to_local(grad_placements=grads))
    out = fn(x.to_local(), *local)
    shape = tuple(x.shape[:-1]) + tuple(out.shape[-1:])
    return DTensor.from_local(out, mesh, x.placements, run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def gather_dim(t, dim: int):
    """A DTensor sharded on `dim` redistributed to replicated there (the
    shifted LM losses slice the sequence, which a sequence shard forbids);
    anything else as it is."""
    from torch.distributed.tensor import Replicate, Shard

    if not is_dtensor(t) or not any(isinstance(p, Shard) and p.dim == dim
                                    for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Shard) and p.dim == dim
                                          else p for p in t.placements])
