"""GPipe pipeline parallelism over a `pipe` mesh dimension.

Counterpart of `llm_qat_tpu/parallel/pipeline.py`. The SP blocks are
stacked on a leading layer axis, so pipeline parallelism shards that axis
over "pipe" (L/S contiguous blocks a stage), splits the batch into M
microbatches and runs the GPipe schedule over M + S - 1 ticks: at tick t
stage 0 takes microbatch t, every other stage takes what the previous
stage sent it (`_comm.rotate`), each stage applies its blocks, and the
last stage keeps microbatch t - (S - 1). A masked sum then gives every
stage the outputs (`_comm.sum_to_replicated`). The embeddings, ln_f and the
tied head run replicated, as they run outside JAX's `shard_map`.

The schedule is one `autograd.Function`, `_GPipe`. Its forward records
each tick's local graph; its backward walks the ticks in reverse, rotating
the cotangents the other way, so every stage runs the same collectives in
the same order whatever autograd would schedule. Bubble ticks compute
nothing and send zeros (JAX computes them and masks the result, which
gets no cotangent). The block banks' gradients come back with their
placements (sharded over "pipe"); the embeddings' gradient, which only
stage 0 computes, is summed over the stages, as JAX's transpose of a
replicated `shard_map` input sums it.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, Dict, NamedTuple, Optional

import torch
from ..models.sp_model import (PrecTables, _unstack, dropout_uniforms, embed_tokens,
                               lm_cross_entropy, prec_tables, sp_block,
                               switchable_layernorm, torch_dtype)
from ..ops.matmul import matmul_bf16
from ..ops.sharded import is_dtensor, replicating
from ..train import optim
from . import _comm
from .mesh import _distribute, _map_with_keys, placements


def pp_param_specs(params, mesh_dims=("pipe",), axis_name: str = "pipe") -> Any:
    """Placements over a mesh with dimensions `mesh_dims`: every `blocks`
    leaf (a leading n_layer axis) shards that axis over `axis_name`, so a
    stage holds only its blocks' weights, quantizer banks, LoRA and LN
    banks; the embeddings and ln_f are replicated."""
    return _map_with_keys(params, lambda keys, x: placements(
        (axis_name,) if keys[0] == "blocks" else (None,), mesh_dims))


def shard_params_pp(params, mesh, axis_name: str = "pipe"):
    """(the params as DTensors with this stage's L/S blocks, placements)."""
    specs = pp_param_specs(params, mesh.mesh_dim_names, axis_name)
    return _distribute(params, specs, mesh), specs


class _Schedule(NamedTuple):
    """What `_GPipe` needs besides tensors."""
    keys: list          # the block leaves' paths, in `leaves` order
    n_local: int        # blocks a stage
    prec: int
    tables: Any
    cfg: Any
    calibration_mode: bool
    group: Any          # the `pipe` dimension's process group
    S: int
    stage: int
    M: int
    data_group: Any     # the batch dimension's group (DP x PP), or None
    rows: slice         # this rank's rows of each microbatch
    collect_hidden: bool
    need_graph: bool    # record each tick's graph for the backward


def _stage_fn(x, blocks, sch: _Schedule):
    """This stage's blocks on x; also each block's input."""
    hs = []
    for bp in _unstack(blocks, sch.n_local):
        hs.append(x)
        x = sp_block(x, bp, sch.prec, sch.tables, sch.cfg,
                     calibration_mode=sch.calibration_mode)[0]
    return x, hs


def _tree(keys, leaves):
    tree = {}
    for path, leaf in zip(keys, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


class _GPipe(torch.autograd.Function):
    """(this stage's microbatch outputs, zeros except on the last stage;
    the gathered per-block input states, or an empty tensor)."""

    @staticmethod
    def forward(ctx, x_mb, sch: _Schedule, *leaves):
        S, stage, M = sch.S, sch.stage, sch.M
        rows_total = x_mb.shape[1]
        live = [l.detach().requires_grad_(l.requires_grad) for l in leaves]
        blocks = _tree(sch.keys, live)
        n_ticks = M + S - 1
        x_mb = x_mb[:, sch.rows]  # this rank's rows of each microbatch (DP)
        state = torch.zeros_like(x_mb[0])
        outputs = torch.zeros_like(x_mb)
        hidden = (x_mb.new_zeros((M, sch.n_local) + x_mb.shape[1:])
                  if sch.collect_hidden else x_mb.new_zeros((0,)))
        ticks = {}
        for t in range(n_ticks):
            mb = t - stage
            send = state.new_zeros(state.shape)
            if 0 <= mb < M:
                x = (x_mb[mb] if stage == 0 else state).detach()
                x.requires_grad_(sch.need_graph)
                with torch.set_grad_enabled(sch.need_graph):
                    y, hs = _stage_fn(x, blocks, sch)
                if sch.collect_hidden:
                    hidden[mb] = torch.stack(hs).detach()
                if stage == S - 1:
                    outputs[mb] = y.detach()
                if sch.need_graph:
                    ticks[t] = (x, y)
                send = y.detach()
            if t + 1 < n_ticks:
                state = _comm.rotate(send, sch.group, 1)
        if sch.collect_hidden:
            hidden = _comm.all_gather_cat(hidden, sch.group, 1)
            if sch.data_group is not None:
                hidden = _comm.all_gather_cat(hidden, sch.data_group, 2)
        ctx.sch, ctx.ticks, ctx.live, ctx.rows_total = sch, ticks, live, rows_total
        ctx.mark_non_differentiable(hidden)
        return outputs, hidden

    @staticmethod
    def backward(ctx, g_out, _g_hidden):
        sch, ticks, live = ctx.sch, ctx.ticks, ctx.live
        S, stage, M = sch.S, sch.stage, sch.M
        need = [i for i, l in enumerate(live) if l.requires_grad]
        grads = [None] * len(live)
        g_x_mb = (g_out.new_zeros((M, ctx.rows_total) + g_out.shape[2:])
                  if ctx.needs_input_grad[0] else None)
        n_ticks = M + S - 1
        g_state = torch.zeros_like(g_out[0])  # cotangent of the next tick's x
        for t in reversed(range(n_ticks)):
            g_y = (_comm.rotate(g_state, sch.group, -1) if t + 1 < n_ticks
                   else torch.zeros_like(g_state))
            g_state = torch.zeros_like(g_state)
            if t not in ticks:
                continue
            mb = t - stage
            if stage == S - 1:
                g_y = g_y + g_out[mb]
            x, y = ticks.pop(t)
            got = torch.autograd.grad(y, [x] + [live[i] for i in need], g_y,
                                      allow_unused=True)
            for i, g in zip(need, got[1:]):
                if g is not None:
                    grads[i] = g if grads[i] is None else grads[i] + g
            g_x = got[0] if got[0] is not None else torch.zeros_like(g_state)
            if stage == 0:
                if g_x_mb is not None:
                    g_x_mb[mb, sch.rows] = g_x
            else:
                g_state = g_x
        if g_x_mb is not None:  # every rank's copy gets stage 0's rows
            _comm.all_reduce_(g_x_mb, sch.group)
            if sch.data_group is not None:
                _comm.all_reduce_(g_x_mb, sch.data_group)
        grads = [torch.zeros_like(live[i]) if grads[i] is None and i in need
                 else grads[i] for i in range(len(live))]
        if sch.data_group is not None:  # each data rank saw its own rows
            for i in need:
                _comm.all_reduce_(grads[i], sch.data_group)
        return (g_x_mb, None, *grads)


def _local_params(params, mesh, axis_name, stage, n_local):
    """Plain tensors: this stage's blocks, the rest whole. DTensor leaves go
    through `to_local` (gradients come back as DTensors); plain block
    banks are sliced to this stage's layers."""
    pp = pp_param_specs(params, mesh.mesh_dim_names, axis_name)

    def local(keys, leaf):
        spec = pp
        for k in keys:
            spec = spec[k]
        if is_dtensor(leaf):
            return leaf.redistribute(mesh, spec).to_local()
        if keys[0] == "blocks":
            return leaf[stage * n_local:(stage + 1) * n_local]
        return leaf

    return _map_with_keys(params, local)


def pipeline_sp_forward(params, input_ids, prec, cfg, mesh, *,
                        n_microbatches: Optional[int] = None,
                        tables: Optional[PrecTables] = None, labels=None,
                        axis_name: str = "pipe",
                        batch_axis_name: Optional[str] = None,
                        calibration_mode: bool = False,
                        deterministic: bool = True, dropout_gen=None,
                        output_hidden_states: bool = False) -> Dict[str, Any]:
    """SP GPT-2 forward with the blocks pipeline-parallel over `axis_name`.

    `sp_forward`'s training path: embeddings (with the dropout drawn from
    `dropout_gen` as `sp_forward` draws it, when not `deterministic`), the
    pipelined blocks, ln_f, the tied head, and the shifted CE when `labels`
    are given. `output_hidden_states` returns `sp_forward`'s detached (L+1,
    B, T, d) stack, gathered from the stages, which is what the
    distillation step reads (`make_pp_sp_train_step`). Masks, `remat`,
    `collect_stats` and `attention_fn` are not taken (a TypeError).

    n_layer must divide into the stages and the batch into
    `n_microbatches` (default: one per stage). `batch_axis_name` also
    shards each microbatch's rows over that dimension (DP x PP); other
    mesh dimensions larger than 1 replicate the work (a warning).
    """
    group, S, stage = _comm.group_of(mesh, axis_name)
    m = cfg.model
    L = m.n_layer
    if L % S != 0:
        raise ValueError(f"n_layer={L} not divisible by {S} pipeline stages")
    M = n_microbatches if n_microbatches is not None else S
    if M < 1:
        raise ValueError(f"n_microbatches must be >= 1, got {M}")
    if is_dtensor(input_ids):
        input_ids = input_ids.full_tensor()
    B, T = input_ids.shape
    if B % M != 0:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    extra = [a for a in mesh.mesh_dim_names
             if a != axis_name and mesh.size(mesh.mesh_dim_names.index(a)) > 1]
    if batch_axis_name is None and extra:
        warnings.warn(
            f"mesh has non-pipe axes {extra} but batch_axis_name is None: "
            "activations replicate over them and every device along those "
            "axes redundantly computes the full batch; pass batch_axis_name "
            "to shard the microbatch batch dim", stacklevel=2)
    if tables is None:
        tables = prec_tables(cfg.quant, mesh.device_type)
    if is_dtensor(labels):
        labels = labels.full_tensor()
    prec = int(prec)
    n_local = L // S
    p = _local_params(params, mesh, axis_name, stage, n_local)

    h = embed_tokens(p["wte"], input_ids) + p["wpe"][:T][None]
    if not deterministic and m.embd_pdrop > 0.0:
        keep = 1.0 - m.embd_pdrop
        drop = dropout_uniforms(dropout_gen, h.shape, h.device) < keep
        h = torch.where(drop, h / keep, torch.zeros_like(h))
    h_mb = h.reshape(M, B // M, T, m.n_embd)

    data_group, rows = None, slice(None)
    if batch_axis_name is not None:
        data_group, n_data, d_idx = _comm.group_of(mesh, batch_axis_name)
        b = B // M
        if b % n_data:
            raise ValueError(f"microbatch of {b} rows not divisible by the "
                             f"{n_data} ranks of {batch_axis_name!r}")
        rows = slice(d_idx * (b // n_data), (d_idx + 1) * (b // n_data))

    keys = [k for k, _ in optim.leaves_with_paths(p["blocks"])]
    leaves = [optim.get_leaf(p["blocks"], k) for k in keys]
    sch = _Schedule(keys=keys, n_local=n_local, prec=prec, tables=tables,
                    cfg=cfg, calibration_mode=calibration_mode, group=group,
                    S=S, stage=stage, M=M, data_group=data_group, rows=rows,
                    collect_hidden=output_hidden_states,
                    need_graph=torch.is_grad_enabled() and (
                        h_mb.requires_grad or any(l.requires_grad for l in leaves)))
    out_mb, hid = _GPipe.apply(h_mb, sch, *leaves)
    out_mb = _comm.sum_to_replicated(out_mb, group)
    if data_group is not None:
        out_mb = _comm.gather_to_replicated(out_mb, data_group, 1)

    h = out_mb.reshape(B, T, m.n_embd)
    h = switchable_layernorm(h, p["ln_f"], prec, m.layer_norm_epsilon)
    # the head as `sp_forward` computes it (operands in compute_dtype), so
    # the pipelined step replays the unsharded one at every compute dtype
    logits = matmul_bf16(h, p["wte"].T, torch_dtype(cfg.compute_dtype))
    out = {"logits": logits, "trunk": h}
    if output_hidden_states:
        hid = hid.permute(1, 0, 2, 3, 4).reshape(L, B, T, m.n_embd)
        out["hidden_states"] = torch.cat([hid, h.detach()[None]], dim=0)
    if labels is not None:
        out["loss"] = lm_cross_entropy(logits, labels)
    return out


def make_pp_sp_train_step(cfg, tcfg, mesh, *, tables: Optional[PrecTables] = None,
                          n_microbatches: Optional[int] = None,
                          axis_name: str = "pipe",
                          batch_axis_name: Optional[str] = None):
    """The SP multi-precision distillation step (`make_sp_train_step`: the
    teacher's CE, the sampled students' KL·T² and feature MSE, gradient
    accumulation) run through the GPipe schedule: (init_state, train_step)
    with `make_sp_train_step`'s signatures."""
    from ..train.sp_trainer import make_sp_train_step

    fwd = functools.partial(pipeline_sp_forward, mesh=mesh,
                            n_microbatches=n_microbatches, axis_name=axis_name,
                            batch_axis_name=batch_axis_name)
    return make_sp_train_step(cfg, tcfg, tables, forward_fn=fwd)


def make_pp_train_step(cfg, tcfg, mesh, *, tables: Optional[PrecTables] = None,
                       n_microbatches: Optional[int] = None,
                       axis_name: str = "pipe",
                       batch_axis_name: Optional[str] = None):
    """Single-precision CE training through the GPipe schedule:
    (init_state, train_step) with `train_step(state, ids, prec)` returning
    (state, {"loss", "grad_norm"}).

    As JAX's `optax.multi_transform`: the gradients of every leaf are
    taken, the trainable ones (`trainable_mask`) are clipped to
    `max_grad_norm` by their global norm and updated by AdamW at
    `learning_rate` with optax's `adamw` defaults (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4), the frozen ones are left as they are, and
    `grad_norm` is the global norm of all the gradients.
    """
    from ..train.sp_trainer import trainable_paths

    def init_state(params):
        return params, optim.adamw_init(params, trainable_paths(params))

    @replicating
    def train_step(state, ids, prec):
        params, opt_state = state
        tabs = tables if tables is not None else prec_tables(cfg.quant, mesh.device_type)
        paths = [k for k, v in optim.leaves_with_paths(params)
                 if torch.is_floating_point(v)]
        live = optim.replace_leaves(params, {
            k: optim.get_leaf(params, k).detach().requires_grad_(True) for k in paths})
        loss = pipeline_sp_forward(
            live, ids, prec, cfg, mesh, labels=ids, tables=tabs,
            n_microbatches=n_microbatches, axis_name=axis_name,
            batch_axis_name=batch_axis_name)["loss"]
        grads = torch.autograd.grad(loss, [optim.get_leaf(live, k) for k in paths],
                                    allow_unused=True, materialize_grads=True)
        grad_map = dict(zip(paths, grads))
        train = trainable_paths(params)
        params, opt_state = optim.clip_adamw_update(
            params, {k: grad_map[k] for k in train}, opt_state, tcfg.learning_rate,
            max_norm=tcfg.max_grad_norm, b1=0.9, b2=0.999, eps=1e-8,
            weight_decay=1e-4)
        return (params, opt_state), {"loss": loss.detach(),
                                     "grad_norm": optim.global_norm(grads)}

    return init_state, train_step
