"""The rank processes of the port's multi-rank CPU tests.

`tests/test_torch_parallel.py` and `tests/test_torch_parallel_pp.py` start
one process per rank of a gloo group:

    python tests/torch_parallel_ranks.py SUITE IN_FILE OUT_DIR STORE RANK WORLD

Each joins the group through `initialize_multihost` (a FileStore at STORE),
reads the inputs the test computed (numpy arrays and the port's configs,
`torch.save`d to IN_FILE), runs every case of SUITE in order and saves
{case: result or {"error": traceback}} to OUT_DIR/rank<RANK>.pt. The tests
then assert each case's result, so each case counts on its own. `RankRun`
starts them (the tests import it). This file imports neither JAX nor the
JAX package, and pytest does not collect it.
"""

import dataclasses
import os
import subprocess
import sys
import time
import traceback
from functools import partial

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch import parallel as P
from llm_qat_tpu_torch.models.inference import (
    infer_forward_unrolled, init_layer_caches, quantize_for_inference)
from llm_qat_tpu_torch.models.sp_model import prec_tables, sp_forward
from llm_qat_tpu_torch.ops import attention as ta
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train.sp_trainer import make_sp_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class RankRun:
    """SUITE running on `world` rank processes (gloo, one thread each),
    started at once; `results()` waits for them and returns each rank's
    {case: result}. It raises when a rank does not end within `timeout`
    seconds of the start (all are killed then) or fails outside a case."""

    def __init__(self, suite, world, data, out_dir, timeout=300):
        self.suite, self.world, self.out_dir = suite, world, str(out_dir)
        inp = os.path.join(self.out_dir, "in.pt")
        torch.save(data, inp)
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
        env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        self.deadline = time.monotonic() + timeout
        self.errs = [open(os.path.join(self.out_dir, f"rank{r}.err"), "w")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, inp, self.out_dir,
             os.path.join(self.out_dir, "store"), str(r), str(world)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=self.errs[r])
            for r in range(world)]
        self._results = None

    def results(self):
        if self._results is None:
            self._results = self._wait()
        return self._results

    def _wait(self):
        try:
            while any(p.poll() is None for p in self.procs):
                if time.monotonic() > self.deadline:
                    raise TimeoutError(f"{self.suite}: ranks still running at the timeout")
                time.sleep(0.2)
        finally:
            self.close()
        out = []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.out_dir, f"rank{r}.pt")
            if p.returncode != 0 or not os.path.exists(path):
                with open(os.path.join(self.out_dir, f"rank{r}.err")) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"{self.suite}: rank {r} exited with "
                                   f"{p.returncode}:\n{tail}")
            out.append(torch.load(path, weights_only=False))
        return out

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.errs:
            f.close()


def _np(t):
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return t.detach().numpy()


def _params(data, key):
    return bridge.params_from_numpy(data[key], "cpu")


def _mesh(shape, names):
    ranks = torch.arange(dist.get_world_size()).reshape(shape)
    return DeviceMesh("cpu", ranks, mesh_dim_names=names)


# ---------------------------------------------------------------------------
# TP, DP and TP decode on a (data 2, model 2) mesh
# ---------------------------------------------------------------------------


def tp_forward(data):
    cfg = data["tp_cfg"]
    params = _params(data, "tp_params")
    tables = prec_tables(cfg.quant, "cpu")
    ids = torch.as_tensor(data["tp_ids"])
    mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
    sharded, _ = P.shard_params(params, mesh)
    ids_sh = distribute_tensor(ids, mesh, P.batch_sharding(mesh))
    with torch.no_grad():
        want = sp_forward(params, ids, 0, cfg, tables=tables)["logits"]
        got = sp_forward(sharded, ids_sh, 0, cfg, tables=tables)["logits"]
    return {"got": _np(got), "want": _np(want),
            "c_attn_w_local": tuple(sharded["blocks"]["c_attn"]["w"].to_local().shape)}


def tp_dp_step(data):
    """One SP step on the (data 2, model 2) mesh and on one device, from the
    same state and generator (its draws and its dropout)."""
    cfg, tcfg = data["tp_cfg"], data["tp_tcfg"]
    params = _params(data, "tp_params")
    ids = torch.as_tensor(data["tp_ids"])
    mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
    sharded, _ = P.shard_params(params, mesh)
    ids_sh = distribute_tensor(ids, mesh, P.batch_sharding(mesh))
    init_state, train_step = make_sp_train_step(cfg, tcfg)
    s0, m0 = train_step(init_state(params), ids, torch.Generator().manual_seed(0))
    s1, m1 = train_step(init_state(sharded), ids_sh, torch.Generator().manual_seed(0))
    out = {k: (float(_np(m1[k])), float(_np(m0[k])))
           for k in ("loss", "teacher_loss", "grad_norm")}
    out["placements"] = {
        "/".join(k): tuple(str(p) for p in optim.get_leaf(s1.params, k).placements)
        for k, _ in optim.leaves_with_paths(s1.params)}
    out["params"] = {"/".join(k): (_np(optim.get_leaf(s1.params, k)), _np(v))
                     for k, v in optim.leaves_with_paths(s0.params)}
    return out


def tp_decode(data):
    cfg = data["dec_cfg"]
    params = _params(data, "dec_params")
    ip = quantize_for_inference(params, cfg, 8, torch.float32, weight_format="int8_xla",
                                lm_head_int8=True)
    static = ip.pop("_static")
    ids = torch.as_tensor(data["dec_ids"])
    caches = init_layer_caches(cfg, 2, 16, torch.float32, device="cpu")
    with torch.no_grad():
        want, cref, _ = infer_forward_unrolled(ip, ids, cfg, caches, 0, static=static)
        tok = torch.argmax(want[:, -1:], dim=-1)
        want2, _, _ = infer_forward_unrolled(ip, tok, cfg, cref, 8, static=static)
        mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
        ip_sh, _ = P.shard_infer_params(ip, mesh, per_channel=False)
        caches_sh = tuple(distribute_tensor(c, mesh, P.kv_cache_sharding(mesh))
                          for c in init_layer_caches(cfg, 2, 16, torch.float32, device="cpu"))
        ids_sh = distribute_tensor(ids, mesh, P.batch_sharding(mesh))
        got, csh, _ = infer_forward_unrolled(ip_sh, ids_sh, cfg, caches_sh, 0, static=static)
        # argmax over the vocab-sharded logits: DTensor's argmax handler
        # fails on a sharded dimension, so the logits are gathered first
        tok_sh = distribute_tensor(torch.argmax(got.full_tensor()[:, -1:], dim=-1), mesh,
                                   P.batch_sharding(mesh))
        got2, _, _ = infer_forward_unrolled(ip_sh, tok_sh, cfg, csh, 8, static=static)
    return {"got": _np(got), "want": _np(want), "got2": _np(got2), "want2": _np(want2),
            "cache_placements": tuple(str(p) for p in csh[0].placements)}


def mesh_shapes(data):
    """make_mesh's defaults and checks over the 4 ranks."""
    shapes = {}
    for kw in ({}, {"n_model": 2}, {"n_data": 1}, {"n_data": 2, "n_model": 2}):
        mesh = P.make_mesh(**kw, device="cpu")
        shapes[str(sorted(kw.items()))] = (tuple(mesh.shape), mesh.mesh_dim_names)
    try:
        P.make_mesh(3, 1, device="cpu")
        refused = False
    except ValueError:
        refused = True
    mesh = P.make_mesh(n_model=2, device="cpu")
    return {"shapes": shapes, "refused": refused,
            "replicated": tuple(str(p) for p in P.replicated(mesh)),
            "batch": tuple(str(p) for p in P.batch_sharding(mesh)),
            "kv": tuple(str(p) for p in P.kv_cache_sharding(mesh))}


def tp_fused(data):
    """`linear_impl="fused"` on TP-sharded parameters: the fused linear's
    kernels (their plain versions here) take replicated operands."""
    cfg = data["fused_cfg"]
    params = _params(data, "fused_params")
    ids = torch.as_tensor(data["fused_ids"])
    mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
    sharded, _ = P.shard_params(params, mesh)
    with torch.no_grad():
        want = sp_forward(params, ids, 0, cfg)["logits"]
        got = sp_forward(sharded, distribute_tensor(ids, mesh, P.batch_sharding(mesh)), 0,
                         cfg)["logits"]
    return {"got": _np(got), "want": _np(want)}


def flash_boundary(data):
    """The flash wrappers on DTensor operands (batch over "data", heads over
    "model"): the local shards go to the kernel's plain version here, and
    forward and gradients equal the plain call on the whole tensors."""
    mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
    out = {}
    for name, fn in (("trainable", ta.flash_attention_trainable),
                     ("serving", ta.flash_attention)):
        qkv = [torch.as_tensor(a).clone().requires_grad_(True) for a in data["flash_qkv"]]
        want = fn(*qkv)
        want.square().sum().backward()
        sh = [distribute_tensor(t.detach(), mesh, P.kv_cache_sharding(mesh)).requires_grad_(True)
              for t in qkv]
        got = fn(*sh)
        placements = tuple(str(p) for p in got.placements)
        got.square().sum().backward()
        out[name] = {"got": _np(got), "want": _np(want), "placements": placements,
                     "grads": [(_np(a.grad), _np(b.grad)) for a, b in zip(sh, qkv)]}
    return out


# ---------------------------------------------------------------------------
# Ring attention, CP and PP
# ---------------------------------------------------------------------------


def ring(data):
    mesh = _mesh((dist.get_world_size(),), ("sp",))
    q, k, v = (torch.as_tensor(a) for a in data["ring_qkv"])
    seq = (Shard(2),)
    got = P.ring_attention(*(distribute_tensor(t, mesh, seq) for t in (q, k, v)), mesh, "sp")
    plain = P.ring_attention(q, k, v, mesh, "sp")
    k2, v2 = k.clone(), v.clone()
    T = q.shape[2]
    cut = T - T // dist.get_world_size()
    k2[:, :, cut:] = 50.0
    v2[:, :, cut:] = -50.0
    poisoned = P.ring_attention(q, k2, v2, mesh, "sp")
    return {"got": _np(got), "plain": _np(plain), "dense": _np(ta.causal_attention_reference(q, k, v)),
            "placements": tuple(str(p) for p in got.placements),
            "poisoned": _np(poisoned), "cut": cut}


def ring_grads(data):
    mesh = _mesh((dist.get_world_size(),), ("sp",))
    qkv = [torch.as_tensor(a).clone().requires_grad_(True) for a in data["ring_qkv"]]
    ta.causal_attention_reference(*qkv).square().sum().backward()
    sh = [distribute_tensor(t.detach(), mesh, (Shard(2),)).requires_grad_(True) for t in qkv]
    P.ring_attention(*sh, mesh, "sp").square().sum().backward()
    return {"grads": [(_np(a.grad), _np(b.grad)) for a, b in zip(sh, qkv)]}


def cp_forward(data):
    cfg = data["cp_cfg"]
    params = _params(data, "cp_params")
    tables = prec_tables(cfg.quant, "cpu")
    ids = torch.as_tensor(data["cp_ids"])
    mesh = _mesh((dist.get_world_size(),), ("sp",))
    with torch.no_grad():
        want = sp_forward(params, ids, 0, cfg, tables=tables, labels=ids)
        got = P.sp_forward_context_parallel(params, ids, 0, cfg, mesh, "sp", tables=tables,
                                            labels=ids)
    return {"got": _np(got["logits"]), "want": _np(want["logits"]),
            "loss": (float(_np(got["loss"])), float(_np(want["loss"])))}


def cp_step(data):
    cfg, tcfg = data["tp_cfg"], data["cp_tcfg"]
    params = _params(data, "tp_params")
    ids = torch.as_tensor(data["tp_ids"])
    mesh = P.make_mesh(n_data=2, n_model=2, device="cpu")
    init_p, step_p = make_sp_train_step(cfg, tcfg)
    init_c, step_c = make_sp_train_step(
        cfg, tcfg, attention_fn=partial(P.ring_attention, mesh=mesh, axis_name="model"))
    _, m_plain = step_p(init_p(params), ids, torch.Generator().manual_seed(3))
    ids_sh = distribute_tensor(ids, mesh, (Replicate(), Shard(1)))
    _, m_cp = step_c(init_c(params), ids_sh, torch.Generator().manual_seed(3))
    return {k: (float(_np(m_cp[k])), float(_np(m_plain[k])))
            for k in ("loss", "teacher_loss", "grad_norm")}


def _pp(data, shape=(2, 2), names=("data", "pipe")):
    cfg = data["pp_cfg"]
    params = _params(data, "pp_params")
    mesh = _mesh(shape, names)
    sharded, _ = P.shard_params_pp(params, mesh)
    return cfg, params, sharded, mesh, prec_tables(cfg.quant, "cpu"), torch.as_tensor(data["pp_ids"])


def pp_forward(data):
    cfg, params, sharded, mesh, tables, ids = _pp(data)
    with torch.no_grad():
        want = sp_forward(params, ids, 0, cfg, tables=tables, labels=ids)
        got = P.pipeline_sp_forward(sharded, ids, 0, cfg, mesh, tables=tables, labels=ids,
                                    batch_axis_name="data")
        more = P.pipeline_sp_forward(sharded, ids, 0, cfg, mesh, tables=tables,
                                     n_microbatches=4, batch_axis_name="data")
        hid = P.pipeline_sp_forward(sharded, ids, 0, cfg, mesh, tables=tables,
                                    batch_axis_name="data", output_hidden_states=True)
        want_h = sp_forward(params, ids, 0, cfg, tables=tables, output_hidden_states=True)
    refused = []
    for kw, c in (({"n_microbatches": 0}, cfg), ({"n_microbatches": 3}, cfg),
                  ({}, cfg.replace(model=dataclasses.replace(cfg.model, n_layer=3)))):
        try:
            P.pipeline_sp_forward(sharded, ids, 0, c, mesh, tables=tables, **kw)
        except ValueError as e:
            refused.append(str(e))
    return {"got": _np(got["logits"]), "want": _np(want["logits"]),
            "loss": (float(got["loss"]), float(want["loss"])), "refused": refused,
            "more": _np(more["logits"]),
            "hidden": (_np(hid["hidden_states"]), _np(want_h["hidden_states"])),
            "local_layers": sharded["blocks"]["c_attn"]["w"].to_local().shape[0]}


def pp_replicated(data):
    """No batch axis on a (data 2, pipe 2) mesh: the work replicates over
    "data", with a warning."""
    cfg, params, sharded, mesh, tables, ids = _pp(data)
    import warnings

    with warnings.catch_warnings(record=True) as caught, torch.no_grad():
        warnings.simplefilter("always")
        got = P.pipeline_sp_forward(sharded, ids, 0, cfg, mesh, tables=tables)
        want = sp_forward(params, ids, 0, cfg, tables=tables)
    return {"got": _np(got["logits"]), "want": _np(want["logits"]),
            "warned": any("batch_axis_name" in str(w.message) for w in caught)}


def pp_grads(data):
    cfg, params, sharded, mesh, tables, ids = _pp(data)
    names = [("wte",), ("wpe",), ("blocks", "c_attn", "lora_B"), ("blocks", "mlp_proj", "w"),
             ("ln_f", "g")]

    def grads(tree, fwd):
        live = optim.replace_leaves(tree, {
            k: optim.get_leaf(tree, k).detach().requires_grad_(True) for k in names})
        loss = fwd(live)["loss"]
        return torch.autograd.grad(loss, [optim.get_leaf(live, k) for k in names])

    want = grads(params, lambda p: sp_forward(p, ids, 0, cfg, tables=tables, labels=ids))
    got = grads(sharded, lambda p: P.pipeline_sp_forward(p, ids, 0, cfg, mesh, tables=tables,
                                                         labels=ids))
    return {"/".join(k): (_np(g), _np(w)) for k, g, w in zip(names, got, want)}


def pp_distill_step(data):
    cfg, params, sharded, mesh, tables, ids = _pp(data)
    tcfg = data["pp_tcfg"]
    init_s, step_s = make_sp_train_step(cfg, tcfg)
    init_p, step_p = P.make_pp_sp_train_step(cfg, tcfg, mesh, batch_axis_name="data")
    out = {}
    nodrop = data["pp_cfg_nodrop"]
    init_n, step_n = P.make_pp_sp_train_step(nodrop, tcfg, mesh, batch_axis_name="data")
    init_m, step_m = make_sp_train_step(nodrop, tcfg)
    for name, (i_s, f_s, i_p, f_p), draws in (
            ("drawn", (init_s, step_s, init_p, step_p), {}),
            ("replayed", (init_m, step_m, init_n, step_n), data["pp_draws"])):
        s_s, want = f_s(i_s(params), ids, torch.Generator().manual_seed(3), **draws)
        s_p, got = f_p(i_p(sharded), ids, torch.Generator().manual_seed(3), **draws)
        out[name] = {k: (_np(got[k]), _np(want[k]))
                     for k in ("loss", "teacher_loss", "student_loss_mean", "grad_norm",
                               "precisions")}
        out[name]["params"] = {"/".join(k): (_np(optim.get_leaf(s_p.params, k)), _np(v))
                               for k, v in optim.leaves_with_paths(s_s.params)}
        out[name]["placements"] = tuple(
            str(p) for p in s_p.params["blocks"]["c_fc"]["w"].placements)
    return out


def pp_train_step(data):
    cfg = data["pp_cfg"]
    params = _params(data, "pp_params")
    mesh = _mesh((2, 2), ("pipe", "data"))
    init_state, train_step = P.make_pp_train_step(cfg, data["pp_train_tcfg"], mesh,
                                                  batch_axis_name="data")
    sharded, _ = P.shard_params_pp(params, mesh)
    state = init_state(sharded)
    ids = torch.as_tensor(data["pp_train_ids"])
    prec = cfg.quant.prec_index(32)
    losses, norms = [], []
    for _ in range(6):
        state, metrics = train_step(state, ids, prec)
        losses.append(float(metrics["loss"]))
        norms.append(float(_np(metrics["grad_norm"])))
    p = state[0]
    return {"losses": losses, "grad_norms": norms,
            "wte": (_np(p["wte"]), _np(params["wte"])),
            "wq_scale": (_np(p["blocks"]["c_attn"]["wq_scale"]),
                         _np(params["blocks"]["c_attn"]["wq_scale"])),
            "c_fc_w": _np(p["blocks"]["c_fc"]["w"])}


def multihost(data):
    info = P.initialize_multihost()  # already initialised: reports the group
    full = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    sl = P.host_local_batch_slice(8)
    mesh = P.make_mesh(device="cpu")
    arr = P.make_global_batch(full[sl], mesh, P.batch_sharding(mesh))
    return {"info": info, "slice": (sl.start, sl.stop), "shape": tuple(arr.shape),
            "sum": float(arr.sum().full_tensor()), "want": float(full.sum())}


SUITES = {
    "tp": [mesh_shapes, tp_forward, tp_dp_step, tp_decode, tp_fused, flash_boundary],
    "pp": [ring, ring_grads, cp_forward, cp_step, pp_forward, pp_replicated, pp_grads,
           pp_distill_step, pp_train_step],
    "multihost": [multihost],
}


def main(argv):
    suite, inp, out_dir, store, rank, world = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    info = P.initialize_multihost(f"file://{store}", world, rank, device="cpu")
    data = torch.load(inp, weights_only=False)
    results = {"init": info}
    for case in SUITES[suite]:
        try:
            results[case.__name__] = case(data)
        except Exception:  # recorded for the case's own test to report
            results[case.__name__] = {"error": traceback.format_exc()}
            print(results[case.__name__]["error"], file=sys.stderr, flush=True)
    results["jax_imported"] = sorted(m for m in sys.modules
                                     if m.split(".")[0] in ("jax", "llm_qat_tpu"))
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
