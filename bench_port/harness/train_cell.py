"""The training cells: `make_sp_train_step` driven back to back.

Set-up builds one train state from seeded weights (calibrated by the
system's `CalibrationManager` on the mix's calibration batches) and drives
it through its first steps with the window's own call and feed; the same
state goes on into the window. The window runs steps until `--seconds`
have passed, then synchronises: tokens/s is B·T a step over all steps and
all the window's time. The reference then follows the first steps from the
same weights, batches, student draws and dropout seed.
"""

from __future__ import annotations

import time

import torch

from .compare import train_numbers
from .trace import Spans, kernel_table, profile_slice, top_ops
from .traffic import StudentDraws, train_data
from .weights import make_params

SPANS = ("train_step", "batch")


def build_cfg(config: dict, traffic: dict):
    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig, TrainConfig

    q = config["quant"]
    rank, alpha = q["lora_rank"], q["lora_alpha"]
    quant = QuantConfig(
        bit_widths=tuple(q["bit_widths"]),
        lora_rank_per_bit={b: rank for b in range(2, 17)} | {32: 0},
        lora_alpha_per_bit={b: alpha for b in range(2, 17)} | {32: 0},
        quantizer_per_bit={int(b): k for b, k in traffic.get("quantizer_per_bit", {}).items()},
        per_channel=traffic["per_channel"])
    model = GPT2Config(vocab_size=config["vocab_size"], n_positions=config["n_positions"],
                       n_embd=config["n_embd"], n_layer=config["n_layer"],
                       n_head=config["n_head"], layer_norm_epsilon=config["layer_norm_epsilon"],
                       embd_pdrop=config["embd_pdrop"])
    cfg = SPModelConfig(model=model, quant=quant, compute_dtype=q["compute_dtype"],
                        attention_impl=traffic.get("attention_impl", "auto"),
                        linear_impl=traffic.get("linear_impl", "auto"))
    if traffic["kind"] != "train":
        return cfg, None
    opt, dist = traffic["optimizer"], traffic["distill"]
    tcfg = TrainConfig(
        batch_size=traffic["batch_size"], max_seq_length=traffic["seq_len"],
        gradient_accumulation_steps=traffic["accum"], student_mode=traffic["student_mode"],
        distill_cache_dtype=traffic["distill_cache_dtype"],
        learning_rate=opt["learning_rate"], weight_decay=opt["weight_decay"],
        adam_b1=opt["adam_b1"], adam_b2=opt["adam_b2"], adam_epsilon=opt["adam_epsilon"],
        max_grad_norm=opt["max_grad_norm"], num_iterations=opt["num_iterations"],
        distill_alpha_kl=dist["alpha_kl"], distill_alpha_feature=dist["alpha_feature"],
        distill_temperature=dist["temperature"], distill_accumulative=dist["accumulative"])
    return cfg, tcfg


def ref_dims(config: dict, traffic: dict):
    from ..reference.sp_model import Dims

    q = config["quant"]
    return Dims(config, q["bit_widths"], q["lora_rank"], q["lora_alpha"],
                traffic["per_channel"], traffic.get("quantizer_per_bit"))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        faults=None, keep=False) -> dict:
    """One run of a training cell. `faults` (tests only) wraps the train
    step the window and the checked steps call; `keep` returns the
    reference's inputs and the program's readings too (`readings.py`)."""
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
    from llm_qat_tpu_torch.train.sp_trainer import make_sp_train_step, trainable_paths

    from ..reference.sp_train import follow

    config, traffic = cell.config, cell.traffic
    cfg, tcfg = build_cfg(config, traffic)
    q = cfg.quant
    gen = torch.Generator(device=device).manual_seed(seed)
    params = make_params(config, q.bit_widths, q.max_rank, q.per_channel, gen, device)
    ring, cal = train_data(traffic, config["vocab_size"], gen, device)
    calibrated = CalibrationManager(cfg, len(cal)).calibrate_all_precisions(params, cal)
    init_state, train_step = make_sp_train_step(cfg, tcfg)
    if faults is not None:
        train_step = faults(train_step)
    state = init_state(calibrated)
    draws = StudentDraws(traffic, [q.prec_index(b) for b in q.student_bits],
                         config["n_layer"], seed)
    dropout_seed = (seed * 2654435761 + 12345) % (2 ** 62)
    dgen = torch.Generator(device=device).manual_seed(dropout_seed)
    spans = Spans()

    # the first steps, through the window's call and feed, checked after it
    paths = trainable_paths(calibrated)
    start = {p: _get(calibrated, p) for p in paths}
    n_ref = traffic["reference_steps"]
    steps, prog = [], {"teacher_loss": [], "student_loss": []}
    for i in range(n_ref):
        slots, layers = draws.next()
        steps.append((ring[i % len(ring)], slots, layers))
        state, m = train_step(state, ring[i % len(ring)], dgen, precs=slots, layers=layers)
        prog["teacher_loss"].append(float(m["teacher_loss"]))
        prog["student_loss"].append(float(m["student_loss_mean"]))
        if i == 0:
            b1 = tcfg.adam_b1
            prog["grad1"] = {p: float((state.opt_state.mu[p] / (1 - b1)).norm()) for p in paths}
    # each leaf's change, on the host until the reference says which of
    # its elements move by round-off alone
    delta = {p: (_get(state.params, p) - start[p]).float().cpu() for p in paths}
    del start
    _sync(device)
    setup_s = time.perf_counter() - t0

    # the window
    B, T = traffic["batch_size"], traffic["seq_len"]
    bad = torch.zeros((), device=device)
    it, step_i = 0, n_ref
    _sync(device)
    t_start = time.perf_counter()
    while True:
        with spans("batch"):
            ids = ring[step_i % len(ring)]
            slots, layers = draws.next()
        with spans("train_step"):
            state, m = train_step(state, ids, dgen, precs=slots, layers=layers)
        bad += (~torch.isfinite(m["loss"])).float()
        it += 1
        step_i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    _sync(device)
    wall = time.perf_counter() - t_start
    failed = int(bad.item())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    out = {"attempted": it, "failed": failed, "memory_peak_bytes": peak,
           "end_to_end": {"setup_s": setup_s, "train_tokens_per_s": it * B * T / wall}}
    if trace:
        from llm_qat_tpu_torch.ops import attention as att
        from llm_qat_tpu_torch.ops import fused_linear as fl

        counters = {"flash_fwd_lse": att.flash_fwd_lse, "flash_bwd": att.flash_bwd,
                    "fused_linear_fwd": fl.fused_linear_fwd,
                    "fused_linear_bwd_dx": fl.fused_linear_bwd_dx,
                    "fused_linear_bwd_dw": fl.fused_linear_bwd_dw, "fq_weight": fl.fq_weight}
        n_prof = traffic["profile_iterations"]
        for fn in counters.values():
            fn.launches = 0

        def slice_():
            nonlocal state, step_i
            for _ in range(n_prof):
                with spans("batch"):
                    ids = ring[step_i % len(ring)]
                    slots, layers = draws.next()
                with spans("train_step"):
                    state, _ = train_step(state, ids, dgen, precs=slots, layers=layers)
                step_i += 1

        tr = profile_slice(slice_, spans, SPANS)
        out["trace"] = {"busy_s": tr["busy_s"], "window_s": tr["window_s"],
                        "breakdown": {"device_ops": top_ops(tr), "idle_gaps": tr["idle_gaps"]}}
        out["ctx"] = {"config": config, "traffic": traffic,
                      "device_name": torch.cuda.get_device_name(device),
                      "window": {"iterations": it, "wall_s": wall, "iter_s": wall / it},
                      "slice": {"iterations": n_prof},
                      "made": {k: fn.launches for k, fn in counters.items()},
                      "kernels": kernel_table(tr), "busy_s": tr["busy_s"],
                      "trace_window_s": tr["window_s"]}
    del state, calibrated, m
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = follow(params, ref_dims(config, traffic), traffic, cal, steps, dropout_seed, "bf16")
    prog["change"] = {p: float(delta[p].to(device)[ref["keep"][p]].norm()) for p in paths}
    out["numbers"] = train_numbers(prog, ref)
    out["reference_s"] = time.perf_counter() - t_ref
    if keep:
        out["kept"] = {"params": params, "cal": cal, "steps": steps,
                       "dropout_seed": dropout_seed, "prog": prog, "ref": ref, "delta": delta}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
