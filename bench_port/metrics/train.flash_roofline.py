"""train.flash_roofline: the trainable flash attention #5 (forward with
LSE) and #6 (backward) against their roofline, in %.

A launch on (B', H, T, D) heads (B' = B for the teacher, S·B for the
students, folded) needs, causally, 2·B'·H·D·T·(T+1) operations forward
(q·kᵀ and p·v) and twice that backward (dV, dP, dQ, dK; the recomputed
scores are not counted); bytes: q, k, v and o in bf16 and the float32 LSE
forward; q, k, v, o, dO, LSE read and dQ, dK, dV written backward. Device
time: the mean per recorded launch of each of its kernels times the
wrappers' launch counts.
"""

import sys

from bench_port.harness.peaks import peaks_of
from bench_port.harness.trace import launch_time

KERNELS = (("flash_fwd_wgmma", "flash_fwd_lse"), ("flash_bwd_prep", "flash_bwd"),
           ("flash_bwd_dkdv_wgmma", "flash_bwd"), ("flash_bwd_dq_wgmma", "flash_bwd"))


def launch_cost(kernel: str, B: int, H: int, T: int, D: int):
    qkv = B * H * T * D * 2
    if kernel == "fwd":
        return 2 * B * H * D * T * (T + 1), 4 * qkv + 4 * B * H * T
    if kernel == "bwd":
        return 4 * B * H * D * T * (T + 1), 8 * qkv + 4 * B * H * T
    raise ValueError(kernel)


def iteration_launches(config: dict, traffic: dict):
    H, L = config["n_head"], config["n_layer"]
    D, T, B = config["n_embd"] // H, traffic["seq_len"], traffic["batch_size"]
    S = traffic["accum"] - 1
    return [(k, b, H, T, D) for _ in range(L) for k in ("fwd", "bwd") for b in (B, S * B)]


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    if peaks is None:
        return None
    launches = iteration_launches(ctx["config"], ctx["traffic"])
    n_it = ctx["slice"]["iterations"]
    made = ctx["made"]
    want = sum(1 for x in launches if x[0] == "fwd") * n_it
    if made["flash_fwd_lse"] != want or made["flash_bwd"] != want:
        print(f"train.flash_roofline: launches {made} are not the shapes' {want} of each",
              file=sys.stderr)
        return None
    times = [launch_time(ctx["kernels"], name, made[counter]) for name, counter in KERNELS]
    if any(t is None for t in times):
        return None
    bound, by_ops = 0.0, 0
    for kernel, B, H, T, D in launches:
        ops, nbytes = launch_cost(kernel, B, H, T, D)
        t_ops, t_bytes = ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"]
        bound += max(t_ops, t_bytes)
        by_ops += t_ops >= t_bytes
    print(f"train.flash_roofline: {by_ops} of {len(launches)} launches an iteration bound by "
          f"operations; device s {sum(times)!r} in {n_it} iterations", file=sys.stderr)
    return 100.0 * bound * n_it / sum(times)
