"""train.fused_linear_roofline: the fused QAT linear's kernels #14-#16
(with #14/#15's weight prologue) against their roofline, in %.

For each launch, the least time the card could take: its required
operations over the bf16 peak or the bytes of its operands and results
(each read or written once) over HBM bandwidth, the larger. Summed over
the launches of the profiled iterations and divided by their device time:
the mean per recorded launch of each kernel times the launches the
wrappers counted. The teacher's launches at the 32-bit slot need no LoRA
(its scaling is 0), so they count rank 0.
"""

import sys

from bench_port.harness.peaks import peaks_of
from bench_port.harness.trace import launch_time

LINEARS = ((1, 3), (1, 1), (1, 4), (4, 1))   # (in, out) in units of n_embd
KERNELS = (("fl_fq_weight", "fq_weight"), ("fl_fwd_wgmma", "fused_linear_fwd"),
           ("fl_bwd_dx_wgmma", "fused_linear_bwd_dx"), ("fl_bwd_dw_wgmma", "fused_linear_bwd_dw"))


def launch_cost(kernel: str, S: int, M: int, K: int, N: int, r: int):
    """(operations, bytes) that one launch of #14 ("fwd"), #15 ("dx") or
    #16 ("dw") needs, S students of M rows each; bf16 activations, float32
    weight, scales, bias and results."""
    if kernel == "fwd":
        ops = S * (2 * M * K * N + 2 * M * r * N)
        nbytes = S * (2 * M * K + 2 * M * r + 2 * r * N + 8 * N + 4 * M * N) + 4 * K * N + 4 * N
    elif kernel == "dx":
        ops = S * (2 * M * N * K + 2 * M * N * r)
        nbytes = S * (2 * M * N + 2 * r * N + 8 * N + 4 * M * K + 4 * M * r) + 4 * K * N
    elif kernel == "dw":
        ops = S * 2 * M * K * N
        nbytes = S * (2 * M * K + 2 * M * N + 4 * K * N)
    else:
        raise ValueError(kernel)
    return ops, nbytes


def iteration_launches(config: dict, traffic: dict):
    """(kernel, S, M, K, N, r) of every launch of one iteration."""
    d, L = config["n_embd"], config["n_layer"]
    M, r = traffic["batch_size"] * traffic["seq_len"], config["quant"]["lora_rank"]
    S = traffic["accum"] - 1
    out = []
    for _ in range(L):
        for a, b in LINEARS:
            for kernel in ("fwd", "dx", "dw"):
                out.append((kernel, 1, M, a * d, b * d, 0))
                out.append((kernel, S, M, a * d, b * d, r))
    return out


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    if peaks is None:
        return None
    launches = iteration_launches(ctx["config"], ctx["traffic"])
    n_it = ctx["slice"]["iterations"]
    per_kernel = {k: sum(1 for x in launches if x[0] == k) * n_it for k in ("fwd", "dx", "dw")}
    made = ctx["made"]
    if (made["fused_linear_fwd"], made["fused_linear_bwd_dx"], made["fused_linear_bwd_dw"]) != (
            per_kernel["fwd"], per_kernel["dx"], per_kernel["dw"]):
        print(f"train.fused_linear_roofline: launches {made} are not the shapes' "
              f"{per_kernel}", file=sys.stderr)
        return None
    times = [launch_time(ctx["kernels"], name, made[counter]) for name, counter in KERNELS]
    if any(t is None for t in times):
        return None
    bound, by_ops = 0.0, 0
    for kernel, S, M, K, N, r in launches:
        ops, nbytes = launch_cost(kernel, S, M, K, N, r)
        t_ops, t_bytes = ops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes"]
        bound += max(t_ops, t_bytes)
        by_ops += t_ops >= t_bytes
    print(f"train.fused_linear_roofline: {by_ops} of {len(launches)} launches an iteration "
          f"bound by operations, the rest by bytes; device s {sum(times)!r} in {n_it} "
          f"iterations", file=sys.stderr)
    return 100.0 * bound * n_it / sum(times)
