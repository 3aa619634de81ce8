"""serve.k_mega_roofline: the whole-model decode step #4 (`k_mega`)
against its roofline, in %.

Per step of the profiled chunks, for the slots in flight at the chunk's
start (each at its length l0, attending a = l0 + j + 1 rows at step j):
the bytes the step needs, over HBM bandwidth; or its integer operations
over the int8 peak; the larger. Over the mean device time of a recorded
`k_mega` launch (one a step).

Bytes a layer: the b-bit weight tiles (12·d²·b/8); the per-column scales
and biases of the nine tiles that take them (q, k, v, proj, the four fc
tiles and the mlp's sum: 2·9·d·4); the int8 LoRA tiles the step reads (A
of q/k/v, proj, fc and the mlp's four input quarters: 7; B of q, k, v,
proj, the four fc tiles and the mlp: 9; 16·d·r) and their 16 scalar
scales; the LayerNorm banks (4·d·4) and the four activation scales; per
slot the a KV rows attended and the new row written (d·kv_bits/8 bytes of
codes and a float32 scale, K and V). Per slot, the hidden row in and out
(2·d·4). Operations a slot and layer: 2·(12·d² + 16·d·r + 2·d·a)."""

import sys

from bench_port.harness.peaks import peaks_of
from bench_port.harness.trace import launch_time


def step_cost(attended, d: int, L: int, r: int, wbits: int, kv_bits: int):
    """(operations, bytes) of one step over slots attending `attended`
    rows each."""
    row_bytes = 2 * (d * kv_bits // 8 + 4)
    weights = L * (12 * d * d * wbits // 8 + 2 * 9 * d * 4 + 16 * d * r + 16 * 4
                   + 4 * d * 4 + 4 * 4)
    kv = L * row_bytes * (sum(attended) + len(attended))
    acts = len(attended) * d * 4 * 2
    ops = sum(2 * L * (12 * d * d + 16 * d * r + 2 * d * a) for a in attended)
    return ops, weights + kv + acts


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    if peaks is None:
        return None
    cfg, tr = ctx["config"], ctx["traffic"]
    d, L, r = cfg["n_embd"], cfg["n_layer"], cfg["quant"]["lora_rank"]
    steps = sum(c["steps"] for c in ctx["slice"]["chunks"])
    made = ctx["made"]["mega_decode_step_cb"]
    if made != steps:
        print(f"serve.k_mega_roofline: {made} launches in {steps} steps", file=sys.stderr)
        return None
    t = launch_time(ctx["kernels"], "k_mega", made)
    if t is None:
        return None
    bound, by_ops = 0.0, 0
    for c in ctx["slice"]["chunks"]:
        for j in range(c["steps"]):
            ops, nbytes = step_cost([l0 + j + 1 for l0 in c["lengths0"]], d, L, r,
                                    tr["bits"], tr["kv_bits"])
            t_ops, t_bytes = ops / peaks["int8_ops"], nbytes / peaks["hbm_bytes"]
            bound += max(t_ops, t_bytes)
            by_ops += t_ops >= t_bytes
    print(f"serve.k_mega_roofline: {by_ops} of {steps} steps bound by operations; "
          f"k_mega device s {t!r} for {made} launches", file=sys.stderr)
    return 100.0 * bound / t
