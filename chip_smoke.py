#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root on a machine with an H100 (no arguments):

    python3 chip_smoke.py

It builds the port's CUDA kernels from `llm_qat_tpu_torch/csrc/`, holds each
kernel against its plain PyTorch version at GPT-2 124M widths, and drives
the port's paths with random weights from a seed, each with the launch
counters set to 0 just before it and read just after:

- serving (calibrate → quantize_for_inference → prefill → mega decode →
  int4 LM head → greedy sampling) through `InferenceEngine.generate`, which
  must go through the flash prefill kernel #2 (once a layer, all on one
  route: the linears give float32 q, k, v, as in JAX, so the SIMT forward)
  and the decode-step kernel;
- continuous-batching serving through `ContinuousBatchingEngine` with
  scripts/cb_bench.py's workload (8 slots, 24 greedy requests of 128 new
  tokens, prompts of 16 / 64 / 128, chunks of 64) in three configurations:
  packed W8A8, which must run the per-slot packed attention kernel (#8)
  once per layer and decode step, and mega W8 KV8 and W4 KV4, which must
  run the continuous-batching step kernel (#4) once per decode step; each
  with the flash prefill; then `InferenceEngine.generate` with the packed
  layout (the single-token packed kernel #7) and with the mega layout at
  kv_bits 16 (the float-cache step kernel #3); every served path's tokens
  held against its plain path by teacher-forced replay and a jitter floor;
- the int8 decode options (path A): `InferenceEngine` with
  `weight_format="int8"` (packed layout, 128-token prompt, 32 greedy
  tokens), which must run the packed-weight GEMM #10 for each of the 48
  linears of every forward call; (path B) a greedy loop of 64 steps over
  `infer_forward_unrolled(fused_attention=True, fused_linears=True)` on the
  8-bit int8_xla tree with dense bf16 caches, each step running the fused
  LN+QKV kernel #12, the dense-cache attention #9 and the fused
  post-attention kernel #13 once per layer; both held against their plain
  paths as above, path B's step timed beside the unfused int8_xla step;
- SP distillation training of GPT-2 124M at T = 1024 (CalibrationManager →
  make_sp_train_step → 3 steps of one teacher and 7 student micro-steps,
  then clip + AdamW), twice from the same calibrated parameters: on the
  flat linear, which must go through the flash forward+LSE and flash
  backward kernels once per layer and micro-step (with bf16 operands at
  head_dim 64 both on their wgmma kernels), and on the fused QAT
  linear (`linear_impl="fused"`), which must also go through the fused
  forward, dx and dW kernels once per linear, layer and micro-step (with
  bf16 operands the forward and dx each run the weight prologue first,
  which is held bit-equal to its plain version); after
  each, one step with the kernels against the same step on their plain
  versions, held against the floor the plain path sets against itself
  under a few ulps of jitter.

It times the kernels, their plain versions, the library yardsticks and
both train iterations with CUDA events and the host clock (#14-#16 also by
CUDA-graph replay, which leaves the host's dispatch out, and the host time
of one wrapper call), profiles one iteration of each path, and prints:

- the card's name and power limit (nvidia-smi);
- ptxas's registers, shared memory and spills of each kernel of
  `csrc/fused_linear.cu`, `csrc/quant_matmul.cu`,
  `csrc/flash_attention.cu`, `csrc/decode_attention.cu`,
  `csrc/mega_decode.cu` and `csrc/fused_decode.cu`, and a
  `ptxas_flash_wgmma` JSON line with the
  registers, stack frame and spills of each forward of #2/#5 (wgmma with
  and without the LSE, SIMT by operand type and head_dim) and the wgmma
  kernels of #6;
- one line per comparison, its error beside its tolerance;
- `timings`, `serving_timings`, `fused_decode_timings`,
  `decode_kernel_timings`, `int8_kernel_timings`, `train_profile`,
  `fused_train_profile`, `train_timings`, `flash_serve_timings`,
  `flash_timings` and `fused_kernel_timings` JSON lines and a `kernels` JSON line (all sixteen
  kernels; #11, which no model path runs, with the launches of its direct
  hold);
- last, `{"ok": true, "device": {...}}`.

Any failed check raises, so the script exits non-zero and prints no result
line. Without a CUDA device, or without the repository beside it, it exits
non-zero too. It imports neither JAX nor the JAX package.

    python3 chip_smoke.py --fused-linear

runs only the holds and timings of #14-#16 and the weight prologue (about
a minute; for A/B runs of two trees on one card, each tree with this
script) and prints no result line.

    python3 chip_smoke.py --quant-matmul

does the same for #10/#11: their holds at the four GPT-2 linear shapes and
`qmm_timings` (hot and cold-cache device time per layer).

    python3 chip_smoke.py --flash

does the same for #2/#5/#6: #2's holds (float32 at (8, 12, T, 64), T =
128 and 512; bf16 at (8, 12, 128, 64), (1, 12, 128, 64) and (8, 12, T,
64), T = 200, 384 and 512), #5/#6's at (8, 12, T, 64) (T = 1024 and 256 in
bf16 and float32, T = 200 in bf16), the ptxas lines,
`flash_serve_timings` (#2 in bf16 and float32 at the served shapes and at
T = 512, by events and by graph replay, beside SDPA's forward on the same
operands) and
`flash_timings` (#5/#6: events, graph replay, each wgmma kernel's device
time, SDPA's forward and backward).

    python3 chip_smoke.py --decode-attention

does the same for the one-token decode attention #7/#8/#9: decode_attention.cu's
ptxas report; the full run's holds (#7/#8 on packed bf16 caches of T = 512
at shared and ragged per-slot positions, -1, 0, 1 and T - 1 among them; #9
on dense caches of T = 192 and 512, bf16 and float32); `da_split_sweep`
(#9 at path B's shape and #8 at the server's, launched at every split of
the cluster from 1 to 8, each held, repeated calls bit-equal, timed by
graph replay beside the plan's split); and `decode_attention_timings` (each
kernel's profiler device time and graph-replay time beside SDPA's, at the
main paths' shapes).

    python3 chip_smoke.py --mega-decode

does the same for the decode steps #1/#3/#4 (one launch a step of the
persistent kernel `k_mega`): mega_decode.cu's ptxas report; #1's, #3's and
#4's holds as in the full run; `mega_timings` at #1's pos 160 and bench
shape, #3's engine shape (a 160-row bf16 cache at pos 143) and #4's server
shape (events, profiler device time, graph replay, the launches per step
by kernel, each phase's and barrier's time from the kernel's barrier
clock, the step at 1, 2, 4 and 12 layers with its cost per layer, and a
grid sweep: the plan's grid, half of it, one and two blocks per SM, each
held and its repeat calls compared); then `mega_e2e` (`decode_tok_s` and
the per-token step time at the bench shapes, KV4 and kv_bits 16, and the
mega W8 KV8 / W4 KV4 servers' end-to-end and steady tokens/s, without
their token replays).

    python3 chip_smoke.py --fused-decode

does the same for the fused int8 decode layer #12/#13 (one launch a call
of the persistent cooperative kernel `k_fused`): fused_decode.cu's and
mega_decode.cu's ptxas reports; the full run's holds of #12/#13; holds at
B = 1, 8 and 16 on each layer alone with repeat calls compared bit for
bit; a grid sweep (the plan's grid, half of it, two blocks per SM, each
held where the card takes it; a grid the runtime refuses raises); each
kernel's events, profiler and graph-replay ms, host ms a call and launches
a call by kernel name at the table's shapes, and the phase and barrier µs
of the kernel's barrier clock; the decode steps #1/#3/#4 by events and
profiler (they share sm90.cuh's grid barrier); and path B's
`fused_decode_timings` without its token replay.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
PEAK_F32_FLOPS = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_INT8_OPS = 1979e12     # H100 SXM int8 tensor cores, dense
PEAK_BF16_FLOPS = 989e12    # H100 SXM bf16 tensor cores, dense

# Kernel vs plain tolerances. Both kernels compute in float32, as the JAX
# kernels do, and sum in another order than their plain versions, so the two
# differ by float32 rounding. In the decode step such a difference now and
# then moves a value across a rounding boundary (a ±7 activation code, a KV
# code, or a bf16 rounding at `_rt`); that row then differs by a
# quantization step, and through later layers the difference grows. So the
# step is held tightly one layer at a time, and loosely at full depth. The
# limits were set from the spread measured on the card (PERF.md, PR 1).
# Row error = max |kernel - plain| over a batch row / max |plain h_out|.
MEGA_ROW_TIGHT = {"float32": 1e-5, "bfloat16": 4e-3}   # float rounding only
MEGA_TIGHT_SHARE = 0.9      # share of rows within the tight limit, at least
MEGA_LAYER_MAX = 2e-2       # any row, one layer alone
MEGA_LAYER_CODE_SHARE = 1e-3  # appended K/V codes that differ (by one code)
MEGA_LAYER_SCALE_REL = 1e-4   # appended K/V row scales, relative
# An appended row whose new K/V values moved an activation code upstream:
# its scale, relative (the row counts against MEGA_LAYER_CODE_SHARE)
MEGA_MOVED_SCALE_REL = 10 * MEGA_LAYER_SCALE_REL
MEGA_STEP_MAX = 5e-1        # any row, all 12 layers
FLASH_ABS_TOL = 1e-5
# The served tokens: the kernel path's greedy tokens replayed through the
# plain path (teacher forcing), against the floor that the plain path sets
# against itself when its kernels' outputs move by a few float32 ulps:
# argmax agreement at most this far below the floor's, and mean |logit
# difference| at most this many times the floor's.
TOKEN_AGREE_MARGIN = 0.1
LOGIT_FLOOR_FACTOR = 2.0
# Kernels #2 and #5 (the flash forwards, without and with the LSE) and #6
# (flash backward) against their plain versions on the same inputs. float32
# outputs of #5/#6: within FLASH_TRAIN_F32 of max |plain| (sums in another
# order); of #2: within FLASH_ABS_TOL absolute (values O(1)). bf16 outputs,
# element by element: within FLASH_TRAIN_BF16_ULPS bf16 ulps at the max
# |plain| of the element's row (a float32 value a rounding apart may round
# to the neighbouring bf16 value), plus FLASH_TRAIN_F32 of max |plain| (in
# row 0, dP = D in exact arithmetic, so dS and the dq row are float32
# cancellation noise in both versions). Both versions round P and dS at the
# same scale (the forwards at the running max of the same JAX k-blocks, the
# backward from the LSE), so they differ only by float32 summation order,
# and at most FLASH_TRAIN_BF16_DIFF_SHARE of the bf16 outputs may differ at
# all, over all rows: a kernel that skipped the rounding of P or dS would
# move a third of them or more. LSE (float32 in both) within
# FLASH_TRAIN_LSE_ABS. The spread measured on the card is in PERF.md.
FLASH_TRAIN_F32 = 1e-5
FLASH_TRAIN_BF16_ULPS = 2
FLASH_TRAIN_BF16_DIFF_SHARE = 2e-2
FLASH_TRAIN_LSE_ABS = 1e-5
# The train step with the kernels against the same step on their plain
# versions, from the same state with the same student slots, feature layers
# and dropout draws. The floor is the plain step against itself with the
# plain flash outputs moved by about one bf16 ulp (relative noise 2^-8 before
# the rounding to bf16; 2^-22 on the float32 LSE). Each relative difference
# (loss, teacher loss, grad norm, and the parameter update over all trainable
# leaves) must stay within TRAIN_FLOOR_FACTOR times the floor's. Measured on
# the card (PERF.md): 0.25x to 3.9x the floor.
TRAIN_FLOOR_FACTOR = 4.0
# Kernels #14-#16 (the fused QAT linear) against their plain versions at the
# four GPT-2 linear shapes (M = 8192, rank 64, bf16), each slot: every
# output within FUSED_REL of max |plain|. Both compute the same weight codes
# (the same float32 operations, none contracted into an FMA) and exact
# float32 products of bf16 operands, so they differ by the order of the
# float32 sums only. The spread measured on the card is in PERF.md.
FUSED_REL = 1e-5
# The fused train step with the kernels against the same step on their plain
# versions: the floor moves the plain versions' float32 outputs by this
# relative noise, about the size of the kernels' own differences.
FUSED_JITTER = 2.0 ** -20
# A one-draw floor is itself noisy: on an H100 one draw of the fused loss's
# floor read 1.7e-7 (a few float32 ulps of a loss of 1.37) against the
# kernels' 6.98e-7, 4.0x, and the flat step has read 3.9x. Each train step's
# floor (flat and fused) is the largest over this many noise draws.
FLOOR_DRAWS = 3
# Kernels #7/#8 against their plain versions on bf16 packed caches: both
# round q·sm_scale and each block's probabilities to bf16 at the same block
# maxima, so they differ by the order of float32 sums. Each float32 output
# within DA_BF16_ULPS bf16 ulps at its row's max |plain| (plus
# FLASH_TRAIN_F32 of max |plain|); rounded to bf16, at most DA_DIFF_SHARE of
# the outputs may differ (a kernel that skipped a rounding would move about
# a third of them).
DA_BF16_ULPS = 2
DA_DIFF_SHARE = 2e-2
# Kernel #3's appended K/V rows (float caches), each layer alone: at most
# MEGA_LAYER_CODE_SHARE of the values off by more than 1e-5 of their row's
# max (a bf16 rounding moved by an ulp of float32), none by more than
# KV16_LAYER_REL (one bf16 ulp at the row's max).
KV16_LAYER_REL = 2.0 ** -7
# Kernels #10/#11 (the packed-weight GEMM) against their plain versions at
# the four GPT-2 linear shapes, M = 8 and 1024: the codes are exact in bf16
# and bf16 products exact in float32, so the two differ by the order of the
# float32 sums: every output within QMM_REL of max |plain|.
QMM_REL = 1e-5
# Kernel #9 (dense-cache decode attention) against its plain version: float32
# scores and probabilities in both, sums in another order: outputs within
# DA9_ABS (values O(1)); the caches bit-equal (row pos written in the cache
# dtype by both, every other row untouched).
DA9_ABS = 1e-5
# Kernels #12/#13 (the fused int8 decode layer), each layer alone, held as the
# decode steps are: per batch row, max |kernel - plain| / max |plain| within
# float32 rounding (FD_ROW_TIGHT) for at least MEGA_TIGHT_SHARE of the rows
# (the int8 dots are exact; LN and LoRA sum in another order); a row where a
# value sat on a rounding boundary of the activation quantizer and a code
# moved within MEGA_LAYER_MAX.
FD_ROW_TIGHT = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host time of one fn() call in ms: `iters` calls back to back
    from an idle card, host clock, no synchronise between them (the launch
    queue does not fill, so no call waits for the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return 1e3 * t / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed between CUDA events, so the host's dispatch is not
    counted (unlike `cuda_ms`, where a wrapper whose host work outlasts its
    kernels is timed by its host work), and no profiler records can be
    dropped (unlike `device_ms`)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def _kernel_events(fn, iters: int, names=None):
    """torch.profiler's CUDA kernel records over `iters` calls of fn() (one
    warm call first): those whose name contains one of `names`, or all."""
    import torch

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count
            and (names is None or any(n in ev.key for n in names))]


def device_ms(fn, iters: int, names=None) -> float:
    """Mean device time of fn() in ms over `iters` calls: the self device
    time of the CUDA kernels it launches (those whose name contains one of
    `names`, or all of them), from torch.profiler. Unlike `cuda_ms`, gaps
    in which the card waits for the host's next launch are not counted."""
    return sum(ev.self_device_time_total for ev in _kernel_events(fn, iters, names)) / iters / 1e3


def kernel_name(key: str) -> str:
    """A profiler record's kernel name without its return type, template
    arguments and parameters ("void k_mega<1>(Mega)" -> "k_mega")."""
    return key.split("(")[0].split("<")[0].replace("void ", "").strip()


def launch_ms(fn, iters: int, name: str):
    """Mean device time in ms of one launch of the CUDA kernel `name`, which
    fn() launches once per call, over the launches the profiler recorded
    (None if none). Late in a long run the profiler drops records (an
    iteration profile has recorded 60 of 96 launches of a kernel), which
    lowers `device_ms`, a sum over the calls made, but not this mean."""
    evs = _kernel_events(fn, iters, [name])
    count = sum(ev.count for ev in evs)
    return sum(ev.self_device_time_total for ev in evs) / count / 1e3 if count else None


def bf16_row_ulps(got, want, atol):
    """(|got - want| - atol) per element, in bf16 ulps at the max |want| of
    the element's row (the last axis): 2^(floor(log2 rowmax) - 7)."""
    import torch

    top = want.float().abs().amax(dim=-1, keepdim=True).clamp(min=2.0 ** -126)
    err = ((got.float() - want.float()).abs() - atol).clamp(min=0)
    return err / torch.exp2(torch.floor(torch.log2(top)) - 7)


def bf16_hold(got, want):
    """(largest |got - want| in bf16 ulps at the max |want| of the element's
    row, less FLASH_TRAIN_F32 of max |want|; share of the outputs that
    differ at all, over all rows)."""
    ulps = bf16_row_ulps(got, want, FLASH_TRAIN_F32 * want.float().abs().max()).max().item()
    return ulps, (got != want).float().mean().item()


# Kernel #2's holds: float32 at the served prompt length and at 512; bf16 at
# the served shapes (the InferenceEngine prefill at B = 8 and the server's
# bucketed prefill at B = 1, 128 tokens), a ragged 200, and 384 and 512
# (JAX k-blocks of 128 and 256 keys)
FLASH_SERVE_F32_T = (128, 512)
FLASH_SERVE_BF16 = ((8, 128), (1, 128), (8, 200), (8, 384), (8, 512))


def flash_serve_vs_plain(gen, dev, H, D, failures):
    """Kernel #2 against its plain version: float32 within FLASH_ABS_TOL,
    bf16 within #5's limits (`bf16_hold`). Returns the largest absolute
    error at the served shape (8, H, 128, D) by dtype name: {"float32":
    .., "bfloat16": ..}."""
    import torch

    from llm_qat_tpu_torch.ops import attention as att

    served = {}
    cases = [(8, T, torch.float32) for T in FLASH_SERVE_F32_T]
    cases += [(B, T, torch.bfloat16) for B, T in FLASH_SERVE_BF16]
    for B, T, dt in cases:
        q, k, v = (torch.randn((B, H, T, D), generator=gen, device=dev).to(dt)
                   for _ in range(3))
        got, want = att.flash_attention(q, k, v), att.flash_attention_plain(q, k, v)
        err = (got.float() - want.float()).abs().max().item()
        tag = f"flash #2 ({B},{H},{T},{D}) {str(dt)[6:]}"
        if dt == torch.float32:
            print(f"{tag}: max abs err {err:.3e} (tol {FLASH_ABS_TOL:g})", flush=True)
            ok = err <= FLASH_ABS_TOL
        else:
            ulps, share = bf16_hold(got, want)
            print(f"{tag}: {ulps:.2f} bf16 ulps of its row's max (tol {FLASH_TRAIN_BF16_ULPS}), "
                  f"differing {share:.2e} (tol {FLASH_TRAIN_BF16_DIFF_SHARE:g}), "
                  f"k-block {att.jax_block_k(T)}", flush=True)
            ok = ulps <= FLASH_TRAIN_BF16_ULPS and share <= FLASH_TRAIN_BF16_DIFF_SHARE
        if (B, T) == (8, 128):
            served[str(dt)[6:]] = err
        if not ok:
            failures.append(f"{tag}: err {err:.3e}")
    return served


def flash_serve_timings(dev, H, D):
    """Kernel #2 at the served shapes (8, H, 128, D) and (1, H, 128, D) and
    at (8, H, 512, D): bf16 and float32 by CUDA events (`*_ms`, the
    wrapper's host work included where it outlasts the kernel) and by graph
    replay (`*_device_ms`), each beside SDPA's forward on the same operands
    (events and graph replay) and the plain version (events)."""
    import torch
    import torch.nn.functional as F

    from llm_qat_tpu_torch.ops import attention as att

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for B, T in ((8, 128), (1, 128), (8, 512)):
        q, k, v = (torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        qf, kf, vf = (t.float() for t in (q, k, v))
        sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
        sdpa_f32 = lambda: F.scaled_dot_product_attention(qf, kf, vf,  # noqa: E731
                                                          is_causal=True)
        out[f"{B}x{T}"] = {
            "bf16_ms": cuda_ms(lambda: att.flash_attention(q, k, v), 50),
            "bf16_device_ms": graph_ms(lambda: att.flash_attention(q, k, v), 50),
            "f32_ms": cuda_ms(lambda: att.flash_attention(qf, kf, vf), 50),
            "f32_device_ms": graph_ms(lambda: att.flash_attention(qf, kf, vf), 50),
            "sdpa_bf16_ms": cuda_ms(sdpa, 50),
            "sdpa_bf16_device_ms": graph_ms(sdpa, 50),
            "sdpa_f32_ms": cuda_ms(sdpa_f32, 50),
            "sdpa_f32_device_ms": graph_ms(sdpa_f32, 50),
            "bf16_plain_ms": cuda_ms(lambda: att.flash_attention_plain(q, k, v), 10),
            "f32_plain_ms": cuda_ms(lambda: att.flash_attention_plain(qf, kf, vf), 10)}
    return out


def print_flash_serve_timings(st):
    print("flash_serve_timings " + json.dumps(st), flush=True)
    for shape, r in st.items():
        print(f"flash #2 {shape}: bf16 {r['bf16_device_ms']:.5f} ms by graph replay "
              f"({r['bf16_ms']:.5f} by events), SDPA bf16 {r['sdpa_bf16_device_ms']:.5f} "
              f"({r['sdpa_bf16_ms']:.5f}); float32 {r['f32_device_ms']:.5f} "
              f"({r['f32_ms']:.5f}), SDPA float32 {r['sdpa_f32_device_ms']:.5f} "
              f"({r['sdpa_f32_ms']:.5f})", flush=True)


def flash_train_vs_plain(gen, dev, B, H, D, failures):
    """Kernels #5 and #6 against their plain versions at T = 1024 and 256,
    bf16 and float32, and at the ragged T = 200 in bf16 (the wgmma
    kernels' masked tail). Returns the largest absolute errors at the
    main path's shape (T = 1024, bf16): {"flash_fwd_lse": .., "flash_bwd":
    ..}. With bf16 at head_dim 64 both run their wgmma kernels."""
    import torch

    from llm_qat_tpu_torch.ops import attention as att

    errs = {}
    for T, dts in ((1024, (torch.bfloat16, torch.float32)),
                   (256, (torch.bfloat16, torch.float32)), (200, (torch.bfloat16,))):
        for dt in dts:
            q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=dev).to(dt)
                           for _ in range(4))
            o, lse = att.flash_fwd_lse(q, k, v)
            grads = att.flash_bwd(q, k, v, o, lse, do)
            po, plse = att.flash_fwd_lse_plain(q, k, v)
            pgrads = att.flash_bwd_plain(q, k, v, o, lse, do)
            torch.cuda.synchronize()
            tag = f"({B},{H},{T},{D}) {str(dt)[6:]}"
            lse_err = (lse - plse).abs().max().item()
            parts = [f"lse {lse_err:.2e} (tol {FLASH_TRAIN_LSE_ABS:g})"]
            if not lse_err <= FLASH_TRAIN_LSE_ABS:
                failures.append(f"flash_fwd_lse {tag}: lse err {lse_err:.3e}")
            abs_errs = {}
            for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (po, *pgrads)):
                err = (got.float() - want.float()).abs().max().item()
                abs_errs[name] = err
                if dt == torch.float32:
                    rel = err / want.float().abs().max().item()
                    parts.append(f"{name} {rel:.2e} of max (tol {FLASH_TRAIN_F32:g})")
                    ok = rel <= FLASH_TRAIN_F32
                else:
                    ulps, share = bf16_hold(got, want)
                    parts.append(
                        f"{name} {ulps:.2f} bf16 ulps of its row's max (tol "
                        f"{FLASH_TRAIN_BF16_ULPS}), differing {share:.2e} (tol "
                        f"{FLASH_TRAIN_BF16_DIFF_SHARE:g})")
                    ok = ulps <= FLASH_TRAIN_BF16_ULPS and share <= FLASH_TRAIN_BF16_DIFF_SHARE
                if not ok:
                    failures.append(f"flash train {tag} {name}: err {err:.3e}")
            print(f"flash train kernels vs plain {tag}: " + "; ".join(parts), flush=True)
            if T == 1024 and dt == torch.bfloat16:
                errs = {"flash_fwd_lse": max(abs_errs["o"], lse_err),
                        "flash_bwd": max(abs_errs[n] for n in ("dq", "dk", "dv"))}
    return errs


LINEARS = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


def train_setup(dev):
    """GPT-2 124M training config (bits 4/8/32, default kinds, rank 64, bf16
    compute), B = 8, T = 1024, accum 8; random weights from seed 0,
    calibrated by CalibrationManager on 3 batches. Returns (cfg, tcfg,
    params, batches, generator)."""
    import torch

    from llm_qat_tpu_torch.models.config import (
        GPT2Config,
        QuantConfig,
        SPModelConfig,
        TrainConfig,
    )
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager

    cfg = SPModelConfig(model=GPT2Config(), quant=QuantConfig(bit_widths=(4, 8, 32)),
                        compute_dtype="bfloat16")
    tcfg = TrainConfig(batch_size=8, max_seq_length=1024, gradient_accumulation_steps=8)
    m = cfg.model
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_sp_params(gen, cfg, device=dev)
    batches = [torch.randint(0, m.vocab_size, (tcfg.batch_size, tcfg.max_seq_length),
                             generator=gen, device=dev) for _ in range(3)]
    t = time.time()
    params = CalibrationManager(cfg, len(batches)).calibrate_all_precisions(params, batches)
    torch.cuda.synchronize()
    print(f"train calibration: {time.time() - t:.1f} s (3 batches of "
          f"({tcfg.batch_size}, {tcfg.max_seq_length}), bits 4 and 8)", flush=True)
    return cfg, tcfg, params, batches, gen


def train_counters():
    """The launch counters of the training path's kernels (#5, #6, #14-#16)."""
    from llm_qat_tpu_torch.ops import attention as att
    from llm_qat_tpu_torch.ops import fused_linear as fl

    return (att.flash_fwd_lse, att.flash_bwd, fl.fused_linear_fwd, fl.fused_linear_bwd_dx,
            fl.fused_linear_bwd_dw)


def train_path(cfg, tcfg, params, batches, gen, tag):
    """A training main path: 3 steps of `make_sp_train_step` from the
    calibrated `params` at `cfg.linear_impl`, with every training kernel's
    counter set to 0 just before and read just after. Per iteration: #5 and
    #6 once per layer and micro-step (96); #14, #15 and #16 once per linear,
    layer and micro-step (384) on the fused path, never on the flat one.
    Returns (state after 3 steps, train_step, main-path launches)."""
    import torch

    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train.sp_trainer import make_sp_train_step, trainable_mask

    init_state, train_step = make_sp_train_step(cfg, tcfg)
    state = init_state(params)
    from llm_qat_tpu_torch.ops import fused_linear as fl

    counters = train_counters()
    for fn in counters + (fl.fq_weight,):
        fn.launches = 0
    counters[0].route_launches.update(wgmma=0, simt=0)
    metrics = []
    t = time.time()
    for i in range(3):
        state, mt = train_step(state, batches[i], gen)
        metrics.append({k: v.tolist() for k, v in mt.items()})
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"{tag} main path: 3 steps in {time.time() - t:.1f} s (first includes "
          f"warm-up); launches {launches}; metrics {json.dumps(metrics)}", flush=True)
    per_iter = cfg.model.n_layer * tcfg.gradient_accumulation_steps
    fused = 4 * per_iter if cfg.linear_impl == "fused" else 0
    want = {fn.__name__: 3 * (per_iter if fn.__name__.startswith("flash") else fused)
            for fn in counters}
    check(launches == want, f"{tag} main path ran #5/#6 {per_iter} and #14-#16 {fused} "
          f"times each per iteration: {launches}")
    check(counters[0].route_launches["wgmma"] == launches["flash_fwd_lse"],
          f"{tag} main path ran #5 on its wgmma route (bf16 at head_dim 64): "
          f"{counters[0].route_launches}")
    # bf16 operands: one weight prologue per #14 and per #15 call
    check(fl.fq_weight.launches == 3 * 2 * fused,
          f"{tag} main path ran the weight prologue {2 * fused} times per iteration: "
          f"{fl.fq_weight.launches}")
    check(all(math.isfinite(x[k]) for x in metrics
              for k in ("loss", "teacher_loss", "student_loss_mean", "grad_norm")),
          f"{tag}: finite losses and grad norm")
    slots = {cfg.quant.prec_index(b) for b in cfg.quant.student_bits}
    check(all(set(x["precisions"]) <= slots for x in metrics), "precisions are student slots")
    for path, trainable in optim.leaves_with_paths(trainable_mask(params)):
        before, after = optim.get_leaf(params, path), optim.get_leaf(state.params, path)
        if trainable:
            check(not torch.equal(before, after), f"{tag}: trainable {path} moved")
        else:
            check(torch.equal(before, after), f"{tag}: frozen {path} bit-identical")
    print(f"{tag} main path: frozen leaves (wte, wpe, wq_*/iq_* banks) bit-identical, "
          "every trainable leaf moved", flush=True)
    return state, train_step, launches


def step_vs_plain(cfg, tcfg, state, batches, dev, failures, module, names, jitter_rels, tag):
    """One step from `state` with the kernels of `module` named `names` and
    with their plain versions (`<name>_plain`; same slots, layers and
    dropout draws), against the floor: the plain step with each plain
    version's outputs moved by relative noise of `jitter_rels` (one tuple
    per name, one entry per output), each metric's largest difference over
    FLOOR_DRAWS noise draws."""
    import torch

    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train.sp_trainer import make_sp_train_step, trainable_paths

    n = tcfg.gradient_accumulation_steps - 1
    precs = [i % 2 for i in range(n)]                        # both student slots
    layers = [(3 * i) % (cfg.model.n_layer + 1) for i in range(n)]
    paths = trainable_paths(state.params)

    def run(fns):
        """One step from `state` with module's `names` set to fns."""
        saved = [getattr(module, nm) for nm in names]
        for nm, fn in zip(names, fns):
            setattr(module, nm, fn)
        try:
            _, step = make_sp_train_step(cfg, tcfg)
            new, mt = step(state, batches[1], torch.Generator(device=dev).manual_seed(7),
                           precs=precs, layers=layers)
        finally:
            for nm, fn in zip(names, saved):
                setattr(module, nm, fn)
        delta = [optim.get_leaf(new.params, p) - optim.get_leaf(state.params, p)
                 for p in paths]
        return {k: float(mt[k]) for k in ("loss", "teacher_loss", "grad_norm")}, delta

    plain_fns = [getattr(module, nm + "_plain") for nm in names]
    kern = run([getattr(module, nm) for nm in names])
    plain = run(plain_fns)
    noise = torch.Generator(device=dev).manual_seed(1)

    def jitter(x, rel):
        e = rel * torch.randn(x.shape, generator=noise, device=dev)
        return (x.float() * (1 + e)).to(x.dtype)

    def jittered(fn, rels):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            if isinstance(out, torch.Tensor):
                return jitter(out, rels[0])
            return tuple(None if o is None else jitter(o, rel) for o, rel in zip(out, rels))
        return wrapped

    floors = [run([jittered(f, rels) for f, rels in zip(plain_fns, jitter_rels)])
              for _ in range(FLOOR_DRAWS)]

    def diffs(x, ref):
        out = {k: abs(x[0][k] - ref[0][k]) / abs(ref[0][k]) for k in ref[0]}
        num = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(x[1], ref[1])))
        den = torch.sqrt(sum((b ** 2).sum() for b in ref[1]))
        out["update"] = (num / den).item()
        return out

    got, each = diffs(kern, plain), [diffs(f, plain) for f in floors]
    base = {k: max(d[k] for d in each) for k in got}
    print(f"{tag} train step kernels vs plain (relative): "
          + "; ".join(f"{k} {got[k]:.3e} (floor {base[k]:.3e}, draws "
                      + " ".join(f"{d[k]:.2e}" for d in each)
                      + f", tol {TRAIN_FLOOR_FACTOR}x floor)" for k in got)
          + f"; kernel step {json.dumps(kern[0])}, plain step {json.dumps(plain[0])}",
          flush=True)
    for k in got:
        if not got[k] <= TRAIN_FLOOR_FACTOR * base[k]:
            failures.append(f"{tag} train step {k}: {got[k]:.3e} vs floor {base[k]:.3e}")


def fused_operands(cfg, params, slot, lin, M, gen, dev):
    """Kernels #14-#16's operands for linear `lin` of layer 0 of the
    calibrated training parameters at precision `slot`, M rows: xq is a
    standard normal input fake-quantized with the layer's input scales,
    xa and bq LoRA-sized bf16 operands, g a bf16 cotangent. Returns the
    argument tuples of the three wrappers and the bf16 quantized weight."""
    import torch

    from llm_qat_tpu_torch.models.sp_model import prec_tables
    from llm_qat_tpu_torch.ops import fused_linear as fl
    from llm_qat_tpu_torch.quant.functional import fake_quant_flat

    q = cfg.quant
    tables = prec_tables(q, dev)
    p = {k: v[0] for k, v in params["blocks"][lin].items()}
    K, N = p["w"].shape
    r = q.max_rank
    bf = torch.bfloat16
    bits, kind = tables.bits[slot], tables.kind[slot]
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    xq = fake_quant_flat(rnd(M, K), p["iq_scale"][slot], p["iq_zp"][slot], bits, kind,
                         q.symmetric, q.eps).to(bf)
    ws = p["wq_scale"][slot].expand(N).contiguous()
    wz = p["wq_zp"][slot].expand(N).contiguous()
    scalars = torch.stack([bits, kind.float(), tables.scaling[slot],
                           torch.zeros((), device=dev)])
    w = p["w"].contiguous()
    bq, g = (0.05 * rnd(r, N)).to(bf), (1e-3 * rnd(M, N)).to(bf)
    fwd = (xq, (0.5 * rnd(M, r)).to(bf), w, ws, wz, bq, p["b"].contiguous(), scalars,
           q.symmetric, q.eps)
    dx = (g, w, ws, wz, bq, scalars, q.symmetric, q.eps)
    dw = (xq, g, scalars)
    wq = fl.fq_tile_plain(w, ws, wz, bits, kind.float(), q.symmetric, q.eps).to(bf)
    return fwd, dx, dw, wq


def fused_linear_vs_plain(cfg, params, dev, M, failures):
    """Kernels #14, #15, #16 against their plain versions at the four GPT-2
    linear shapes, M rows, each slot; and the bf16 weight prologue of
    #14/#15 bit-equal to `fq_weight_plain` in both layouts. Returns the
    largest absolute error of each kernel."""
    import torch

    from llm_qat_tpu_torch.ops import fused_linear as fl

    gen = torch.Generator(device=dev).manual_seed(11)
    errs = {"fused_linear_fwd": 0.0, "fused_linear_bwd_dx": 0.0, "fused_linear_bwd_dw": 0.0}
    rels = {k: [] for k in errs}
    for lin in LINEARS:
        for slot in range(cfg.quant.n_prec):
            fwd, dx, dw, _ = fused_operands(cfg, params, slot, lin, M, gen, dev)
            wargs = fwd[2:5] + fwd[7:]
            for tr in (False, True):
                if not torch.equal(fl.fq_weight(*wargs, tr), fl.fq_weight_plain(*wargs, tr)):
                    failures.append(f"fused {lin} slot {slot}: prologue weights (transpose "
                                    f"{tr}) differ from fq_weight_plain")
            got = {"fused_linear_fwd": (fl.fused_linear_fwd(*fwd),),
                   "fused_linear_bwd_dx": fl.fused_linear_bwd_dx(*dx),
                   "fused_linear_bwd_dw": (fl.fused_linear_bwd_dw(*dw),)}
            want = {"fused_linear_fwd": (fl.fused_linear_fwd_plain(*fwd),),
                    "fused_linear_bwd_dx": fl.fused_linear_bwd_dx_plain(*dx),
                    "fused_linear_bwd_dw": (fl.fused_linear_bwd_dw_plain(*dw),)}
            torch.cuda.synchronize()
            parts = []
            for name in errs:
                for o, (a, b) in zip(("out",) if name.endswith("fwd") else
                                     ("dxq", "dxa") if name.endswith("dx") else ("dw",),
                                     zip(got[name], want[name])):
                    err = (a - b).abs().max().item()
                    rel = err / max(b.abs().max().item(), 1e-30)  # dxa is 0 at 32 bits
                    errs[name] = max(errs[name], err)
                    rels[name].append(rel)
                    parts.append(f"{o} {rel:.2e}")
                    if not rel <= FUSED_REL:
                        failures.append(f"fused {lin} slot {slot} {o}: {rel:.3e} of max")
            K, N = fwd[2].shape
            print(f"fused kernels vs plain {lin} (M={M}, K={K}, N={N}, r={fwd[1].shape[1]}) "
                  f"slot {slot}, error / max |plain| (tol {FUSED_REL:g}): " + "; ".join(parts)
                  + "; prologue bf16 weights bit-equal in both layouts (held)", flush=True)
    for name, rs in rels.items():
        print(f"fused {name} vs plain: {len(rs)} outputs, error / max |plain| max "
              f"{max(rs):.2e}, median {sorted(rs)[len(rs) // 2]:.2e}", flush=True)
    return errs


def iteration_timings(state, train_step, batches, accum, gen):
    """Mean wall time of 3 train iterations (host clock around steps that
    end in a synchronise), tokens/s and peak memory. Returns (dict, state)."""
    import torch

    walls = []
    torch.cuda.reset_peak_memory_stats()
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = train_step(state, batches[i], gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    it = sum(walls) / len(walls)
    return {"iter_ms": 1e3 * it, "iter_ms_each": [1e3 * w for w in walls],
            "tokens_per_s": batches[0].numel() / it,
            "microstep_tokens_per_s": accum * batches[0].numel() / it,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}, state


def iteration_profile(state, train_step, batch, gen, it_ms, tag):
    """Device time by kernel over one profiled iteration. The profiler may
    drop records over an iteration's tens of thousands of launches: the
    port's kernels' recorded counts are printed beside the counts their
    wrappers made (one flash_fwd_wgmma per #5; flash_bwd_prep,
    flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma per #6 (bf16 operands at
    head_dim 64);
    fl_fq_weight and fl_fwd_wgmma per #14, fl_fq_weight and
    fl_bwd_dx_wgmma per #15, fl_bwd_dw_wgmma per #16 (bf16 operands; #16's
    split of M is summed inside the launch, over a cluster)), and the idle share,
    1 - recorded busy time / the mean wall time of unprofiled iterations,
    is an upper bound."""
    import torch

    from llm_qat_tpu_torch.ops import fused_linear as fl

    counters = train_counters() + (fl.fq_weight,)
    for fn in counters:
        fn.launches = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        train_step(state, batch, gen)
        torch.cuda.synchronize()
    n5, n6, n14, n15, n16, nfq = (fn.launches for fn in counters)
    made = {"flash_fwd_wgmma": n5, "flash_bwd_prep": n6, "flash_bwd_dkdv_wgmma": n6,
            "flash_bwd_dq_wgmma": n6, "fl_fq_weight": nfq, "fl_fwd_wgmma": n14,
            "fl_bwd_dx_wgmma": n15, "fl_bwd_dw_wgmma": n16}
    made = {k: v for k, v in made.items() if v}
    by_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            by_kernel[ev.key[:80]] = (ev.count, ev.self_device_time_total / 1e3)
    busy = sum(ms for _, ms in by_kernel.values())
    recorded, port_by = {}, {}
    for name, (c, ms) in by_kernel.items():
        short = kernel_name(name)
        if short in made:
            recorded[short] = recorded.get(short, 0) + c
            port_by[short] = port_by.get(short, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:10]
    prof_out = {
        "unprofiled_iteration_wall_ms": it_ms, "device_busy_ms_recorded": busy,
        "idle_share_upper_bound": 1 - busy / it_ms, "port_kernels_ms": sum(port_by.values()),
        "port_kernels_ms_by_name": port_by,
        "port_launches_recorded": recorded, "port_launches_made": made,
        "all_port_launches_recorded": recorded == made,
        "kernel_launches_recorded": sum(c for c, _ in by_kernel.values()),
        "top10": [{"kernel": name, "launches": c, "ms": ms} for name, (c, ms) in top]}
    print(f"{tag}train_profile " + json.dumps(prof_out), flush=True)
    return prof_out


def flash_timings(dev, B, H, T, D):
    """Kernels #5/#6, their plain versions, SDPA, and dense vs flash
    attention at T = 256, 512, 1024. #5 and #6 by CUDA events, by graph
    replay (`*_device_ms`) and each of their wgmma kernels' device time per
    launch by the profiler (`launch_ms`). SDPA's forward by events and by
    graph replay; its backward by CUDA events around `torch.autograd.grad`
    (`sdpa_bwd_ms`, autograd's host work included) and by graph replay
    (`sdpa_bwd_device_ms`: SDPA's forward and backward replayed, less its
    forward alone). #5's and #6's ratios to SDPA are taken from the
    graph-replay device times."""
    import torch
    import torch.nn.functional as F

    from llm_qat_tpu_torch.ops import attention as att

    tm = {}
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = att.flash_fwd_lse(q, k, v)
    tm["flash_fwd_lse_ms"] = cuda_ms(lambda: att.flash_fwd_lse(q, k, v), 20)
    tm["flash_fwd_lse_device_ms"] = graph_ms(lambda: att.flash_fwd_lse(q, k, v), 20)
    if hasattr(att, "flash_route"):  # #5's wgmma route (A/B runs: absent in older trees)
        tm["flash_fwd_kernels_device_ms"] = {"flash_fwd_wgmma": launch_ms(
            lambda: att.flash_fwd_lse(q, k, v), 10, "flash_fwd_wgmma")}
    tm["flash_fwd_lse_plain_ms"] = cuda_ms(lambda: att.flash_fwd_lse_plain(q, k, v), 5)
    tm["flash_bwd_ms"] = cuda_ms(lambda: att.flash_bwd(q, k, v, o, lse, do), 10)
    tm["flash_bwd_plain_ms"] = cuda_ms(lambda: att.flash_bwd_plain(q, k, v, o, lse, do), 3)
    tm["flash_bwd_device_ms"] = graph_ms(lambda: att.flash_bwd(q, k, v, o, lse, do), 10)
    if hasattr(att, "flash_bwd_plan"):  # #6's wgmma route (A/B runs: absent in older trees)
        tm["flash_bwd_kernels_device_ms"] = {
            name: launch_ms(lambda: att.flash_bwd(q, k, v, o, lse, do), 10, name)
            for name in ("flash_bwd_prep", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma")}
    tm["sdpa_fwd_ms"] = cuda_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    tm["sdpa_fwd_device_ms"] = graph_ms(
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20)
    tm["flash_fwd_over_sdpa_fwd"] = tm["flash_fwd_lse_device_ms"] / tm["sdpa_fwd_device_ms"]
    qr, kr, vr = (t_.clone().requires_grad_(True) for t_ in (q, k, v))
    out = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    tm["sdpa_bwd_ms"] = cuda_ms(
        lambda: torch.autograd.grad(out, (qr, kr, vr), do, retain_graph=True), 20)

    def sdpa_fwd_bwd():
        # gradients taken at views made here, not at the leaves: autograd
        # would sync a leaf's gradient with the default stream, which a
        # CUDA graph's capture refuses
        qn, kn, vn = (t_.view_as(t_) for t_ in (qr, kr, vr))
        return torch.autograd.grad(
            F.scaled_dot_product_attention(qn, kn, vn, is_causal=True), (qn, kn, vn), do)

    tm["sdpa_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd, 20)
    tm["sdpa_bwd_device_ms"] = graph_ms(sdpa_fwd_bwd, 10) - graph_ms(
        lambda: F.scaled_dot_product_attention(qr, kr, vr, is_causal=True), 10)
    tm["flash_bwd_over_sdpa_bwd"] = tm["flash_bwd_device_ms"] / tm["sdpa_bwd_device_ms"]
    cross = {}
    for Tc in (256, 512, 1024):
        qc, kc, vc, dc = (torch.randn((B, H, Tc, D), generator=gen, device=dev)
                          .to(torch.bfloat16).requires_grad_(True) for _ in range(4))
        row = {}
        for name, fn in (("dense", att.causal_attention_reference),
                         ("flash", att.flash_attention_trainable)):
            with torch.no_grad():
                row[f"{name}_fwd_ms"] = cuda_ms(lambda: fn(qc, kc, vc), 10)
            row[f"{name}_fwd_bwd_ms"] = cuda_ms(
                lambda: torch.autograd.grad(fn(qc, kc, vc), (qc, kc, vc), dc), 10)
        cross[Tc] = row
    tm["dense_vs_flash"] = cross
    return tm


def fused_bytes_flops(name, M, K, N, r):
    """Bytes each of #14-#16 must move (each input read once, each output
    written once; bf16 operands, float32 weight and outputs) and its flops."""
    if name == "fused_linear_fwd":
        return 2 * M * K + 4 * K * N + 2 * M * r + 2 * r * N + 4 * M * N, 2 * M * N * (K + r)
    if name == "fused_linear_bwd_dx":
        return 2 * M * N + 4 * K * N + 2 * r * N + 4 * M * K + 4 * M * r, 2 * M * N * (K + r)
    return 2 * M * K + 2 * M * N + 4 * K * N, 2 * M * K * N


def fused_timings(cfg, params, dev, M):
    """#14, #15 and #16 and their plain versions at the four GPT-2 linear
    shapes, each slot, and as the library yardstick the product alone:
    torch.mm of the already quantized bf16 operands with a float32 result
    (no PyTorch call computes the fake-quant and the GEMM together). `ms`,
    `plain_ms` and `library_ms` time calls back to back by CUDA events
    (`cuda_ms`: a call whose host work outlasts its kernels is timed by
    its host work); `device_ms` is the device time of the
    kernels a wrapper call launches (`graph_ms`), `host_ms` the host time
    of one wrapper call (`host_ms`); for #14/#15 `fq_weight_device_ms` is
    the weight prologue's device time alone. Returns
    {slot: {linear: {kernel: {...}}}}."""
    import torch

    from llm_qat_tpu_torch.ops import fused_linear as fl

    gen = torch.Generator(device=dev).manual_seed(12)
    f32 = torch.float32
    out = {}
    for slot in range(cfg.quant.n_prec):
        per = out.setdefault(slot, {})
        for lin in LINEARS:
            fwd, dx, dw, wq = fused_operands(cfg, params, slot, lin, M, gen, dev)
            xq, g = fwd[0], dx[0]
            lib = {"fused_linear_fwd": lambda: torch.mm(xq, wq, out_dtype=f32),
                   "fused_linear_bwd_dx": lambda: torch.mm(g, wq.T, out_dtype=f32),
                   "fused_linear_bwd_dw": lambda: torch.mm(xq.T, g, out_dtype=f32)}
            row = {}
            for name, args in (("fused_linear_fwd", fwd), ("fused_linear_bwd_dx", dx),
                               ("fused_linear_bwd_dw", dw)):
                kern, plain = getattr(fl, name), getattr(fl, name + "_plain")
                row[name] = {"ms": cuda_ms(lambda: kern(*args), 10),
                             "device_ms": graph_ms(lambda: kern(*args), 10),
                             "host_ms": host_ms(lambda: kern(*args), 10),
                             "plain_ms": cuda_ms(lambda: plain(*args), 3, warmup=1),
                             "library_ms": cuda_ms(lib[name], 10)}
            w_args = fwd[2:5] + fwd[7:]
            row["fused_linear_fwd"]["fq_weight_device_ms"] = graph_ms(
                lambda: fl.fq_weight(*w_args, True, fwd[5]), 10)
            row["fused_linear_bwd_dx"]["fq_weight_device_ms"] = graph_ms(
                lambda: fl.fq_weight(*w_args, False), 10)
            per[lin] = row
    return out


def print_fused_timings(ft):
    """Prints `fused_timings`' rows, then per slot each kernel's sums over
    the four linears of one layer."""
    print("fused_kernel_timings " + json.dumps(ft), flush=True)
    for slot, per in ft.items():
        tot = lambda name, key: sum(per[lin][name][key] for lin in LINEARS)
        print(f"fused kernels per layer, slot {slot}: " + "; ".join(
            f"{name} {tot(name, 'ms'):.4f} ms by events (device {tot(name, 'device_ms'):.4f}, "
            f"host {tot(name, 'host_ms'):.4f}"
            + (f", prologue device {tot(name, 'fq_weight_device_ms'):.4f}"
               if name != "fused_linear_bwd_dw" else "")
            + f"; torch.mm {tot(name, 'library_ms'):.4f})"
            for name in ("fused_linear_fwd", "fused_linear_bwd_dx", "fused_linear_bwd_dw")),
            flush=True)


def dw_split_sweep(cfg, params, dev, M, failures):
    """Kernel #16 at the four GPT-2 linear shapes (M rows, the 8-bit log
    slot's operands) launched with every split of M the kernel takes (1 to
    8 blocks of a cluster), bypassing `dw_splits`: device ms per call by
    graph replay (`graph_ms`) and dW's error / max |plain|, beside the
    split the plan picks. Every split the plan may pick (chunks of at most
    DW_MAX_CHUNK_STEPS steps) is held within FUSED_REL; fewer chunks are
    reported only. Returns {"KxN": {...}}."""
    import torch

    from llm_qat_tpu_torch.ops import fused_linear as fl

    gen = torch.Generator(device=dev).manual_seed(13)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for lin in LINEARS:
        _, _, (xq, g, scalars), _ = fused_operands(cfg, params, cfg.quant.prec_index(8), lin,
                                                   M, gen, dev)
        K, N = xq.shape[1], g.shape[1]
        dw = torch.empty((K, N), dtype=torch.float32, device=dev)
        want = fl.fused_linear_bwd_dw_plain(xq, g, scalars)
        top = want.abs().max().item()

        def launch(split):
            fl.launch_dw_wgmma(xq, g, scalars, dw, split)

        ms, rel = {}, {}
        for split in range(1, 9):
            launch(split)
            torch.cuda.synchronize()
            rel[split] = (dw - want).abs().max().item() / top
            if split * fl.DW_MAX_CHUNK_STEPS * fl.DW_STEP >= M and not rel[split] <= FUSED_REL:
                failures.append(f"dw split sweep {K}x{N} split {split}: {rel[split]:.3e} of max")
            ms[split] = graph_ms(lambda: launch(split), 10)
        plan, best = fl.dw_splits(M, K, N, sms), min(ms, key=ms.get)
        out[f"{K}x{N}"] = {"ms": ms, "rel_err": rel, "plan": plan, "plan_ms": ms[plan],
                           "best": best, "best_ms": ms[best]}
        print(f"dw split sweep (M={M}, K={K}, N={N}; split: device ms by graph replay, "
              f"error / max |plain|): "
              + ", ".join(f"{s_}: {ms[s_]:.4f} {rel[s_]:.2e}" for s_ in ms)
              + f"; plan {plan} ({ms[plan]:.4f}), best {best} ({ms[best]:.4f})", flush=True)
    tot = lambda key: sum(v[key] for v in out.values())
    print(f"dw split sweep per layer: plan {tot('plan_ms'):.4f} ms, best {tot('best_ms'):.4f} "
          f"ms; dw_split_sweep " + json.dumps(out), flush=True)
    return out


def fused_linear_phase(dev) -> int:
    """`--fused-linear`: kernels #14-#16 and the weight prologue alone,
    held against their plain versions and timed at the training path's
    shapes as in the full run, then #16 at every split of M (for A/B runs
    of two trees on one card; the sweep runs where the tree has it).
    Prints no result line; returns 1 if a hold failed."""
    import torch

    from llm_qat_tpu_torch.ops import _build

    print("ptxas, csrc/fused_linear.cu:\n" + _build.ptxas_report("fused_linear"), flush=True)
    tcfg_model, tcfg, tparams, _, _ = train_setup(dev)
    Mt = tcfg.batch_size * tcfg.max_seq_length
    failures = []
    fused_linear_vs_plain(tcfg_model, tparams, dev, Mt, failures)
    print_fused_timings(fused_timings(tcfg_model, tparams, dev, Mt))
    if "fused_linear_bwd_dw_wgmma" in _build.KERNELS["fused_linear"]:
        dw_split_sweep(tcfg_model, tparams, dev, Mt, failures)
    torch.cuda.synchronize()
    for f in failures:
        print(f"chip_smoke --fused-linear: FAIL {f}", flush=True)
    return 1 if failures else 0


# mangled-name pieces of the kernels of flash_attention.cu that the
# `ptxas_flash_wgmma` line reports: the forwards of #2 and #5 (the wgmma
# forward without and with the LSE, and the SIMT forward by operand type and
# head_dim) and #6's wgmma kernels
FLASH_PTXAS_KERNELS = {
    "flash_fwd_wgmmaILb0E": "flash_fwd_wgmma<no lse> (#2)",
    "flash_fwd_wgmmaILb1E": "flash_fwd_wgmma<lse> (#5)",
    "flash_fwdIfLi64E": "flash_fwd<float, 64>", "flash_fwdIfLi128E": "flash_fwd<float, 128>",
    "flash_fwdI13__nv_bfloat16Li64E": "flash_fwd<bf16, 64>",
    "flash_fwdI13__nv_bfloat16Li128E": "flash_fwd<bf16, 128>",
    "flash_bwd_dkdv_wgmma": "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma": "flash_bwd_dq_wgmma"}


def print_ptxas_wgmma_flash(_build):
    """ptxas's registers, stack frame and spills of the forwards of #2/#5
    and the wgmma kernels of #6, from the build's report, as one
    `ptxas_flash_wgmma` JSON line."""
    out, name = {}, None
    for line in _build.ptxas_report("flash_attention").splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in FLASH_PTXAS_KERNELS.items() if k in line), None)
        elif name and "stack frame" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            out[name] = dict(zip(("stack_bytes", "spill_store_bytes", "spill_load_bytes"), nums))
        elif name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(line.split("Used")[1].split()[0])
    print("ptxas_flash_wgmma " + json.dumps(out), flush=True)


def flash_phase(dev) -> int:
    """`--flash`: kernels #2, #5 and #6 alone, held against their plain
    versions as in the full run (`flash_serve_vs_plain`,
    `flash_train_vs_plain`) and timed (#2 at the served shapes,
    `flash_serve_timings`; #5/#6 at the training path's shape,
    `flash_timings`), with flash_attention.cu's ptxas report (for A/B runs
    of two trees on one card). Prints no result line; returns 1 if a hold
    failed."""
    import torch

    from llm_qat_tpu_torch.ops import _build

    print("ptxas, csrc/flash_attention.cu:\n" + _build.ptxas_report("flash_attention"),
          flush=True)
    print_ptxas_wgmma_flash(_build)
    gen = torch.Generator(device=dev).manual_seed(0)
    failures = []
    flash_serve_vs_plain(gen, dev, 12, 64, failures)
    flash_train_vs_plain(gen, dev, 8, 12, 64, failures)
    print_flash_serve_timings(flash_serve_timings(dev, 12, 64))
    tt = flash_timings(dev, 8, 12, 1024, 64)
    print("flash_timings " + json.dumps(tt), flush=True)
    print(f"flash_fwd_lse {tt['flash_fwd_lse_ms']:.4f} ms by events, SDPA forward "
          f"{tt['sdpa_fwd_ms']:.4f} ms; device time by graph replay "
          f"{tt['flash_fwd_lse_device_ms']:.4f} ms against SDPA forward "
          f"{tt['sdpa_fwd_device_ms']:.4f} ms: {tt['flash_fwd_over_sdpa_fwd']:.2f}x", flush=True)
    print(f"flash_bwd {tt['flash_bwd_ms']:.4f} ms by events, SDPA backward "
          f"{tt['sdpa_bwd_ms']:.4f} ms by events (host work included); device time by graph "
          f"replay {tt['flash_bwd_device_ms']:.4f} ms against SDPA backward "
          f"{tt['sdpa_bwd_device_ms']:.4f} ms: {tt['flash_bwd_over_sdpa_bwd']:.2f}x", flush=True)
    for f in failures:
        print(f"chip_smoke --flash: FAIL {f}", flush=True)
    return 1 if failures else 0


def serve_setup(dev):
    """GPT-2 124M with the bench's quant config, random weights from seed
    0, LoRA B banks drawn small and non-zero so the LoRA branch does work,
    weight and input quantizers calibrated. Returns (cfg, params, gen)."""
    import torch

    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.train.calibration_manager import (
        calibrate_input_quantizers,
        calibrate_weight_quantizers,
    )

    cfg = SPModelConfig(
        model=GPT2Config(),
        quant=QuantConfig(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
                          per_channel=False),
        compute_dtype="bfloat16")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_sp_params(gen, cfg, device=dev)
    for lin in LINEARS:
        lb = params["blocks"][lin]["lora_B"]
        params["blocks"][lin]["lora_B"] = 0.02 * torch.randn(
            lb.shape, generator=gen, device=dev)
    t = time.time()
    params = calibrate_weight_quantizers(params, cfg)
    cal = [torch.randint(0, cfg.model.vocab_size, (2, 64), generator=gen, device=dev)
           for _ in range(3)]
    params = calibrate_input_quantizers(params, cfg, cal)
    torch.cuda.synchronize()
    print(f"calibration: {time.time() - t:.1f} s", flush=True)
    return cfg, params, gen


def quant_matmul_phase(dev) -> int:
    """`--quant-matmul`: kernels #10/#11 alone, held against their plain
    versions at the four GPT-2 linear shapes (M = 8 and 1024) and timed as
    in the full run's `int8_kernel_timings` (for A/B runs of two trees on
    one card). Prints no result line; returns 1 if a hold failed."""
    import torch

    from llm_qat_tpu_torch.models.inference import quantize_for_inference

    cfg, params, gen = serve_setup(dev)
    tree = quantize_for_inference(params, cfg, 8, weight_format="int8")
    tree.pop("_static")
    failures = []
    quant_matmul_vs_plain(tree, gen, dev, failures)
    qt = qmm_timings(tree, gen, dev)
    print("quant_matmul_timings " + json.dumps(qt), flush=True)
    for key, r in qt.items():
        cold = f", cold {r['cold_ms']:.4f} (torch.mm {r['library_cold_ms']:.4f})" \
            if "cold_ms" in r else ""
        print(f"{key} per layer: {r['ms']:.4f} ms{cold}; torch.mm {r['library_ms']:.4f}; "
              f"bound {r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    torch.cuda.synchronize()
    for f in failures:
        print(f"chip_smoke --quant-matmul: FAIL {f}", flush=True)
    return 1 if failures else 0


def decode_attention_vs_plain(gen, dev, B, H, D, failures):
    """Kernels #7 and #8 against their plain versions on packed bf16 caches
    of T = 512 (the server's max_len), at shared positions and at two sets
    of per-slot ones (pos -1, 0, 1 and T - 1 among mid ones, so that slots
    split their prefixes differently), element by element: within
    DA_BF16_ULPS bf16 ulps at the max |plain| of the output's row plus
    FLASH_TRAIN_F32 of max |plain|; rounded to bf16, at most
    DA_DIFF_SHARE of the outputs may differ at all (both round q and each
    block's probabilities at the same scale); the caches bit-equal after
    the append. Returns the largest absolute error of each."""
    import torch

    from llm_qat_tpu_torch.ops import decode_attention as da

    P, Tp = 128 // D, 256
    T = P * Tp
    bf = torch.bfloat16
    q, kn, vn = (torch.randn((B, H, 1, D), generator=gen, device=dev).to(bf) for _ in range(3))
    kc, vc = (torch.randn((B, H, Tp, P * D), generator=gen, device=dev).to(bf) for _ in range(2))
    slot_pos = [-1, 0, 17, 100, 255, 300, T - 3, T - 1]
    ragged = [1, T - 1, -1, 64, 0, 65, 200, 1]
    errs = {}
    for name, positions in (("decode_attention_hbm", (1, 300, T - 1)),
                            ("decode_attention_hbm_multi", (slot_pos, ragged))):
        kern, plain = getattr(da, name), getattr(da, name + "_plain")
        err = 0.0
        for pos in positions:
            ok, ck, cv = kern(q, kn, vn, kc.clone(), vc.clone(), pos)
            op, pk, pv = plain(q, kn, vn, kc.clone(), vc.clone(), pos)
            torch.cuda.synchronize()
            act = torch.tensor(pos, device=dev).expand(B) >= 0
            ok, op = ok[act], op[act]
            e = (ok - op).abs().max().item()
            err = max(err, e)
            ulps = bf16_row_ulps(ok, op, FLASH_TRAIN_F32 * op.abs().max()).max().item()
            share = (ok.to(bf) != op.to(bf)).float().mean().item()
            same = torch.equal(ck, pk) and torch.equal(cv, pv)
            print(f"{name} (8,12,1,64) packed bf16 T={T} pos {pos}: max abs err {e:.3e}, "
                  f"{ulps:.2f} bf16 ulps of the row's max (tol {DA_BF16_ULPS}), "
                  f"bf16-rounded outputs differing {share:.2e} (tol {DA_DIFF_SHARE:g}), "
                  f"caches bit-equal {same}", flush=True)
            if not (ulps <= DA_BF16_ULPS and share <= DA_DIFF_SHARE and same):
                failures.append(f"{name} pos {pos}: {ulps:.2f} ulps, share {share:.2e}, "
                                f"caches equal {same}")
        errs[name] = err
    return errs


def hold_layers(name, kernel, act, run, L, kv_codes, failures, spread):
    """Hold a step kernel against its plain version as #1 is held: `run(l)`
    returns (row errors, differing appended values, appended values,
    largest appended difference (codes) or relative one (floats), scale
    relative error, h_out max abs error[, moved-scale rows]) for layer l
    alone, or for the full depth with l = None. Full depth within
    MEGA_STEP_MAX; each layer alone within MEGA_LAYER_MAX, its appended
    codes off by at most one in at most MEGA_LAYER_CODE_SHARE of them (float
    caches: off by more than KV16_LAYER_REL of the row's max in at most that
    share), scales within MEGA_LAYER_SCALE_REL. Where `run` also returns
    moved-scale rows (appended rows whose scale is off by more than that
    with an activation code moved upstream, a rounding boundary crossed
    before the scale is taken) and their largest scale error, its scale
    error covers the other rows only; those rows count against the same
    share as the differing codes, and their scales hold within
    MEGA_MOVED_SCALE_REL. The rows go into `spread[(kernel, depth, act)]`
    for the tight share.
    Returns the full-depth h_out max abs error."""
    step = run(None)
    layers = [run(l) for l in range(L)]
    spread.setdefault((kernel, "step", act), []).extend(step[0])
    rows = [e for r in layers for e in r[0]]
    spread.setdefault((kernel, "layer", act), []).extend(rows)
    ndiff, nval = sum(r[1] for r in layers), sum(r[2] for r in layers)
    worst, srel = max(r[3] for r in layers), max(r[4] for r in layers)
    moved = sum(r[6] if len(r) > 6 else 0 for r in layers)
    moved_srel = max(r[7] if len(r) > 7 else 0.0 for r in layers)
    print(f"{name}: full depth row err max {max(step[0]):.3e} (tol {MEGA_STEP_MAX:g}); "
          f"layers alone row err max {max(rows):.3e} (tol {MEGA_LAYER_MAX:g}), appended "
          f"values differing {ndiff}/{nval} and rows whose scale moved with a moved "
          f"activation code {moved} (tol {MEGA_LAYER_CODE_SHARE:g} of the values), largest "
          f"{worst:.3g} (tol {1 if kv_codes else KV16_LAYER_REL:g}), scale rel err "
          f"{srel:.2e} (tol {MEGA_LAYER_SCALE_REL:g}), of the moved-scale rows "
          f"{moved_srel:.2e} (tol {MEGA_MOVED_SCALE_REL:g})", flush=True)
    if not max(step[0]) <= MEGA_STEP_MAX:
        failures.append(f"{name} full depth: row err {max(step[0]):.3e}")
    if not (max(rows) <= MEGA_LAYER_MAX and ndiff + moved <= MEGA_LAYER_CODE_SHARE * nval
            and worst <= (1 if kv_codes else KV16_LAYER_REL)
            and srel <= MEGA_LAYER_SCALE_REL and moved_srel <= MEGA_MOVED_SCALE_REL):
        failures.append(f"{name} layers: row err {max(rows):.3e}, {ndiff}/{nval} appended "
                        f"values differ (largest {worst}), {moved} moved-scale rows "
                        f"(scale rel {moved_srel:.2e}), scale rel {srel:.2e}")
    return step[5]


def _layer_of(t, l):
    return t if l is None else t[l:l + 1]


def float_step_vs_plain(md, tree, cfg, gen, dev, B, failures, spread):
    """Kernel #3 against its plain version at GPT-2 width: W4 weights, int8
    LoRA banks, a 384-row head-interleaved cache of the activation dtype
    (float32, bf16), pos 64 and 300, full depth and each layer alone."""
    import torch

    m = cfg.model
    L, d, H = m.n_layer, m.n_embd, m.n_head
    mw = md.pack_mega_weights(tree, cfg)
    aq = float(tree["blocks"]["c_attn"]["qmax"][0])
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        c0 = [torch.randn((L, B, 384, d), generator=gen, device=dev).to(dt) for _ in range(2)]
        for pos in (64, 300):
            h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
            kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=dt, aq_max=aq,
                      tbp=64, tiles_per_step=4)

            def run(l):
                w = md.MegaWeights(*(_layer_of(t, l) for t in mw))
                cs = [_layer_of(c, l) for c in c0]
                out_k = md.mega_decode_step(h, w, *[c.clone() for c in cs], pos, **kw)
                out_p = md.mega_decode_step_plain(h, w, *[c.clone() for c in cs], pos, **kw)
                rows = ((out_k[0] - out_p[0]).abs().amax(dim=1)
                        / out_p[0].abs().max()).tolist()
                rest = [t for t in range(cs[0].shape[2]) if t != pos]
                if not all(torch.equal(a[:, :, rest], c[:, :, rest])
                           for a, c in zip(out_k[1:], cs)):
                    failures.append("mega_decode_step touched cache rows other than pos")
                new_k = torch.cat([a[:, :, pos].float().flatten() for a in out_k[1:]])
                new_p = torch.cat([a[:, :, pos].float().flatten() for a in out_p[1:]])
                top = torch.cat([a[:, :, pos].float().abs().amax(-1, keepdim=True)
                                 .expand(a[:, :, pos].shape).flatten() for a in out_p[1:]])
                rel = (new_k - new_p).abs() / top
                return (rows, int((rel > 1e-5).sum()), rel.numel(), rel.max().item(), 0.0,
                        (out_k[0] - out_p[0]).abs().max().item())

            err = max(err, hold_layers(f"mega_decode_step {str(dt)[6:]} pos {pos}",
                                       "mega_decode_step", str(dt)[6:], run, L, False,
                                       failures, spread))
    return err


def cb_step_vs_plain(md, trees, cfg, gen, dev, B, failures, spread):
    """Kernel #4 against its plain version at GPT-2 width: W4 KV4 and W8 KV8,
    a 512-row main cache with slot lengths [0, 17, 64, 100, 255, 300, 447,
    448], a 64-row recent buffer (tbp 64) at rpos 0 (float32 activations)
    and 37 (bf16), full depth and each layer alone."""
    import torch

    m = cfg.model
    L, d, H = m.n_layer, m.n_embd, m.n_head
    lengths = [0, 17, 64, 100, 255, 300, 447, 448]
    err = 0.0
    for wbits, kv_bits in ((4, 4), (8, 8)):
        tree = trees[wbits]
        mw = md.pack_mega_weights(tree, cfg)
        aq = float(tree["blocks"]["c_attn"]["qmax"][0]) if wbits == 4 else 127.0
        dc = d if kv_bits == 8 else d // 2
        codes = lambda n: torch.randint(-128, 128, (L, B, n, dc), generator=gen, device=dev,
                                        dtype=torch.int8)
        scales = lambda n: 0.01 + 0.04 * torch.rand((L, B, n), generator=gen, device=dev)
        main = [codes(512), codes(512), scales(512), scales(512)]
        rec0 = [codes(64), codes(64), scales(64), scales(64)]
        for act, rpos in ((torch.float32, 0), (torch.bfloat16, 37)):
            h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
            kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=act, aq_max=aq,
                      tbp=64, kv_bits=kv_bits, tiles_per_step=4)

            scale_rows = [0, 0, 0]  # appended rows off by > the scale limit; of them
            # with a moved activation code upstream, and without

            def run(l):
                w = md.MegaWeights(*(_layer_of(t, l) for t in mw))
                mn = [_layer_of(c, l) for c in main]
                rc = [_layer_of(c, l) for c in rec0]
                out_k = md.mega_decode_step_cb(h, w, *mn, *[c.clone() for c in rc], lengths,
                                               rpos, **kw)
                kv_k = None
                if l is not None:  # the kernel's new K/V rows, from its qkv scratch
                    qkv = md._mega_ptrs(h, mw.at.shape[3], None, wbits)[0][4]
                    kv_k = (qkv[:, d:2 * d].clone(), qkv[:, 2 * d:].clone())
                kv_p = []
                spy_of = md._attention_cb_plain

                def spy(q_row, kn_f, vn_f, *a, **k):
                    kv_p.append((kn_f.clone(), vn_f.clone()))
                    return spy_of(q_row, kn_f, vn_f, *a, **k)

                md._attention_cb_plain = spy
                try:
                    out_p = md.mega_decode_step_cb_plain(h, w, *mn, *[c.clone() for c in rc],
                                                         lengths, rpos, **kw)
                finally:
                    md._attention_cb_plain = spy_of
                rows = ((out_k[0] - out_p[0]).abs().amax(dim=1)
                        / out_p[0].abs().max()).tolist()
                rest = [t for t in range(64) if t != rpos]
                if not all(torch.equal(a[:, :, rest], c[:, :, rest])
                           for a, c in zip(out_k[1:], rc)):
                    failures.append("mega_decode_step_cb touched recent rows other than rpos")
                dcodes = [md._kv_codes(a[:, :, rpos], kv_bits) - md._kv_codes(b[:, :, rpos], kv_bits)
                          for a, b in zip(out_k[1:3], out_p[1:3])]
                dcode = torch.cat([c.flatten() for c in dcodes])
                srels = [(a[:, :, rpos] - b[:, :, rpos]).abs() / b[:, :, rpos]
                         for a, b in zip(out_k[3:], out_p[3:])]
                srel = max(x.max().item() for x in srels)
                moved, moved_srel = 0, 0.0
                if kv_k is not None:
                    # per appended row (K and V of each batch row): its scale off by more
                    # than the limit, and an activation code moved upstream of it (the
                    # new row itself off by more than float rounding), a boundary
                    # crossed before the scale is taken. Such a row counts against the
                    # code share, its scale within MEGA_MOVED_SCALE_REL; the scale limit
                    # holds the others. (The row's own K/V codes come from its scale, so
                    # a moved one excuses nothing.)
                    srel = 0.0
                    for sr, nk, npl in zip(srels, kv_k, kv_p[0]):
                        off = sr[0] > MEGA_LAYER_SCALE_REL
                        act_moved = ((nk - npl).abs().amax(dim=1)
                                     / npl.abs().amax(dim=1)) > FD_ROW_TIGHT
                        scale_rows[0] += int(off.sum())
                        scale_rows[1] += int((off & act_moved).sum())
                        scale_rows[2] += int((off & ~act_moved).sum())
                        moved += int((off & act_moved).sum())
                        moved_srel = max(moved_srel,
                                         torch.where(act_moved, sr[0], 0.0).max().item())
                        srel = max(srel, torch.where(act_moved, 0.0, sr[0]).max().item())
                return (rows, int((dcode != 0).sum()), dcode.numel(),
                        int(dcode.abs().max()), srel, (out_k[0] - out_p[0]).abs().max().item(),
                        moved, moved_srel)

            name = f"mega_decode_step_cb w{wbits} kv{kv_bits} {str(act)[6:]} rpos {rpos}"
            err = max(err, hold_layers(name, "mega_decode_step_cb", str(act)[6:], run, L, True,
                                       failures, spread))
            print(f"{name}, layers alone: appended rows whose scale is off by more than "
                  f"{MEGA_LAYER_SCALE_REL:g}: {scale_rows[0]}; of them with an activation code "
                  f"moved upstream (the new K/V row off by more than {FD_ROW_TIGHT:g}) "
                  f"{scale_rows[1]} (counted against the code share), without "
                  f"{scale_rows[2]} (must be 0)", flush=True)
    return err


def kv8_step_vs_plain(md, trees, cfg, gen, dev, B, failures):
    """Kernel #1 against its plain version at GPT-2 width: W4 KV4 with int8
    LoRA banks and W8 KV8 with bf16 banks, a 384-row cache, float32 and
    bf16 activations, pos 64 and 300, full depth and each layer alone (the
    limits atop this script; the rows' spread against MEGA_ROW_TIGHT).
    Returns the full-depth h_out max abs error."""
    import torch

    m = cfg.model
    L, d, H = m.n_layer, m.n_embd, m.n_head
    err = 0.0

    def compare_step(h, mw, caches0, pos, kw):
        """Kernel vs plain on copies of caches0: (row errors, differing
        codes, codes, largest code difference, scale relative error, h_out
        max abs error)."""
        ck = [c.clone() for c in caches0]
        cp = [c.clone() for c in caches0]
        out_k = md.mega_decode_step_kv8(h, mw, *ck, pos, **kw)
        out_p = md.mega_decode_step_kv8_plain(h, mw, *cp, pos, **kw)
        rows = ((out_k[0] - out_p[0]).abs().amax(dim=1)
                / out_p[0].abs().max()).tolist()
        kvb = kw["kv_bits"]
        dcode = torch.cat([(md._kv_codes(a[:, :, pos], kvb) - md._kv_codes(b[:, :, pos], kvb))
                           .flatten() for a, b in zip(out_k[1:3], out_p[1:3])])
        srel = max(((a[:, :, pos] - b[:, :, pos]).abs() / b[:, :, pos]).max().item()
                   for a, b in zip(out_k[3:], out_p[3:]))
        rest = [t for t in range(caches0[0].shape[2]) if t != pos]
        if not all(torch.equal(a[:, :, rest], c[:, :, rest])
                   for a, c in zip(out_k[1:], caches0)):
            failures.append("mega step touched cache rows other than pos")
        return (rows, int((dcode != 0).sum()), dcode.numel(),
                int(dcode.abs().max()), srel, (out_k[0] - out_p[0]).abs().max().item())

    cases = [(4, 4, True), (8, 8, False)]  # (weight bits, kv bits, int8 LoRA)
    spread = {}  # (depth, act) -> row errors
    for wbits, kv_bits, lora_i8 in cases:
        tree = trees[wbits]
        mw = md.pack_mega_weights(tree, cfg, lora_int8=lora_i8)
        check((mw.at.dtype == torch.int8) == lora_i8, "LoRA bank dtype")
        aq = float(tree["blocks"]["c_attn"]["qmax"][0]) if wbits == 4 else 127.0
        T = 384
        dc = d if kv_bits == 8 else d // 2
        lo = -127 if kv_bits == 8 else -128
        caches0 = [torch.randint(lo, 128, (L, B, T, dc), generator=gen, device=dev,
                                 dtype=torch.int8) for _ in range(2)]
        caches0 += [0.01 + 0.04 * torch.rand((L, B, T), generator=gen, device=dev)
                    for _ in range(2)]
        for act in (torch.float32, torch.bfloat16):
            an = str(act)[6:]
            for pos in (64, 300):
                h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
                kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=act,
                          aq_max=aq, tbp=64, kv_bits=kv_bits, tiles_per_step=4)
                runs = {"step": [compare_step(h, mw, caches0, pos, kw)],
                        "layer": [compare_step(
                            h, md.MegaWeights(*(t[l:l + 1] for t in mw)),
                            [c[l:l + 1] for c in caches0], pos, kw) for l in range(L)]}
                for depth, res in runs.items():
                    rows = [e for r in res for e in r[0]]
                    ndiff, ncode = sum(r[1] for r in res), sum(r[2] for r in res)
                    cmax, srel = max(r[3] for r in res), max(r[4] for r in res)
                    spread.setdefault((depth, an), []).extend(rows)
                    tols = (f"row tol {MEGA_STEP_MAX:g}; codes and scales not held at "
                            f"full depth" if depth == "step" else
                            f"row tol {MEGA_LAYER_MAX:g}; codes tol {MEGA_LAYER_CODE_SHARE:g}"
                            f" of them, by 1; scale tol {MEGA_LAYER_SCALE_REL:g}")
                    print(f"mega w{wbits} kv{kv_bits} lora_{'i8' if lora_i8 else 'bf16'} "
                          f"{an} pos {pos} {depth}: row err max {max(rows):.3e}; "
                          f"codes differing {ndiff}/{ncode} (largest {cmax}); "
                          f"scale rel err {srel:.2e} ({tols})", flush=True)
                    tag = f"mega w{wbits} kv{kv_bits} {an} pos {pos} {depth}"
                    if depth == "step":
                        err = max(err, res[0][5])
                        if not max(rows) <= MEGA_STEP_MAX:
                            failures.append(f"{tag}: row err {max(rows):.3e}")
                        continue
                    if not max(rows) <= MEGA_LAYER_MAX:
                        failures.append(f"{tag}: row err {max(rows):.3e}")
                    if not (cmax <= 1 and ndiff <= MEGA_LAYER_CODE_SHARE * ncode):
                        failures.append(f"{tag}: {ndiff} codes differ, largest by {cmax}")
                    if not srel <= MEGA_LAYER_SCALE_REL:
                        failures.append(f"{tag}: scale rel err {srel:.2e}")
    for (depth, an), rows in sorted(spread.items()):
        rs = sorted(rows)
        share = sum(e <= MEGA_ROW_TIGHT[an] for e in rs) / len(rs)
        q = {f"p{int(100 * f)}": rs[min(len(rs) - 1, int(f * len(rs)))]
             for f in (0.5, 0.9, 0.99)}
        held = f"tol >= {MEGA_TIGHT_SHARE}" if depth == "layer" else "not held"
        print(f"mega {depth} {an}: {len(rs)} rows, within {MEGA_ROW_TIGHT[an]:g}: "
              f"{share:.3f} ({held}); quantiles "
              + " ".join(f"{k} {v:.2e}" for k, v in q.items())
              + f"; max {rs[-1]:.2e} (tol {MEGA_STEP_MAX if depth == 'step' else MEGA_LAYER_MAX:g})",
              flush=True)
        if depth == "layer" and share < MEGA_TIGHT_SHARE:
            failures.append(f"mega layer {an}: {share:.3f} of rows within "
                            f"{MEGA_ROW_TIGHT[an]:g}")
    return err


CB_PROMPTS = (16, 64, 128)   # scripts/cb_bench.py's workload
CB_SLOTS, CB_MAXLEN, CB_CHUNK, CB_NEW, CB_REQUESTS = 8, 512, 64, 128, 24
CB_REPLAY = 32               # tokens of the first wave held against the plain path
CB_CONFIGS = {
    "packed_w8a8": dict(bits=8, weight_format="int8_xla", lm_head_bits=8, kv_layout="packed"),
    "mega_w8kv8": dict(bits=8, weight_format="int8_xla", lm_head_bits=8, kv_layout="mega",
                       kv_bits=8),
    "mega_w4kv4": dict(bits=4, weight_format="int4_xla", lm_head_bits=8, kv_layout="mega",
                       kv_bits=4),
}


def cb_replay(eng, prompts, toks):
    """Teacher-forced logits of served tokens through a fresh engine: the
    requests `prompts` fill the slots together, as the first wave of the
    served run did; then token i - 1 of each is fed back at step i, inside
    one chunk (on the mega layout rpos = i over the same main caches, as
    served). toks (S, n) on the device. Returns (S, n, V) float32."""
    import torch

    from llm_qat_tpu_torch.serving.engine import _decode_step

    dev = eng.device
    first = []
    for slot, pr in enumerate(prompts):
        T0 = len(pr)
        ids = torch.zeros((1, eng._bucket(T0)), dtype=torch.int64, device=dev)
        ids[0, :T0] = torch.as_tensor(pr, device=dev)
        logits, caches1 = eng._prefill(ids)
        first.append(logits[0, T0 - 1])
        eng._insert_slot(caches1, slot, T0)
        eng.lengths[slot] = T0
    lengths0 = torch.as_tensor(eng.lengths, device=dev)
    steps = [torch.stack(first)]
    for i in range(toks.shape[1] - 1):
        if eng.kv_layout == "mega":
            logits = eng._mega_token(toks[:, i], eng.lengths, lengths0, i)
        else:
            logits = _decode_step(eng.iparams, toks[:, i], eng.caches, lengths0 + i,
                                  eng.lengths + i, eng.cfg, eng.static, eng.use_kernels)
        steps.append(logits)
    return torch.stack(steps, dim=1)


def jittered_floor(patches, replay_fn, dev, seed=1):
    """`replay_fn()` with relative noise of 2^-22 (a few float32 ulps) at
    each (module, name, where) of `patches`: where "out", on the function's
    first output (a plain version's result); where "in", on its first
    argument (the mega steps' `_rt`, so every value is moved just before
    each bf16 rounding of the step, where the kernels' float32 sums in
    another order move it)."""
    import torch

    noise = torch.Generator(device=dev).manual_seed(seed)

    def jitter(x):
        return x * (1 + 2.0 ** -22 * torch.randn(x.shape, generator=noise, device=dev))

    saved = [getattr(mod, nm) for mod, nm, _ in patches]

    def wrap(fn, where):
        def wrapped(*a, **k):
            if where == "in":
                return fn(jitter(a[0]), *a[1:], **k)
            out = fn(*a, **k)
            if isinstance(out, torch.Tensor):
                return jitter(out)
            return (jitter(out[0]),) + tuple(out[1:])
        return wrapped

    for (mod, nm, where), fn in zip(patches, saved):
        setattr(mod, nm, wrap(fn, where))
    try:
        return replay_fn()
    finally:
        for (mod, nm, _), fn in zip(patches, saved):
            setattr(mod, nm, fn)


def agreement(x, y):
    """(argmax agreement, mean |x - y| / std(y))."""
    return ((x.argmax(-1) == y.argmax(-1)).float().mean().item(),
            ((x - y).abs().mean() / y.std()).item())


def hold_tokens(tag, toks, lk, lp, lj):
    """The served tokens `toks` against the plain path: `lk` the kernel
    path's teacher-forced logits, `lp` the plain path's, `lj` the plain
    path's under jitter (the floor)."""
    import torch

    check(bool(torch.isfinite(lk).all()) and bool(torch.isfinite(lp).all()),
          f"{tag}: finite logits")
    check(torch.equal(lk.argmax(-1), toks), f"{tag}: served tokens equal their own replay")
    forced_agree, logit_rel = agreement(lk, lp)
    floor_agree, floor_rel = agreement(lj, lp)
    print(f"{tag} served tokens vs plain versions: teacher-forced argmax agreement "
          f"{forced_agree:.4f} (floor {floor_agree:.4f}, tol floor - {TOKEN_AGREE_MARGIN}); "
          f"logits mean abs err / std {logit_rel:.3e} (floor {floor_rel:.3e}, tol "
          f"{LOGIT_FLOOR_FACTOR}x floor)", flush=True)
    check(forced_agree >= floor_agree - TOKEN_AGREE_MARGIN,
          f"{tag}: served tokens agree with the plain path")
    check(logit_rel <= LOGIT_FLOOR_FACTOR * floor_rel,
          f"{tag}: served logits agree with the plain path")


def serve_path(params, cfg, dev, name, prompts, replay=True):
    """The slice's main path in one configuration: scripts/cb_bench.py's
    workload through `ContinuousBatchingEngine` (8 slots, max_len 512, 24
    greedy requests of 128 new tokens, prompts cycling 16 / 64 / 128,
    `run_until_done(chunk=64)`), after one warm-up request, with the
    counters of #2, #4 and #8 set to 0 just before and read just after;
    then the steady-state decode rate (cb_bench's: 8 long requests, one
    timed step_chunk(64) at a time, 3 repetitions, the median), and the
    first wave's first CB_REPLAY tokens held against the plain path (with
    `replay`). Returns (timings, launches)."""
    import numpy as np
    import torch

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import mega_decode as md
    from llm_qat_tpu_torch.ops.attention import flash_attention
    from llm_qat_tpu_torch.serving import ContinuousBatchingEngine
    from llm_qat_tpu_torch.serving import engine as serving_engine

    kw = dict(CB_CONFIGS[name], n_slots=CB_SLOTS, max_len=CB_MAXLEN)
    eng = ContinuousBatchingEngine(params, cfg, **kw)
    eng.submit(prompts[0], max_new_tokens=CB_CHUNK + 2)
    eng.run_until_done(chunk=CB_CHUNK)
    counters = (flash_attention, da.decode_attention_hbm_multi, md.mega_decode_step_cb)
    for c in counters:
        c.launches = 0
    steps0 = eng.decode_steps
    torch.cuda.synchronize()
    t = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=CB_NEW) for p in prompts]
    fin = eng.run_until_done(chunk=CB_CHUNK)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    steps = eng.decode_steps - steps0
    total = sum(len(fin[i].generated) for i in ids)
    print(f"serve {name} main path: {len(ids)} requests, {total} tokens in {wall:.2f} s, "
          f"{steps} decode steps; launches {launches}", flush=True)
    check(all(len(fin[i].generated) == CB_NEW for i in ids),
          f"{name}: every request finished with {CB_NEW} tokens")
    check(all(0 <= x < cfg.model.vocab_size for i in ids for x in fin[i].generated),
          f"{name}: token ids in range")
    check(all(r is None for r in eng.slot_req) and len(ids) > CB_SLOTS,
          f"{name}: {len(ids)} requests through {CB_SLOTS} slots (recycled), all freed")
    check(launches["flash_attention"] > 0, f"{name}: the 128-token prompts ran flash #2")
    L = cfg.model.n_layer
    if eng.kv_layout == "packed":
        check(launches["decode_attention_hbm_multi"] == L * steps
              and launches["mega_decode_step_cb"] == 0,
              f"{name}: #8 ran {L} times per decode step")
    else:
        check(launches["mega_decode_step_cb"] == steps
              and launches["decode_attention_hbm_multi"] == 0,
              f"{name}: #4 ran once per decode step")
    tm = {"e2e_tok_s": total / wall, "e2e_wall_s": wall, "requests": len(ids),
          "decode_steps": steps}
    for p in prompts[:CB_SLOTS]:
        eng.submit(p, max_new_tokens=CB_MAXLEN)
    eng.step_chunk(8)
    eng.step_chunk(CB_CHUNK)
    ts = []
    for _ in range(3):
        before = int(np.sum(eng.gen_counts))
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.step_chunk(CB_CHUNK)
        ts.append(time.perf_counter() - t)
        check(int(np.sum(eng.gen_counts)) - before == CB_SLOTS * CB_CHUNK,
              f"{name}: a steady-state chunk advanced every slot {CB_CHUNK} tokens")
    tm["steady_chunk_s"] = ts
    tm["steady_decode_tok_s"] = CB_SLOTS * CB_CHUNK / float(np.median(ts))
    tm["steady_us_per_step"] = 1e6 * float(np.median(ts)) / CB_CHUNK
    if not replay:
        print(f"serve {name} timings " + json.dumps(tm), flush=True)
        return tm, launches

    wave = prompts[:CB_SLOTS]
    toks = torch.tensor([fin[i].generated[:CB_REPLAY] for i in ids[:CB_SLOTS]],
                        device=dev)
    lk = cb_replay(ContinuousBatchingEngine(params, cfg, **kw), wave, toks)
    lp = cb_replay(ContinuousBatchingEngine(params, cfg, use_kernels=False, **kw), wave, toks)
    patches = [(inference, "flash_attention_plain", "out"),
               (serving_engine, "decode_attention_hbm_multi_plain", "out"),
               (md, "_rt", "in")]
    lj = jittered_floor(patches, lambda: cb_replay(
        ContinuousBatchingEngine(params, cfg, use_kernels=False, **kw), wave, toks), dev)
    hold_tokens(f"serve {name}", toks, lk, lp, lj)
    print(f"serve {name} timings " + json.dumps(tm), flush=True)
    return tm, launches


def engine_layouts_path(params, cfg, dev, B, gen):
    """`InferenceEngine` with kv_layout "packed" and with "mega" at kv_bits
    16, B = 8, a 127-token prompt (a 126-token aligned prefill, then the odd
    tail as a single-token step through #7), 32 new tokens; the counters of
    #3 and #7 set to 0 just before each and read just after; the tokens held
    against the plain path by teacher-forced replay and the jitter floor.
    Returns the launches of each."""
    import torch

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models.inference import InferenceEngine, init_layer_caches
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import mega_decode as md

    T0, NEW = 127, 32
    prompt = torch.randint(0, cfg.model.vocab_size, (B, T0), generator=gen, device=dev)
    L = cfg.model.n_layer
    out = {}
    for layout, kv_bits in (("packed", 16), ("mega", 16)):
        kw = dict(bits=4, max_batch=B, max_len=T0 + NEW, weight_format="int4_xla",
                  lm_head_bits=4, kv_layout=layout, kv_bits=kv_bits, mega_tbp=64)
        eng = InferenceEngine(params, cfg, **kw)
        da.decode_attention_hbm.launches = 0
        md.mega_decode_step.launches = 0
        res = eng.generate(prompt, max_new_tokens=NEW)
        torch.cuda.synchronize()
        launches = {"decode_attention_hbm": da.decode_attention_hbm.launches,
                    "mega_decode_step": md.mega_decode_step.launches}
        tag = f"engine {layout} kv{kv_bits}"
        print(f"{tag} main path launches: {launches}", flush=True)
        want = ({"decode_attention_hbm": L * (T0 % 2 + NEW), "mega_decode_step": 0}
                if layout == "packed" else
                {"decode_attention_hbm": 0, "mega_decode_step": NEW})
        check(launches == want, f"{tag}: launches {launches} == {want}")
        check(tuple(res.shape) == (B, T0 + NEW) and torch.equal(res[:, :T0], prompt),
              f"{tag}: generate shape and prompt kept")
        toks = res[:, T0:]

        def replay(e):
            if layout == "packed":
                caches = init_layer_caches(cfg, B, T0 + NEW, e.dtype, kv_layout="packed",
                                           device=dev)
                _, caches = e.prefill(prompt[:, :T0 - 1], caches)
                last, caches = e._forward(prompt[:, T0 - 1:], caches, T0 - 1)
            else:
                caches = init_layer_caches(cfg, B, -(-(T0 + NEW) // 32) * 32, e.dtype,
                                           device=dev)
                logits, caches = e.prefill(prompt, caches)
                last, caches = logits[:, -1], e._to_mega(caches)
            steps = [last]
            for i in range(NEW - 1):
                if layout == "packed":
                    last, caches = e._forward(toks[:, i:i + 1], caches, T0 + i)
                else:
                    last, *caches = e.mega_step(toks[:, i], T0 + i, *caches)
                steps.append(last)
            return torch.stack(steps, dim=1)

        ref = InferenceEngine(params, cfg, use_kernels=False, **kw)
        lk, lp = replay(eng), replay(ref)
        patches = [(inference, "decode_attention_hbm_plain", "out"), (md, "_rt", "in")]
        lj = jittered_floor(patches, lambda: replay(ref), dev)
        hold_tokens(tag, toks, lk, lp, lj)
        out[layout] = launches
    return out


def packed_bytes(B, H, D, positions, elt):
    """Bytes #7/#8 must move: q, k_new, v_new read (float32), each active
    slot's live K and V rows [0, pos) (ceil(pos / P) packed rows of 128
    lanes), the (B, H, D) float32 output and the appended lane groups."""
    P = 128 // D
    live = sum(2 * H * -(-max(p, 0) // P) * 128 * elt for p in positions)
    appended = sum(2 * H * D * elt for p in positions if p >= 0)
    return 3 * B * H * D * 4 + live + B * H * D * 4 + appended


def packed_flops(H, D, positions):
    """Multiply-adds of the scores and the weighted V over each live prefix
    and the new token: 2 products of D per (slot, head, timestep)."""
    return sum(2 * 2 * H * D * (max(p, 0) + 1) for p in positions if p >= 0)


def da_timings(dev, gen, B, H, D, n_iter=200, graph=False):
    """#7 and #8 at the main paths' shapes (bf16 packed caches), their plain
    versions, and the library yardstick: one F.scaled_dot_product_attention
    of (B, H, 1, D) against the unpacked view with a per-slot length mask.
    #7: the InferenceEngine packed run (T = 256, pos 143); #8: the server's
    steady state (T = 512, slots at mixed positions). "ms" is the kernel's
    device time and "library_ms" SDPA's (profiler); one call of either
    takes less device time than the host needs to issue it, so the
    CUDA-event time of back-to-back calls ("wrapper_ms", "library_wall_ms")
    measures the host. With `graph`, also both by CUDA-graph replay
    ("graph_ms", "library_graph_ms": the wrapper's call and SDPA's, with
    their own copies and allocations)."""
    import torch
    import torch.nn.functional as F

    from llm_qat_tpu_torch.ops import decode_attention as da

    bf = torch.bfloat16
    P = 128 // D
    out = {}
    for name, T, pos in (("decode_attention_hbm", 256, 143),
                         ("decode_attention_hbm_multi", 512,
                          [150, 182, 214, 246, 278, 310, 342, 374])):
        q, kn, vn = (torch.randn((B, H, 1, D), generator=gen, device=dev).to(bf)
                     for _ in range(3))
        kc, vc = (torch.randn((B, H, T // P, 128), generator=gen, device=dev).to(bf)
                  for _ in range(2))
        kern, plain = getattr(da, name), getattr(da, name + "_plain")
        positions = [pos] * B if isinstance(pos, int) else pos
        ku, vu = da.unpack_kv(kc, D), da.unpack_kv(vc, D)
        mask = (torch.arange(T, device=dev)[None] <= torch.tensor(positions, device=dev)[:, None])
        mask = mask[:, None, None, :]
        nbytes = packed_bytes(B, H, D, positions, 2)
        flops = packed_flops(H, D, positions)
        sdpa = lambda: F.scaled_dot_product_attention(q, ku, vu, attn_mask=mask)
        out[name] = {
            "ms": device_ms(lambda: kern(q, kn, vn, kc, vc, pos), n_iter, ["k_decode_hbm"]),
            "wrapper_ms": cuda_ms(lambda: kern(q, kn, vn, kc, vc, pos), n_iter),
            "plain_ms": cuda_ms(lambda: plain(q, kn, vn, kc, vc, pos), 20),
            "library_ms": device_ms(sdpa, n_iter),
            "library_wall_ms": cuda_ms(sdpa, n_iter),
            "bytes": nbytes, "flops": flops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS
                         else "operations")}
        if graph:
            out[name]["graph_ms"] = graph_ms(lambda: kern(q, kn, vn, kc, vc, pos), 20)
            out[name]["library_graph_ms"] = graph_ms(sdpa, 20)
    return out


def dense_da_timing(dev, gen, B, H, D, graph=False):
    """#9 at path B's shape: B slots, T = 192 (path B's cache), pos 160
    (mid-decode), dense bf16 cache, float32 q/k_new/v_new (the fused
    layer's qkv): device time (profiler, `k_decode_dense`), the plain
    version's (CUDA events), bytes, operations and bound; library: SDPA of
    the bf16 q against the dense cache with a length mask (profiler). With
    `graph`, also both by CUDA-graph replay ("graph_ms",
    "library_graph_ms")."""
    import torch
    import torch.nn.functional as F

    from llm_qat_tpu_torch.ops import decode_attention as da

    bf = torch.bfloat16
    T, pos = FUSED_T0 + FUSED_NEW, FUSED_T0 + FUSED_NEW // 2   # 192, 160
    q, kn, vn = (torch.randn((B, H, 1, D), generator=gen, device=dev) for _ in range(3))
    kc, vc = (torch.randn((B, H, T, D), generator=gen, device=dev).to(bf) for _ in range(2))
    mask = (torch.arange(T, device=dev) <= pos)[None, None, None, :]
    qb = q.to(bf)
    live = pos + 1
    kern = lambda: da.decode_attention(q, kn, vn, kc, vc, pos)
    sdpa = lambda: F.scaled_dot_product_attention(qb, kc, vc, attn_mask=mask)
    out = timing_row(
        device_ms(kern, 200, ["k_decode_dense"]),
        cuda_ms(lambda: da.decode_attention_plain(q, kn, vn, kc, vc, pos), 20),
        device_ms(sdpa, 200),
        3 * B * H * D * 4 + 2 * B * H * live * D * 2 + B * H * D * 4 + 2 * B * H * D * 2,
        4 * B * H * D * live / PEAK_BF16_FLOPS)
    if graph:
        out["graph_ms"] = graph_ms(kern, 20)
        out["library_graph_ms"] = graph_ms(sdpa, 20)
    return out


def da_split_sweep(dev, gen, B, H, D, failures):
    """#9 at path B's shape (dense bf16, T = 192, pos 160) and #8 at the
    server's (packed bf16, T = 512, slots at 150 ... 374) launched at every
    split of the cluster from 1 to 8 (`launch_dense`, `launch_hbm`),
    bypassing the plans: each split held against the plain version as the
    full run holds the wrappers (#9 within DA9_ABS; #8 within DA_BF16_ULPS
    and DA_DIFF_SHARE; the caches bit-equal to the plain version's), two
    calls bit-equal, and timed by graph replay (`graph_ms`, device ms per
    call) beside the split the plan picks. Returns {"name": {...}}."""
    import torch

    from llm_qat_tpu_torch.ops import decode_attention as da

    bf = torch.bfloat16
    P = 128 // D
    Td, pd = FUSED_T0 + FUSED_NEW, [FUSED_T0 + FUSED_NEW // 2] * B
    dq, dkn, dvn = (torch.randn((B, H, 1, D), generator=gen, device=dev) for _ in range(3))
    dkc, dvc = (torch.randn((B, H, Td, D), generator=gen, device=dev).to(bf) for _ in range(2))
    Tp, ph = 256, [150, 182, 214, 246, 278, 310, 342, 374]
    hq, hkn, hvn = (torch.randn((B, H, 1, D), generator=gen, device=dev).to(bf)
                    for _ in range(3))
    hkc, hvc = (torch.randn((B, H, Tp, P * D), generator=gen, device=dev).to(bf)
                for _ in range(2))
    cases = {
        "decode_attention": (
            lambda kc, vc, s: (da.launch_dense(dq, dkn, dvn, kc, vc, pd, s), kc, vc),
            lambda kc, vc: da.decode_attention_plain(dq, dkn, dvn, kc, vc, pd),
            dkc, dvc, da.dense_split(pd)),
        "decode_attention_hbm_multi": (
            lambda kc, vc, s: da.launch_hbm(hq, hkn, hvn, kc, vc, ph, 32, s),
            lambda kc, vc: da.decode_attention_hbm_multi_plain(hq, hkn, hvn, kc, vc, ph),
            hkc, hvc, da.hbm_split(ph, P, 32))}
    out = {}
    for name, (launch, plain, kc0, vc0, plan) in cases.items():
        op, pk, pv = plain(kc0.clone(), vc0.clone())
        ms, err = {}, {}
        for split in range(1, da.MAX_SPLIT + 1):
            ok, ck, cv = launch(kc0.clone(), vc0.clone(), split)
            again = launch(kc0.clone(), vc0.clone(), split)[0]
            torch.cuda.synchronize()
            same = torch.equal(ck, pk) and torch.equal(cv, pv) and torch.equal(ok, again)
            if name == "decode_attention":
                err[split] = (ok - op).abs().max().item()
                good = err[split] <= DA9_ABS
            else:
                err[split] = bf16_row_ulps(ok, op, FLASH_TRAIN_F32 * op.abs().max()).max().item()
                share = (ok.to(bf) != op.to(bf)).float().mean().item()
                good = err[split] <= DA_BF16_ULPS and share <= DA_DIFF_SHARE
            if not (good and same):
                failures.append(f"{name} split {split}: err {err[split]:.3e}, caches equal and "
                                f"repeat bit-equal {same}")
            kc, vc = kc0.clone(), vc0.clone()
            ms[split] = graph_ms(lambda: launch(kc, vc, split), 20)
        best = min(ms, key=ms.get)
        out[name] = {"ms": ms, "err": err, "plan": plan, "plan_ms": ms[plan], "best": best,
                     "best_ms": ms[best]}
        unit = "max abs err" if name == "decode_attention" else "bf16 ulps of the row's max"
        print(f"{name} split sweep (split: device ms by graph replay, {unit}): "
              + ", ".join(f"{s_}: {ms[s_]:.4f} {err[s_]:.2e}" for s_ in ms)
              + f"; plan {plan} ({ms[plan]:.4f}), best {best} ({ms[best]:.4f})", flush=True)
    print("da_split_sweep " + json.dumps(out), flush=True)
    return out


def decode_attention_phase(dev) -> int:
    """`--decode-attention`: kernels #7/#8/#9 alone, held against their
    plain versions as in the full run, then (where the tree has the split
    launchers) at every split of the cluster, and timed at the main paths'
    shapes by the profiler and by graph replay beside SDPA, with
    decode_attention.cu's ptxas report (for A/B runs of two trees on one
    card). Prints no result line; returns 1 if a hold failed."""
    import torch

    from llm_qat_tpu_torch.ops import _build
    from llm_qat_tpu_torch.ops import decode_attention as da

    print("ptxas, csrc/decode_attention.cu:\n" + _build.ptxas_report("decode_attention"),
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, H, D = 8, 12, 64
    failures = []
    decode_attention_vs_plain(gen, dev, B, H, D, failures)
    dense_attention_vs_plain(gen, dev, B, H, D, failures)
    if hasattr(da, "launch_dense"):
        da_split_sweep(dev, gen, B, H, D, failures)
    tm = da_timings(dev, gen, B, H, D, graph=True)
    tm["decode_attention"] = dense_da_timing(dev, gen, B, H, D, graph=True)
    print("decode_attention_timings " + json.dumps(tm), flush=True)
    for name, r in tm.items():
        print(f"{name}: {r['ms']:.4f} ms device time (profiler), {r['graph_ms']:.4f} by graph "
              f"replay; SDPA {r['library_ms']:.4f} / {r['library_graph_ms']:.4f}; bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']})", flush=True)
    torch.cuda.synchronize()
    for f in failures:
        print(f"chip_smoke --decode-attention: FAIL {f}", flush=True)
    return 1 if failures else 0


def bench_decode(params, cfg, dev, B, gen, kw_eng):
    """End to end at the bench shapes: `InferenceEngine.generate` with B
    rows, prompt 64, 512 new tokens, host clock around calls that end in a
    synchronise. Returns generate_512_s, decode_tok_s =
    B·511 / (t(512 new) − t(1 new)) and decode_ms_per_token_step."""
    import torch

    from llm_qat_tpu_torch.models.inference import InferenceEngine

    eng_b = InferenceEngine(params, cfg, **dict(kw_eng, max_len=64 + 512))
    pb = torch.randint(0, cfg.model.vocab_size, (B, 64), generator=gen, device=dev)
    eng_b.generate(pb, max_new_tokens=4)
    wall = {}
    for n in (1, 512):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng_b.generate(pb, max_new_tokens=n)
        torch.cuda.synchronize()
        wall[n] = time.perf_counter() - t
    return {"generate_512_s": wall[512], "decode_tok_s": B * 511 / (wall[512] - wall[1]),
            "decode_ms_per_token_step": 1e3 * (wall[512] - wall[1]) / 511}


MEGA_LAYER_SWEEP = (1, 2, 4, 12)  # depths of the per-layer cost fit


def mega_cases(md, cfg, trees, eng, gen, dev, B):
    """The decode steps at the main paths' shapes: #1 at pos 160 of a
    192-row KV4 cache and at the bench shape (T = 576, pos 320), on the mega
    W4 KV4 engine's weights; #3 at the kv_bits 16 engine's (a 160-row bf16
    cache at pos 143, tbp 64, W4 weights); #4 at the W4 KV4 server's steady
    state (a 512-row KV4 main cache, slots at lengths 118 ... 342, rpos 32
    of the 64-row recent buffer). Returns {tag: (wrapper name, h, weights,
    caches, trailing positional arguments, keywords, bytes the step must
    move)}."""
    import torch

    from llm_qat_tpu_torch.models.inference import init_layer_caches

    m = cfg.model
    L, d, H = m.n_layer, m.n_embd, m.n_head
    dc = d // 2
    cases = {}
    for tag, T, pos in (("kv8_pos160", 192, 160), ("kv8_bench", 576, 320)):
        kc, vc, ks, vs = eng._to_mega(init_layer_caches(cfg, B, T, eng.dtype, device=dev))
        kc.random_(-128, 128)
        vc.random_(-128, 128)
        h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
        kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=eng.dtype,
                  aq_max=eng._aq_max, tbp=64, kv_bits=4, tiles_per_step=4)
        cases[tag] = ("mega_decode_step_kv8", h, eng.mega, [kc, vc, ks, vs], [pos], kw,
                      step_bytes(eng.mega, B * pos, 2 * (dc + 4), B, d, 2 * (dc + 4)))
    mw4 = md.pack_mega_weights(trees[4], cfg)
    lens4, rpos4 = [118, 150, 182, 214, 246, 278, 310, 342], 32
    codes4 = lambda n: torch.randint(-128, 128, (L, B, n, dc), generator=gen, device=dev,
                                     dtype=torch.int8)
    sc4 = lambda n: 0.01 + 0.04 * torch.rand((L, B, n), generator=gen, device=dev)
    cb4 = [codes4(512), codes4(512), sc4(512), sc4(512), codes4(64), codes4(64), sc4(64),
           sc4(64)]
    kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=torch.bfloat16,
              aq_max=float(trees[4]["blocks"]["c_attn"]["qmax"][0]), tbp=64, kv_bits=4,
              tiles_per_step=4)
    cases["cb_server"] = ("mega_decode_step_cb", 0.5 * torch.randn((B, d), generator=gen,
                                                                   device=dev),
                          mw4, cb4, [lens4, rpos4], kw,
                          step_bytes(mw4, sum(lens4) + B * rpos4, 2 * (dc + 4), B, d,
                                     2 * (dc + 4)))
    c16 = [torch.randn((L, B, 160, d), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    kw16 = {k: v for k, v in kw.items() if k != "kv_bits"}
    cases["kv16_pos143"] = ("mega_decode_step", 0.5 * torch.randn((B, d), generator=gen,
                                                                  device=dev),
                            mw4, c16, [143], kw16,
                            step_bytes(mw4, B * 143, 2 * d * 2, B, d, 2 * d * 2))
    # #3 timed first: in an A/B run an older tree's #3, a host launch
    # sequence, took for its own the error that a grid sweep's refused
    # cooperative launch had left in the runtime
    return {"kv16_pos143": cases.pop("kv16_pos143"), **cases}


def mega_call(md, case, n_layers=None, grid=None, plain=False):
    """A no-argument call of a case's wrapper (or its plain version) on its
    first `n_layers` layers, at a forced `grid` where one is given."""
    name, h, mw, caches, rest, kw, _ = case
    if n_layers is not None:
        mw = md.MegaWeights(*(t[:n_layers] for t in mw))
        caches = [c[:n_layers] for c in caches]
    fn = getattr(md, name + ("_plain" if plain else ""))
    extra = {} if grid is None else {"grid": grid}
    return lambda: fn(h, mw, *caches, *rest, **kw, **extra)


MEGA_PHASES = ("G_qkv", "E_qkv", "ATT", "G_proj", "R1", "G_fc", "E_fc", "G_mlp", "R2")


def mega_phase_times(md, case):
    """Where the persistent step's time goes: one step with the barrier
    clock on (`md.phase_clock`: the card's global timer at every block's
    arrival at and release from every grid barrier). Per phase kind, the
    mean over layers of: its time (last release of the barrier before it to
    the last arrival at the one after it), the spread of the arrivals
    (first to last block) and the barrier's own latency (last arrival to
    last release), in microseconds; the phase before layer 0 is "P0" (its
    time counted from the first arrival)."""
    import torch

    fn = mega_call(md, case)
    fn()
    torch.cuda.synchronize()
    n_bar = md.mega_barriers(case[2].wt.shape[0])
    nb = md.step_grid(case[1].device)
    buf = torch.zeros((2 * n_bar, nb), dtype=torch.int64, device=case[1].device)
    md.phase_clock(buf)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        md.phase_clock(None)
    t = buf.double().cpu()
    arr, rel = t[0::2], t[1::2]
    out = {}
    for k in range(n_bar):
        name = "P0" if k == 0 else MEGA_PHASES[(k - 1) % len(MEGA_PHASES)]
        start = arr[k].min() if k == 0 else rel[k - 1].max()
        vals = (float(arr[k].max() - start), float(arr[k].max() - arr[k].min()),
                float(rel[k].max() - arr[k].max()))
        acc = out.setdefault(name, [0.0, 0.0, 0.0, 0])
        for i in range(3):
            acc[i] += vals[i] / 1e3
        acc[3] += 1
    return {k: {"us": v[0] / v[3], "arrival_spread_us": v[1] / v[3],
                "barrier_us": v[2] / v[3], "count": v[3]} for k, v in out.items()}


def mega_timings(md, cases, failures):
    """Per case: CUDA events over back-to-back steps (`ms`), profiler device
    time (`device_ms`), graph replay (`graph_ms`, or why a capture failed),
    the launches and device time per step of each CUDA kernel and copy the
    profiler records; the step at MEGA_LAYER_SWEEP depths with a least-squares
    line (cost per layer, fixed cost); where the wrapper takes a forced grid,
    the grid sweep (the plan's grid, half of it, one and two blocks per SM),
    each full-depth step held within MEGA_STEP_MAX of the plain version and
    two calls bit-equal. Returns {tag: {...}}."""
    import inspect

    import torch

    out = {}
    for tag, case in cases.items():
        fn = mega_call(md, case)
        r = {"ms": cuda_ms(fn, 50), "device_ms": device_ms(fn, 10), "bytes": case[6],
             "bound_ms": 1e3 * case[6] / HBM_BYTES_PER_S}
        try:
            r["graph_ms"] = graph_ms(fn, 20)
        except Exception as e:  # a capture the runtime refuses is recorded, not fatal
            r["graph_ms"] = None
            r["graph_error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
            torch.cuda.synchronize()
        per = {}
        for ev in _kernel_events(fn, 5):
            per[kernel_name(ev.key)] = {"launches_per_step": ev.count / 5,
                                        "us_per_step": ev.self_device_time_total / 5}
        r["by_kernel"] = per
        r["launches_per_step"] = sum(v["launches_per_step"] for v in per.values())
        if hasattr(md, "mega_barriers"):
            r["barriers"] = md.mega_barriers(case[2].wt.shape[0])
        if hasattr(md, "phase_clock") and r["launches_per_step"] == 1:  # k_mega alone
            r["phases"] = mega_phase_times(md, case)
            print(f"{tag} phases (us per layer: phase, arrival spread, barrier): "
                  + ", ".join(f"{k} {v['us']:.2f}/{v['arrival_spread_us']:.2f}/"
                              f"{v['barrier_us']:.2f}" for k, v in r["phases"].items()),
                  flush=True)
        if tag != "kv8_bench":
            depth = {}
            for nl in MEGA_LAYER_SWEEP:
                f_l = mega_call(md, case, n_layers=nl)
                depth[nl] = {"ms": cuda_ms(f_l, 50), "device_ms": device_ms(f_l, 10)}
            xs = list(depth)
            for key in ("ms", "device_ms"):
                ys = [depth[x][key] for x in xs]
                mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
                slope = (sum((x - mx) * (y - my) for x, y in zip(xs, ys))
                         / sum((x - mx) ** 2 for x in xs))
                r[f"per_layer_{key}"] = slope
                r[f"fixed_{key}"] = my - slope * mx
            r["depth"] = depth
        name = case[0]
        if "grid" in inspect.signature(getattr(md, name)).parameters and tag != "kv8_bench":
            dev = case[1].device
            nsm = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = md.step_grid(dev)
            ref = mega_call(md, case, plain=True)()[0]
            sweep = {}
            for g in sorted({plan, max(1, plan // 2), nsm, 2 * nsm}):
                f_g = mega_call(md, case, grid=g)
                try:
                    a, b = f_g()[0].clone(), f_g()[0].clone()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    sweep[g] = {"refused": str(e).splitlines()[0][:200]}
                    continue
                row = ((a - ref).abs().amax(dim=1) / ref.abs().max()).max().item()
                same = torch.equal(a, b)
                if not (row <= MEGA_STEP_MAX and same):
                    failures.append(f"{tag} grid {g}: row err {row:.3e}, repeat equal {same}")
                sweep[g] = {"ms": cuda_ms(f_g, 50), "device_ms": device_ms(f_g, 10),
                            "row_err": row, "repeat_bit_equal": same}
            r["grid_plan"] = plan
            r["grid_sweep"] = sweep
        out[tag] = r
        print(f"{tag}: {r['ms']:.4f} ms by events, {r['device_ms']:.4f} device, graph "
              f"{r['graph_ms']}; {r['launches_per_step']:g} launches per step "
              + json.dumps(per), flush=True)
    return out


def mega_decode_phase(dev) -> int:
    """`--mega-decode`: the decode steps #1, #3 and #4 alone (for A/B runs of
    two trees on one card): mega_decode.cu's ptxas report; #1's, #3's and
    #4's holds against their plain versions as in the full run (limits
    unchanged); `mega_timings` (events, profiler device time, graph replay,
    launches per step by kernel, the layer sweep, the barrier count and the
    grid sweep); then the end-to-end numbers the steps feed: `decode_tok_s`
    and the per-token step time at the bench shapes (KV4, and kv_bits 16
    through #3) and the mega W8 KV8 / W4 KV4 servers' end-to-end and steady
    tokens/s (without their token replays). Prints no result line; returns
    1 if a hold failed."""
    import torch

    from llm_qat_tpu_torch.models.inference import InferenceEngine, quantize_for_inference
    from llm_qat_tpu_torch.ops import _build
    from llm_qat_tpu_torch.ops import mega_decode as md

    print("ptxas, csrc/mega_decode.cu:\n" + _build.ptxas_report("mega_decode"), flush=True)
    cfg, params, gen = serve_setup(dev)
    B = 8
    trees = {4: quantize_for_inference(params, cfg, 4, weight_format="int4_xla"),
             8: quantize_for_inference(params, cfg, 8, weight_format="int8_xla")}
    for tree in trees.values():
        tree.pop("_static")
    failures = []
    kv8_step_vs_plain(md, trees, cfg, gen, dev, B, failures)
    spread_new = {}
    float_step_vs_plain(md, trees[4], cfg, gen, dev, B, failures, spread_new)
    cb_step_vs_plain(md, trees, cfg, gen, dev, B, failures, spread_new)
    spread_summary(spread_new, failures)
    kw_eng = dict(bits=4, max_batch=B, max_len=192, weight_format="int4_xla",
                  lm_head_bits=4, kv_layout="mega", kv_bits=4, mega_tbp=64)
    eng = InferenceEngine(params, cfg, **kw_eng)
    tm = mega_timings(md, mega_cases(md, cfg, trees, eng, gen, dev, B), failures)
    print("mega_timings " + json.dumps(tm), flush=True)
    e2e = {"bench": bench_decode(params, cfg, dev, B, gen, kw_eng),
           "bench_kv16": bench_decode(params, cfg, dev, B, gen, dict(kw_eng, kv_bits=16))}
    print(f"kv16 mega engine: {e2e['bench_kv16']['decode_ms_per_token_step']:.4f} ms a "
          f"token step (KV4: {e2e['bench']['decode_ms_per_token_step']:.4f})", flush=True)
    V = cfg.model.vocab_size
    prompts = [torch.randint(1, V, (n,), generator=gen, device=dev).tolist()
               for n, _ in zip(CB_PROMPTS * CB_REQUESTS, range(CB_REQUESTS))]
    for name in ("mega_w8kv8", "mega_w4kv4"):
        e2e[name] = serve_path(params, cfg, dev, name, prompts, replay=False)[0]
    print("mega_e2e " + json.dumps(e2e), flush=True)
    torch.cuda.synchronize()
    for f in failures:
        print(f"chip_smoke --mega-decode: FAIL {f}", flush=True)
    return 1 if failures else 0


def step_bytes(mw, kv_rows, kv_row_bytes, B, d, appended_row_bytes):
    """Bytes a whole-model decode step must move: the weight tiles, the
    LoRA tiles and per-tile vectors it reads (of the 12-tile bank, LoRA-A
    tiles 0, 3, 4, 8-11 and LoRA-B, scale and bias tiles 0-7, 11; the rest
    is zero padding), LN vectors, activation scales, h in and out, the KV
    rows the attention reads (`kv_rows` per layer, summed over the batch,
    `kv_row_bytes` each for K and V together) and the appended rows."""
    a_tiles, b_tiles = [0, 3, 4, 8, 9, 10, 11], [0, 1, 2, 3, 4, 5, 6, 7, 11]

    def nbytes(t):
        return t.numel() * t.element_size()

    L = mw.wt.shape[0]
    weights = (nbytes(mw.wt) + nbytes(mw.ln) + nbytes(mw.xs)
               + nbytes(mw.at[:, a_tiles]) + nbytes(mw.at_s[:, a_tiles])
               + sum(nbytes(t[:, b_tiles]) for t in (mw.bt, mw.bt_s, mw.ws, mw.bias)))
    return weights + L * kv_rows * kv_row_bytes + 2 * B * d * 4 + L * B * appended_row_bytes


def spread_summary(spread, failures):
    """Per (kernel, depth, activation dtype): the share of rows within the
    float-rounding limit MEGA_ROW_TIGHT (held, >= MEGA_TIGHT_SHARE, for the
    layers alone) and quantiles."""
    for (kernel, depth, an), rows in sorted(spread.items()):
        rs = sorted(rows)
        share = sum(e <= MEGA_ROW_TIGHT[an] for e in rs) / len(rs)
        q = {f"p{int(100 * f)}": rs[min(len(rs) - 1, int(f * len(rs)))]
             for f in (0.5, 0.9, 0.99)}
        held = f"tol >= {MEGA_TIGHT_SHARE}" if depth == "layer" else "not held"
        print(f"{kernel} {depth} {an}: {len(rs)} rows, within {MEGA_ROW_TIGHT[an]:g}: "
              f"{share:.3f} ({held}); quantiles "
              + " ".join(f"{k} {v:.2e}" for k, v in q.items()) + f"; max {rs[-1]:.2e}",
              flush=True)
        if depth == "layer" and share < MEGA_TIGHT_SHARE:
            failures.append(f"{kernel} layer {an}: {share:.3f} of rows within "
                            f"{MEGA_ROW_TIGHT[an]:g}")


QMM_LAYER = 0                  # the layer whose weights hold #10/#11 and time them
INT8_T0, INT8_NEW = 128, 32    # path A: prompt and new tokens
FD_LAYER = 0                   # the layer whose weights time #12/#13
FUSED_T0, FUSED_NEW = 128, 64  # path B: prompt and decode steps


def quant_matmul_vs_plain(tree, gen, dev, failures):
    """Kernels #10 and #11 against their plain versions at the four GPT-2
    linear shapes, M = 8 (a decode step) and 1024 (path A's prefill, B·S):
    #10 on the codes of the "int8" tree's first layer, #11 on the same
    weights packed as int4. Returns ({name: largest abs error}, launches of
    each in this hold)."""
    import torch

    from llm_qat_tpu_torch.ops import quant_matmul as qm

    errs = {"quant_matmul_int8": 0.0, "quant_matmul_int4": 0.0}
    before = {n: getattr(qm, n).launches for n in errs}
    for lin in LINEARS:
        p = tree["blocks"][lin]
        codes, ws = p["w_int8"][QMM_LAYER], p["w_s"][QMM_LAYER]
        w4, s4 = qm.pack_int4(codes.float() * ws)
        K, N = codes.shape
        for M in (8, 1024):
            x = torch.randn((M, K), generator=gen, device=dev)
            parts = []
            for name, w, s in (("quant_matmul_int8", codes, ws), ("quant_matmul_int4", w4, s4)):
                got = getattr(qm, name)(x, w, s)
                want = getattr(qm, name + "_plain")(x, w, s)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().item()
                errs[name] = max(errs[name], err)
                parts.append(f"{name} {rel:.2e}")
                if not rel <= QMM_REL:
                    failures.append(f"{name} {lin} M={M}: {rel:.3e} of max")
            print(f"quant_matmul kernels vs plain {lin} (M={M}, K={K}, N={N}), error / max "
                  f"|plain| (tol {QMM_REL:g}): " + "; ".join(parts), flush=True)
    return errs, {n: getattr(qm, n).launches - before[n] for n in errs}


def dense_attention_vs_plain(gen, dev, B, H, D, failures):
    """Kernel #9 against its plain version on dense caches of T = 192 (path
    B's) and 512, bf16 and float32, at shared positions 0, 100, T - 1 and
    one per slot; q, k_new, v_new float32 (the fused layer's qkv). Returns
    the largest absolute error."""
    import torch

    from llm_qat_tpu_torch.ops import decode_attention as da

    err = 0.0
    for T in (192, 512):
        slots = [0, 5, 64, 100, 150, T - 40, T - 2, T - 1]
        for dt in (torch.bfloat16, torch.float32):
            q, kn, vn = (torch.randn((B, H, 1, D), generator=gen, device=dev) for _ in range(3))
            kc, vc = (torch.randn((B, H, T, D), generator=gen, device=dev).to(dt)
                      for _ in range(2))
            for pos in (0, 100, T - 1, slots):
                ok, ck, cv = da.decode_attention(q, kn, vn, kc.clone(), vc.clone(), pos)
                op, pk, pv = da.decode_attention_plain(q, kn, vn, kc.clone(), vc.clone(), pos)
                torch.cuda.synchronize()
                e = (ok - op).abs().max().item()
                err = max(err, e)
                p = torch.tensor(pos, device=dev).expand(B)
                rest = (torch.arange(T, device=dev)[None] != p[:, None])[:, None].expand(B, H, T)
                same = torch.equal(ck, pk) and torch.equal(cv, pv)
                kept = torch.equal(ck[rest], kc[rest]) and torch.equal(cv[rest], vc[rest])
                tag = f"T={T} {str(dt)[6:]} pos {'per slot' if isinstance(pos, list) else pos}"
                print(f"decode_attention ({B},{H},1,{D}) dense {tag}: max abs err {e:.3e} (tol "
                      f"{DA9_ABS:g}); caches bit-equal {same}; other rows untouched {kept}",
                      flush=True)
                if not (e <= DA9_ABS and same and kept):
                    failures.append(f"decode_attention {tag}: err {e:.3e}, caches equal "
                                    f"{same}, other rows kept {kept}")
    return err


def fused_decode_vs_plain(tree, cfg, gen, dev, B, failures):
    """Kernels #12 and #13 against their plain versions, each layer alone on
    that layer's weights of the 8-bit int8_xla tree (rank-64 bf16 LoRA
    banks, static activation scales), h and attn drawn per layer. Returns
    the largest absolute error of each."""
    import torch

    from llm_qat_tpu_torch.models.sp_model import _layer
    from llm_qat_tpu_torch.ops import fused_decode as fd

    m = cfg.model
    rows = {"fused_ln_qkv": [], "fused_post_attention": []}
    errs = {k: 0.0 for k in rows}
    for li in range(m.n_layer):
        bp = _layer(tree["blocks"], li)
        ca = bp["c_attn"]
        h = torch.randn((B, m.n_embd), generator=gen, device=dev)
        attn = 0.5 * torch.randn((B, m.n_embd), generator=gen, device=dev)
        xs = torch.stack([bp[n]["x_s"] for n in ("attn_proj", "c_fc", "mlp_proj")])
        for name, args in (
                ("fused_ln_qkv", (h, bp["ln1"]["g"], bp["ln1"]["b"], ca["w_i8"], ca["w_s"],
                                  ca["b"], ca["x_s"], ca["lora_A"], ca["lora_B"])),
                ("fused_post_attention", (attn, h, bp["ln2"]["g"], bp["ln2"]["b"],
                                          bp["attn_proj"], bp["c_fc"], bp["mlp_proj"], xs))):
            got = getattr(fd, name)(*args, eps=m.layer_norm_epsilon)
            want = getattr(fd, name + "_plain")(*args, eps=m.layer_norm_epsilon)
            torch.cuda.synchronize()
            errs[name] = max(errs[name], (got - want).abs().max().item())
            rows[name] += ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()
    for name, rs in rows.items():
        share = sum(e <= FD_ROW_TIGHT for e in rs) / len(rs)
        print(f"{name} vs plain, each of {m.n_layer} layers alone (B={B}, rank "
              f"{cfg.quant.max_rank} bf16 LoRA): {len(rs)} rows, within {FD_ROW_TIGHT:g}: "
              f"{share:.3f} (tol >= {MEGA_TIGHT_SHARE}); row err max {max(rs):.3e} (tol "
              f"{MEGA_LAYER_MAX:g}), median {sorted(rs)[len(rs) // 2]:.2e}", flush=True)
        if not (share >= MEGA_TIGHT_SHARE and max(rs) <= MEGA_LAYER_MAX):
            failures.append(f"{name}: {share:.3f} of rows within {FD_ROW_TIGHT:g}, row err "
                            f"max {max(rs):.3e}")
    return errs


def int8_engine_path(params, cfg, dev, B, gen):
    """Path A: `InferenceEngine(bits=8, weight_format="int8",
    lm_head_bits=8)` with the card's "auto" layout (packed), B = 8, a
    128-token prompt (one aligned prefill through flash #2), 32 greedy new
    tokens, after a short warm-up; the counters of #2, #7 and #10 set to 0
    just before and read just after: #10 once per linear, layer and forward
    call (48 per call; the prefill and 32 decode calls), #7 once per layer
    and decode call. The tokens held against the plain path by teacher-forced
    replay and the jitter floor. Returns (launches, timings)."""
    import torch

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models.inference import InferenceEngine, init_layer_caches
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import quant_matmul as qm
    from llm_qat_tpu_torch.ops.attention import flash_attention

    T0, NEW, L = INT8_T0, INT8_NEW, cfg.model.n_layer
    kw = dict(bits=8, max_batch=B, max_len=T0 + NEW, weight_format="int8", lm_head_bits=8)
    eng = InferenceEngine(params, cfg, **kw)
    check(eng.kv_layout == "packed", "path A: 'auto' is the packed layout on the card")
    prompt = torch.randint(0, cfg.model.vocab_size, (B, T0), generator=gen, device=dev)
    eng.generate(prompt[:, :16], max_new_tokens=2)
    counters = (qm.quant_matmul_int8, da.decode_attention_hbm, flash_attention)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = eng.generate(prompt, max_new_tokens=NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    want = {"quant_matmul_int8": 4 * L * (1 + NEW), "decode_attention_hbm": L * NEW,
            "flash_attention": L}
    print(f"path A (InferenceEngine int8, packed) main path: {B} x {NEW} tokens in "
          f"{wall:.2f} s ({1e3 * wall / NEW:.2f} ms per token step, prefill included); "
          f"launches {launches}", flush=True)
    check(launches == want, f"path A: launches {launches} == {want} (#10: 48 per forward)")
    check(tuple(res.shape) == (B, T0 + NEW) and torch.equal(res[:, :T0], prompt),
          "path A: generate shape and prompt kept")
    toks = res[:, T0:]
    check(bool(((toks >= 0) & (toks < cfg.model.vocab_size)).all()), "path A: token ids")

    def replay(e):
        caches = init_layer_caches(cfg, B, T0 + NEW, e.dtype, kv_layout="packed", device=dev)
        logits, caches = e.prefill(prompt, caches)
        steps = [logits[:, -1]]
        for i in range(NEW - 1):
            last, caches = e._forward(toks[:, i:i + 1], caches, T0 + i)
            steps.append(last)
        return torch.stack(steps, dim=1)

    ref = InferenceEngine(params, cfg, use_kernels=False, **kw)
    lk, lp = replay(eng), replay(ref)
    patches = [(inference, "quant_matmul_int8_plain", "out"),
               (inference, "decode_attention_hbm_plain", "out"),
               (inference, "flash_attention_plain", "out")]
    lj = jittered_floor(patches, lambda: replay(ref), dev)
    hold_tokens("path A int8", toks, lk, lp, lj)
    return launches, {"generate_s": wall, "tokens": B * NEW}


def fused_decode_path(params, cfg, dev, B, gen, replay=True):
    """Path B: a greedy decode loop over `infer_forward_unrolled(
    fused_attention=True, fused_linears=True)` on the 8-bit int8_xla tree
    with the int8 head, dense bf16 caches, B = 8: a 128-token prefill through
    flash #2, then 64 steps, each of which must run #12, #9 and #13 once per
    layer and #10 never; the counters set to 0 just before and read just
    after. The tokens held against the plain path by teacher-forced replay
    and the jitter floor (unless `replay` is false). Then the fused step's
    time beside the unfused int8_xla step on the same tree and caches, and
    each step's launches. Returns (launches, timings)."""
    import numpy as np
    import torch

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models.inference import (
        infer_forward_unrolled,
        init_layer_caches,
        quantize_for_inference,
    )
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import fused_decode as fd
    from llm_qat_tpu_torch.ops import quant_matmul as qm
    from llm_qat_tpu_torch.ops.attention import flash_attention

    T0, NEW, L = FUSED_T0, FUSED_NEW, cfg.model.n_layer
    tree = quantize_for_inference(params, cfg, 8, weight_format="int8_xla", lm_head_bits=8)
    st = tree.pop("_static")
    prompt = torch.randint(0, cfg.model.vocab_size, (B, T0), generator=gen, device=dev)

    def prefill(use_kernels, fused):
        caches = init_layer_caches(cfg, B, T0 + NEW, torch.bfloat16, device=dev)
        kw = dict(static=st, use_kernels=use_kernels, fused_attention=fused,
                  fused_linears=fused)
        logits, caches, _ = infer_forward_unrolled(tree, prompt, cfg, caches, 0,
                                                   initial_prefill=True, **kw)
        return logits[:, -1], caches, kw

    def decode(use_kernels=True, toks=None):
        """Prefill, then NEW fused steps, greedy (toks None) or on toks.
        Returns (tokens (B, NEW), the logits each token was taken from)."""
        last, caches, kw = prefill(use_kernels, True)
        out, steps = [], []
        for i in range(NEW):
            steps.append(last)
            tok = last.argmax(-1) if toks is None else toks[:, i]
            out.append(tok)
            logits, caches, _ = infer_forward_unrolled(tree, tok[:, None], cfg, caches,
                                                       T0 + i, **kw)
            last = logits[:, -1]
        return torch.stack(out, dim=1), torch.stack(steps, dim=1)

    decode(toks=prompt[:, :NEW])  # warm-up
    counters = (fd.fused_ln_qkv, da.decode_attention, fd.fused_post_attention,
                qm.quant_matmul_int8, flash_attention)
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    toks, _ = decode()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {c.__name__: c.launches for c in counters}
    want = {"fused_ln_qkv": L * NEW, "decode_attention": L * NEW,
            "fused_post_attention": L * NEW, "quant_matmul_int8": 0, "flash_attention": L}
    print(f"path B (fused int8 decode layer, dense bf16 caches) main path: prefill + {NEW} "
          f"steps in {wall:.2f} s; launches {launches}", flush=True)
    check(launches == want, f"path B: launches {launches} == {want} (#12, #9, #13: "
          f"{L} each per step)")
    check(bool(((toks >= 0) & (toks < cfg.model.vocab_size)).all()), "path B: token ids")
    if replay:
        lk = decode(toks=toks)[1]
        lp = decode(use_kernels=False, toks=toks)[1]
        patches = [(fd, "_ln_f32", "out"), (fd, "_lora", "out"),
                   (inference, "decode_attention_plain", "out"),
                   (inference, "flash_attention_plain", "out")]
        lj = jittered_floor(patches, lambda: decode(use_kernels=False, toks=toks)[1], dev)
        hold_tokens("path B fused", toks, lk, lp, lj)

    def steps_ms(fused):
        """Host ms per decode step over NEW steps on toks (kernels on)."""
        _, caches, kw = prefill(True, fused)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(NEW):
            _, caches, _ = infer_forward_unrolled(tree, toks[:, i:i + 1], cfg, caches, T0 + i,
                                                  **kw)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / NEW

    def step_profile(fused):
        """Kernel launches and recorded device ms of one step at pos T0."""
        _, caches, kw = prefill(True, fused)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            infer_forward_unrolled(tree, toks[:, :1], cfg, caches, T0, **kw)
            torch.cuda.synchronize()
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count]
        return (sum(ev.count for ev in evs), sum(ev.self_device_time_total for ev in evs) / 1e3)

    runs = {"fused": [], "unfused": []}
    for name in ("fused", "unfused", "unfused", "fused"):
        runs[name].append(steps_ms(name == "fused"))
    tm = {"main_path_wall_s": wall}
    for name, ms in runs.items():
        n, busy = step_profile(name == "fused")
        tm[name] = {"ms_per_step_each": ms, "ms_per_step": float(np.median(ms)),
                    "device_launches_per_step": n, "device_busy_ms_per_step": busy}
    print("fused_decode_timings " + json.dumps(tm), flush=True)
    return launches, tm


def timing_row(ms, plain, lib, nbytes, t_o):
    """A kernel's timings with its bound; t_o: the operations' least time
    in seconds."""
    t_b = nbytes / HBM_BYTES_PER_S
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bytes": nbytes,
            "bound_ms": 1e3 * max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}


def qmm_timings(tree, gen, dev, n_iter=50):
    """#10/#11 on the "int8" tree, the four linears of one layer summed, at
    M = 8 (a decode step, the main path's usual shape) and M = 1024 (path
    A's prefill). `ms`: the profiler's device time of every CUDA kernel a
    wrapper call launches (names with "qmm"; `per_linear_ms` in LINEARS'
    order), on layer QMM_LAYER's weights, which stay in the 50 MB L2
    between calls; at M = 8 `cold_ms`: the same per layer over calls that
    cycle through all layers' weights in path A's order (12 x 7.1 MB of
    codes, more than the L2 holds), and `library_cold_ms` torch.mm's
    likewise. Plain: CUDA events. Library: the bf16 product alone (torch.mm
    of the bf16 input and the codes as bf16, float32 result)."""
    import torch

    from llm_qat_tpu_torch.ops import quant_matmul as qm

    f32, bf = torch.float32, torch.bfloat16
    blocks = tree["blocks"]
    L = blocks[LINEARS[0]]["w_int8"].shape[0]
    out = {}
    for name, bits in (("quant_matmul_int8", 8), ("quant_matmul_int4", 4)):
        kern, plain = getattr(qm, name), getattr(qm, name + "_plain")
        # per layer and linear: (weight, scale, codes as bf16 for torch.mm)
        ws = []
        for layer in range(L):
            per = []
            for lin in LINEARS:
                codes, sc = blocks[lin]["w_int8"][layer], blocks[lin]["w_s"][layer]
                w, s = (codes, sc) if bits == 8 else qm.pack_int4(codes.float() * sc)
                per.append((w, s, (codes if bits == 8 else qm.unpack_int4(w)).to(bf)))
            ws.append(per)
        for M in (8, 1024):
            acc = dict(ms=0.0, plain=0.0, lib=0.0, nbytes=0, ops=0.0)
            xs, per_linear = [], []
            for lin, (w, s, wb) in zip(LINEARS, ws[QMM_LAYER]):
                K, N = wb.shape
                x = torch.randn((M, K), generator=gen, device=dev).to(bf)
                xs.append(x)
                per_linear.append(device_ms(lambda: kern(x, w, s), n_iter, ["qmm"]))
                acc["ms"] += per_linear[-1]
                acc["plain"] += cuda_ms(lambda: plain(x, w, s), 10)
                acc["lib"] += device_ms(lambda: torch.mm(x, wb, out_dtype=f32), n_iter)
                acc["nbytes"] += 2 * M * K + K * N * bits // 8 + 4 * N + 4 * M * N
                acc["ops"] += 2 * M * K * N / PEAK_BF16_FLOPS
            r = timing_row(acc["ms"], acc["plain"], acc["lib"], acc["nbytes"], acc["ops"])
            r["per_linear_ms"] = per_linear
            if M == 8:
                def sweep():
                    for per in ws:
                        for x, (w, s, _) in zip(xs, per):
                            kern(x, w, s)

                def lib_sweep():
                    for per in ws:
                        for x, (_, _, wb) in zip(xs, per):
                            torch.mm(x, wb, out_dtype=f32)

                r["cold_ms"] = device_ms(sweep, 5, ["qmm"]) / L
                r["library_cold_ms"] = device_ms(lib_sweep, 5) / L
            out[f"{name}_M{M}"] = r
    return out


def fd_cases(tree, cfg, gen, dev, B, layer=FD_LAYER):
    """#12's and #13's operands on one layer of the 8-bit int8_xla tree
    (rank-64 bf16 LoRA banks, static activation scales), h and attn drawn:
    {name: (arguments, bytes the call must move, least time of its
    operations in seconds)}."""
    import torch

    from llm_qat_tpu_torch.models.sp_model import _layer

    m = cfg.model
    d, r = m.n_embd, cfg.quant.max_rank
    bp = _layer(tree["blocks"], layer)
    ca = bp["c_attn"]
    h = torch.randn((B, d), generator=gen, device=dev)
    attn = 0.5 * torch.randn((B, d), generator=gen, device=dev)
    xs = torch.stack([bp[n]["x_s"] for n in ("attn_proj", "c_fc", "mlp_proj")])

    def lin_bytes(lin):
        K, N = lin["w_i8"].shape
        return (K * N + 4 * lin["w_s"].numel() + 4 * N
                + lin["lora_A"].numel() * lin["lora_A"].element_size()
                + lin["lora_B"].numel() * lin["lora_B"].element_size())

    def lin_ops(lin):
        K, N = lin["w_i8"].shape
        return 2 * B * K * N / PEAK_INT8_OPS + 2 * B * r * (K + N) / PEAK_BF16_FLOPS

    return {
        "fused_ln_qkv": ((h, bp["ln1"]["g"], bp["ln1"]["b"], ca["w_i8"], ca["w_s"], ca["b"],
                          ca["x_s"], ca["lora_A"], ca["lora_B"]),
                         4 * B * d + 8 * d + lin_bytes(ca) + 4 + 4 * B * 3 * d, lin_ops(ca)),
        "fused_post_attention": ((attn, h, bp["ln2"]["g"], bp["ln2"]["b"], bp["attn_proj"],
                                  bp["c_fc"], bp["mlp_proj"], xs),
                                 8 * B * d + 8 * d + sum(lin_bytes(bp[n]) for n in LINEARS[1:])
                                 + 12 + 4 * B * d,
                                 sum(lin_ops(bp[n]) for n in LINEARS[1:]))}


def int8_kernel_timings(trees, cfg, gen, dev, B, n_iter=50):
    """#9-#13 at their main paths' shapes: device time (profiler), the plain
    versions' time (CUDA events), bytes, operations and bounds, and the
    library yardsticks. #10/#11: `qmm_timings`. #9: `dense_da_timing`.
    #12/#13: layer FD_LAYER of the int8_xla tree (`fd_cases`); no single
    PyTorch call computes either."""
    from llm_qat_tpu_torch.ops import fused_decode as fd

    eps = cfg.model.layer_norm_epsilon
    out = qmm_timings(trees["int8"], gen, dev, n_iter)
    out["decode_attention"] = dense_da_timing(dev, gen, B, cfg.model.n_head, cfg.model.head_dim)
    for name, (args, nbytes, ops) in fd_cases(trees[8], cfg, gen, dev, B).items():
        kern, plain = getattr(fd, name), getattr(fd, name + "_plain")
        out[name] = timing_row(device_ms(lambda: kern(*args, eps=eps), n_iter),
                               cuda_ms(lambda: plain(*args, eps=eps), 20), None, nbytes, ops)
    print("int8_kernel_timings " + json.dumps(out), flush=True)
    return out


FD_BATCHES = (1, 8, 16)   # batch rows of --fused-decode's holds
# the phases of one launch, in order (ops/fused_decode.py::barriers between them)
FD_PHASES = {"fused_ln_qkv": ("G_qkv", "E_qkv"),
             "fused_post_attention": ("G_proj", "E_proj", "G_fc", "E_fc", "G_mlp", "E_mlp")}


def fd_rows(fd, name, args, eps, **kw):
    """A wrapper call and its plain version: (kernel output, per batch row
    max |kernel - plain| / max |plain|)."""
    got = getattr(fd, name)(*args, eps=eps, **kw)
    want = getattr(fd, name + "_plain")(*args, eps=eps)
    return got, ((got - want).abs().amax(dim=1) / want.abs().max()).tolist()


def fd_hold(tag, rows, failures):
    """Rows held as the full run holds #12/#13: FD_ROW_TIGHT for a share of
    MEGA_TIGHT_SHARE, every row within MEGA_LAYER_MAX."""
    share = sum(e <= FD_ROW_TIGHT for e in rows) / len(rows)
    print(f"{tag}: {len(rows)} rows, within {FD_ROW_TIGHT:g}: {share:.3f} (tol >= "
          f"{MEGA_TIGHT_SHARE}); row err max {max(rows):.3e} (tol {MEGA_LAYER_MAX:g})",
          flush=True)
    if not (share >= MEGA_TIGHT_SHARE and max(rows) <= MEGA_LAYER_MAX):
        failures.append(f"{tag}: {share:.3f} of rows within {FD_ROW_TIGHT:g}, row err max "
                        f"{max(rows):.3e}")


def fd_batch_holds(tree, cfg, gen, dev, failures):
    """#12 and #13 at B = 1, 8 and 16, each of the layers alone on its own
    weights, held by `fd_hold`; a second call on the same inputs must be
    bit-equal to the first."""
    import torch

    from llm_qat_tpu_torch.ops import fused_decode as fd

    eps = cfg.model.layer_norm_epsilon
    for B in FD_BATCHES:
        rows = {name: [] for name in FD_PHASES}
        for layer in range(cfg.model.n_layer):
            for name, (args, _, _) in fd_cases(tree, cfg, gen, dev, B, layer).items():
                got, rs = fd_rows(fd, name, args, eps)
                again = getattr(fd, name)(*args, eps=eps)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    failures.append(f"{name} B={B} layer {layer}: repeat call not bit-equal")
                rows[name] += rs
        for name, rs in rows.items():
            fd_hold(f"{name} B={B}, each layer alone, repeat calls bit-equal", rs, failures)


def fd_phase_times(fd, name, args, eps, dev, calls=5):
    """Where a launch's time goes, from the kernel's barrier clock
    (`fd.phase_clock`: the global timer at every block's start, arrival at
    and release from every grid barrier, and end), the median over `calls`
    launches, in microseconds: each phase (the last release of the barrier
    before it, or the first start, to the last arrival at the barrier after
    it, or the last end), each barrier's latency (last arrival to last
    release) and arrival spread (first to last arrival), the launch's start
    skew (first to last block start) and its span (first start to last
    end)."""
    import statistics

    import torch

    names = FD_PHASES[name]
    n_bar = fd.barriers(len(names) // 2)
    nb = fd.fused_grid(dev)
    fn = lambda: getattr(fd, name)(*args, eps=eps)
    fn()
    runs = []
    for _ in range(calls):
        buf = torch.zeros((2 * n_bar + 2, nb), dtype=torch.int64, device=dev)
        fd.phase_clock(buf)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            fd.phase_clock(None)
        t = buf.double().cpu() / 1e3
        arr, rel, end, start = t[0:2 * n_bar:2], t[1:2 * n_bar:2], t[2 * n_bar], t[2 * n_bar + 1]
        r = {"span_us": float(end.max() - start.min()),
             "start_skew_us": float(start.max() - start.min())}
        for k, ph in enumerate(names):
            t0 = start.min() if k == 0 else rel[k - 1].max()
            t1 = end.max() if k == n_bar else arr[k].max()
            r[ph] = float(t1 - t0)
        for k in range(n_bar):
            r[f"barrier{k}_us"] = float(rel[k].max() - arr[k].max())
            r[f"barrier{k}_spread_us"] = float(arr[k].max() - arr[k].min())
        runs.append(r)
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def fd_grid_sweep(fd, cases, eps, dev, failures):
    """Each kernel at the plan's grid (one block per SM), half of it and two
    blocks per SM: held by `fd_hold`, two calls bit-equal, profiler device
    ms; a grid the runtime refuses raises, and is recorded as refused."""
    import torch

    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = fd.fused_grid(dev)
    out = {}
    for name, (args, _, _) in cases.items():
        sweep = {}
        for g in sorted({plan, plan // 2, 2 * nsm}):
            try:
                got, rows = fd_rows(fd, name, args, eps, grid=g)
                again = getattr(fd, name)(*args, eps=eps, grid=g)
                torch.cuda.synchronize()
            except RuntimeError as e:
                sweep[g] = {"refused": str(e).splitlines()[0][:200]}
                continue
            same = torch.equal(got, again)
            fd_hold(f"{name} grid {g}", rows, failures)
            if not same:
                failures.append(f"{name} grid {g}: repeat call not bit-equal")
            sweep[g] = {"device_ms": device_ms(lambda: getattr(fd, name)(*args, eps=eps, grid=g),
                                               20),
                        "row_err": max(rows), "repeat_bit_equal": same}
        check(plan in sweep and "refused" not in sweep[plan], f"{name} ran at the plan's grid")
        out[name] = {"grid_plan": plan, "sweep": sweep}
    return out


def fd_timings(fd, cases, eps, dev):
    """#12 and #13 at the table's shapes: CUDA events around back-to-back
    calls (`ms`), profiler device time (`device_ms`), graph replay
    (`graph_ms`, or why a capture failed), the host time of one wrapper call
    (`host_ms`), the launches and device µs per call of each CUDA kernel or
    copy the profiler records, the plain version's events ms, the bound;
    and where the kernel keeps a barrier clock, `fd_phase_times`."""
    import torch

    out = {}
    for name, (args, nbytes, ops) in cases.items():
        kern, plain = getattr(fd, name), getattr(fd, name + "_plain")
        fn = lambda: kern(*args, eps=eps)
        r = timing_row(cuda_ms(fn, 50), cuda_ms(lambda: plain(*args, eps=eps), 20), None,
                       nbytes, ops)
        r["device_ms"] = device_ms(fn, 20)
        try:
            r["graph_ms"] = graph_ms(fn, 20)
        except Exception as e:  # a capture the runtime refuses is recorded, not fatal
            r["graph_ms"] = None
            r["graph_error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
            torch.cuda.synchronize()
        r["host_ms"] = host_ms(fn, 50)
        per = {}
        for ev in _kernel_events(fn, 10):
            per[kernel_name(ev.key)] = {"launches_per_call": ev.count / 10,
                                        "us_per_call": ev.self_device_time_total / 10}
        r["by_kernel"] = per
        r["launches_per_call"] = sum(v["launches_per_call"] for v in per.values())
        if hasattr(fd, "phase_clock"):
            r["phases_us"] = fd_phase_times(fd, name, args, eps, dev)
        out[name] = r
        print(f"{name}: {r['ms']:.4f} ms by events, {r['device_ms']:.4f} device, graph "
              f"{r['graph_ms']}, host {r['host_ms']:.4f}; {r['launches_per_call']:g} launches "
              f"per call " + json.dumps(per), flush=True)
        if "phases_us" in r:
            print(f"{name} phases (us): " + json.dumps(r["phases_us"]), flush=True)
    return out


def fused_decode_phase(dev) -> int:
    """`--fused-decode`: kernels #12/#13 alone (for A/B runs of two trees on
    one card): fused_decode.cu's and mega_decode.cu's ptxas reports; the
    full run's holds of #12/#13 (`fused_decode_vs_plain`, limits unchanged);
    holds at B = 1, 8 and 16 with repeat calls bit-equal
    (`fd_batch_holds`); the grid sweep (`fd_grid_sweep`); `fd_timings` at the
    table's shapes (events, profiler and graph-replay ms, host ms a call,
    launches per call by kernel, the barrier clock's phases); the decode
    steps #1/#3/#4 at `mega_cases`' shapes by events and profiler (k_mega
    shares sm90.cuh's barrier); then path B (`fused_decode_path` without its
    token replay). Prints no result line; returns 1 if a hold failed."""
    import torch

    from llm_qat_tpu_torch.models.inference import InferenceEngine, quantize_for_inference
    from llm_qat_tpu_torch.ops import _build
    from llm_qat_tpu_torch.ops import fused_decode as fd
    from llm_qat_tpu_torch.ops import mega_decode as md

    for src in ("fused_decode", "mega_decode"):
        print(f"ptxas, csrc/{src}.cu:\n" + _build.ptxas_report(src), flush=True)
    cfg, params, gen = serve_setup(dev)
    B, eps = 8, cfg.model.layer_norm_epsilon
    trees = {4: quantize_for_inference(params, cfg, 4, weight_format="int4_xla"),
             8: quantize_for_inference(params, cfg, 8, weight_format="int8_xla")}
    for tree in trees.values():
        tree.pop("_static")
    failures = []
    fused_decode_vs_plain(trees[8], cfg, gen, dev, B, failures)
    fd_batch_holds(trees[8], cfg, gen, dev, failures)
    cases = fd_cases(trees[8], cfg, gen, dev, B)
    res = {}
    if hasattr(fd, "fused_grid"):
        res["grid_sweep"] = fd_grid_sweep(fd, cases, eps, dev, failures)
    res["timings"] = fd_timings(fd, cases, eps, dev)
    kw_eng = dict(bits=4, max_batch=B, max_len=192, weight_format="int4_xla",
                  lm_head_bits=4, kv_layout="mega", kv_bits=4, mega_tbp=64)
    eng = InferenceEngine(params, cfg, **kw_eng)
    res["mega"] = {}
    for tag, case in mega_cases(md, cfg, trees, eng, gen, dev, B).items():
        fn = mega_call(md, case)
        res["mega"][tag] = {"ms": cuda_ms(fn, 50), "device_ms": device_ms(fn, 10)}
    _, res["path_b"] = fused_decode_path(params, cfg, dev, B, gen, replay=False)
    print("fused_decode_ab " + json.dumps(res), flush=True)
    torch.cuda.synchronize()
    for f in failures:
        print(f"chip_smoke --fused-decode: FAIL {f}", flush=True)
    return 1 if failures else 0


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--fused-linear", action="store_true",
                    help="only hold and time kernels #14-#16 and the weight prologue")
    ap.add_argument("--quant-matmul", action="store_true",
                    help="only hold and time kernels #10/#11")
    ap.add_argument("--flash", action="store_true",
                    help="only hold and time kernels #5/#6")
    ap.add_argument("--decode-attention", action="store_true",
                    help="only hold, sweep and time kernels #7/#8/#9")
    ap.add_argument("--mega-decode", action="store_true",
                    help="only hold, sweep and time the decode steps #1/#3/#4")
    ap.add_argument("--fused-decode", action="store_true",
                    help="only hold, sweep and time the fused decode layer #12/#13")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models.inference import (
        InferenceEngine,
        _lm_head,
        _ln,
        init_layer_caches,
        quantize_for_inference,
    )
    from llm_qat_tpu_torch.ops import _build
    from llm_qat_tpu_torch.ops import attention as att
    from llm_qat_tpu_torch.ops import fused_linear as fl
    from llm_qat_tpu_torch.ops import mega_decode as md
    from llm_qat_tpu_torch.ops.attention import flash_attention

    # full-precision float32 matmuls (the exact integer dots rely on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    # 2. build
    t = time.time()
    _build.build_all()
    print(f"build: {time.time() - t:.1f} s (nvcc, sm_90a, one process per source, "
          f"in parallel)", flush=True)
    if args.fused_linear:
        return fused_linear_phase(dev)
    if args.quant_matmul:
        return quant_matmul_phase(dev)
    if args.flash:
        return flash_phase(dev)
    if args.decode_attention:
        return decode_attention_phase(dev)
    if args.mega_decode:
        return mega_decode_phase(dev)
    if args.fused_decode:
        return fused_decode_phase(dev)
    for src in ("fused_linear", "quant_matmul", "flash_attention", "decode_attention",
                "mega_decode", "fused_decode"):
        print(f"ptxas, csrc/{src}.cu:\n" + _build.ptxas_report(src), flush=True)
    print_ptxas_wgmma_flash(_build)

    cfg, params, gen = serve_setup(dev)
    m = cfg.model
    V, d, L, H = m.vocab_size, m.n_embd, m.n_layer, m.n_head

    # 3. kernels vs plain versions at GPT-2 widths. The decode step runs
    #    at full depth and, to keep a rounding-boundary difference from
    #    cascading through the layers, each layer alone on the same input.
    B = 8
    errs = {"mega_decode_step_kv8": 0.0}
    failures = []
    trees = {
        4: quantize_for_inference(params, cfg, 4, weight_format="int4_xla"),
        8: quantize_for_inference(params, cfg, 8, weight_format="int8_xla"),
    }
    for tree in trees.values():
        tree.pop("_static")

    errs["mega_decode_step_kv8"] = kv8_step_vs_plain(md, trees, cfg, gen, dev, B, failures)
    flash_errs = flash_serve_vs_plain(gen, dev, H, d // H, failures)
    errs.update(flash_train_vs_plain(gen, dev, B, H, d // H, failures))
    errs.update(decode_attention_vs_plain(gen, dev, B, H, d // H, failures))
    trees["int8"] = quantize_for_inference(params, cfg, 8, weight_format="int8")
    trees["int8"].pop("_static")
    qerrs, int4_launches = quant_matmul_vs_plain(trees["int8"], gen, dev, failures)
    errs.update(qerrs)
    errs["decode_attention"] = dense_attention_vs_plain(gen, dev, B, H, d // H, failures)
    errs.update(fused_decode_vs_plain(trees[8], cfg, gen, dev, B, failures))
    spread_new = {}
    errs["mega_decode_step"] = float_step_vs_plain(md, trees[4], cfg, gen, dev, B, failures,
                                                   spread_new)
    errs["mega_decode_step_cb"] = cb_step_vs_plain(md, trees, cfg, gen, dev, B, failures,
                                                   spread_new)
    spread_summary(spread_new, failures)
    check(not failures, "; ".join(failures))

    # 4. the main path: greedy serving at full GPT-2 width, B=8, prompt 128
    #    (reaches the flash prefill), 64 new tokens
    T0, NEW = 128, 64
    kw_eng = dict(bits=4, max_batch=B, max_len=T0 + NEW, weight_format="int4_xla",
                  lm_head_bits=4, kv_layout="mega", kv_bits=4, mega_tbp=64)
    eng = InferenceEngine(params, cfg, **kw_eng)
    prompt = torch.randint(0, V, (B, T0), generator=gen, device=dev)
    flash_attention.launches = 0
    flash_attention.route_launches.update(wgmma=0, simt=0)
    md.mega_decode_step_kv8.launches = 0
    out = eng.generate(prompt, max_new_tokens=NEW)
    torch.cuda.synchronize()
    launches = {"flash_attention": flash_attention.launches,
                "mega_decode_step_kv8": md.mega_decode_step_kv8.launches}
    flash_routes = dict(flash_attention.route_launches)
    print(f"main path launches: {launches}; #2 by route {flash_routes}", flush=True)
    check(launches["flash_attention"] == L, "main path ran the flash kernel once a layer")
    # the prefill's q, k, v come from the linears in float32 (as in JAX),
    # so #2 takes its SIMT route there; the kernels line reports the route
    # the main path took, at its dtype
    flash_route = "wgmma" if flash_routes["wgmma"] else "simt"
    check(flash_routes[flash_route] == L, f"main path ran #2 on one route: {flash_routes}")
    check(launches["mega_decode_step_kv8"] > 0, "main path ran the mega kernel")
    check(tuple(out.shape) == (B, T0 + NEW), "generate shape")
    check(torch.equal(out[:, :T0], prompt), "prompt kept")
    toks = out[:, T0:]
    check(bool(((toks >= 0) & (toks < V)).all()), "token ids in range")

    ref = InferenceEngine(params, cfg, use_kernels=False, **kw_eng)
    ref_out = ref.generate(prompt, max_new_tokens=NEW)
    free_agree = (ref_out[:, T0:] == toks).float().mean().item()

    def replay(e):
        """Teacher-forced per-step logits of `toks` through engine e."""
        caches = init_layer_caches(cfg, B, -(-(T0 + NEW) // 32) * 32, e.dtype,
                                   device=dev)
        logits, caches = e.prefill(prompt, caches)
        kc, vc, ks, vs = e._to_mega(caches)
        steps = [logits[:, -1]]
        for i in range(NEW - 1):
            last, kc, vc, ks, vs = e.mega_step(toks[:, i], T0 + i, kc, vc, ks, vs)
            steps.append(last)
        return torch.stack(steps, dim=1)

    # The floor: the plain path against itself with the output of each
    # kernel's plain version moved by a few float32 ulps (relative noise of
    # 2^-22). With random weights the served logits are nearly flat and 12
    # layers of 4-bit codes amplify such a difference; the kernels must agree
    # with the plain path about as well as this does.
    lk, lp = replay(eng), replay(ref)
    lj = jittered_floor([(inference, "flash_attention_plain", "out"),
                         (inference, "mega_decode_step_kv8_plain", "out")],
                        lambda: replay(ref), dev)
    hold_tokens("engine mega kv4", toks, lk, lp, lj)
    print(f"engine mega kv4 free-running agreement {free_agree:.4f}", flush=True)

    # 4a. the continuous-batching server, in its three configurations, and
    #     InferenceEngine's packed and mega kv_bits=16 layouts
    cb_prompts = [torch.randint(1, V, (n,), generator=gen, device=dev).tolist()
                  for n, _ in zip(CB_PROMPTS * CB_REQUESTS, range(CB_REQUESTS))]
    serve = {name: serve_path(params, cfg, dev, name, cb_prompts) for name in CB_CONFIGS}
    layout_launches = engine_layouts_path(params, cfg, dev, B, gen)

    # 4b. the int8 weight format (path A) and the fused int8 decode layer
    #     (path B)
    a_launches, _ = int8_engine_path(params, cfg, dev, B, gen)
    b_launches, _ = fused_decode_path(params, cfg, dev, B, gen)

    # 4c. training: kernels #14-#16 against their plain versions at the
    #     GPT-2 linear shapes, then the flat and the fused main paths from
    #     the same calibrated parameters, each with one step against the
    #     same step on its kernels' plain versions
    tcfg_model, tcfg, tparams, tbatches, tgen = train_setup(dev)
    Mt = tcfg.batch_size * tcfg.max_seq_length
    errs.update(fused_linear_vs_plain(tcfg_model, tparams, dev, Mt, failures))
    check(not failures, "; ".join(failures))
    tstate, train_step, tlaunch = train_path(tcfg_model, tcfg, tparams, tbatches, tgen, "flat")
    step_vs_plain(tcfg_model, tcfg, tstate, tbatches, dev, failures, att,
                  ("flash_fwd_lse", "flash_bwd"), ((2.0 ** -8, 2.0 ** -22), (2.0 ** -8,) * 3),
                  "flat")
    fcfg = tcfg_model.replace(linear_impl="fused")
    fstate, fstep, flaunch = train_path(fcfg, tcfg, tparams, tbatches, tgen, "fused")
    step_vs_plain(fcfg, tcfg, fstate, tbatches, dev, failures, fl,
                  ("fused_linear_fwd", "fused_linear_bwd_dx", "fused_linear_bwd_dw"),
                  ((FUSED_JITTER,), (FUSED_JITTER,) * 2, (FUSED_JITTER,)), "fused")
    check(not failures, "; ".join(failures))

    # 5. time on the card
    timings = {}
    # main-path shapes: flash #2 (8,12,128,64) bf16 once per layer, also
    # at the server's B = 1 and at T = 512; a mega step at pos 160 of a
    # 192-row cache
    st = flash_serve_timings(dev, H, d // H)
    print_flash_serve_timings(st)

    def mega_setup(T, pos):
        caches = init_layer_caches(cfg, B, T, eng.dtype, device=dev)
        kc, vc, ks, vs = eng._to_mega(caches)
        kc.random_(-128, 128)
        vc.random_(-128, 128)
        h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
        args = (h, eng.mega, kc, vc, ks, vs, pos)
        kw = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=eng.dtype,
                  aq_max=eng._aq_max, tbp=64, kv_bits=4, tiles_per_step=4)
        return args, kw

    def mega_bytes(mw, pos):
        """Bytes one step must move: the weight tiles, the LoRA tiles and
        per-tile vectors it reads (of the 12-tile bank, LoRA-A tiles 0, 3,
        4, 8-11 and LoRA-B, scale and bias tiles 0-7, 11; the rest is
        zero padding), LN vectors, activation scales, h in and out, the KV
        prefix [0, pos) with its row scales, and the appended rows."""
        a_tiles, b_tiles = [0, 3, 4, 8, 9, 10, 11], [0, 1, 2, 3, 4, 5, 6, 7, 11]

        def nbytes(t):
            return t.numel() * t.element_size()

        dc = d // 2  # KV4 code bytes per row
        weights = (nbytes(mw.wt) + nbytes(mw.ln) + nbytes(mw.xs)
                   + nbytes(mw.at[:, a_tiles]) + nbytes(mw.at_s[:, a_tiles])
                   + sum(nbytes(t[:, b_tiles]) for t in (mw.bt, mw.bt_s, mw.ws, mw.bias)))
        kv = 2 * L * B * pos * (dc + 4)
        return weights + kv + 2 * B * d * 4 + 2 * L * B * (dc + 4)

    mega_ops = 2 * B * L * 12 * d * d  # int8 multiply-adds of the 12 tiles
    # device time per CUDA kernel inside a decode step (main-path shapes),
    # the mean over 5 steps at pos 160
    args, kw = mega_setup(192, 160)
    md.mega_decode_step_kv8(*args, **kw)
    torch.cuda.synchronize()
    n_prof = 5
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            md.mega_decode_step_kv8(*args, **kw)
        torch.cuda.synchronize()
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count:
            name = kernel_name(ev.key)
            per_kernel[name] = {"launches_per_step": ev.count / n_prof,
                                "us_per_step": ev.self_device_time_total / n_prof}
    print("mega step device time by kernel (pos 160, B=8) "
          + json.dumps(per_kernel), flush=True)
    for tag, T, pos in (("", 192, 160), ("_bench", 576, 320)):
        args, kw = mega_setup(T, pos)
        timings[f"mega{tag}_ms"] = cuda_ms(lambda: md.mega_decode_step_kv8(*args, **kw), 50)
        timings[f"mega{tag}_plain_ms"] = cuda_ms(
            lambda: md.mega_decode_step_kv8_plain(*args, **kw), 3, warmup=1)
        nbytes = mega_bytes(eng.mega, pos)
        timings[f"mega{tag}_bytes"] = nbytes
        timings[f"mega{tag}_bound_ms"] = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                                   mega_ops / PEAK_INT8_OPS)
    mega_bound_by = ("bytes" if mega_bytes(eng.mega, 160) / HBM_BYTES_PER_S
                     >= mega_ops / PEAK_INT8_OPS else "operations")
    hf = _ln(torch.randn((B, 1, d), generator=gen, device=dev).to(eng.dtype),
             eng.iparams["ln_f"]["g"], eng.iparams["ln_f"]["b"], m.layer_norm_epsilon)
    timings["lm_head_ms"] = cuda_ms(lambda: _lm_head(eng.iparams, hf, eng._planes), 50)

    timings.update(bench_decode(params, cfg, dev, B, gen, kw_eng))
    timings.update({f"kv16_{k}": v for k, v in bench_decode(
        params, cfg, dev, B, gen, dict(kw_eng, kv_bits=16)).items()})
    print(f"kv16 mega engine: {timings['kv16_decode_ms_per_token_step']:.4f} ms a token step",
          flush=True)
    print("timings " + json.dumps(timings), flush=True)
    print("serving_timings " + json.dumps({n: tm for n, (tm, _) in serve.items()}), flush=True)

    # kernels #7/#8, and #3/#4 at the main paths' shapes: #3 the
    # InferenceEngine kv_bits=16 run (a 160-row bf16 cache at pos 143), #4
    # the W4 KV4 server's steady state (a 512-row KV4 main cache, slots at
    # their own lengths, rpos 32 of the 64-row recent buffer)
    dtm = da_timings(dev, gen, B, H, d // H)
    mw4 = md.pack_mega_weights(trees[4], cfg)
    kw_s = dict(n_head=H, head_dim=d // H, has_lora=True, act_dtype=torch.bfloat16,
                aq_max=float(trees[4]["blocks"]["c_attn"]["qmax"][0]), tbp=64,
                tiles_per_step=4)
    h = 0.5 * torch.randn((B, d), generator=gen, device=dev)
    c16 = [torch.randn((L, B, 160, d), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    lens4, rpos4 = [118, 150, 182, 214, 246, 278, 310, 342], 32
    codes4 = lambda n: torch.randint(-128, 128, (L, B, n, d // 2), generator=gen, device=dev,
                                     dtype=torch.int8)
    sc4 = lambda n: 0.01 + 0.04 * torch.rand((L, B, n), generator=gen, device=dev)
    cb4 = [codes4(512), codes4(512), sc4(512), sc4(512), codes4(64), codes4(64), sc4(64),
           sc4(64)]
    for name, args, kw_k, nbytes in (
            ("mega_decode_step", (h, mw4, *c16, 143), kw_s,
             step_bytes(mw4, B * 143, 2 * d * 2, B, d, 2 * d * 2)),
            ("mega_decode_step_cb", (h, mw4, *cb4, lens4, rpos4), dict(kw_s, kv_bits=4),
             step_bytes(mw4, sum(lens4) + B * rpos4, 2 * (d // 2 + 4), B, d,
                        2 * (d // 2 + 4)))):
        kern, plain = getattr(md, name), getattr(md, name + "_plain")
        dtm[name] = {"ms": cuda_ms(lambda: kern(*args, **kw_k), 50),
                     "device_ms": device_ms(lambda: kern(*args, **kw_k), 10),
                     "plain_ms": cuda_ms(lambda: plain(*args, **kw_k), 3, warmup=1),
                     "library_ms": None, "bytes": nbytes,
                     "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, mega_ops / PEAK_INT8_OPS),
                     "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= mega_ops / PEAK_INT8_OPS
                                  else "operations")}
    print("decode_kernel_timings " + json.dumps(dtm), flush=True)
    itm = int8_kernel_timings(trees, cfg, gen, dev, B)
    accum = tcfg.gradient_accumulation_steps
    it_flat, tstate = iteration_timings(tstate, train_step, tbatches, accum, tgen)
    iteration_profile(tstate, train_step, tbatches[0], tgen, it_flat["iter_ms"], "")
    it_fused, fstate = iteration_timings(fstate, fstep, tbatches, accum, tgen)
    iteration_profile(fstate, fstep, tbatches[0], tgen, it_fused["iter_ms"], "fused_")
    print("train_timings " + json.dumps({"flat": it_flat, "fused": it_fused}), flush=True)
    tt = flash_timings(dev, B, H, tbatches[0].shape[1], d // H)
    print("flash_timings " + json.dumps(tt), flush=True)
    ft = fused_timings(tcfg_model, tparams, dev, Mt)
    print_fused_timings(ft)

    # #2 at the served shape (B, H, T0, D) on the main path's route: q, k, v
    # read and o written once; Q.K^T and P.V over the causal half, on the
    # tensor cores in bf16 (wgmma) or outside them in float32 (SIMT)
    fdt, esz, fpeak = (("bf16", 2, PEAK_BF16_FLOPS) if flash_route == "wgmma"
                       else ("f32", 4, PEAK_F32_FLOPS))
    flash_bytes = 4 * B * H * T0 * (d // H) * esz
    flash_flops = 2 * B * H * (d // H) * T0 * (T0 + 1)
    flash_bound_s = max(flash_bytes / HBM_BYTES_PER_S, flash_flops / fpeak)
    served = st[f"{B}x{T0}"]
    kernels = [
        {"name": "mega_decode_step_kv8", "route": "cuda",
         "source": "llm_qat_tpu_torch/csrc/mega_decode.cu",
         "replaces": "llm_qat_tpu/ops/mega_decode.py:1245",
         "launches": launches["mega_decode_step_kv8"],
         "max_abs_err": errs["mega_decode_step_kv8"],
         "ms": timings["mega_ms"], "plain_ms": timings["mega_plain_ms"],
         "bound_ms": timings["mega_bound_ms"], "bound_by": mega_bound_by,
         "library_ms": None},
        {"name": "flash_attention", "route": "cuda",
         "source": "llm_qat_tpu_torch/csrc/flash_attention.cu",
         "replaces": "llm_qat_tpu/ops/attention.py:117",
         "launches": launches["flash_attention"],
         "max_abs_err": flash_errs["bfloat16" if fdt == "bf16" else "float32"],
         "ms": served[f"{fdt}_device_ms"], "events_ms": served[f"{fdt}_ms"],
         "plain_ms": served[f"{fdt}_plain_ms"], "bound_ms": 1e3 * flash_bound_s,
         "bound_by": ("bytes" if flash_bytes / HBM_BYTES_PER_S
                      >= flash_flops / fpeak else "operations"),
         "library_ms": served[f"sdpa_{fdt}_device_ms"],
         "library_events_ms": served[f"sdpa_{fdt}_ms"],
         "cuda_kernels": [{"wgmma": "flash_fwd_wgmma<false>",
                           "simt": "flash_fwd"}[flash_route]]},
    ]
    # kernels #5/#6 at the training path's shape: (B, H, T, D) bf16
    Tt, Dh = tbatches[0].shape[1], d // H
    pairs = B * H * Tt * (Tt + 1) // 2            # causal (q, k) pairs
    op_bytes = B * H * Tt * Dh * 2                # one bf16 operand
    lse_bytes = B * H * Tt * 4
    for name, line, n_tensors, n_products, lib, launched in (
            ("flash_fwd_lse", 303, 4, 2, tt["sdpa_fwd_device_ms"], ["flash_fwd_wgmma"]),
            ("flash_bwd", 359, 8, 5, tt["sdpa_bwd_device_ms"],
             ["flash_bwd_prep", "flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma"])):
        nbytes = n_tensors * op_bytes + lse_bytes
        flops = n_products * 2 * Dh * pairs
        kernels.append({
            "name": name, "route": "cuda",
            "source": "llm_qat_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"llm_qat_tpu/ops/attention.py:{line}",
            "launches": tlaunch[name], "max_abs_err": errs[name],
            "ms": tt[f"{name}_ms"], "plain_ms": tt[f"{name}_plain_ms"],
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_BF16_FLOPS),
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_BF16_FLOPS
                         else "operations"),
            "library_ms": lib, "cuda_kernels": launched})
    # kernels #14-#16 summed over the four linears of one layer at the
    # training path's shapes, at the 8-bit log slot (the dearest fake-quant);
    # ms by CUDA events around back-to-back wrapper calls (#14/#15: the
    # weight prologue and the GEMM)
    r = tcfg_model.quant.max_rank
    shapes = [tuple(tparams["blocks"][lin]["w"].shape[1:]) for lin in LINEARS]
    log_slot = tcfg_model.quant.prec_index(8)
    for name, line in (("fused_linear_fwd", 134), ("fused_linear_bwd_dx", 225),
                       ("fused_linear_bwd_dw", 263)):
        row = [ft[log_slot][lin][name] for lin in LINEARS]
        bf = [fused_bytes_flops(name, Mt, K, N, r) for K, N in shapes]
        t_bytes = [b / HBM_BYTES_PER_S for b, _ in bf]
        t_ops = [f / PEAK_BF16_FLOPS for _, f in bf]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "llm_qat_tpu_torch/csrc/fused_linear.cu",
            "replaces": f"llm_qat_tpu/ops/fused_linear.py:{line}",
            "launches": flaunch[name], "max_abs_err": errs[name],
            "ms": sum(x["ms"] for x in row), "plain_ms": sum(x["plain_ms"] for x in row),
            "bound_ms": 1e3 * sum(max(a, b) for a, b in zip(t_bytes, t_ops)),
            "bound_by": "operations" if sum(t_ops) >= sum(t_bytes) else "bytes",
            "library_ms": sum(x["library_ms"] for x in row)})
    new_launches = {
        "decode_attention_hbm": layout_launches["packed"]["decode_attention_hbm"],
        "decode_attention_hbm_multi": serve["packed_w8a8"][1]["decode_attention_hbm_multi"],
        "mega_decode_step": layout_launches["mega"]["mega_decode_step"],
        "mega_decode_step_cb": sum(serve[n][1]["mega_decode_step_cb"]
                                   for n in ("mega_w8kv8", "mega_w4kv4"))}
    for name, src, replaces in (
            ("mega_decode_step", "mega_decode.cu", "mega_decode.py:667"),
            ("mega_decode_step_cb", "mega_decode.cu", "mega_decode.py:1400"),
            ("decode_attention_hbm", "decode_attention.cu", "decode_attention.py:361"),
            ("decode_attention_hbm_multi", "decode_attention.cu", "decode_attention.py:591")):
        t_ = dtm[name]
        kernels.append({
            "name": name, "route": "cuda", "source": f"llm_qat_tpu_torch/csrc/{src}",
            "replaces": f"llm_qat_tpu/ops/{replaces}", "launches": new_launches[name],
            "max_abs_err": errs[name], "ms": t_["ms"], "plain_ms": t_["plain_ms"],
            "bound_ms": t_["bound_ms"], "bound_by": t_["bound_by"],
            "library_ms": t_["library_ms"]})
    # kernels #9-#13: #10/#11 per layer (four linears) at a decode step's
    # M = 8; #9 at path B's cache, #12/#13 one layer
    new_launches = {"decode_attention": b_launches["decode_attention"],
                    "quant_matmul_int8": a_launches["quant_matmul_int8"],
                    "quant_matmul_int4": int4_launches["quant_matmul_int4"],
                    "fused_ln_qkv": b_launches["fused_ln_qkv"],
                    "fused_post_attention": b_launches["fused_post_attention"]}
    for name, src, replaces, key in (
            ("decode_attention", "decode_attention.cu", "decode_attention.py:129",
             "decode_attention"),
            ("quant_matmul_int8", "quant_matmul.cu", "quant_matmul.py:124", "quant_matmul_int8_M8"),
            ("quant_matmul_int4", "quant_matmul.cu", "quant_matmul.py:151", "quant_matmul_int4_M8"),
            ("fused_ln_qkv", "fused_decode.cu", "fused_decode.py:129", "fused_ln_qkv"),
            ("fused_post_attention", "fused_decode.cu", "fused_decode.py:165",
             "fused_post_attention")):
        t_ = itm[key]
        kernels.append({
            "name": name, "route": "cuda", "source": f"llm_qat_tpu_torch/csrc/{src}",
            "replaces": f"llm_qat_tpu/ops/{replaces}", "launches": new_launches[name],
            "max_abs_err": errs[name], "ms": t_["ms"], "plain_ms": t_["plain_ms"],
            "bound_ms": t_["bound_ms"], "bound_by": t_["bound_by"],
            "library_ms": t_["library_ms"]})
    check(len(kernels) == 16, "the kernels line has a row for each of the 16 kernels")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
