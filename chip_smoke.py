#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Run from the repository root on a machine with an H100 (no arguments):

    python3 chip_smoke.py

It builds the port's CUDA kernels from `llm_qat_tpu_torch/csrc/`, holds each
kernel against its plain PyTorch version at GPT-2 124M widths, and drives
the port's paths with random weights from a seed, each with the launch
counters set to 0 just before it and read just after:

- first, the SP command line `python -m llm_qat_tpu_torch.cli.main_sp` at
  GPT-2 124M, T = 1024, offline, as `--main-sp` below runs it;

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
- KV-cached generation with the serving parameters, as `--cached-generate`
  below runs it, and the SP evaluation command `python -m
  llm_qat_tpu_torch.cli.eval_sp` at T = 1024, as `--eval-sp` below runs it;
- the CPT and SQuAD command lines, as `--main-cpt` and `--main-squad` below
  run them, and the RPI command line `python -m
  llm_qat_tpu_torch.cli.run_rpi` with its gradient importance, as
  `--run-rpi` below runs them but the command on the first text only and
  at GPT-2 width with RPI_DEFAULT_LAYERS layers (for the time limit);
- the parallel layer on one NCCL group of world size 1, as `--parallel`
  below runs it but at PARALLEL_DEFAULT_LAYERS layers: TP/DP, CP and PP
  train steps and TP decode, each held against its single-device path,
  with #2, #5 and #6 launched on DTensor-held or local operands;
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
- `main_sp_timings`, `cached_generate_timings`, `eval_sp_timings`,
  `main_cpt_timings`, `main_squad_timings`, `rpi_timings`, `timings`,
  `serving_timings`, `fused_decode_timings`,
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

    python3 chip_smoke.py --main-sp

runs only the SP command line (`main_sp.main`, GPT-2 124M, B = 8, T =
1024, accum 8, bits 4/8/32, offline: the byte tokenizer, the synthetic
corpus, random init) three times: a 5-iteration run with elastic saves
stopped after 3 iterations, its relaunch with `--auto-resume` (2
iterations, to step 5, then the per-bit checkpoints, which must reload
bit for bit), and 5 iterations uninterrupted, whose final state the
relaunch must equal bit for bit. Every train step must launch #5 and #6 96
times each on their wgmma route. Prints `main_sp_timings` (dataset build,
calibration, each iteration, host ms of each async save) and no result
line.

    python3 chip_smoke.py --cached-generate

runs only the KV-cached generation paths at GPT-2 124M (serve_setup's
calibrated parameters, B = 8, a 128-token prompt, 32 greedy tokens), each
with every kernel's counter set to 0 just before it and read just after:
(a) `models.generate.generate` on the SP parameters at 8 bits (float32),
which runs no kernel, its tokens held by a teacher-forced replay through
the uncached `sp_forward`; (b) a greedy loop of `infer_forward_with_cache`
on the `weight_format="int8"` tree, which must run #10 48 times a call
(33 calls); (c) the same loop over `infer_forward_unrolled` on
`init_layer_caches(kv_bits=8)` (the int8 `QuantizedKV` caches), #10 as in
(b), its caches after the prefill held against the plain path's (layer 0
tightly, all layers against the jitter floor); (b) and (c) held against
`use_kernels=False`; (d) the folded LoRA tree against the factored one,
float32, within the floor. Prints `cached_generate_timings` (prefill and
token-step ms, launches by kernel) and no result line.

    python3 chip_smoke.py --eval-sp

runs only the SP evaluation command: a calibrated GPT-2 124M (bits
4/8/32, per-channel) saved by `save_per_bit_checkpoints`, then
`eval_sp.main` offline on sp_8bit.npz and sp_4bit.npz (`--max-length 1024
--stride 512 --synthetic-tasks`; the 4-bit run without the zero-shot
suite), which must run #5 12 times per forward, all on its float32 SIMT
route; the 8-bit run again on #5's plain version: the perplexity within
1e-4, the zero-shot choices the same but at ties. Prints `eval_sp_timings`
and no result line. The two flags may be given together.

    python3 chip_smoke.py --run-rpi

runs only the RPI command line (`run_rpi.main`, GPT-2 124M, bits 4/8/32,
float32, the command's random initialisation, offline: the byte
tokenizer, the synthetic corpus, the static synonym table and MLM
stand-in) on its first two texts (271 words at T = 1024, each forward
through #5 on its SIMT route, 12 launches; 63 words at T = 355, dense),
every forward counted and timed; checks the launches, the report's keys
and finite accuracies, and each switched forward against a host replay
of its `random.Random(seed)`. Then `make_gradient_importance_fn` on the
first text (#5 and #6 on SIMT, 12 launches each), and at GPT-2 width with
2 layers, T = 1024, `metrics_at` at 32 and 4 bits and the importance
scores, card against CPU within 4x the CPU's jitter floor. Prints
`rpi_timings`, then the result line.

    python3 chip_smoke.py --parallel

runs only the parallel layer (`parallel_phase`) at GPT-2 width with 12
layers on one NCCL group of world size 1 (a FileStore): the TP/DP step on
`shard_params` DTensors (#5/#6 on their local shards), the CP forward and
step with `ring_attention`, the PP step (`make_pp_sp_train_step`, S = 1,
M = 2) and TP decode on the sharded int8_xla tree (#2 in the prefill),
each held against its single-device path (bit-equal, or within its
jitter floor), each path's wall beside the single-device one. Prints
`parallel_timings`, then the result line.

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

import importlib
import json
import math
import os
import subprocess
import sys
import time

# the card's peaks (H100 SXM, dense), from the port's single source
from llm_qat_tpu_torch.utils.profiling import (  # noqa: E402
    H100_HBM_BW as HBM_BYTES_PER_S,
    H100_PEAK_BF16_FLOPS as PEAK_BF16_FLOPS,
    H100_PEAK_F32_FLOPS as PEAK_F32_FLOPS,
    H100_PEAK_INT8_OPS as PEAK_INT8_OPS,
)

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


def train_setup(dev, n_layer=12):
    """GPT-2 124M training config (bits 4/8/32, default kinds, rank 64, bf16
    compute; `n_layer` blocks), B = 8, T = 1024, accum 8; random weights
    from seed 0, calibrated by CalibrationManager on 3 batches. Returns
    (cfg, tcfg, params, batches, generator)."""
    import torch

    from llm_qat_tpu_torch.models.config import (
        GPT2Config,
        QuantConfig,
        SPModelConfig,
        TrainConfig,
    )
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager

    cfg = SPModelConfig(model=GPT2Config(n_layer=n_layer),
                        quant=QuantConfig(bit_widths=(4, 8, 32)), compute_dtype="bfloat16")
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

    qm = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")

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
    qm = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")
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
    qm = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")
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

    qm = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")

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


# The SP command line at GPT-2 124M, T = 1024 (the trainable flash kernels'
# shape), offline: the synthetic corpus, the byte tokenizer, random init.
MAIN_SP_FLAGS = ["--max-seq-length", "1024", "--batch-size", "8", "--grad-accum", "8",
                 "--bit-widths", "4", "8", "32", "--eval-interval", "2",
                 "--num-iterations", "5"]
MAIN_SP_PREEMPT = 3   # iterations the first run takes before it is stopped
# The default run cuts the command's corpus (80,000 train and 5,000
# validation documents of the offline corpus, 855,013 and 53,863 windows,
# about 13 s of build in each of the three runs) to these documents: its
# 5 iterations read 320 windows. `--main-sp` keeps the whole corpus.
MAIN_SP_DEFAULT_DOCS = (8000, 1000)


class Preempted(Exception):
    """Stops a `main_sp` run between two iterations, as a preemption would."""


def main_sp_phase(dev, card: str, docs=None) -> int:
    """`--main-sp` (and part of the default run): `python -m
    llm_qat_tpu_torch.cli.main_sp` through `main_sp.main`, three times, on
    its whole corpus or, with `docs` = (train, validation), on that many
    documents of it:

    A. the command with `--save-every 1 --auto-resume`, stopped before its
       fourth iteration once its third elastic save has landed;
    B. the same command relaunched: it resumes at iteration 3, takes 2
       iterations, ends at step 5 and writes the per-bit checkpoints;
    C. the command without elastic saves, from a fresh directory, 5
       iterations uninterrupted.

    Around every train step the counters of #5 and #6 are set to 0 just
    before and read just after: 96 launches each (12 layers x 8
    micro-steps), all on the wgmma route. Eval and calibration run outside
    the steps. Checks finite losses, the per-bit files reloading bit for
    bit, and B's final state (params, AdamW moments, count, step) against
    C's, bit for bit. Prints `main_sp_timings`: the dataset build, the
    calibration, every iteration (host clock around a synchronised step)
    and the host ms of each async save. Returns 0, or raises."""
    import shutil
    import statistics
    import tempfile

    import torch

    from llm_qat_tpu_torch.cli import main_sp
    from llm_qat_tpu_torch.deploy import elastic, load_checkpoint
    from llm_qat_tpu_torch.ops import attention as att

    # offline: the tokenizer, corpus and pretrained weights fall back to the
    # byte tokenizer, the synthetic corpus and random init, and the hub is
    # never asked
    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    rec = {"data_s": [], "calib_s": [], "iter_ms": {}, "save_host_ms": [],
           "losses": {}, "data": []}
    managers = []
    per_iter = 12 * 8
    make, manager_cls, calib_cls = (main_sp.make_sp_train_step, main_sp.AsyncCheckpointManager,
                                    main_sp.CalibrationManager)
    make_dataloaders = main_sp.create_dataloaders

    def instrumented(run, stop_after=None):
        """Wraps main_sp's steps, data build, calibration and saves for one
        run named `run`."""
        rec["iter_ms"][run], rec["losses"][run] = [], []

        def make_counted(*a, **k):
            init_state, step = make(*a, **k)

            def train_step(state, ids, gen):
                if stop_after is not None and len(rec["iter_ms"][run]) == stop_after:
                    raise Preempted
                for fn in (att.flash_fwd_lse, att.flash_bwd):
                    fn.launches = 0
                    fn.route_launches.update(wgmma=0, simt=0)
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, mt = step(state, ids, gen)
                torch.cuda.synchronize()
                rec["iter_ms"][run].append(1e3 * (time.perf_counter() - t))
                for fn in (att.flash_fwd_lse, att.flash_bwd):
                    check(fn.launches == per_iter and fn.route_launches["wgmma"] == per_iter,
                          f"main_sp {run}: {fn.__name__} ran {fn.launches} times in a train "
                          f"step, by route {fn.route_launches}; want {per_iter} on wgmma")
                rec["losses"][run].append([float(mt[k]) for k in ("loss", "teacher_loss")])
                return state, mt

            return init_state, train_step

        def timed_dataloaders(tokenizer, *a, **k):
            if docs is not None:
                k = dict(k, train_limit=docs[0], val_limit=docs[1])
            t = time.perf_counter()
            out = make_dataloaders(tokenizer, *a, **k)
            rec["data_s"].append(time.perf_counter() - t)
            rec["data"].append({"tokenizer": type(tokenizer).__name__,
                                "train_windows": len(out[0]), "val_windows": len(out[1])})
            return out

        class Calibration(calib_cls):
            def calibrate_all_precisions(self, *a, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = super().calibrate_all_precisions(*a, **k)
                torch.cuda.synchronize()
                rec["calib_s"].append(time.perf_counter() - t)
                return out

        class Manager(manager_cls):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                managers.append(self)

            def save(self, *a, **k):
                t = time.perf_counter()
                super().save(*a, **k)
                rec["save_host_ms"].append(1e3 * (time.perf_counter() - t))

        return {"make_sp_train_step": make_counted, "create_dataloaders": timed_dataloaders,
                "CalibrationManager": Calibration, "AsyncCheckpointManager": Manager}

    def run_main(run, argv, stop_after=None):
        patches = instrumented(run, stop_after)
        saved = {name: getattr(main_sp, name) for name in patches}
        for name, fn in patches.items():
            setattr(main_sp, name, fn)
        try:
            return main_sp.main(argv)
        finally:
            for name, fn in saved.items():
                setattr(main_sp, name, fn)
            for mgr in managers:
                mgr.wait()
            managers.clear()

    root = tempfile.mkdtemp(prefix="main_sp_")
    try:
        dir_ab, dir_c = os.path.join(root, "ab"), os.path.join(root, "c")
        elastic_flags = ["--save-every", "1", "--auto-resume"]
        try:
            run_main("A", MAIN_SP_FLAGS + elastic_flags + ["--output-dir", dir_ab],
                     stop_after=MAIN_SP_PREEMPT)
            check(False, "main_sp A was not stopped")
        except Preempted:
            pass
        saved_steps = sorted(os.listdir(os.path.join(dir_ab, "elastic")))
        check(saved_steps == [f"step_{s:010d}.npz" for s in range(MAIN_SP_PREEMPT)],
              f"main_sp A: elastic saves {saved_steps}")
        state_b, stats_b = run_main("B", MAIN_SP_FLAGS + elastic_flags
                                    + ["--output-dir", dir_ab])
        check(len(stats_b.iteration_losses) == 2 and state_b.step == 5,
              f"main_sp B resumed at iteration 3 and took 2 ({stats_b.iteration_losses}), "
              f"ending at step 5 ({state_b.step})")
        for bits in (4, 8):
            params, meta = load_checkpoint(os.path.join(dir_ab, f"sp_{bits}bit.npz"), device=dev)
            check(meta["bit_width"] == bits, f"main_sp B: sp_{bits}bit.npz meta {meta['bit_width']}")
            same = [torch.equal(a, b) for a, b in zip(elastic.tree_leaves(params),
                                                       elastic.tree_leaves(state_b.params))]
            check(len(same) == len(elastic.tree_leaves(state_b.params)) and all(same),
                  f"main_sp B: sp_{bits}bit.npz reloads bit for bit")
        check(not os.path.exists(os.path.join(dir_ab, "sp_32bit.npz")),
              "main_sp B: no file for the 32-bit teacher")
        shutil.rmtree(dir_ab)
        state_c, stats_c = run_main("C", MAIN_SP_FLAGS + ["--output-dir", dir_c])
        check(len(stats_c.iteration_losses) == 5 and state_c.step == 5,
              "main_sp C took 5 iterations")
        losses = [x for run in "ABC" for pair in rec["losses"][run] for x in pair]
        check(all(math.isfinite(x) for x in losses), f"main_sp: finite losses {rec['losses']}")
        check(rec["losses"]["A"] == rec["losses"]["C"][:MAIN_SP_PREEMPT]
              and rec["losses"]["B"] == rec["losses"]["C"][MAIN_SP_PREEMPT:],
              f"main_sp: A and B's losses are C's: {rec['losses']}")
        lb, lc = elastic.tree_leaves(state_b), elastic.tree_leaves(state_c)
        check(len(lb) == len(lc), "main_sp: B and C have the same state structure")
        n_diff, max_diff = 0, 0.0
        for x, y in zip(lb, lc):
            if isinstance(x, torch.Tensor):
                if not torch.equal(x, y):
                    n_diff += 1
                    max_diff = max(max_diff, (x.double() - y.double()).abs().max().item())
            elif x != y:
                n_diff += 1
        print(f"main_sp resumed (B) vs uninterrupted (C): {n_diff} of {len(lb)} state leaves "
              f"differ, max |difference| {max_diff!r}", flush=True)
        check(n_diff == 0, "main_sp: the resumed run's final state equals the uninterrupted "
              "run's bit for bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    iters = [ms for run in "ABC" for ms in rec["iter_ms"][run]]
    steady = rec["iter_ms"]["C"][1:]
    out = {"card": card, "B": 8, "T": 1024, "accum": 8,
           "data": rec["data"], "dataset_build_s": rec["data_s"],
           "calibration_s": rec["calib_s"],
           "iter_ms": rec["iter_ms"], "median_iter_ms": statistics.median(iters),
           "median_iter_ms_C_after_first": statistics.median(steady),
           "save_host_ms": rec["save_host_ms"],
           "median_save_host_ms": statistics.median(rec["save_host_ms"]),
           "flash_launches_per_iteration": {"flash_fwd_lse": per_iter, "flash_bwd": per_iter},
           "resumed_vs_uninterrupted_max_abs_diff": max_diff}
    print("main_sp_timings " + json.dumps(out), flush=True)
    return 0


# The CPT command line at GPT-2 124M (float32, as the JAX command), offline:
# the command's defaults but for these flags, the PRT on.
MAIN_CPT_FLAGS = ["--max-seq-length", "256", "--batch-size", "8", "--total-epochs", "4",
                  "--total-cycles", "2"]
# Documents of the 80,000-document offline corpus the train windows are cut
# from: 14 give 67 windows of 256 bytes, 8 batches of 8 an epoch (the
# validation windows, which main_cpt never reads, from as many).
MAIN_CPT_DOCS = 14
EVAL_CPT_FLAGS = ["--max-length", "1024", "--stride", "512"]
# The SQuAD command line at its defaults (GPT-2 124M, T = 384, stride 128,
# B = 16, accum 4, bits 7/32, float32) but for 4 iterations, on 256 of the
# offline synthetic examples.
MAIN_SQUAD_FLAGS = ["--num-iterations", "4"]
MAIN_SQUAD_EXAMPLES = 256


def no_kernel(tag, fn, *a, **k):
    """fn(*a, **k) with every kernel's counter set to 0 just before and read
    just after; raises if any kernel ran (the JAX CPT and QA paths run no
    Pallas kernel: a launch would be a silent flash or fused route)."""
    zero_counters()
    out = fn(*a, **k)
    ran = read_counters()
    check(not ran, f"{tag}: launched {ran}; the path runs no kernel")
    return out


def synced_ms(fn, *a, **k):
    """(fn(*a, **k), host ms around it, synchronised on both sides)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*a, **k)
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t)


def _patched(module, patches):
    """Sets `module`'s attributes from `patches`; returns the old values."""
    saved = {name: getattr(module, name) for name in patches}
    for name, fn in patches.items():
        setattr(module, name, fn)
    return saved


def step_hold(tag, run_step, trainable, jitter_patches, failures):
    """One train step on the card against the same step on the CPU, from
    the same parameters, batch and draws (`run_step(device)` -> (metrics,
    {path: update})), held against the floor the CPU step sets against
    itself under 2^-22 jitter at `jitter_patches` (`jittered_floor`, the
    largest of FLOOR_DRAWS draws): loss, grad_norm and the relative L2 of
    the update over the trainable leaves, each within TRAIN_FLOOR_FACTOR
    times the floor's. Every kernel counter reads 0 across the card step."""
    import torch

    card = no_kernel(f"{tag} step on the card", run_step, torch.device("cuda"))
    cpu = run_step(torch.device("cpu"))

    def diffs(x):
        out = {k: abs(float(x[0][k]) - float(cpu[0][k])) / abs(float(cpu[0][k]))
               for k in ("loss", "grad_norm")}
        num = math.sqrt(sum(float(((x[1][p].cpu() - cpu[1][p]) ** 2).sum()) for p in trainable))
        den = math.sqrt(sum(float((cpu[1][p] ** 2).sum()) for p in trainable))
        out["update"] = num / den
        return out

    got = diffs(card)
    each = [diffs(jittered_floor(jitter_patches, lambda: run_step(torch.device("cpu")),
                                 torch.device("cpu"), seed=s))
            for s in range(1, FLOOR_DRAWS + 1)]
    base = {k: max(d[k] for d in each) for k in got}
    print(f"{tag} train step card vs CPU (relative): "
          + "; ".join(f"{k} {got[k]:.3e} (floor {base[k]:.3e}, draws "
                      + " ".join(f"{d[k]:.2e}" for d in each)
                      + f", tol {TRAIN_FLOOR_FACTOR}x floor)" for k in got)
          + f"; card {float(card[0]['loss'])!r} / {float(card[0]['grad_norm'])!r}, "
          f"CPU {float(cpu[0]['loss'])!r} / {float(cpu[0]['grad_norm'])!r}", flush=True)
    check(all(math.isfinite(float(x[0][k])) for x in (card, cpu) for k in ("loss", "grad_norm")),
          f"{tag}: finite loss and grad_norm")
    for k in got:
        if not got[k] <= TRAIN_FLOOR_FACTOR * base[k]:
            failures.append(f"{tag} train step {k}: {got[k]:.3e} vs floor {base[k]:.3e}")
    return {"card_vs_cpu": got, "floor": base}


def cpt_step_hold(failures):
    """One CPT train step at GPT-2 width with 2 layers, B = 2, T = 128, at
    the 5-bit log slot with the LoRA gradients quantized, on the card and
    on the CPU (`step_hold`); the floor jitters every quantizer input and
    every product's left operand. The parameters: random from seed 0,
    lora_B N(0, 0.02²), calibrated at 5 bits and for the gradient
    quantizers on the card, then copied to the CPU."""
    import torch

    from llm_qat_tpu_torch.models import cpt_model
    from llm_qat_tpu_torch.models.config import CPTConfig, GPT2Config
    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train.cpt_trainer import (
        CPTCalibrationManager,
        cpt_trainable_mask,
        make_cpt_train_step,
    )

    cfg = CPTConfig(model=GPT2Config(n_layer=2))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = cpt_model.init_cpt_params(gen, cfg, device=dev)
    for lin in [params["blocks"][n] for n in LINEARS] + [params["lm_head"]]:
        lin["lora_B"] = 0.02 * torch.randn(lin["lora_B"].shape, generator=gen, device=dev)
    ids = torch.randint(0, cfg.model.vocab_size, (2, 128), generator=gen, device=dev)
    mgr = CPTCalibrationManager(cfg, 2)
    params = mgr.calibrate_gradient_quantizers(params, ids)
    params = mgr.ensure_calibrated(params, 5, [ids])
    on = {d: optim.replace_leaves(params, {p: v.to(d) for p, v in optim.leaves_with_paths(params)})
          for d in ("cuda", "cpu")}
    slot = cpt_model.prec_index(cfg, 5)
    trainable = [p for p, m in optim.leaves_with_paths(cpt_trainable_mask(params)) if m]

    def run_step(d):
        init_state, step = make_cpt_train_step(cfg, learning_rate=1e-4, total_steps=10)
        state = init_state(on[d.type])
        new, m = step(state, ids.to(d), slot)
        return m, {p: optim.get_leaf(new["params"], p) - optim.get_leaf(on[d.type], p)
                   for p in trainable}

    return step_hold("cpt", run_step, trainable,
                     [(cpt_model, "fake_quant", "in"), (cpt_model, "matmul_bf16", "in")],
                     failures)


def qa_step_hold(failures):
    """One QA train step (`make_squad_train_step`, accum 4: the teacher and
    three students) at GPT-2 width with 2 layers, B = 2, T = 128 (windows of
    the synthetic SQuAD set), bits 7/32 (7: log), on the card and on the
    CPU (`step_hold`), with the same student slots, feature layers and
    dropout uniforms given to both; the floor jitters every quantizer input
    and every product's left operand of the SP trunk."""
    import torch

    from llm_qat_tpu_torch.data.squad import OffsetByteTokenizer, SQuADDataset, synthetic_squad
    from llm_qat_tpu_torch.models import sp_model
    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig, TrainConfig
    from llm_qat_tpu_torch.models.qa import init_qa_params
    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
    from llm_qat_tpu_torch.train.sp_trainer import trainable_paths
    from llm_qat_tpu_torch.train.squad_trainer import make_squad_train_step

    cfg = SPModelConfig(model=GPT2Config(n_layer=2), quant=QuantConfig(bit_widths=(7, 32)))
    tcfg = TrainConfig(batch_size=2, learning_rate=3e-5, num_iterations=4,
                       gradient_accumulation_steps=4)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_qa_params(gen, cfg, device=dev)
    for n in LINEARS:
        b = params["blocks"][n]["lora_B"]
        params["blocks"][n]["lora_B"] = 0.02 * torch.randn(b.shape, generator=gen, device=dev)
    ds = SQuADDataset(synthetic_squad(8), OffsetByteTokenizer(), 128, 128)
    batch = next(ds.batches(2))
    cal = [torch.as_tensor(batch["input_ids"], dtype=torch.long, device=dev)]
    params = CalibrationManager(cfg, 1).calibrate_all_precisions(params, cal)
    on = {d: optim.replace_leaves(params, {p: v.to(d) for p, v in optim.leaves_with_paths(params)})
          for d in ("cuda", "cpu")}
    draws = torch.Generator().manual_seed(1)
    uniforms = [torch.rand((2, 128, cfg.model.n_embd), generator=draws) for _ in range(4)]
    trainable = trainable_paths(params)

    def run_step(d):
        init_state, step = make_squad_train_step(cfg, tcfg)
        state = init_state(on[d.type])
        tb = {k: torch.as_tensor(v, device=d) for k, v in batch.items() if k != "example_ids"}
        tb["input_ids"] = tb["input_ids"].long()
        new, m = step(state, tb, torch.Generator(device=d).manual_seed(2), precs=[0, 0, 0],
                      layers=[0, 1, 2], uniforms=[u.to(d) for u in uniforms])
        return m, {p: optim.get_leaf(new.params, p) - optim.get_leaf(on[d.type], p)
                   for p in trainable}

    return step_hold("qa", run_step, trainable,
                     [(sp_model, "fake_quant_flat", "in"), (sp_model, "matmul_bf16", "in")],
                     failures)


def main_cpt_phase(dev, card) -> int:
    """`--main-cpt` (and part of the default run): `python -m
    llm_qat_tpu_torch.cli.main_cpt` through `main_cpt.main` at GPT-2 124M
    (float32), offline, at MAIN_CPT_FLAGS with the PRT on, its train windows
    cut from MAIN_CPT_DOCS documents (8 batches an epoch); then
    `eval_cpt.main` on the saved checkpoint at EVAL_CPT_FLAGS, and again
    with `--bits` at a width the checkpoint left uncalibrated (its
    emergency re-calibration runs). Every kernel counter reads 0 across
    each train step and each evaluation. Checks finite losses, the
    checkpoint reloading bit for bit with its meta read back as a
    `CPTConfig`, and finite perplexities; then the card-vs-CPU hold of one
    CPT step (`cpt_step_hold`). Prints `main_cpt_timings` (gradient-
    quantizer calibration s, the PRT's s and bounds, the bits of each
    epoch, ms per train step, save s, each evaluation's load s,
    perplexity and window tokens/s, the step's ms with and without the
    frozen leaves' gradients that JAX's grad_norm needs, each also
    profiled once, and a profiled (16, 1024) evaluation forward). Returns
    0, or raises."""
    import shutil
    import statistics
    import tempfile

    import torch

    from llm_qat_tpu_torch.cli import eval_cpt, main_cpt
    from llm_qat_tpu_torch.deploy import load_checkpoint
    from llm_qat_tpu_torch.deploy.checkpoint import _config_to_dict
    from llm_qat_tpu_torch.deploy.elastic import tree_leaves
    from llm_qat_tpu_torch.models.config import CPTConfig, GPT2Config
    from llm_qat_tpu_torch.models.cpt_model import prec_index
    from llm_qat_tpu_torch.train import cpt_trainer

    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    rec = {"step_ms": [], "losses": [], "bits": [], "eval": []}
    make_dataloaders = main_cpt.create_dataloaders

    def dataloaders(tokenizer, *a, **k):
        t = time.perf_counter()
        out = make_dataloaders(tokenizer, *a, train_limit=MAIN_CPT_DOCS,
                               val_limit=MAIN_CPT_DOCS, **k)
        rec["data"] = {"tokenizer": type(tokenizer).__name__, "train_windows": len(out[0]),
                       "s": time.perf_counter() - t}
        return out

    class Calibration(main_cpt.CPTCalibrationManager):
        def calibrate_gradient_quantizers(self, *a, **k):
            out, ms = synced_ms(super().calibrate_gradient_quantizers, *a, **k)
            rec["gq_calibration_s"] = ms / 1e3
            return out

    class PRT(main_cpt.PrecisionRangeTest):
        def find_bounds(self, *a, **k):
            bounds, ms = synced_ms(super().find_bounds, *a, **k)
            rec["prt"] = {"s": ms / 1e3, "bounds": list(bounds)}
            return bounds

    class Scheduler(main_cpt.CyclicPrecisionScheduler):
        def get_precision_for_epoch(self, epoch):
            bits = super().get_precision_for_epoch(epoch)
            rec["bits"].append(bits)
            return bits

    make, save_ckpt = main_cpt.make_cpt_train_step, main_cpt.save_checkpoint

    def make_step(*a, **k):
        init_state, step = make(*a, **k)

        def train_step(state, ids, prec):
            (state, m), ms = synced_ms(no_kernel, "main_cpt train step", step, state, ids, prec)
            rec["step_ms"].append(ms)
            rec["losses"].append(float(m["loss"]))
            return state, m

        return init_state, train_step

    def save(*a, **k):
        out, ms = synced_ms(save_ckpt, *a, **k)
        rec["save_s"] = ms / 1e3
        return out

    root = tempfile.mkdtemp(prefix="main_cpt_")
    saved = _patched(main_cpt, {"create_dataloaders": dataloaders,
                                "CPTCalibrationManager": Calibration,
                                "PrecisionRangeTest": PRT, "CyclicPrecisionScheduler": Scheduler,
                                "make_cpt_train_step": make_step, "save_checkpoint": save})
    try:
        state, stats = main_cpt.main(MAIN_CPT_FLAGS + ["--output-dir", root])
    finally:
        _patched(main_cpt, saved)
    try:
        per_epoch = len(rec["step_ms"]) // 4
        check(per_epoch == 8 and len(rec["step_ms"]) == 32,
              f"main_cpt: 8 steps in each of 4 epochs ({rec['data']}, {len(rec['step_ms'])})")
        check(all(math.isfinite(x) for x in rec["losses"]), "main_cpt: finite losses")
        ckpt = os.path.join(root, "cpt_target_5bit.npz")
        params, meta = load_checkpoint(ckpt, device=dev)
        same = [torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(state["params"]))]
        check(len(same) == len(tree_leaves(state["params"])) and all(same),
              "main_cpt: the checkpoint reloads bit for bit")
        c = meta["config"]
        read = CPTConfig(**{**c, "model": GPT2Config(**c["model"]),
                            "bit_widths": tuple(c["bit_widths"])})
        want = CPTConfig(target_bits=5, total_epochs=4, total_cycles=2)
        check(read == want and _config_to_dict(read) == c and meta["bit_width"] == 5,
              f"main_cpt: the meta reads back as the command's CPTConfig: {c}")
        forensics = eval_cpt.calibration_forensics(params, read)
        missing = [b for b, ok in forensics.items() if not ok]
        check(forensics[5] and missing, f"main_cpt: calibration forensics {forensics}")

        def timed_load(*a, **k):
            out, ms = synced_ms(load_checkpoint, *a, **k)
            rec["eval"][-1]["load_s"] = ms / 1e3
            return out

        class Evaluator(eval_cpt.PerplexityEvaluator):
            def calculate_perplexity(self, seqs):
                n = len(self.windows(seqs))
                ppl, ms = synced_ms(super().calculate_perplexity, seqs)
                rec["eval"][-1].update(perplexity=ppl, perplexity_s=ms / 1e3, windows=n,
                                       window_tokens_per_s=n * self.max_length / (ms / 1e3))
                return ppl

        recal = []

        class EvalCalibration(eval_cpt.CPTCalibrationManager):
            def ensure_calibrated(self, *a, **k):
                recal.append(a[1])
                return super().ensure_calibrated(*a, **k)

        saved = _patched(eval_cpt, {"load_checkpoint": timed_load, "PerplexityEvaluator": Evaluator,
                                    "CPTCalibrationManager": EvalCalibration})
        try:
            for extra in ([], ["--bits", str(max(missing))]):
                rec["eval"].append({"flags": EVAL_CPT_FLAGS + extra})
                res, ms = synced_ms(no_kernel, "eval_cpt", eval_cpt.main,
                                    ["--model-path", ckpt, "--output-dir",
                                     os.path.join(root, "eval", str(len(rec["eval"])))]
                                    + EVAL_CPT_FLAGS + extra)
                rec["eval"][-1].update(s=ms / 1e3, bit_width=res["bit_width"],
                                       results=res["perplexity"])
                check(math.isfinite(rec["eval"][-1]["perplexity"]),
                      f"eval_cpt {extra}: finite perplexity")
        finally:
            _patched(eval_cpt, saved)
        check(recal == [max(missing)], f"eval_cpt: the emergency re-calibration ran once, at "
              f"{max(missing)} bits: {recal}")

        # what JAX's grad_norm costs: the step at the command's shape with
        # and without the frozen leaves' gradients, in turns, 4 of each by
        # the host clock, then one profiled call of each
        gen = torch.Generator(device=dev).manual_seed(3)
        ids = torch.randint(0, read.model.vocab_size, (8, min(256, read.model.n_positions)),
                            generator=gen, device=dev)
        init_state, step = make(read, 1e-4, total_steps=10)
        st = init_state(state["params"])
        paths = cpt_trainer._gradient_paths
        slot = prec_index(read, 5)
        modes = ("with_frozen_grads", "trainable_only")
        rec["grad_norm_cost_ms"] = {m: [] for m in modes}

        def run(mode, fn):
            if mode == "trainable_only":
                cpt_trainer._gradient_paths = lambda p: (paths(p)[0], [])
            try:
                return fn()
            finally:
                cpt_trainer._gradient_paths = paths

        for i in range(8):
            mode = modes[i % 2]
            _, ms = run(mode, lambda: synced_ms(step, st, ids, slot))
            rec["grad_norm_cost_ms"][mode].append(ms)
        rec["step_profile"] = {m: run(m, lambda: call_profile(lambda: step(st, ids, slot)))
                               for m in modes}
        with torch.no_grad():
            x = torch.randint(0, read.model.vocab_size, (16, min(1024, read.model.n_positions)),
                              generator=gen, device=dev)
            rec["eval_forward_profile"] = call_profile(
                lambda: main_cpt.cpt_forward(params, x, slot, read)["logits"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    hold = cpt_step_hold(failures)
    check(not failures, "; ".join(failures))
    out = {"card": card, "flags": MAIN_CPT_FLAGS, "data": rec["data"],
           "gq_calibration_s": rec["gq_calibration_s"], "prt": rec["prt"],
           "bits_per_epoch": rec["bits"], "steps": len(rec["step_ms"]),
           "step_ms": rec["step_ms"], "median_step_ms": statistics.median(rec["step_ms"]),
           "median_step_ms_after_first_epoch": statistics.median(rec["step_ms"][8:]),
           "epoch_losses": stats.iteration_losses, "save_s": rec["save_s"],
           "eval_cpt": rec["eval"], "grad_norm_cost_ms": rec["grad_norm_cost_ms"],
           "step_profile": rec["step_profile"],
           "eval_forward_profile_16x1024": rec["eval_forward_profile"], "step_hold": hold}
    print("main_cpt_timings " + json.dumps(out), flush=True)
    return 0


def main_squad_phase(dev, card) -> int:
    """`--main-squad` (and part of the default run): `python -m
    llm_qat_tpu_torch.cli.main_squad` through `main_squad.main` at its
    defaults (GPT-2 124M, float32, T = 384, stride 128, B = 16, accum 4,
    bits 7/32) but for MAIN_SQUAD_FLAGS, offline, on MAIN_SQUAD_EXAMPLES of
    the synthetic examples (`load_squad_examples` wrapped). Every kernel
    counter reads 0 across each train step and each bit's evaluation.
    Checks finite losses, EM/F1 at both bits within [0, 100], the per-bit
    checkpoint reloading bit for bit; then the card-vs-CPU hold of one QA
    step (`qa_step_hold`). Prints `main_squad_timings` (windows, ms per
    train step, each bit's evaluation s and EM/F1, one profiled train step
    and evaluation batch). Returns 0, or raises."""
    import shutil
    import statistics
    import tempfile

    import torch

    from llm_qat_tpu_torch.cli import main_squad
    from llm_qat_tpu_torch.data.squad import synthetic_squad
    from llm_qat_tpu_torch.deploy import load_checkpoint
    from llm_qat_tpu_torch.deploy.elastic import tree_leaves

    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    rec = {"step_ms": [], "losses": [], "eval": []}

    class Dataset(main_squad.SQuADDataset):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rec["windows"] = len(self)
            rec["tokenizer"] = type(self.tokenizer).__name__

    make, evaluate_model = main_squad.make_squad_train_step, main_squad.evaluate_squad_model

    def make_step(*a, **k):
        init_state, step = make(*a, **k)

        def train_step(state, batch, gen):
            rec["step"] = (step, state, batch)
            (state, m), ms = synced_ms(no_kernel, "main_squad train step", step, state, batch, gen)
            rec["step_ms"].append(ms)
            rec["losses"].append([float(m["loss"]), float(m["grad_norm"])])
            rec["params"] = state.params
            return state, m

        return init_state, train_step

    def evaluate(*a, **k):
        rec["logits_fn"] = a[0]
        res, ms = synced_ms(no_kernel, "main_squad evaluation", evaluate_model, *a, **k)
        rec["eval"].append({"s": ms / 1e3, **res})
        return res

    root = tempfile.mkdtemp(prefix="main_squad_")
    saved = _patched(main_squad, {
        "load_squad_examples": lambda version, split, limit=None:
            synthetic_squad(MAIN_SQUAD_EXAMPLES, unanswerable=version != "v1"),
        "SQuADDataset": Dataset, "make_squad_train_step": make_step,
        "evaluate_squad_model": evaluate})
    try:
        results = main_squad.main(MAIN_SQUAD_FLAGS + ["--output-dir", root])
        check(len(rec["step_ms"]) == 4, f"main_squad took 4 steps: {len(rec['step_ms'])}")
        check(all(math.isfinite(x) for pair in rec["losses"] for x in pair),
              f"main_squad: finite losses {rec['losses']}")
        check(sorted(results) == [7, 32] and all(
            0.0 <= r[k] <= 100.0 for r in results.values() for k in ("exact_match", "f1")),
            f"main_squad: EM/F1 at 7 and 32 bits: {results}")
        params, meta = load_checkpoint(os.path.join(root, "squad_7bit.npz"), device=dev)
        same = [torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                   tree_leaves(rec["params"]))]
        check(meta["bit_width"] == 7 and len(same) == len(tree_leaves(rec["params"]))
              and all(same), "main_squad: squad_7bit.npz reloads bit for bit")
        check(not os.path.exists(os.path.join(root, "squad_32bit.npz")),
              "main_squad: no file for the 32-bit teacher")
        # one profiled call of a train step and of an evaluation batch
        step, st, batch = rec.pop("step")
        gen = torch.Generator(device=dev).manual_seed(5)
        rec["step_profile"] = call_profile(lambda: step(st, batch, gen))
        ids, mask = batch["input_ids"][:8], batch["attention_mask"][:8]
        with torch.no_grad():
            rec["eval_profile"] = call_profile(lambda: rec["logits_fn"](ids, mask))
    finally:
        _patched(main_squad, saved)
        shutil.rmtree(root, ignore_errors=True)
    failures = []
    hold = qa_step_hold(failures)
    check(not failures, "; ".join(failures))
    out = {"card": card, "flags": MAIN_SQUAD_FLAGS, "examples": MAIN_SQUAD_EXAMPLES,
           "tokenizer": rec["tokenizer"], "windows": rec["windows"], "B": 16, "T": 384,
           "accum": 4, "step_ms": rec["step_ms"],
           "median_step_ms_after_first": statistics.median(rec["step_ms"][1:]),
           "losses_and_grad_norms": rec["losses"],
           "eval": {str(b): e for b, e in zip(sorted(results), rec["eval"])},
           "step_profile": rec["step_profile"], "eval_batch_profile_8x384": rec["eval_profile"],
           "step_hold": hold}
    print("main_squad_timings " + json.dumps(out), flush=True)
    return 0


# --run-rpi: the RPI command at GPT-2 124M, its texts (the offline corpus's
# first RPI_SAMPLES of five words or more: 271 words, T = 1024 through #5;
# 63 words, T = 355 dense). The default run takes RPI_DEFAULT_SAMPLES.
RPI_SAMPLES = 2
# The default run takes one text (--run-rpi's command took 485.5 s with 2,
# over 300 s) and runs the command at GPT-2 width with RPI_DEFAULT_LAYERS
# layers (its 1551 host-bound forwards took 339-500 s at 12 layers, on
# hosts of different speed, and the default run 1041-1444 s; PERF.md).
RPI_DEFAULT_SAMPLES = 1
RPI_DEFAULT_LAYERS = 1
RPI_BITS = (4, 8, 32)
RPI_HOLD_LAYERS = 2   # depth of the card-vs-CPU holds (GPT-2 width, T = 1024)


def replay_switch(bits, p, seed):
    """The precision and statistics of one switched forward, replayed on
    the host from `random.Random(seed)` (the reference's draw: with
    probability p a uniform choice among the sorted widths, starting from
    the largest)."""
    import random

    rng = random.Random(seed)
    cur, count = max(bits), 0
    if rng.random() < p:
        new = rng.choice(sorted(bits))
        count += new != cur
        cur = new
    return cur, {"total_forwards": 1, "switch_count": count, "switch_rate": float(count),
                 "precision_distribution": {cur: 1.0}, "precision_counts": {cur: 1}}


def rpi_weights(cfg):
    """numpy-seeded weights at `cfg`'s shapes (GPT-2's init scales; the
    quantizer banks and LN from the port's init), calibrated on the CPU at
    every width on two (1, 256) batches of numpy-seeded ids: a numpy tree."""
    import numpy as np
    import torch

    from llm_qat_tpu_torch import bridge
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager

    rng = np.random.default_rng(0)
    tree = bridge.params_to_numpy(init_sp_params(torch.Generator().manual_seed(0), cfg,
                                                 device="cpu"))
    draw = lambda shape, scale: rng.normal(0, scale, shape).astype(np.float32)
    tree["wte"], tree["wpe"] = draw(tree["wte"].shape, 0.02), draw(tree["wpe"].shape, 0.01)
    for lin in LINEARS:
        b = tree["blocks"][lin]
        bound = 1.0 / math.sqrt(b["w"].shape[1])
        b["w"] = rng.uniform(-bound, bound, b["w"].shape).astype(np.float32)
        b["lora_A"] = np.where(b["lora_A"] != 0, draw(b["lora_A"].shape, 0.05), 0).astype(
            np.float32)
        b["lora_B"] = draw(b["lora_B"].shape, 0.02)
    ids = [torch.as_tensor(rng.integers(0, 256, (1, 256))) for _ in range(2)]
    cal = CalibrationManager(cfg, 2).calibrate_all_precisions(
        bridge.params_from_numpy(tree, "cpu"), ids)
    return bridge.params_to_numpy(cal)


def rpi_holds(dev, text, failures):
    """At GPT-2 width with RPI_HOLD_LAYERS layers, T = 1024, on `rpi_weights`
    (the same numpy tree on the card and on the CPU through bridge.py): the
    command's `metrics_at` (loss, accuracy) at 32 and at 4 bits, and
    `make_gradient_importance_fn`'s scores at its default slot (4 bits), on
    the card against the CPU, each within TRAIN_FLOOR_FACTOR times the
    floor the CPU sets against itself under 2^-22 jitter at every quantizer
    input and product operand (`jittered_floor`, the largest of FLOOR_DRAWS
    draws; the loss's floor at least one float32 ulp of its sum). On the
    card each forward launches #5 once a layer, and the importance #6 too.
    Returns {hold: {card_vs_cpu, floor}}."""
    import numpy as np
    import torch

    from llm_qat_tpu_torch import bridge
    from llm_qat_tpu_torch.cli import run_rpi
    from llm_qat_tpu_torch.data import get_gpt2_tokenizer
    from llm_qat_tpu_torch.models import sp_model
    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig
    from llm_qat_tpu_torch.robustness.attacks import make_gradient_importance_fn

    cfg = SPModelConfig(model=GPT2Config(n_layer=RPI_HOLD_LAYERS),
                        quant=QuantConfig(bit_widths=RPI_BITS))
    tree = rpi_weights(cfg)
    card_dev = str(dev)
    on = {d: bridge.params_from_numpy(tree, d) for d in (card_dev, "cpu")}
    tok = get_gpt2_tokenizer()
    words = text.split()
    jitter = [(sp_model, "fake_quant_flat", "in"), (sp_model, "matmul_bf16", "in")]
    out = {}

    def hold(tag, run, diffs, want_launches, resolution=lambda cpu: {}):
        zero_counters()
        got_card = run(card_dev)
        ran = read_counters()
        check(ran == want_launches, f"rpi hold {tag}: launches {ran}, want {want_launches}")
        cpu = run("cpu")
        got = diffs(got_card, cpu)
        each = [diffs(jittered_floor(jitter, lambda: run("cpu"), torch.device("cpu"), seed=s),
                      cpu) for s in range(1, FLOOR_DRAWS + 1)]
        res = resolution(cpu)
        base = {k: max([d[k] for d in each] + [res.get(k, 0.0)]) for k in got}
        print(f"rpi hold {tag} card vs CPU: "
              + "; ".join(f"{k} {got[k]:.3e} (floor {base[k]:.3e}, draws "
                          + " ".join(f"{d[k]:.2e}" for d in each)
                          + f", resolution {res.get(k, 0.0):.2e}"
                          + f", tol {TRAIN_FLOOR_FACTOR}x floor)" for k in got), flush=True)
        for k in got:
            if not got[k] <= TRAIN_FLOOR_FACTOR * base[k]:
                failures.append(f"rpi hold {tag} {k}: {got[k]:.3e} vs floor {base[k]:.3e}")
        out[tag] = {"card_vs_cpu": got, "floor": base}
        return got_card, cpu

    # The loss is a float32 sum over the text's n tokens, which the card and
    # the CPU add in different orders: its floor is at least one float32
    # ulp of that sum (a jitter of 2^-22 may move no term of a near-uniform
    # random model's sum across an ulp, and then measures 0)
    n = min(len(tok(text)), cfg.model.n_positions) - 1

    def loss_resolution(cpu):
        total = np.float32(cpu[0] * n)
        return {"loss": float(np.spacing(total) / total)}

    L = RPI_HOLD_LAYERS
    for bits in (32, 4):
        def metrics(d, idx=cfg.quant.prec_index(bits)):
            fns = run_rpi.rpi_functions(on[d], cfg, sp_model.prec_tables(cfg.quant, d), tok,
                                        torch.device(d))
            return fns.metrics_at(text, idx)

        card, cpu = hold(f"metrics_{bits}bit", metrics,
                         lambda x, c: {"loss": abs(x[0] - c[0]) / abs(c[0]),
                                       "accuracy": abs(x[1] - c[1])},
                         {"flash_fwd_lse": L}, loss_resolution)
        check(all(math.isfinite(v) for v in card + cpu), f"rpi hold {bits}-bit: finite metrics")
        out[f"metrics_{bits}bit"].update(card=card, cpu=cpu)

    def importance(d):
        return np.asarray(make_gradient_importance_fn(on[d], cfg, tok)(words))

    card, cpu = hold("importance", importance,
                     lambda x, c: {"rel_l2": float(np.linalg.norm(x - c) / np.linalg.norm(c))},
                     {"flash_fwd_lse": L, "flash_bwd": L})
    check(bool(np.isfinite(card).all()) and float(np.abs(cpu).max()) > 0,
          "rpi hold importance: finite, nonzero scores")
    return out


def rpi_phase(dev, card, num_samples, n_layer=12) -> dict:
    """`--run-rpi` (and part of the default run): `python -m
    llm_qat_tpu_torch.cli.run_rpi` through `run_rpi.main` at GPT-2 124M
    (bits 4/8/32, float32, the command's own random initialisation; with
    `n_layer` below 12, GPT-2 width at that depth),
    offline (the byte tokenizer, the synthetic corpus, the static synonym
    table and MLM stand-in), `--num-samples num_samples`, every forward
    counted, timed synchronised and its T recorded. #5 must launch once a
    layer for each forward at T = 1024, all on its SIMT route, and no other
    kernel; the report must have the JAX command's keys and finite
    accuracies, and each switched forward the precision, index and
    statistics of a host replay of its `random.Random(seed)`. Then
    `make_gradient_importance_fn` at GPT-2 124M on the first text (T =
    1024: #5 and #6 on their SIMT routes, 12 launches each, timed by
    `utils.StepTimer`), one profiled call each of the victim function and
    the importance (`call_profile`), one victim call traced by
    `utils.trace` (its Chrome trace must hold #5's kernel), and the
    card-vs-CPU holds of `rpi_holds`. Prints `rpi_timings`. Returns the
    launches by path: {"run_rpi": #5's, "rpi_importance": {kernel: n}}."""
    import functools
    import shutil
    import statistics
    import tempfile

    import numpy as np
    import torch

    from llm_qat_tpu_torch.cli import run_rpi
    from llm_qat_tpu_torch.data import get_gpt2_tokenizer
    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig
    from llm_qat_tpu_torch.models.sp_model import init_sp_params, prec_tables
    from llm_qat_tpu_torch.ops import attention as att
    from llm_qat_tpu_torch.robustness.attacks import make_gradient_importance_fn
    from llm_qat_tpu_torch.utils import StepTimer, trace

    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    t_phase = time.perf_counter()
    rec = {"forwards": [], "attacks": [], "switches": []}
    names = ("sp_forward", "load_wikitext", "TextFoolerAttack", "BERTAttack",
             "SimplifiedRandomSwitching")
    saved = {n: getattr(run_rpi, n) for n in names}

    def forward(params, ids, prec, cfg, **k):
        out, ms = synced_ms(saved["sp_forward"], params, ids, prec, cfg, **k)
        rec["forwards"].append((int(ids.shape[1]), int(prec), ms))
        return out

    def corpus(*a, **k):
        rec["corpus"] = saved["load_wikitext"](*a, **k)
        return rec["corpus"]

    def timed(name):
        class Timed(saved[name]):
            def generate_adversarial(self, text, max_perturb_ratio=None):
                n0 = len(rec["forwards"])
                r, ms = synced_ms(super().generate_adversarial, text, max_perturb_ratio)
                rec["attacks"].append({
                    "attack": name, "words": len(text.split()), "s": ms / 1e3,
                    "forwards": len(rec["forwards"]) - n0,
                    "T": sorted({f[0] for f in rec["forwards"][n0:]}),
                    "num_changes": r["num_changes"], "success": r["success"]})
                return r
        return Timed

    class Switching(saved["SimplifiedRandomSwitching"]):
        def __init__(self, forward_fn, bit_widths, bits_to_idx, switch_probability=0.3,
                     seed=None, device=None):
            super().__init__(forward_fn, bit_widths, bits_to_idx, switch_probability, seed,
                             device=device)
            self.replay = (list(bit_widths), dict(bits_to_idx), switch_probability, seed)

        def forward_with_switching(self, input_ids, labels=None):
            out, precision = super().forward_with_switching(input_ids, labels)
            rec["switches"].append((self.replay, precision, self.get_statistics(),
                                    rec["forwards"][-1][1]))
            return out, precision

    patches = {"sp_forward": forward, "load_wikitext": corpus,
               "TextFoolerAttack": timed("TextFoolerAttack"),
               "BERTAttack": timed("BERTAttack"), "SimplifiedRandomSwitching": Switching}
    if n_layer != 12:
        patches["GPT2Config"] = functools.partial(run_rpi.GPT2Config, n_layer=n_layer)
    saved.update({n: getattr(run_rpi, n) for n in patches if n not in saved})
    root = tempfile.mkdtemp(prefix="run_rpi_")
    _patched(run_rpi, patches)
    zero_counters()
    try:
        report, cmd_ms = synced_ms(run_rpi.main, ["--num-samples", str(num_samples),
                                                  "--output-dir", root])
        launches = read_counters()
        routes = dict(att.flash_fwd_lse.route_launches)
        with open(os.path.join(root, "rpi_report.json")) as f:
            on_disk = json.load(f)
    finally:
        _patched(run_rpi, saved)
        shutil.rmtree(root, ignore_errors=True)

    texts = [t for t in rec["corpus"] if len(t.split()) >= 5][:num_samples]
    fw = rec["forwards"]
    n1024 = sum(1 for T, _, _ in fw if T == 1024)
    L = n_layer
    print(f"run_rpi ({L} layers): {len(texts)} texts of {[len(t.split()) for t in texts]} words; "
          f"{len(fw)} forwards, {n1024} at T = 1024; launches {launches}; #5 by route "
          f"{routes}; {cmd_ms / 1e3:.1f} s", flush=True)
    check(n1024 > 0 and launches == {"flash_fwd_lse": L * n1024}
          and routes == {"wgmma": 0, "simt": L * n1024},
          f"run_rpi: #5 ran {L} times per forward at T = 1024, all on SIMT, and no other kernel")
    check(num_samples < 2 or any(T < 1024 for T, _, _ in fw),
          "run_rpi: the second text's forwards take the dense path")
    check(on_disk == json.loads(json.dumps(report)), "run_rpi: rpi_report.json holds the report")
    by_p = {str(p) for p in (0.0, 0.3, 0.5, 0.7)}
    accs = [report["clean"]["accuracy"]]
    check(set(report) == {"clean", "attacks", "defense"}
          and set(report["attacks"]) == set(report["defense"]) == {"TextFooler", "BERT-Attack"},
          f"run_rpi: the report's keys {sorted(report)}")
    for name, a in report["attacks"].items():
        d = report["defense"][name]
        check(set(a) == {"attack_success_rate", "n_successful"}
              and set(d) == {"by_probability", "optimal_p", "orig_accuracy", "adv_accuracy"}
              and set(d["by_probability"]) == by_p
              and all(set(v) == {"switched_accuracy", "recovery_ratio", "success"}
                      for v in d["by_probability"].values()),
              f"run_rpi {name}: the JAX command's keys")
        accs += [d["orig_accuracy"], d["adv_accuracy"]] + [
            v["switched_accuracy"] for v in d["by_probability"].values()]
    check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in accs), f"run_rpi: accuracies {accs}")
    check(len(rec["switches"]) == 2 * len(by_p) * len(texts),
          f"run_rpi: {len(rec['switches'])} switched forwards")
    for (bits, idx, p, seed), precision, stats, prec in rec["switches"]:
        want, want_stats = replay_switch(bits, p, seed)
        check(precision == want and stats == want_stats and prec == idx[want],
              f"run_rpi: the switched forward at p {p}, seed {seed} ({precision}, {stats}, "
              f"slot {prec}) replays as ({want}, {want_stats})")
    cmd_s = cmd_ms / 1e3

    # gradient importance on the first text at GPT-2 124M (12 layers in
    # every run), the command's initialisation on the card
    cfg = SPModelConfig(model=GPT2Config(), quant=QuantConfig(bit_widths=RPI_BITS))
    params = init_sp_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    words = texts[0].split()
    imp = make_gradient_importance_fn(params, cfg, get_gpt2_tokenizer())
    timer = StepTimer(warmup=0, device=dev)
    zero_counters()
    with timer:
        scores = imp(words)
    imp_launches = read_counters()
    imp_routes = {n: dict(getattr(att, n).route_launches) for n in ("flash_fwd_lse", "flash_bwd")}
    with timer:
        imp(words)
    imp_ms = [1e3 * t for t in timer.times]
    print(f"rpi importance: {len(words)} words; launches {imp_launches}; routes {imp_routes}; "
          f"{imp_ms[0]:.1f} ms, again {imp_ms[1]:.1f} ms", flush=True)
    check(imp_launches == {"flash_fwd_lse": 12, "flash_bwd": 12}
          and all(r == {"wgmma": 0, "simt": 12} for r in imp_routes.values()),
          "rpi importance: #5 and #6 once a layer on SIMT")
    ends = np.cumsum([len(get_gpt2_tokenizer()(w)) for w in words])
    starts = ends - [len(get_gpt2_tokenizer()(w)) for w in words]
    check(len(scores) == len(words) and all(math.isfinite(s) for s in scores)
          and all((s > 0) == (a < 1024) for s, a in zip(scores, starts)),
          "rpi importance: finite scores, 0 exactly for the words past 1024 tokens")
    # where a forward's time goes: the command's victim function (forward
    # and token metrics, 32 bits) and the importance, each profiled once;
    # one victim call traced by utils/profiling.py's `trace`
    victim = run_rpi.rpi_functions(params, cfg, prec_tables(cfg.quant, dev),
                                   get_gpt2_tokenizer(), dev)
    profiles = {"metrics_fn": call_profile(lambda: victim.metrics_fn(texts[0])),
                "importance": call_profile(lambda: imp(words))}
    with tempfile.TemporaryDirectory(prefix="rpi_trace_") as d:
        with trace(d, device=dev):
            victim.metrics_fn(texts[0])
        (name,) = os.listdir(d)
        with open(os.path.join(d, name)) as f:
            events = json.load(f)["traceEvents"]
    traced = sum(1 for e in events if e.get("cat") == "kernel" and "flash_fwd" in e.get("name", ""))
    print(f"rpi profiles {json.dumps(profiles)}; trace: {len(events)} events, {traced} of "
          f"#5's kernel", flush=True)
    check(traced >= 1, "utils.profiling.trace recorded #5's kernel on the card")
    del params, imp, victim
    torch.cuda.empty_cache()

    failures = []
    holds = rpi_holds(dev, texts[0], failures)
    check(not failures, "; ".join(failures))
    phase_s = time.perf_counter() - t_phase
    per_attack = {}
    for a in rec["attacks"]:
        per_attack.setdefault(a["attack"], []).append(a)
    dense = [ms for T, _, ms in fw if T < 1024]
    out = {"card": card, "num_samples": num_samples, "n_layer": n_layer,
           "texts_words": [len(t.split()) for t in texts],
           "forwards": len(fw), "forwards_T1024": n1024,
           "forward_ms_median": statistics.median(ms for _, _, ms in fw),
           "forward_ms_median_T1024": statistics.median(ms for T, _, ms in fw if T == 1024),
           "forward_ms_median_dense": statistics.median(dense) if dense else None,
           "forwards_s": sum(ms for _, _, ms in fw) / 1e3,
           "attacks": per_attack, "command_s": cmd_s,
           "launches": launches, "flash_fwd_lse_routes": routes,
           "report": report, "importance_ms": imp_ms,
           "importance_launches": imp_launches, "profiles": profiles,
           "trace_flash_fwd_kernels": traced, "holds": holds, "phase_s": phase_s}
    print("rpi_timings " + json.dumps(out), flush=True)
    return {"run_rpi": launches["flash_fwd_lse"], "rpi_importance": imp_launches}


# --parallel: the parallel layer at GPT-2 width on one NCCL group of world
# size 1. The default run takes it at PARALLEL_DEFAULT_LAYERS layers (for the
# time limit); --parallel at 12.
PARALLEL_DEFAULT_LAYERS = 2
PARALLEL_DECODE = (8, 128, 8)   # B, prompt (through #2's prefill), greedy steps
PP_MICROBATCHES = 2


def _flash_jitter(patches, seed, fn):
    """fn() with the first output of each (module, name, rel) of `patches`
    moved by relative noise `rel` (the floor of a held path: the reference
    path against itself under noise about the size of the differences a
    changed summation order leaves)."""
    import functools

    import torch

    noise = {}

    def jitter(x, rel):
        if x.device not in noise:
            noise[x.device] = torch.Generator(device=x.device).manual_seed(seed)
        e = rel * torch.randn(x.shape, generator=noise[x.device], device=x.device)
        return (x.float() * (1 + e)).to(x.dtype)

    def wrap(f, rel):
        # the kernel wrapper counts its launches on the attribute of the
        # name it is found by: the jittered function carries the counters
        @functools.wraps(f)
        def wrapped(*a, **k):
            out = f(*a, **k)
            if isinstance(out, torch.Tensor):
                return jitter(out, rel)
            return (jitter(out[0], rel),) + tuple(out[1:])
        return wrapped

    saved = [getattr(mod, nm) for mod, nm, _ in patches]
    for (mod, nm, rel), f in zip(patches, saved):
        setattr(mod, nm, wrap(f, rel))
    try:
        return fn()
    finally:
        for (mod, nm, _), f in zip(patches, saved):
            setattr(mod, nm, f)


def _local(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _step_diffs(x, ref, paths):
    """Relative differences of a step's loss, teacher loss and grad_norm,
    and the relative L2 of its update over the trainable leaves."""
    import torch

    out = {k: abs(float(_local(x[0][k])) - float(_local(ref[0][k])))
           / abs(float(_local(ref[0][k]))) for k in ("loss", "teacher_loss", "grad_norm")}
    num = torch.sqrt(sum(((_local(x[1][p]) - ref[1][p]) ** 2).sum() for p in paths))
    den = torch.sqrt(sum((ref[1][p] ** 2).sum() for p in paths))
    out["update"] = (num / den).item()
    return out


def _held(tag, got, floor_fn, failures, factor=TRAIN_FLOOR_FACTOR, margins=()):
    """`got` (relative differences) bit-equal, or within `factor` times the
    floor (the largest over FLOOR_DRAWS draws of `floor_fn(seed)`), the keys
    in `margins` within the floor plus TOKEN_AGREE_MARGIN; prints the hold
    and returns it."""
    if all(v == 0.0 for v in got.values()):
        print(f"{tag}: bit-equal {json.dumps(got)}", flush=True)
        return {"diff": got, "floor": None}
    each = [floor_fn(seed) for seed in range(1, FLOOR_DRAWS + 1)]
    base = {k: max(d[k] for d in each) for k in got}
    print(f"{tag} (relative): " + "; ".join(
        f"{k} {got[k]:.3e} (floor {base[k]:.3e}, tol {factor}x floor)" for k in got),
        flush=True)
    for k in got:
        limit = base[k] + TOKEN_AGREE_MARGIN if k in margins else factor * base[k]
        if not got[k] <= limit:
            failures.append(f"{tag} {k}: {got[k]:.3e} vs floor {base[k]:.3e}")
    return {"diff": got, "floor": base}


def parallel_phase(dev, card, n_layer) -> dict:
    """The parallel layer (`llm_qat_tpu_torch.parallel`) at GPT-2 width
    (d 768, 12 heads, vocab 50257; bits 4/8/32, per-channel, rank 64, bf16
    compute) with `n_layer` layers, on one NCCL group of world size 1 (a
    FileStore), through the same code as any world size:

    1. TP/DP: `shard_params` on a (1, 1) (data, model) mesh, one SP
       distillation step of train_setup's configuration (B = 8, T = 1024,
       accum 8, flat linear) on the DTensor state with batch-sharded ids,
       against the same step on plain tensors (same state and draws);
    2. CP: `sp_forward_context_parallel` at B = 8, T = 1024 and one step
       with `attention_fn=ring_attention`, against `sp_forward` and the
       step with the dense reference as `attention_fn` (the same float32
       heads, summed in another order), and beside the built-in path;
    3. PP: `make_pp_sp_train_step` on a (1, 1) (data, pipe) mesh, S = 1,
       M = 2, against the unsharded step;
    4. TP decode: `shard_infer_params` on the int8_xla tree,
       `kv_cache_sharding` caches, `infer_forward_unrolled` over a 128-token
       initial prefill (#2) and 8 greedy steps, against the single-device
       decode and its tokens;
    5. `initialize_multihost()` reports one process.

    Each hold is bit-equal or within TRAIN_FLOOR_FACTOR times its floor
    (PERF.md §2). The counters of #2, #5 and #6 are set to 0 just before
    each path and read just after: TP and PP launch #5 and #6 on their
    DTensor-held (TP) or local (PP) operands, CP none (ring attention is
    plain products), TP decode #2 once a layer. Each path's wall time
    (synchronised, the second of two runs) is printed beside its
    single-device time. Returns {path: launches}."""
    import tempfile
    from functools import partial

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from llm_qat_tpu_torch import parallel as P
    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models.inference import (infer_forward_unrolled,
                                                    init_layer_caches,
                                                    quantize_for_inference)
    from llm_qat_tpu_torch.models.sp_model import sp_forward
    from llm_qat_tpu_torch.ops import attention as att
    from llm_qat_tpu_torch.train import optim
    from llm_qat_tpu_torch.train.sp_trainer import make_sp_train_step, trainable_paths

    t_phase = time.time()
    store = tempfile.NamedTemporaryFile(prefix="parallel_store_", delete=False)
    store.close()
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store.name}", rank=0, world_size=1)
    failures, holds, launches, walls = [], {}, {}, {}
    try:
        cfg, tcfg, params, batches, _ = train_setup(dev, n_layer)
        L, ids = cfg.model.n_layer, batches[1]
        accum = tcfg.gradient_accumulation_steps
        n = accum - 1
        draws = dict(precs=[i % 2 for i in range(n)],
                     layers=[(3 * i) % (L + 1) for i in range(n)])
        paths = trainable_paths(params)
        flash = (att.flash_attention, att.flash_fwd_lse, att.flash_bwd)
        # the dense reference as attention_fn, looked up at each call so
        # that a floor's jitter reaches it
        dense_fn = lambda q, k, v: att.causal_attention_reference(q, k, v)  # noqa: E731

        def counted(tag, fn):
            """fn() twice, synchronised; the counters of #2/#5/#6 over the
            second run; (output, wall ms of the first and second run)."""
            ms = []
            for _ in range(2):
                for f in flash:
                    f.launches = 0
                out, t = synced_ms(fn)
                ms.append(t)
            launches[tag] = {f.__name__: f.launches for f in flash}
            return out, ms

        def step(state, make, ids_):
            """(metrics, {path: new leaf}) of one step from `state`."""
            new, mt = make(state, ids_, torch.Generator(device=dev).manual_seed(7), **draws)
            return mt, {p: optim.get_leaf(new.params, p) for p in paths}

        def plain_step(patches=(), seed=1, attention_fn=None):
            init_s, step_s = make_sp_train_step(cfg, tcfg, attention_fn=attention_fn)
            return _flash_jitter(patches, seed, lambda: step(init_s(params), step_s, ids))

        # floors: one bf16 ulp on the flash outputs (the AMP path's rounding
        # point), 2^-22 on the float32 LSE
        flash_rels = [(att, "flash_fwd_lse", 2.0 ** -8), (att, "flash_bwd", 2.0 ** -8)]
        ref, walls["plain_step"] = counted("plain_step", plain_step)
        ref_upd = {p: ref[1][p] - optim.get_leaf(params, p) for p in paths}
        ref = (ref[0], ref_upd)

        def upd(res):
            return (res[0], {p: _local(res[1][p]) - optim.get_leaf(params, p) for p in paths})

        def floor_step(seed, **kw):
            return _step_diffs(upd(plain_step(flash_rels, seed, **kw)), ref, paths)

        # 1. TP/DP
        mesh = P.make_mesh(1, 1, device=dev)
        sharded, _ = P.shard_params(params, mesh)
        ids_sh = distribute_tensor(ids, mesh, P.batch_sharding(mesh))
        init_s, step_s = make_sp_train_step(cfg, tcfg)
        tp, walls["tp_step"] = counted("tp_step", lambda: step(init_s(sharded), step_s, ids_sh))
        check(all(tp[1][p].placements == optim.get_leaf(sharded, p).placements
                  for p in paths), "TP step: every updated leaf keeps its placements")
        holds["tp_step"] = _held("parallel TP/DP step vs single device",
                                 _step_diffs(upd(tp), ref, paths), floor_step, failures)
        check(launches["tp_step"]["flash_fwd_lse"] == L * accum
              and launches["tp_step"]["flash_bwd"] == L * accum,
              f"TP step ran #5 and #6 once a layer and micro-step: {launches['tp_step']}")
        del sharded, tp

        # 2. CP: the ring against the dense reference as attention_fn (the
        # same float32 heads); the floor jitters the reference's attention
        # output by 2^-22
        ring = partial(P.ring_attention, mesh=mesh, axis_name="data")
        prec = cfg.quant.prec_index(4)
        with torch.no_grad():
            cp, walls["cp_forward"] = counted("cp_forward", lambda: P.sp_forward_context_parallel(
                params, ids, prec, cfg, mesh, "data", labels=ids))
            dense, walls["dense_forward"] = counted("dense_forward", lambda: sp_forward(
                params, ids, prec, cfg, labels=ids, attention_fn=dense_fn))
            builtin = sp_forward(params, ids, prec, cfg, labels=ids)

            def fwd_diffs(x):
                xl, dl = _local(x["logits"]).float(), dense["logits"].float()
                return {"logits": ((xl - dl).abs().mean() / dl.std()).item(),
                        "loss": abs(float(_local(x["loss"])) - float(dense["loss"]))
                        / float(dense["loss"])}

            def cp_floor(seed):
                return fwd_diffs(_flash_jitter(
                    [(att, "causal_attention_reference", 2.0 ** -22)], seed,
                    lambda: sp_forward(params, ids, prec, cfg, labels=ids,
                                       attention_fn=dense_fn)))

            holds["cp_forward"] = _held("parallel CP forward vs dense attention_fn",
                                        fwd_diffs(cp), cp_floor, failures)
            holds["cp_forward"]["vs_builtin"] = fwd_diffs(builtin)
            print(f"CP forward: the built-in (flash #5) path vs the dense attention_fn "
                  f"{json.dumps(holds['cp_forward']['vs_builtin'])}", flush=True)
        check(launches["cp_forward"]["flash_fwd_lse"] == 0,
              f"CP forward: ring attention took every block's attention {launches}")
        del cp, dense, builtin
        cp_ref = plain_step(attention_fn=dense_fn)
        cp_ref = (cp_ref[0], {p: cp_ref[1][p] - optim.get_leaf(params, p) for p in paths})
        init_c, step_c = make_sp_train_step(cfg, tcfg, attention_fn=ring)
        ids_seq = distribute_tensor(ids, mesh, (Shard(1), Replicate()))
        cp_st, walls["cp_step"] = counted("cp_step", lambda: step(init_c(params), step_c, ids_seq))
        holds["cp_step"] = _held(
            "parallel CP step vs dense attention_fn step", _step_diffs(upd(cp_st), cp_ref, paths),
            lambda seed: _step_diffs(upd(plain_step(
                [(att, "causal_attention_reference", 2.0 ** -22)], seed,
                attention_fn=dense_fn)), cp_ref, paths), failures)
        check(launches["cp_step"]["flash_fwd_lse"] == 0 and launches["cp_step"]["flash_bwd"] == 0,
              f"CP step: ring attention took every block's attention {launches['cp_step']}")
        del cp_st, cp_ref

        # 3. PP: S = 1, M = 2
        pp_mesh = DeviceMesh(dev.type, torch.zeros((1, 1), dtype=torch.int64),
                             mesh_dim_names=("data", "pipe"))
        pp_params, _ = P.shard_params_pp(params, pp_mesh)
        init_p, step_p = P.make_pp_sp_train_step(cfg, tcfg, pp_mesh,
                                                 n_microbatches=PP_MICROBATCHES)
        pp, walls["pp_step"] = counted("pp_step", lambda: step(init_p(pp_params), step_p, ids))
        holds["pp_step"] = _held("parallel PP step vs single device",
                                 _step_diffs(upd(pp), ref, paths), floor_step, failures)
        want = L * accum * PP_MICROBATCHES
        check(launches["pp_step"]["flash_fwd_lse"] == want
              and launches["pp_step"]["flash_bwd"] == want,
              f"PP step ran #5 and #6 once a layer, microbatch and micro-step: "
              f"{launches['pp_step']}")
        del pp, pp_params

        # 4. TP decode on the int8_xla tree
        B, T0, NEW = PARALLEL_DECODE
        ip = quantize_for_inference(params, cfg, 8, weight_format="int8_xla")
        static = ip.pop("_static")
        prompt = torch.randint(0, cfg.model.vocab_size, (B, T0),
                               generator=torch.Generator(device=dev).manual_seed(3), device=dev)

        def decode(tree, caches, put):
            """Prefill and NEW greedy steps; (tokens, per-step logits)."""
            logits, caches, n = infer_forward_unrolled(tree, put(prompt), cfg, caches, 0,
                                                       static=static, initial_prefill=True)
            steps = [_local(logits)[:, -1].float()]
            toks = [steps[-1].argmax(-1)]
            for _ in range(NEW - 1):
                logits, caches, n = infer_forward_unrolled(tree, put(toks[-1][:, None]), cfg,
                                                           caches, n, static=static)
                steps.append(_local(logits)[:, -1].float())
                toks.append(steps[-1].argmax(-1))
            return torch.stack(toks, 1), torch.stack(steps, 1)

        def single(patches=(), seed=1):
            caches = init_layer_caches(cfg, B, T0 + NEW, device=dev)
            return _flash_jitter(patches, seed, lambda: decode(ip, caches, lambda x: x))

        with torch.no_grad():
            want_dec, walls["decode"] = counted("decode", single)
            ip_sh, _ = P.shard_infer_params(ip, mesh)
            kv = P.kv_cache_sharding(mesh)
            batch = P.batch_sharding(mesh)

            def tp_decode():
                caches = tuple(distribute_tensor(c, mesh, kv) for c in
                               init_layer_caches(cfg, B, T0 + NEW, device=dev))
                return decode(ip_sh, caches, lambda x: distribute_tensor(x, mesh, batch))

            got_dec, walls["tp_decode"] = counted("tp_decode", tp_decode)

            def dec_diffs(x):
                return {"logits": ((x[1] - want_dec[1]).abs().mean()
                                   / want_dec[1].std()).item(),
                        "token_disagreement": (x[0] != want_dec[0]).float().mean().item()}

            holds["tp_decode"] = _held(
                "parallel TP decode vs single device", dec_diffs(got_dec),
                lambda seed: dec_diffs(single([(inference, "flash_attention", 2.0 ** -22)],
                                              seed)), failures, factor=LOGIT_FLOOR_FACTOR,
                margins=("token_disagreement",))
        check(launches["tp_decode"]["flash_attention"] == L,
              f"TP decode ran #2 once a layer in the prefill: {launches['tp_decode']}")
        check(bool(torch.isfinite(got_dec[1]).all()) and tuple(got_dec[0].shape) == (B, NEW),
              "TP decode: finite logits, (B, NEW) tokens")

        # 5. multihost
        info = P.initialize_multihost(device=dev)
        check(info["process_count"] == 1 and info["process_index"] == 0,
              f"initialize_multihost reports one process: {info}")
    finally:
        dist.destroy_process_group()
        os.unlink(store.name)
    check(not failures, "; ".join(failures))
    print("parallel_timings " + json.dumps({
        "card": card, "n_layer": n_layer, "wall_ms_first_second": walls,
        "launches": launches, "holds": holds,
        "phase_s": time.time() - t_phase}), flush=True)
    return launches


def kernel_counters():
    """The sixteen kernels' wrappers (their `launches` counters), by name."""
    from llm_qat_tpu_torch.ops import attention as att
    from llm_qat_tpu_torch.ops import decode_attention as da
    from llm_qat_tpu_torch.ops import fused_decode as fd
    from llm_qat_tpu_torch.ops import fused_linear as fl
    from llm_qat_tpu_torch.ops import mega_decode as md
    qm = importlib.import_module("llm_qat_tpu_torch.ops.quant_matmul")

    fns = (md.mega_decode_step_kv8, md.mega_decode_step, md.mega_decode_step_cb,
           att.flash_attention, att.flash_fwd_lse, att.flash_bwd, da.decode_attention_hbm,
           da.decode_attention_hbm_multi, da.decode_attention, qm.quant_matmul_int8,
           qm.quant_matmul_int4, fd.fused_ln_qkv, fd.fused_post_attention,
           fl.fused_linear_fwd, fl.fused_linear_bwd_dx, fl.fused_linear_bwd_dw)
    return {fn.__name__: fn for fn in fns}


def zero_counters():
    for fn in kernel_counters().values():
        fn.launches = 0
        if hasattr(fn, "route_launches"):
            fn.route_launches.update(wgmma=0, simt=0)


def read_counters():
    """Every kernel's launches since `zero_counters`, the kernels that ran."""
    return {name: fn.launches for name, fn in kernel_counters().items() if fn.launches}


# --cached-generate: B = 8, a 128-token prompt, 32 greedy tokens
CG_B, CG_T0, CG_NEW = 8, 128, 32
# (c)'s int8 KV caches after the prefill, kernel path against plain path.
# Layer 0's K/V rows come from identical inputs through #10, whose sums run in
# another order: a code moves (by one) only where a value sat on a rounding
# boundary of its row's grid, in at most CG_KV_LAYER0_SHARE of the codes, and
# every row scale is within CG_KV_SCALE_REL. Through 12 layers a moved
# activation code upstream moves whole rows (6.4 % of all codes, by up to 7,
# on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md), so the whole cache is held
# against the floor the plain path sets against itself under the jitter of
# `jittered_floor`: at most CG_KV_FLOOR_FACTOR times the floor's share of
# moved codes; rows without a moved code keep their scales within
# CG_KV_SCALE_REL.
CG_KV_LAYER0_SHARE = 1e-3
CG_KV_SCALE_REL = 1e-4
CG_KV_FLOOR_FACTOR = 2.0


def call_profile(fn):
    """One call of fn: its host wall ms (synchronised, unprofiled, after a
    warm-up call), then under torch.profiler the CUDA records it made
    (kernels, copies, sets), their summed device ms, the share of the wall
    the device sat idle (an upper bound: the profiler drops records under
    load) and the three dearest kernels with their device ms and counts."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t)
    cuda = torch.autograd.DeviceType.CUDA
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == cuda and e.count]
    dev_ms = sum(e.self_device_time_total for e in evs) / 1e3
    top = sorted(evs, key=lambda e: -e.self_device_time_total)[:3]
    return {"wall_ms": wall, "device_ms": dev_ms, "cuda_records": sum(e.count for e in evs),
            "idle_share": max(0.0, 1.0 - dev_ms / wall),
            "top": [[kernel_name(e.key), e.self_device_time_total / 1e3, e.count] for e in top]}


class CallTimer:
    """Wraps `fn` in `module`: each call synchronised and timed on the host
    clock (ms), while `on` is set."""

    def __init__(self, module, name):
        import torch

        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.ms, self.on = [], False

        def timed(*a, **k):
            if not self.on:
                return self.fn(*a, **k)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.fn(*a, **k)
            torch.cuda.synchronize()
            self.ms.append(1e3 * (time.perf_counter() - t))
            return out

        setattr(module, name, timed)

    def restore(self):
        setattr(self.module, self.name, self.fn)

    def summary(self, launches):
        import statistics

        return {"prefill_ms": self.ms[0], "step_ms": statistics.median(self.ms[1:]),
                "step_ms_min_max": [min(self.ms[1:]), max(self.ms[1:])],
                "calls": len(self.ms), "launches": launches}


def cached_generate_phase(params, cfg, dev, gen, card):
    """`--cached-generate` (and part of the default run), at GPT-2 124M with
    serve_setup's calibrated parameters, B = 8, a 128-token prompt, 32
    greedy tokens; every kernel's counter set to 0 just before each path
    and read just after:

    (a) `models.generate.generate` on the SP parameters at 8 bits, in
        float32 (the cached forward's head is float32 in JAX whatever the
        config, and in float32 the uncached `sp_forward` computes the same
        function): no kernel on this path (dense attention below T = 1024,
        the flat linear); the tokens held by a teacher-forced replay through
        `sp_forward` against the jitter floor;
    (b) a greedy loop of `infer_forward_with_cache` on
        `quantize_for_inference(bits=8, weight_format="int8")`: #10 48
        times a call, 33 calls (the prefill, then one call per token, the
        last as `generate` takes it); held against `use_kernels=False`;
    (c) the same loop over `infer_forward_unrolled` on
        `init_layer_caches(kv_bits=8)`: the caches' codes and scales after
        the prefill against the plain path's, then the tokens as in (b);
    (d) the folded float32 tree (`lora_format="folded"`) against the factored
        one through `infer_forward_with_cache`: the prefill's logits against
        the floor of the factored tree with its LoRA products jittered.

    Prints `cached_generate_timings` (prefill ms and the median ms of a token
    step of each path, host clock around synchronised calls, beside its
    launches by kernel). Returns #10's launches on (b) and (c)."""
    import torch

    from llm_qat_tpu_torch.models import inference
    from llm_qat_tpu_torch.models import sp_model
    from llm_qat_tpu_torch.models.generate import generate, init_kv_cache
    from llm_qat_tpu_torch.models.inference import (
        infer_forward_with_cache,
        init_layer_caches,
        quantize_for_inference,
    )
    from llm_qat_tpu_torch.models.sp_model import sp_forward

    gen_mod = sys.modules["llm_qat_tpu_torch.models.generate"]
    B, T0, NEW, L = CG_B, CG_T0, CG_NEW, cfg.model.n_layer
    V = cfg.model.vocab_size
    prompt = torch.randint(0, V, (B, T0), generator=gen, device=dev)
    out = {"card": card, "B": B, "T0": T0, "new_tokens": NEW}

    # (a) cached generation on the SP parameters
    gcfg = cfg.replace(compute_dtype="float32")
    prec = cfg.quant.prec_index(8)
    generate(params, prompt[:, :16], prec, gcfg, max_new_tokens=2, do_sample=False)
    timer = CallTimer(gen_mod, "forward_with_cache")
    try:
        zero_counters()
        timer.on = True
        res = generate(params, prompt, prec, gcfg, max_new_tokens=NEW, do_sample=False)
        timer.on = False
        launches = read_counters()
    finally:
        timer.restore()
    check(tuple(res.shape) == (B, T0 + NEW) and torch.equal(res[:, :T0], prompt),
          "(a) generate: shape and prompt kept")
    check(launches == {}, f"(a) generate launched no kernel: {launches}")
    out["generate"] = timer.summary(launches)
    toks = res[:, T0:]

    def cached_replay():
        cache = init_kv_cache(gcfg, B, T0 + NEW, device=dev)
        logits, cache = gen_mod.forward_with_cache(params, prompt, prec, gcfg, cache)
        steps = [logits[:, -1]]
        for i in range(NEW - 1):
            logits, cache = gen_mod.forward_with_cache(params, toks[:, i:i + 1], prec, gcfg,
                                                       cache)
            steps.append(logits[:, 0])
        return torch.stack(steps, dim=1)

    def uncached():
        with torch.no_grad():
            return sp_forward(params, res[:, :T0 + NEW - 1], prec, gcfg)["logits"][:, T0 - 1:]

    lk, lp = cached_replay(), uncached()
    lj = jittered_floor([(sp_model, "matmul_bf16", "out"),
                         (sp_model, "causal_attention", "out")], uncached, dev)
    hold_tokens("(a) generate (cached) vs sp_forward (uncached)", toks, lk, lp, lj)
    del lk, lp, lj

    # (b) and (c) on the int8 tree
    tree = quantize_for_inference(params, cfg, 8, weight_format="int8")
    static = tree.pop("_static")

    def with_cache_loop(use_kernels, forced=None):
        """(tokens, per-step logits (B, NEW, V)): the prefill, then one call
        per token (33 calls); `forced` feeds those tokens instead."""
        cache = init_kv_cache(cfg, B, T0 + NEW, device=dev)
        logits, cache = inference.infer_forward_with_cache(tree, prompt, cfg, cache,
                                                           use_kernels=use_kernels)
        steps, picked = [logits[:, -1]], []
        for i in range(NEW):
            tok = steps[-1].argmax(-1) if forced is None else forced[:, i]
            picked.append(tok)
            logits, cache = inference.infer_forward_with_cache(tree, tok[:, None], cfg, cache,
                                                               use_kernels=use_kernels)
            steps.append(logits[:, 0])
        return torch.stack(picked, dim=1), torch.stack(steps[:NEW], dim=1)

    snaps = {}

    def unrolled_loop(use_kernels, forced=None):
        caches = init_layer_caches(cfg, B, T0 + NEW, kv_bits=8, device=dev)
        logits, caches, n = inference.infer_forward_unrolled(
            tree, prompt, cfg, caches, 0, static=static, initial_prefill=True,
            use_kernels=use_kernels)
        snaps[use_kernels] = [(c.codes.clone(), c.scales.clone()) for c in caches]
        steps, picked = [logits[:, -1]], []
        for i in range(NEW):
            tok = steps[-1].argmax(-1) if forced is None else forced[:, i]
            picked.append(tok)
            logits, caches, n = inference.infer_forward_unrolled(
                tree, tok[:, None], cfg, caches, n, static=static, use_kernels=use_kernels)
            steps.append(logits[:, 0])
        return torch.stack(picked, dim=1), torch.stack(steps[:NEW], dim=1)

    patches = [(inference, "quant_matmul_int8_plain", "out")]
    a_launches = {}
    for key, tag, loop, name in (
            ("with_cache_int8", "(b) infer_forward_with_cache int8", with_cache_loop,
             "infer_forward_with_cache"),
            ("unrolled_kv8", "(c) infer_forward_unrolled int8, kv_bits=8", unrolled_loop,
             "infer_forward_unrolled")):
        loop(True)  # warm-up
        timer = CallTimer(inference, name)
        try:
            zero_counters()
            timer.on = True
            toks, _ = loop(True)
            timer.on = False
            launches = read_counters()
        finally:
            timer.restore()
        want = {"quant_matmul_int8": 4 * L * (1 + NEW)}
        print(f"{tag} main path: {B} x {NEW} tokens; launches {launches}", flush=True)
        check(launches == want, f"{tag}: launches {launches} == {want} (#10: 48 per call)")
        check(bool(((toks >= 0) & (toks < V)).all()), f"{tag}: token ids")
        out[key] = timer.summary(launches)
        a_launches[key] = launches.get("quant_matmul_int8", 0)
        lk = loop(True, toks)[1]
        lp = loop(False, toks)[1]
        plain_snap = snaps.get(False)
        lj = jittered_floor(patches, lambda: loop(False, toks)[1], dev)
        hold_tokens(tag, toks, lk, lp, lj)
        del lk, lp, lj

    # (c)'s caches after the prefill: the kernel path's and the jittered plain
    # path's against the plain path's
    def cache_spread(snap, ref):
        moved, total, max_scale_rel, per_layer = 0, 0, 0.0, []
        for i, ((kc, ks), (pc, ps)) in enumerate(zip(snap, ref)):
            d = (kc.int() - pc.int()).abs()
            rows_moved = (d > 0).any(dim=-1)
            rel = ((ks - ps).abs() / ps.abs().clamp(min=1e-30))[..., 0]
            if bool((~rows_moved).any()):
                max_scale_rel = max(max_scale_rel, float(rel[~rows_moved].max()))
            moved += int((d > 0).sum())
            total += d.numel()
            per_layer.append({"moved": int((d > 0).sum()), "max_move": int(d.max()),
                              "max_scale_rel": float(rel.max())})
        return {"share": moved / total, "max_scale_rel_unmoved_rows": max_scale_rel,
                "layer0": [per_layer[0], per_layer[1]], "codes": total,
                "max_move": max(x["max_move"] for x in per_layer)}

    kern_c, floor_c = cache_spread(snaps[True], plain_snap), cache_spread(snaps[False],
                                                                          plain_snap)
    l0 = kern_c["layer0"]
    l0_share = sum(x["moved"] for x in l0) / (2 * plain_snap[0][0].numel())
    out["kv8_prefill_caches"] = {"kernel": kern_c, "floor": floor_c, "layer0_share": l0_share}
    print(f"(c) int8 KV caches after the prefill, kernel vs plain: layer 0 (K, V) "
          f"{[x['moved'] for x in l0]} codes moved (share {l0_share:.3e}, tol "
          f"{CG_KV_LAYER0_SHARE}), by at most {max(x['max_move'] for x in l0)}, scales within "
          f"{max(x['max_scale_rel'] for x in l0):.3e} (tol {CG_KV_SCALE_REL}); all {L} layers "
          f"{kern_c['share']:.3e} of {kern_c['codes']} codes moved, by at most "
          f"{kern_c['max_move']} (floor {floor_c['share']:.3e}, by at most "
          f"{floor_c['max_move']}; tol {CG_KV_FLOOR_FACTOR}x floor); rows without a moved "
          f"code: scales within {kern_c['max_scale_rel_unmoved_rows']:.3e} (tol "
          f"{CG_KV_SCALE_REL})", flush=True)
    check(l0_share <= CG_KV_LAYER0_SHARE and all(x["max_move"] <= 1 for x in l0)
          and all(x["max_scale_rel"] <= CG_KV_SCALE_REL for x in l0),
          "(c) layer 0's int8 KV codes and scales after the prefill agree with the plain "
          "path's")
    check(kern_c["share"] <= CG_KV_FLOOR_FACTOR * floor_c["share"]
          and kern_c["max_scale_rel_unmoved_rows"] <= CG_KV_SCALE_REL,
          "(c) the int8 KV caches after the prefill agree with the plain path's within the "
          "floor")

    # one token step of each path at position T0, profiled
    tok1 = toks[:, :1]
    cache_a = init_kv_cache(gcfg, B, T0 + 1, device=dev)
    _, cache_a = gen_mod.forward_with_cache(params, prompt, prec, gcfg, cache_a)
    cache_b = init_kv_cache(cfg, B, T0 + 1, device=dev)
    _, cache_b = inference.infer_forward_with_cache(tree, prompt, cfg, cache_b)
    caches_c = init_layer_caches(cfg, B, T0 + 1, kv_bits=8, device=dev)
    inference.infer_forward_unrolled(tree, prompt, cfg, caches_c, 0, static=static)
    profiles = {
        "generate": call_profile(lambda: gen_mod.forward_with_cache(
            params, tok1, prec, gcfg, cache_a)),
        "with_cache_int8": call_profile(lambda: inference.infer_forward_with_cache(
            tree, tok1, cfg, cache_b)),
        "unrolled_kv8": call_profile(lambda: inference.infer_forward_unrolled(
            tree, tok1, cfg, caches_c, T0, static=static))}
    for key, prof in profiles.items():
        out[key]["step_profile"] = prof
        print(f"{key} token step at position {T0}: wall {prof['wall_ms']:.2f} ms, "
              f"{prof['cuda_records']} CUDA records, device {prof['device_ms']:.2f} ms "
              f"(idle share at most {prof['idle_share']:.3f}); dearest {prof['top']}",
              flush=True)
    del cache_a, cache_b, caches_c

    # (d) folded against factored, float32 trees
    trees = {fmt: quantize_for_inference(params, cfg, 8, torch.float32, weight_format="int8",
                                         lora_format=fmt) for fmt in ("factored", "folded")}
    for t in trees.values():
        t.pop("_static")
    check(all("lora_AB" in trees["folded"]["blocks"][n] and "lora_A"
              not in trees["folded"]["blocks"][n] for n in LINEARS),
          "(d) the folded tree holds lora_AB in place of the factors")

    def prefill(fmt):
        cache = init_kv_cache(cfg, B, T0, device=dev)
        return infer_forward_with_cache(trees[fmt], prompt, cfg, cache)[0]

    lk, lp = prefill("folded"), prefill("factored")
    lj = jittered_floor([(inference, "_lora", "out")], lambda: prefill("factored"), dev)
    agree, rel = agreement(lk, lp)
    f_agree, f_rel = agreement(lj, lp)
    print(f"(d) folded vs factored LoRA (float32 trees, prefill logits): argmax agreement "
          f"{agree:.4f} (floor {f_agree:.4f}, tol floor - {TOKEN_AGREE_MARGIN}); mean abs "
          f"diff / std {rel:.3e} (floor {f_rel:.3e}, tol {LOGIT_FLOOR_FACTOR}x floor); max "
          f"abs diff {float((lk - lp).abs().max()):.3e}", flush=True)
    check(bool(torch.isfinite(lk).all()), "(d) finite logits")
    check(agree >= f_agree - TOKEN_AGREE_MARGIN and rel <= LOGIT_FLOOR_FACTOR * f_rel,
          "(d) folded LoRA logits agree with the factored tree's within float rounding")
    out["folded_vs_factored"] = {"argmax_agreement": agree, "mean_abs_over_std": rel,
                                 "floor_agreement": f_agree, "floor_mean_abs_over_std": f_rel}
    del lk, lp, lj, trees
    print("cached_generate_timings " + json.dumps(out), flush=True)
    return a_launches


def eval_setup(dev):
    """GPT-2 124M with the evaluation command's quant config (bits 4/8/32,
    the default kinds, per-channel, rank 64: the fields a checkpoint's
    metadata carries), random weights from seed 0, LoRA B banks drawn small,
    weight and input quantizers calibrated as serve_setup does. Returns
    (cfg, params)."""
    import torch

    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.train.calibration_manager import (
        calibrate_input_quantizers,
        calibrate_weight_quantizers,
    )

    cfg = SPModelConfig(model=GPT2Config(), quant=QuantConfig(bit_widths=(4, 8, 32)))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_sp_params(gen, cfg, device=dev)
    for lin in LINEARS:
        lb = params["blocks"][lin]["lora_B"]
        params["blocks"][lin]["lora_B"] = 0.02 * torch.randn(lb.shape, generator=gen,
                                                             device=dev)
    params = calibrate_weight_quantizers(params, cfg)
    cal = [torch.randint(0, cfg.model.vocab_size, (2, 64), generator=gen, device=dev)
           for _ in range(3)]
    return cfg, calibrate_input_quantizers(params, cfg, cal)


def eval_forward_profiles(params, cfg, dev):
    """The evaluation forward at its two shapes, (16, 1024) (a perplexity
    batch) and (4, 1024) (a four-choice zero-shot example), each profiled
    by `call_profile`; and #5 on its float32 SIMT route at the batch's
    attention shape (16, 12, 1024, 64): CUDA-event ms beside its plain
    version's, SDPA's causal float32 forward on the same operands and the
    bound (q, k, v, o and the LSE moved once; Q·Kᵀ and P·V over the causal
    pairs at the float32 peak outside the tensor cores)."""
    import torch
    import torch.nn.functional as F

    from llm_qat_tpu_torch.models.sp_model import sp_forward
    from llm_qat_tpu_torch.ops import attention as att

    prec = cfg.quant.prec_index(8)
    g = torch.Generator(device=dev).manual_seed(5)
    H, D, T = cfg.model.n_head, cfg.model.head_dim, cfg.model.n_positions
    out = {}
    with torch.no_grad():
        for B in (16, 4):
            ids = torch.randint(0, cfg.model.vocab_size, (B, T), generator=g, device=dev)
            out[f"forward_profile_{B}x{T}"] = call_profile(
                lambda: sp_forward(params, ids, prec, cfg)["logits"])
    B = 16
    q, k, v = (torch.randn((B, H, T, D), generator=g, device=dev) for _ in range(3))
    nbytes = (4 * B * H * T * D + B * H * T) * 4
    flops = 2 * 2 * D * B * H * T * (T + 1) // 2
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)
    out[f"flash_fwd_lse_simt_{B}x{H}x{T}x{D}"] = {
        "ms": cuda_ms(lambda: att.flash_fwd_lse(q, k, v), 20),
        "plain_ms": cuda_ms(lambda: att.flash_fwd_lse_plain(q, k, v), 3, warmup=1),
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
                              20),
        "bound_ms": 1e3 * bound,
        "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= flops / PEAK_F32_FLOPS
        else "operations"}
    for key, val in out.items():
        print(f"eval {key}: {json.dumps(val)}", flush=True)
    return out


EVAL_SP_FLAGS = ["--max-length", "1024", "--stride", "512", "--synthetic-tasks"]
EVAL_PPL_REL = 1e-4      # perplexity, kernels against plain versions, relative
EVAL_TIE = 1e-4          # zero-shot: a choice may differ where the plain top two are this close


def eval_sp_phase(dev, card) -> int:
    """`--eval-sp` (and part of the default run): the calibrated GPT-2 124M
    saved with the port's `save_per_bit_checkpoints` (sp_4bit.npz,
    sp_8bit.npz), then `python -m llm_qat_tpu_torch.cli.eval_sp` through
    `eval_sp.main` on each, offline (the byte tokenizer, the synthetic
    corpus, `--synthetic-tasks`; the 4-bit file with `--skip-zero-shot`), at
    `--max-length 1024 --stride 512`: the
    float32 forward's attention runs #5 on its SIMT route, 12 launches a
    forward (counters set to 0 just before each run, read just after, and
    each forward counted). Checks `results.json`'s keys against the JAX
    command's and a finite perplexity. The 8-bit run again with #5's plain
    version patched in (as `step_vs_plain` patches): the perplexity within
    EVAL_PPL_REL, the same zero-shot choices except where the plain run's
    two best scores are within EVAL_TIE. Prints `eval_sp_timings`. Returns
    #5's launches in the kernel runs."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from llm_qat_tpu_torch.cli import eval_sp
    from llm_qat_tpu_torch.deploy import save_per_bit_checkpoints
    from llm_qat_tpu_torch.ops import attention as att

    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    cfg, params = eval_setup(dev)
    prof = eval_forward_profiles(params, cfg, dev)
    root = tempfile.mkdtemp(prefix="eval_sp_")
    saved = {n: getattr(eval_sp, n) for n in ("load_switchable_model", "sp_forward",
                                              "PerplexityEvaluator", "ZeroShotEvaluator")}

    def run(path, tag, plain=False, extra=()):
        rec = {"forwards": 0, "scores": [], "ppl": []}

        def load(*a, **k):
            t = time.perf_counter()
            res = saved["load_switchable_model"](*a, **k)
            torch.cuda.synchronize()
            rec["load_s"] = time.perf_counter() - t
            return res

        def forward(*a, **k):
            rec["forwards"] += 1
            return saved["sp_forward"](*a, **k)

        class Perplexity(saved["PerplexityEvaluator"]):
            def calculate_perplexity(self, seqs):
                rec["windows"] = len(self.windows(seqs))
                rec["window_tokens"] = rec["windows"] * self.max_length
                torch.cuda.synchronize()
                t = time.perf_counter()
                ppl = super().calculate_perplexity(seqs)
                rec["perplexity_s"] = time.perf_counter() - t
                rec["ppl"].append(ppl)
                return ppl

        class ZeroShot(saved["ZeroShotEvaluator"]):
            def score_choices(self, context, choices):
                s = super().score_choices(context, choices)
                rec["scores"].append(s)
                return s

            def evaluate_all_tasks(self, tasks):
                t = time.perf_counter()
                res = super().evaluate_all_tasks(tasks)
                rec["zero_shot_s"] = time.perf_counter() - t
                return res

        patches = {"load_switchable_model": load, "sp_forward": forward,
                   "PerplexityEvaluator": Perplexity, "ZeroShotEvaluator": ZeroShot}
        kernel = att.flash_fwd_lse
        for n, f in patches.items():
            setattr(eval_sp, n, f)
        if plain:
            att.flash_fwd_lse = att.flash_fwd_lse_plain
        zero_counters()
        try:
            t = time.perf_counter()
            results = eval_sp.main(["--model-path", path, "--output-dir",
                                    os.path.join(root, tag), *EVAL_SP_FLAGS, *extra])
            rec["total_s"] = time.perf_counter() - t
            rec["launches"] = read_counters()
            rec["flash_routes"] = dict(kernel.route_launches)
        finally:
            att.flash_fwd_lse = kernel
            for n, f in saved.items():
                setattr(eval_sp, n, f)
        rec["results"] = results
        return rec

    try:
        paths = save_per_bit_checkpoints(root, params, cfg)
        del params
        torch.cuda.empty_cache()
        names = sorted(os.path.basename(p) for p in paths.values())
        check(names == ["sp_4bit.npz", "sp_8bit.npz"], f"per-bit checkpoints {names}")
        runs = {}
        # the 4-bit file (the minmax kind) without the zero-shot suite, which
        # the 8-bit runs take (about 20 s a run)
        for bits, extra in ((8, ()), (4, ("--skip-zero-shot",))):
            path = os.path.join(root, f"sp_{bits}bit.npz")
            r = runs[bits] = run(path, f"k{bits}", extra=extra)
            n = r["forwards"]
            print(f"eval_sp {bits}-bit: {n} forwards; launches {r['launches']}; #5 by route "
                  f"{r['flash_routes']}; perplexity {r['ppl']}; zero-shot "
                  f"{r['results'].get('zero_shot')}", flush=True)
            L = cfg.model.n_layer
            check(n > 0 and r["launches"] == {"flash_fwd_lse": L * n}
                  and r["flash_routes"] == {"wgmma": 0, "simt": L * n},
                  f"eval_sp {bits}-bit: #5 ran {L} times per forward, all on SIMT")
            res = r["results"]
            with open(os.path.join(root, f"k{bits}", "results.json")) as f:
                on_disk = json.load(f)
            keys = {"bit_width", "perplexity", "model_size_gb", "compression_ratio",
                    "model_size_sweep"} | ({"zero_shot"} if not extra else set())
            check(set(on_disk) == keys
                  and on_disk["bit_width"] == bits and set(on_disk["perplexity"]) == {"wikitext2"}
                  and (extra or set(on_disk["zero_shot"]) == {
                      "BoolQ", "HellaSwag", "WinoGrande", "ARC-e", "ARC-c", "OBQA", "Average"})
                  and len(on_disk["model_size_sweep"]) == 13,
                  f"eval_sp {bits}-bit: results.json has the JAX command's keys")
            check(len(r["ppl"]) == 1 and math.isfinite(r["ppl"][0]) and r["ppl"][0] > 0,
                  f"eval_sp {bits}-bit: finite perplexity")
            check(res["perplexity"]["wikitext2"] == round(r["ppl"][0], 1),
                  f"eval_sp {bits}-bit: results hold the evaluator's perplexity")
        kern, plain = runs[8], run(os.path.join(root, "sp_8bit.npz"), "p8", plain=True)
        check(plain["launches"] == {}, f"eval_sp plain: no kernel launched: {plain['launches']}")
        ppl_rel = abs(kern["ppl"][0] - plain["ppl"][0]) / plain["ppl"][0]
        check(len(kern["scores"]) == len(plain["scores"]) > 0, "eval_sp: the same examples")
        differ = ties = 0
        max_score_diff = 0.0
        for sk, sp in zip(kern["scores"], plain["scores"]):
            fin = np.isfinite(sp)
            check(bool((np.isfinite(sk) == fin).all()), "eval_sp: the same empty spans")
            if fin.any():
                max_score_diff = max(max_score_diff, float(np.abs(sk[fin] - sp[fin]).max()))
            if int(np.argmax(sk)) != int(np.argmax(sp)):
                top = np.sort(sp[fin])[::-1]
                tie = len(top) > 1 and top[0] - top[1] <= EVAL_TIE
                ties += tie
                differ += not tie
        print(f"eval_sp 8-bit, kernels vs plain versions: perplexity {kern['ppl'][0]!r} vs "
              f"{plain['ppl'][0]!r} (relative {ppl_rel:.3e}, tol {EVAL_PPL_REL}); "
              f"{len(kern['scores'])} zero-shot examples, choice scores within "
              f"{max_score_diff:.3e}, {ties} choices moved at a tie (plain top two within "
              f"{EVAL_TIE}), {differ} elsewhere (tol 0)", flush=True)
        check(ppl_rel <= EVAL_PPL_REL, "eval_sp: perplexity agrees with the plain versions'")
        check(differ == 0, "eval_sp: the same zero-shot choices as the plain versions'")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = {"card": card, "flags": EVAL_SP_FLAGS}
    for tag, r in (("k8", runs[8]), ("k4", runs[4]), ("p8", plain)):
        out[tag] = {k: r.get(k) for k in ("load_s", "perplexity_s", "windows",
                                          "window_tokens", "zero_shot_s", "total_s",
                                          "forwards", "launches", "flash_routes")}
        out[tag]["window_tokens_per_s"] = r["window_tokens"] / r["perplexity_s"]
        out[tag]["perplexity"] = r["ppl"][0]
        out[tag]["zero_shot"] = r["results"].get("zero_shot")
    out["perplexity_rel_diff_kernel_vs_plain"] = ppl_rel
    out.update(prof)
    print("eval_sp_timings " + json.dumps(out), flush=True)
    return sum(runs[b]["launches"].get("flash_fwd_lse", 0) for b in (8, 4))


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
    ap.add_argument("--main-sp", action="store_true",
                    help="only run the SP command line at GPT-2 124M, T = 1024")
    ap.add_argument("--cached-generate", action="store_true",
                    help="only run the KV-cached generation paths (may be combined with "
                         "--eval-sp)")
    ap.add_argument("--eval-sp", action="store_true",
                    help="only run the SP evaluation command at T = 1024 (may be combined "
                         "with --cached-generate)")
    ap.add_argument("--main-cpt", action="store_true",
                    help="only run the CPT command line and eval_cpt at GPT-2 124M (may be "
                         "combined with --main-squad)")
    ap.add_argument("--main-squad", action="store_true",
                    help="only run the SQuAD command line at GPT-2 124M (may be combined "
                         "with --main-cpt)")
    ap.add_argument("--run-rpi", action="store_true",
                    help="only run the RPI command line, its gradient importance and their "
                         "holds at GPT-2 124M")
    ap.add_argument("--parallel", action="store_true",
                    help="only run the parallel layer's paths (TP/DP, CP, PP, TP decode) at "
                         "GPT-2 124M, 12 layers, on one NCCL group of world size 1")
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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)

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
    if args.main_sp:
        return main_sp_phase(dev, card)
    if args.main_cpt or args.main_squad:
        if args.main_cpt:
            main_cpt_phase(dev, card)
            torch.cuda.empty_cache()
        if args.main_squad:
            main_squad_phase(dev, card)
        return 0
    if args.run_rpi:
        rpi_phase(dev, card, RPI_SAMPLES)
        print_result()
        return 0
    if args.parallel:
        parallel_phase(dev, card, 12)
        print_result()
        return 0
    if args.cached_generate or args.eval_sp:
        if args.cached_generate:
            cfg, params, gen = serve_setup(dev)
            cached_generate_phase(params, cfg, dev, gen, card)
            del params
            torch.cuda.empty_cache()
        if args.eval_sp:
            eval_sp_phase(dev, card)
        return 0
    for src in ("fused_linear", "quant_matmul", "flash_attention", "decode_attention",
                "mega_decode", "fused_decode"):
        print(f"ptxas, csrc/{src}.cu:\n" + _build.ptxas_report(src), flush=True)
    print_ptxas_wgmma_flash(_build)

    # the SP command line first: its dataset and states are freed before
    # the other paths start
    main_sp_phase(dev, card, MAIN_SP_DEFAULT_DOCS)

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

    # 4c. KV-cached generation (generate, infer_forward_with_cache, the int8
    #     KV cache, the folded LoRA) and the SP evaluation command
    cg_launches = cached_generate_phase(params, cfg, dev, gen, card)
    eval_launches = eval_sp_phase(dev, card)

    # 4c'. the CPT and SQuAD command lines (no kernel: every counter reads
    #      0 across their steps and evaluations)
    torch.cuda.empty_cache()
    main_cpt_phase(dev, card)
    torch.cuda.empty_cache()
    main_squad_phase(dev, card)
    torch.cuda.empty_cache()

    # 4c''. the RPI command line (#5 at T = 1024) and its gradient importance
    #       (#5 and #6)
    rpi_launches = rpi_phase(dev, card, RPI_DEFAULT_SAMPLES, RPI_DEFAULT_LAYERS)
    torch.cuda.empty_cache()

    # 4c, parallel. The parallel layer (TP/DP, CP, PP, TP decode) at GPT-2
    #     width with PARALLEL_DEFAULT_LAYERS layers, one NCCL group of one
    par_launches = parallel_phase(dev, card, PARALLEL_DEFAULT_LAYERS)
    torch.cuda.empty_cache()

    # 4d. training: kernels #14-#16 against their plain versions at the
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
    # one iteration profiled: the fused path's, which runs every training
    # kernel (the flat path's profile, about 30 s, is left out for time)
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
         "launches": launches["flash_attention"] + par_launches["tp_decode"]["flash_attention"],
         "launches_by_path": {"serve": launches["flash_attention"],
                              "tp_decode": par_launches["tp_decode"]["flash_attention"]},
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
        # #5 also runs in the evaluation and RPI commands, and #5 and #6 in
        # the RPI gradient importance (float32, SIMT route)
        by_path = {"train": tlaunch[name]}
        if name == "flash_fwd_lse":
            by_path["eval_sp"] = eval_launches
            by_path["run_rpi"] = rpi_launches["run_rpi"]
        by_path["rpi_importance"] = rpi_launches["rpi_importance"][name]
        by_path["tp_step"] = par_launches["tp_step"][name]
        by_path["pp_step"] = par_launches["pp_step"][name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "llm_qat_tpu_torch/csrc/flash_attention.cu",
            "replaces": f"llm_qat_tpu/ops/attention.py:{line}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name],
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
                    "quant_matmul_int8": (a_launches["quant_matmul_int8"]
                                          + sum(cg_launches.values())),
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
        if name == "quant_matmul_int8":
            kernels[-1]["launches_by_path"] = {"path_a": a_launches["quant_matmul_int8"],
                                               **cg_launches}
    check(len(kernels) == 16, "the kernels line has a row for each of the 16 kernels")
    print(json.dumps({"kernels": kernels}), flush=True)
    print_result()
    return 0


def print_result():
    """The result line, last on standard output."""
    import torch

    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
