"""Profiling and roofline accounting for one NVIDIA H100.

Counterpart of `llm_qat_tpu/utils/profiling.py`: a `torch.profiler` trace
around a block, step timing with warm-up exclusion, and roofline estimates
for the quantized matmul path and a GPT-2 decode step. The peaks are the
H100 SXM data sheet's dense rates at its 700 W limit; they are the single
source of the card's peaks for the port (`chip_smoke.py` reads them here).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict

import torch

from ..device import resolve_device

# H100 SXM per-card peaks (NVIDIA data sheet, dense, without sparsity)
H100_PEAK_BF16_FLOPS = 989e12   # bf16 tensor cores
H100_PEAK_INT8_OPS = 1979e12    # int8 tensor cores
H100_PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
H100_HBM_BW = 3.35e12           # HBM3, bytes/s


@contextlib.contextmanager
def trace(log_dir, device=None):
    """Profile a block with `torch.profiler` (the CPU activity, and the CUDA
    activity on the card) and write a Chrome trace into `log_dir` on exit,
    also when the block raises. Yields `log_dir`."""
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class StepTimer:
    """Wall-clock step timing with warm-up exclusion. On a CUDA device it
    synchronises at enter and at exit, so a step is timed to the end of its
    device work and not only its launches."""

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = resolve_device(device)
        self.times = []
        self._count = 0
        self._t0 = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self.times.append(dt)

    @property
    def mean(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")


@dataclass
class RooflineEstimate:
    flops: float
    bytes: float
    compute_time_s: float
    memory_time_s: float
    bound: str

    @property
    def time_s(self) -> float:
        return max(self.compute_time_s, self.memory_time_s)


def matmul_roofline(m: int, k: int, n: int, weight_bits: int = 8,
                    act_bytes: int = 2, peak_flops: float = H100_PEAK_BF16_FLOPS,
                    hbm_bw: float = H100_HBM_BW) -> RooflineEstimate:
    """Roofline estimate for one x(M,K) @ Wq(K,N) with packed weights."""
    flops = 2.0 * m * k * n
    w_bytes = k * n * weight_bits / 8.0
    a_bytes = (m * k + m * n) * act_bytes
    total_bytes = w_bytes + a_bytes
    ct = flops / peak_flops
    mt = total_bytes / hbm_bw
    return RooflineEstimate(
        flops=flops, bytes=total_bytes, compute_time_s=ct, memory_time_s=mt,
        bound="memory" if mt > ct else "compute",
    )


def gpt2_decode_roofline(batch: int, n_layer: int = 12, d: int = 768,
                         vocab: int = 50257, weight_bits: int = 8,
                         context: int = 192,
                         peak_flops: float = H100_PEAK_BF16_FLOPS,
                         hbm_bw: float = H100_HBM_BW) -> Dict:
    """Tokens/s upper bound for GPT-2 decode at the given weight width on a
    card with `peak_flops` and `hbm_bw` (one H100 by default).

    Per token per layer: qkv (d,3d), proj (d,d), fc (d,4d), proj (4d,d) →
    12·d² MACs/layer; plus lm_head d·V; plus KV-cache reads 2·L·ctx·d·2B.
    """
    def mm(m, k, n, bits):
        return matmul_roofline(m, k, n, bits, peak_flops=peak_flops,
                               hbm_bw=hbm_bw).time_s

    per_layer = mm(batch, d, 3 * d, weight_bits) + mm(batch, d, d, weight_bits) \
        + mm(batch, d, 4 * d, weight_bits) + mm(batch, 4 * d, d, weight_bits)
    head = mm(batch, d, vocab, 16)  # head stays bf16
    kv_bytes = 2 * n_layer * context * d * 2 * batch
    kv_time = kv_bytes / hbm_bw
    step_time = n_layer * per_layer + head + kv_time
    return {
        "step_time_us": step_time * 1e6,
        "tokens_per_sec": batch / step_time,
        "tokens_per_sec_per_seq": 1.0 / step_time,
    }
