"""Spans from the harness, and the profiler trace of a slice after the window.

The harness marks what the host is doing around each call into the system
(`span(name)`: a `torch.profiler.record_function` only while a trace is
being taken). `profile_slice(fn)` runs `fn` under torch.profiler (CPU and
CUDA activity), writes the Chrome trace into a temporary directory under
TMPDIR, and reduces it to: device time and records by kernel, the busy
seconds (the union of kernel, copy and set intervals), the slice's length,
and the idle gaps between device work, each named by the innermost harness
span the host was in when the gap began.
"""

from __future__ import annotations

import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "slice"


class Spans:
    """Harness spans, live only while `on`."""

    def __init__(self):
        self.on = False

    def __call__(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)


def short_name(kernel: str) -> str:
    """A kernel's name without `void `, template arguments and parameters."""
    name = kernel[5:] if kernel.startswith("void ") else kernel
    for cut in ("<", "("):
        name = name.split(cut)[0]
    return name.split("::")[-1].strip()


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce_trace(events: List[dict], names: Tuple[str, ...]) -> dict:
    """The slice's numbers from Chrome-trace events (times in us)."""
    dev, spans = [], []
    by_kernel: Dict[str, List[float]] = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur))
            k = by_kernel.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += dur * 1e-6
        elif cat == "user_annotation" and e["name"] in names + (SLICE,):
            spans.append((ts, ts + dur, e["name"]))
    whole = [s for s in spans if s[2] == SLICE]
    lo, hi = (whole[0][0], whole[0][1]) if whole else (
        min(a for a, _ in dev), max(b for _, b in dev))
    busy = _merge([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
    gaps, t = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    inner = [s for s in spans if s[2] != SLICE]

    def label(t0):
        around = [s for s in inner if s[0] <= t0 < s[1]]
        return min(around, key=lambda s: s[1] - s[0])[2] if around else "host"

    gaps = sorted(((label(a), (b - a) * 1e-6) for a, b in gaps), key=lambda g: -g[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6, "trace_window_s": (hi - lo) * 1e-6,
            "kernels": {name: {"count": c, "seconds": s} for name, (c, s) in by_kernel.items()},
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def profile_slice(fn, spans: Spans, names: Tuple[str, ...]) -> dict:
    """Run `fn()` under the profiler; the slice's reduced trace, with its
    host wall time (`window_s`) beside it."""
    spans.on = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                with torch.profiler.record_function(SLICE):
                    fn()
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            path = Path(tmp) / "trace.json"
            prof.export_chrome_trace(str(path))
            events = json.loads(path.read_text()).get("traceEvents", [])
    finally:
        spans.on = False
    out = reduce_trace(events, names)
    out["window_s"] = wall
    return out


def kernel_table(trace: dict) -> Dict[str, dict]:
    """{short kernel name: {"count": records, "seconds": device s}}."""
    table: Dict[str, dict] = {}
    for name, k in trace["kernels"].items():
        t = table.setdefault(short_name(name), {"count": 0, "seconds": 0.0})
        t["count"] += k["count"]
        t["seconds"] += k["seconds"]
    return table


def top_ops(trace: dict, n: int = 10) -> List[list]:
    ops = sorted(trace["kernels"].items(), key=lambda kv: -kv[1]["seconds"])[:n]
    return [[name[:120], k["seconds"]] for name, k in ops]


def launch_time(table: Dict[str, dict], name: str, made: int):
    """Device seconds of `made` launches of kernel `name`: the mean per
    recorded launch times the launches the wrappers counted (the profiler
    may drop records). None when no launch of it was recorded."""
    k = table.get(name)
    if not made or not k or not k["count"]:
        return None
    return k["seconds"] / k["count"] * made
