"""The serving cells: `ContinuousBatchingEngine` under an open loop.

Set-up makes the weights from the seed, calibrates them with the system's
calibration functions at the served bit-width and builds the engine.
The warm-up serves one request of every prefill bucket of the mix to its
end, which builds and loads every kernel the cell uses; then requests
arrive on the mix's schedule (`traffic.request_stream`: Poisson arrivals
at a fixed rate, whatever the engine does), counted from there; before
each `step_chunk` the harness submits every request whose arrival time
has passed. After `warmup_s` seconds of that loop the window opens on it. Time is the host's, read when `step_chunk`
returns: a token reaches the host at the end of the chunk that made it. A
request that arrived in the window runs to its end after the window closes
and enters the tails, timed from its arrival.

After the window a sample of the finished requests, drawn from the seed
with the longest among them, is held against the reference: each served
token's logit against the reference's best at its position.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from .compare import served_gap
from .trace import Spans, kernel_table, profile_slice, top_ops
from .traffic import check_sample, host_rng, request_stream, warmup_sizes
from .train_cell import build_cfg, ref_dims
from .weights import make_params

SPANS = ("step_chunk", "submit", "bookkeeping")
DRAIN_S = 60.0   # a request unfinished this long after the window has failed
_SALT_WARM = 0x55


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (inf sorts last); inf of nothing."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)] if v else math.inf


class Loop:
    """The open loop: the schedule, the requests in flight, and records."""

    def __init__(self, eng, stream, spans, t_origin: float):
        self.eng, self.stream, self.spans = eng, stream, spans
        self.t_origin = t_origin
        self.next = next(stream)
        self.inflight = {}    # request id -> record
        self.done = []
        self.chunks = []      # per chunk: (end time, tokens, first tokens, steps, lengths0)

    def submit(self, arrival: float, prompt, n_new: int):
        with self.spans("submit"):
            rid = self.eng.submit(prompt, max_new_tokens=n_new)
            req = self.eng.queue[-1]
            self.inflight[rid] = {"req": req, "submit": arrival, "first": None, "last": None,
                                  "seen": 0, "seen0": 0, "in_window": 0, "prompt": prompt,
                                  "n_new": n_new}

    def arrivals(self, now: float) -> int:
        """Submit every request of the schedule that has arrived by `now`."""
        n = 0
        while self.t_origin + self.next[0] <= now:
            off, prompt, n_new = self.next
            self.submit(self.t_origin + off, prompt, n_new)
            self.next = next(self.stream)
            n += 1
        return n

    def open_window(self):
        """Forget the warm-up's records; a request in flight keeps running,
        and only its tokens from here on count."""
        self.done, self.chunks = [], []
        for r in self.inflight.values():
            r["seen0"], r["in_window"] = r["seen"], 0

    def chunk(self, k: int, t_end: float, schedule: bool = True):
        """The arrivals so far, then one step_chunk and its bookkeeping (with
        nothing in flight, a wait for the next arrival); returns the time it
        ended."""
        if schedule:
            self.arrivals(time.perf_counter())
            if not self.inflight:
                time.sleep(max(0.0, self.t_origin + self.next[0] - time.perf_counter()))
                self.arrivals(time.perf_counter())
        before = {rid: max(1, len(r["req"].generated)) for rid, r in self.inflight.items()}
        steps0 = self.eng.decode_steps
        with self.spans("step_chunk"):
            self.eng.step_chunk(k)
        now = time.perf_counter()
        tokens, firsts, lengths0 = 0, 0, []
        with self.spans("bookkeeping"):
            for rid, r in list(self.inflight.items()):
                req = r["req"]
                n = len(req.generated)
                if n > r["seen"]:
                    if r["first"] is None:
                        r["first"] = now
                        firsts += 1
                    if now <= t_end:
                        r["in_window"] += n - r["seen"]
                    tokens += n - r["seen"]
                    lengths0.append(len(r["prompt"]) + before[rid] - 1)
                    r["seen"] = n
                if req.done:
                    r["last"] = now
                    self.done.append(r)
                    del self.inflight[rid]
            self.chunks.append((now, tokens, firsts, self.eng.decode_steps - steps0, lengths0))
        return now


def build(cell, seed: int, device, slots=None):
    """(engine, weights, calibration batches) of a serving cell from the
    seed; `slots` overrides the mix's (the sweep)."""
    from llm_qat_tpu_torch.serving import ContinuousBatchingEngine
    from llm_qat_tpu_torch.train.calibration_manager import (
        calibrate_input_quantizers,
        calibrate_weight_quantizers,
    )

    config, traffic = cell.config, cell.traffic
    cfg, _ = build_cfg(config, traffic)
    q = cfg.quant
    bits = traffic["bits"]
    gen = torch.Generator(device=device).manual_seed(seed)
    params = make_params(config, q.bit_widths, q.max_rank, q.per_channel, gen, device)
    cal = [torch.randint(0, config["vocab_size"], (traffic["calibration"]["batch"],
                                                   traffic["calibration"]["seq_len"]),
                         generator=gen, device=device)]
    calibrated = calibrate_input_quantizers(calibrate_weight_quantizers(params, cfg), cfg, cal,
                                            precisions=[bits])
    eng = ContinuousBatchingEngine(
        calibrated, cfg, bits=bits, n_slots=slots or traffic["slots"],
        max_len=traffic["max_len"], weight_format=traffic["weight_format"],
        lm_head_bits=traffic["lm_head_bits"], kv_layout=traffic["kv_layout"],
        kv_bits=traffic["kv_bits"], mega_tbp=traffic["mega_tbp"], device=device)
    return eng, params, cal


def warm_up(loop: Loop, traffic: dict, vocab: int, seed: int, k: int):
    """The warm-up wave of every prefill bucket, run to its end before the
    schedule starts (so the first run of a checkout builds every kernel
    with no request waiting), then the open loop for `warmup_s`."""
    warm_rng = host_rng(seed, _SALT_WARM)
    for n_prompt, n_new in warmup_sizes(traffic):
        loop.submit(time.perf_counter(),
                    warm_rng.integers(0, vocab, n_prompt).astype(np.int32), n_new)
    while loop.inflight:
        loop.chunk(k, -math.inf, schedule=False)
    loop.t_origin = time.perf_counter()
    while time.perf_counter() < loop.t_origin + traffic["warmup_s"]:
        loop.chunk(k, -math.inf)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        faults=None, keep=False) -> dict:
    """One run of a serving cell. `faults` (tests only) wraps the engine;
    `keep` returns the reference and the checked sequences too
    (`readings.py`)."""
    from ..reference.served import Served, served_gaps

    config, traffic = cell.config, cell.traffic
    bits = traffic["bits"]
    eng, params, cal = build(cell, seed, device)
    if faults is not None:
        eng = faults(eng)
    k = traffic["chunk"]
    spans = Spans()
    loop = Loop(eng, request_stream(traffic, config["vocab_size"], seed), spans,
                time.perf_counter())
    warm_up(loop, traffic, config["vocab_size"], seed, k)
    _sync(device)
    setup_s = time.perf_counter() - t0

    loop.open_window()
    t_start = time.perf_counter()
    t_end = t_start + seconds
    now = t_start
    while now < t_end:
        now = loop.chunk(k, t_end)
    n_window_chunks = len(loop.chunks)
    window_chunk_s = (loop.chunks[-1][0] - t_start) / n_window_chunks
    in_window = [c for c in loop.chunks if c[0] <= t_end]

    in_flight_at_close = len(loop.inflight)
    out = {}
    if trace:
        from llm_qat_tpu_torch.ops import mega_decode as md

        md.mega_decode_step_cb.launches = 0
        n_prof = traffic["profile_chunks"]
        first = len(loop.chunks)
        # the profiler slows the host, so the profiled chunks take the
        # schedule's arrivals at the window's pace (a mean chunk of the
        # window each), not the wall's: each holds the work of a chunk
        # of the window
        pace = [time.perf_counter()]

        def slice_():
            for _ in range(n_prof):
                pace[0] += window_chunk_s
                loop.arrivals(pace[0])
                loop.chunk(k, t_end, schedule=False)

        tr = profile_slice(slice_, spans, SPANS)
        out["trace"] = {"busy_s": tr["busy_s"], "window_s": tr["window_s"],
                        "breakdown": {"device_ops": top_ops(tr), "idle_gaps": tr["idle_gaps"]}}
        out["ctx"] = {
            "config": config, "traffic": traffic,
            "device_name": torch.cuda.get_device_name(device),
            "slice": {"chunks": [{"steps": c[3], "lengths0": c[4]}
                                 for c in loop.chunks[first:]]},
            "made": {"mega_decode_step_cb": md.mega_decode_step_cb.launches},
            "kernels": kernel_table(tr), "busy_s": tr["busy_s"],
            "trace_window_s": tr["window_s"]}
    # the drain: no new request; every request in flight runs to its end
    drain_end = time.perf_counter() + DRAIN_S
    while loop.inflight and time.perf_counter() < drain_end:
        loop.chunk(k, t_end, schedule=False)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    everyone = loop.done + list(loop.inflight.values())
    window = [r for r in everyone if t_start <= r["submit"] < t_end]
    ttft = [r["first"] - r["submit"] if r["last"] is not None else math.inf for r in window]
    tpot = [(r["last"] - r["first"]) / max(1, r["seen"] - 1) if r["last"] is not None
            else math.inf for r in window]
    out.update({
        "attempted": len(window), "failed": sum(1 for r in window if r["last"] is None),
        "memory_peak_bytes": peak,
        "end_to_end": {"setup_s": setup_s,
                       "serve_ttft_p95_ms": 1e3 * percentile(ttft, 95),
                       "serve_tpot_p95_ms": 1e3 * percentile(tpot, 95)}})
    t_half = t_start + seconds / 2
    halves = ([x for r, x in zip(window, ttft) if r["submit"] < t_half],
              [x for r, x in zip(window, ttft) if r["submit"] >= t_half])
    decode_tokens = sum(c[1] - c[2] for c in in_window)
    decode_steps = sum(c[3] for c in in_window)
    print(f"bench_port: window {len(window)} arrivals, "
          f"{sum(r['in_window'] for r in everyone) / seconds!r} tokens/s reached the host, "
          f"{in_flight_at_close} in flight or queued at the close, "
          f"{n_window_chunks} chunks of {window_chunk_s!r} s, "
          f"{decode_tokens / max(1, decode_steps)!r} slots busy a step, "
          f"ttft p50 {1e3 * percentile(ttft, 50)!r} ms, p95 of the window's halves "
          f"{[1e3 * percentile(h, 95) for h in halves]!r} ms", file=sys.stderr)
    if trace:
        # a request's tokens inside the window are its tokens seen0 ..
        # seen0 + in_window - 1: token 0 from its prefill, token i from a
        # decode step over T0 + i rows
        out["ctx"]["window"] = {
            "seconds": seconds, "chunk_s": window_chunk_s, "slots": traffic["slots"],
            "decode_steps": decode_steps, "decode_tokens": decode_tokens,
            "prefills": [len(r["prompt"]) for r in everyone
                         if r["seen0"] == 0 and r["in_window"] > 0],
            "decode_contexts": [len(r["prompt"]) + i for r in everyone
                                for i in range(max(1, r["seen0"]), r["seen0"] + r["in_window"])]}

    done = [r for r in loop.done if t_start <= r["submit"] < t_end]
    del eng, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not done:
        out["numbers"] = {"served_gap": {"value": math.inf, "at": "no finished request"}}
        return out
    t_ref = time.perf_counter()
    longest = max(range(len(done)), key=lambda i: len(done[i]["req"].generated))
    pick = check_sample(len(done), longest, traffic["check_requests"], seed)
    ref = Served(params, ref_dims(config, traffic), bits, cal, traffic["kv_bits"],
                 traffic["lm_head_bits"], k, decode_block(traffic))
    gaps, kept = [], []
    for i in pick:
        r = done[i]
        served = torch.as_tensor(r["req"].generated, device=device)
        ids = torch.cat([torch.as_tensor(r["prompt"], device=device).long(), served[:-1]])
        T0 = len(r["prompt"])
        logits = ref.logits(ids, T0)[T0 - 1:]
        gaps.append(served_gaps(logits, served))
        kept.append((ids, T0, served))
    worst = max(range(len(gaps)), key=lambda i: float(gaps[i].max()))
    out["numbers"] = {"served_gap": {
        "value": served_gap(gaps),
        "at": f"request of {len(done[pick[worst]]['prompt'])} + {len(gaps[worst])} tokens",
        "tokens": int(sum(len(g) for g in gaps))}}
    out["reference_s"] = time.perf_counter() - t_ref
    if keep:
        out["kept"] = {"ref": ref, "sequences": kept, "gaps": gaps, "params": params,
                       "cal": cal}
    return out


def decode_block(traffic: dict) -> int:
    """The rows of a decode attention block: the engine's `mega_tbp`,
    lowered by 8 until it divides the cache length."""
    tbp = min(traffic["mega_tbp"], traffic["max_len"])
    while traffic["max_len"] % tbp and tbp > 8:
        tbp -= 8
    return tbp


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
