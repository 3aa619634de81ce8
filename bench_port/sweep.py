"""The sweep that finds what a serving cell's engine sustains (not run by
the benchmark; its findings set the mix's slots and rate).

    python3 bench_port/sweep.py --workload <serving cell> --seed <n> \\
        --slots 64,128,256 --seconds 20 [--rates 6,8] [--fractions 0.8] \\
        [--open-seconds 30] [--out FILE]

For each slot count, the engine runs saturated: a backlog of the mix's
requests at least as long as its slots, so that every freed slot refills
at once. After `--seconds` / 2 of warm-up it measures `--seconds`: the
requests finished and the tokens that reached the host per second (the
most the engine sustains), the chunk and the decode step. Then, at each
rate of `--rates`, and at each of `--fractions` of the saturated rate at
the mix's slots, one run of the cell as `run.py` makes it (the open loop
at that rate, `--open-seconds` long). One JSON line a measurement.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def saturated(cell, seed: int, slots: int, seconds: float, device) -> dict:
    import torch

    from bench_port.harness.serve_cell import Loop, build
    from bench_port.harness.trace import Spans
    from bench_port.harness.traffic import request_stream

    eng, _, _ = build(cell, seed, device, slots)
    stream = request_stream(cell.traffic, cell.config["vocab_size"], seed)
    loop = Loop(eng, stream, Spans(), time.perf_counter())
    k = cell.traffic["chunk"]

    def chunk(t_end):
        now = time.perf_counter()
        while len(eng.queue) < slots:
            _, prompt, n_new = next(stream)
            loop.submit(now, prompt, n_new)
        return loop.chunk(k, t_end, schedule=False)

    t_warm = time.perf_counter() + seconds / 2
    while time.perf_counter() < t_warm:
        chunk(math.inf)
    loop.open_window()
    steps0 = eng.decode_steps
    t_start = time.perf_counter()
    t_end = t_start + seconds
    now = t_start
    while now < t_end:
        now = chunk(t_end)
    wall = now - t_start
    done = [r for r in loop.done if r["last"] <= now]
    tokens = sum(c[1] for c in loop.chunks)
    decode = sum(c[1] - c[2] for c in loop.chunks)
    steps = eng.decode_steps - steps0
    out = {"slots": slots, "seconds": wall, "requests_per_s": len(done) / wall,
           "tokens_per_s": tokens / wall, "chunk_s": wall / len(loop.chunks),
           "slots_busy_a_step": decode / max(1, steps),
           "mean_new_tokens": sum(len(r["req"].generated) for r in done) / max(1, len(done)),
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    del eng, loop
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--slots", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", default="")
    ap.add_argument("--fractions", default="")
    ap.add_argument("--open-seconds", type=float, default=30.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness.spec import load_cell
    from bench_port.run import run_cell

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row.update(workload=args.workload, card=torch.cuda.get_device_name(device))
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    rates = [float(r) for r in args.rates.split(",") if r]
    for slots in [int(s) for s in args.slots.split(",") if s]:
        torch.cuda.reset_peak_memory_stats()
        row = saturated(cell, args.seed, slots, args.seconds, device)
        emit(dict(row, mode="saturated"))
        if slots == cell.traffic["slots"]:
            rates += [float(f) * row["requests_per_s"] for f in args.fractions.split(",") if f]
    for rate in rates:
        cell.traffic["rate_per_s"] = rate
        torch.cuda.reset_peak_memory_stats()
        res = run_cell(cell, args.seed, args.open_seconds, False, device, time.perf_counter())
        emit({"mode": "open", "rate_per_s": rate, "slots": cell.traffic["slots"],
              "correct": res["correct"], "attempted": res["attempted"],
              "metrics": {k: v["value"] for k, v in res["metrics"].items()},
              "numbers": res["_numbers"], "memory_peak_bytes": res["_peak"]})
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
