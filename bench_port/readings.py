"""Readings that set a cell's correctness limits (not run by the benchmark).

    python3 bench_port/readings.py --workload <cell> --seeds 11,12,13 \\
        --seconds 5 --controls 3 [--out FILE]

For each seed, one run of the cell as `run.py` makes it (a short window),
then the numbers that decide `correct`: the program against the reference
(the lower readings), and for the first `--controls` seeds the control,
the reference computed one precision below the configuration's
(float8 e4m3 products or activations in place of bf16; for a serving
cell also the system's own 4-bit path, W4A4 KV4, in place of its 8-bit
one, and its 4-bit LM head), and, for a training cell, the planted faults
that leave half of each batch out and scale the learning rate by 1.2, in
the reference put in the program's place. One JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_port.harness.compare import train_numbers
    from bench_port.harness.spec import load_cell
    from bench_port.harness.train_cell import ref_dims
    from bench_port.harness.serve_cell import decode_block
    from bench_port.reference.served import Served, served_gaps
    from bench_port.reference.sp_train import follow
    from bench_port.run import run_cell

    cell = load_cell(args.workload)
    device = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, False, device, t0, keep=True)
        kept = res.pop("_kept")
        row = {"workload": args.workload, "seed": seed, "correct": res["correct"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "program": res["_numbers"], "card": torch.cuda.get_device_name(device)}
        if cell.traffic["kind"] == "train" and i < args.controls:
            dims = ref_dims(cell.config, cell.traffic)
            args_ = (kept["params"], dims, cell.traffic, kept["cal"], kept["steps"],
                     kept["dropout_seed"])
            keep = kept["ref"]["keep"]
            row["control_fp8"] = train_numbers(follow(*args_, "fp8", keep=keep), kept["ref"])
            row["fault_half_batch"] = train_numbers(
                follow(*args_, "bf16", half_batch=True, keep=keep), kept["ref"])
            row["fault_lr_1.2x"] = train_numbers(
                follow(*args_, "bf16", lr_scale=1.2, keep=keep), kept["ref"])
        if cell.traffic["kind"] == "serve":
            ref = kept["ref"]
            gaps = torch.cat(kept["gaps"])
            row["program_mean_gap"] = float(gaps.mean())
            row["program_disagree"] = float((gaps > 0).float().mean())
            if i < args.controls:
                tr = cell.traffic
                low = Served(kept["params"], ref_dims(cell.config, tr), 4, kept["cal"], 4,
                             tr["lm_head_bits"], tr["chunk"], decode_block(tr))
                controls = (("control_4bit", low, {}), ("control_fp8", ref, {"act": "fp8"}),
                            ("head_4bit", ref, {"head_bits": 4}))
                for name, model, kw in controls:
                    g = []
                    for ids, T0, served in kept["sequences"]:
                        r = ref.logits(ids, T0)[T0 - 1:]
                        c = model.logits(ids, T0, **kw)[T0 - 1:]
                        g.append(served_gaps(r, c.argmax(-1)))
                    g = torch.cat(g)
                    row[name] = {"served_gap": float(g.max()), "mean_gap": float(g.mean()),
                                 "disagree": float((g > 0).float().mean())}
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row, default=float)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del kept, res
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
