"""The benchmark of llm_qat_tpu_torch: one cell, one run, one result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the checkout's root on a machine with the card(s) the cell asks
for. The run makes its weights and inputs from --seed, builds the system's
kernels into build/kernels/ (the first run of a checkout), warms up every
shape the cell uses, measures for --seconds with the profiler off, and
holds what the timed path produced against the plain reference in
bench_port/reference/. With --trace 1 it then profiles a fixed slice after
the window and reports the cell's per-layer metrics instead of its
end-to-end ones. The last line of standard output is the result, a JSON
object; the numbers compared for `correct` close it (`checks`) and are
the last lines of standard error. Without the card(s), or if JAX or the
JAX package is loaded, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "llm_qat_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (llm_qat_tpu_torch is not llm_qat_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _caches():
    """Every cache the system or torch might write, at fixed paths inside
    the checkout (the system's own kernels go to build/kernels/)."""
    base = ROOT / "build" / "bench_port"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(base / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(base / "triton"))
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(base / "inductor"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def finite(obj):
    """obj with every non-finite float replaced by None (strict JSON)."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def checks_of(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "ok"}} for every number compared."""
    out = {}
    for name, n in numbers.items():
        lim = limits.get("numbers", {}).get(name, {}).get("limit")
        v = n["value"]
        ok = lim is not None and math.isfinite(v) and v <= lim
        out[name] = {"value": v, "limit": lim, "ok": ok}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t0: float,
             faults=None, keep=False) -> dict:
    """One run of `cell` on `device`: the result object (without the
    device record). `faults` (tests only) breaks the timed path; `keep`
    passes the cell runner's kept inputs on under "_kept"."""
    from bench_port.harness import serve_cell, train_cell
    from bench_port.harness.spec import read_per_layer

    drive = {"train": train_cell.run, "serve": serve_cell.run}[cell.traffic["kind"]]
    out = drive(cell, seed, seconds, trace, device, t0, faults, keep)
    checks = checks_of(out["numbers"], cell.limits)
    result = {"correct": all(c["ok"] for c in checks.values()) and out["failed"] == 0,
              "attempted": out["attempted"], "failed": out["failed"]}
    if trace:
        result["metrics"] = read_per_layer(cell, out["ctx"])
        result["breakdown"] = out["trace"]["breakdown"]
    else:
        names = [m["name"] for m in cell.end_to_end]
        result["metrics"] = {m["name"]: {"value": out["end_to_end"][m["name"]],
                                         "unit": m["unit"]} for m in cell.end_to_end
                             if m["name"] in out["end_to_end"]}
        missing = sorted(set(names) - set(result["metrics"]))
        if missing:
            raise RuntimeError(f"the cell measured none of {missing}")
    result["_trace"] = out.get("trace")
    result["_peak"] = out["memory_peak_bytes"]
    result["_numbers"] = out["numbers"]
    result["_kept"] = out.get("kept")
    result["checks"] = checks
    return result


def result_line(res: dict, kind: str, count: int):
    """(the result object, the lines for standard error) of `run_cell`'s
    result: the keys the contract names, `checks` last; the notes end
    with one line per number compared, beside its limit."""
    res = dict(res)
    trace, peak, numbers = res.pop("_trace"), res.pop("_peak"), res.pop("_numbers")
    res.pop("_kept", None)
    checks = res.pop("checks")
    res["device"] = {"platform": "gpu", "kind": kind, "count": count,
                     "memory_peak_bytes": int(peak)}
    if trace:
        res["device"].update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    res["checks"] = checks
    notes = [f"bench_port: {name} at {json.dumps({k: v for k, v in n.items() if k != 'value'})}"
             for name, n in numbers.items()]
    notes += [f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAIL'}"
              for name, c in checks.items()]
    return res, notes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, str(ROOT))
    from bench_port.harness.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"bench_port: the cell {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)

    bad = forbidden_modules()
    if bad:
        print(f"bench_port: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    line, notes = result_line(res, torch.cuda.get_device_name(device), cell.chips)
    for note in notes:
        print(note, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
