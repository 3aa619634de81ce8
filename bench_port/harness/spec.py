"""Finds a cell's parts by the names in BENCHMARK.json.

A workload names a configuration and a traffic mix; the harness reads
`bench_port/configs/<config>.json`, `bench_port/traffic/<traffic>.json`,
the correctness limits `bench_port/limits/<workload>.json`, and the
per-layer metrics `bench_port/metrics/<metric>.py` that BENCHMARK.json
lists for the cell. A later cell, mix, configuration or metric is a new
file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    workload: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(workload: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `workload` of BENCHMARK.json with its files read."""
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    read = lambda sub, name: json.loads((BENCH_DIR / sub / f"{name}.json").read_text())
    limits_path = BENCH_DIR / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text()) if limits_path.exists() else {}
    return Cell(workload=workload, chips=int(w["chips"]), config=read("configs", w["config"]),
                traffic=read("traffic", w["traffic"]), limits=limits,
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])


def load_reader(name: str):
    """The `read(ctx)` of `bench_port/metrics/<name>.py` (metric names hold
    dots, so the file is loaded by its path)."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_per_layer(cell: Cell, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read for: {name: {"value", "unit"}}."""
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
