"""The result line's keys, the trace's reduction, and the run without a
card or without the system."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench_port.harness.trace import launch_time, reduce_trace, short_name
from bench_port.run import finite, result_line, run_cell
from bench_port.tests.tiny import ROOT, tiny_cell, workloads

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", [workloads("train")[0], workloads("serve")[0]])
def test_result_line_keys(workload):
    cell = tiny_cell(workload)
    res = run_cell(cell, 31, 1.5, False, torch.device("cpu"), time.perf_counter())
    line, notes = result_line(res, "NVIDIA H100 80GB HBM3", 1)
    line = json.loads(json.dumps(finite(line), allow_nan=False))
    assert list(line) == KEYS               # `checks` last
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
    assert "setup_s" in line["metrics"] and len(line["metrics"]) >= 2
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit", "ok"}
    # standard error ends with one line per number compared, beside its limit
    assert [n.split()[1] for n in notes[-len(line["checks"]):]] == list(line["checks"])
    assert all(" limit " in n for n in notes[-len(line["checks"]):])


def test_traced_line_carries_busy_window_and_breakdown():
    res = {"correct": True, "attempted": 3, "failed": 0, "metrics": {"x": {"value": 1, "unit": "%"}},
           "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["host", 0.01]]},
           "_trace": {"busy_s": 0.5, "window_s": 0.7}, "_peak": 10, "_numbers": {},
           "_kept": None, "checks": {}}
    line, _ = result_line(res, "card", 1)
    assert line["device"]["busy_s"] == 0.5 and line["device"]["window_s"] == 0.7
    assert list(line)[-1] == "checks" and "breakdown" in line


def test_reduce_trace_busy_gaps_and_labels():
    ev = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    events = [
        ev("user_annotation", "slice", 0, 100),
        ev("user_annotation", "step_chunk", 0, 60),
        ev("user_annotation", "bookkeeping", 60, 40),
        ev("kernel", "void k_mega<1>(Params)", 10, 20),
        ev("kernel", "void k_mega<1>(Params)", 25, 10),     # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoH", 50, 5),
        ev("kernel", "other", 90, 5),
        ev("cpu_op", "aten::add", 0, 100),
    ]
    tr = reduce_trace(events, ("step_chunk", "bookkeeping"))
    assert tr["busy_s"] == pytest.approx(35e-6)           # [10, 35) + [50, 55) + [90, 95)
    assert tr["trace_window_s"] == pytest.approx(100e-6)
    assert tr["kernels"]["void k_mega<1>(Params)"] == {"count": 2, "seconds": pytest.approx(30e-6)}
    # each gap named by the innermost span the host was in as it began
    labels = sorted((n, round(s * 1e6)) for n, s in tr["idle_gaps"])
    assert labels == [("bookkeeping", 5), ("step_chunk", 10), ("step_chunk", 15),
                      ("step_chunk", 35)]
    assert short_name("void k_mega<1>(Params)") == "k_mega"
    table = {"k_mega": {"count": 2, "seconds": 30e-6}}
    assert launch_time(table, "k_mega", 4) == pytest.approx(60e-6)
    assert launch_time(table, "k_fused", 4) is None


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                           "gpt2-124m.train-sp-vmap", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_run_fails_without_a_card():
    out = _run(ROOT, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_fails_without_the_system(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
