"""The controls, the reference one precision below the configuration's in
the program's place, come out not correct against each cell's limits:
here at the tiny size on the CPU, and (marked `cuda`) at the cell's own
size on the card, as `bench_port/readings.py` reads them for the limits.
Training: float8 e4m3 products in place of bf16. Serving: each stated
precision a step down in turn: the system's own 4-bit path (W4A4, KV4)
for its 8-bit one, its 4-bit LM head for the 8-bit head, and float8
activations for bf16; the smallest of their readings sets the limit's
upper end, and at the tiny size (logits of a 128-wide model) only the
4-bit path reads above it."""

import time

import pytest
import torch

from bench_port.harness.compare import train_numbers
from bench_port.harness.train_cell import ref_dims
from bench_port.harness.serve_cell import decode_block
from bench_port.reference.served import Served, served_gaps
from bench_port.reference.sp_train import follow
from bench_port.run import checks_of, run_cell
from bench_port.tests.tiny import tiny_cell, workloads


def _control_checks(cell, device, seed, seconds):
    """{control: its checks against the cell's limits}."""
    res = run_cell(cell, seed, seconds, False, device, time.perf_counter(), keep=True)
    kept = res["_kept"]
    tr = cell.traffic
    if tr["kind"] == "train":
        ctrl = follow(kept["params"], ref_dims(cell.config, tr), tr, kept["cal"],
                      kept["steps"], kept["dropout_seed"], "fp8", keep=kept["ref"]["keep"])
        return {"fp8": checks_of(train_numbers(ctrl, kept["ref"]), cell.limits)}
    ref = kept["ref"]
    low = Served(kept["params"], ref_dims(cell.config, tr), 4, kept["cal"], 4,
                 tr["lm_head_bits"], tr["chunk"], decode_block(tr))
    out = {}
    for name, model, kw in (("4bit", low, {}), ("head_4bit", ref, {"head_bits": 4}),
                            ("fp8", ref, {"act": "fp8"})):
        gaps = []
        for ids, T0, _ in kept["sequences"]:
            r = ref.logits(ids, T0)[T0 - 1:]
            c = model.logits(ids, T0, **kw)[T0 - 1:]
            gaps.append(served_gaps(r, c.argmax(-1)))
        numbers = {"served_gap": {"value": float(torch.cat(gaps).max())}}
        out[name] = checks_of(numbers, cell.limits)
    return out


def _fails(checks):
    return not all(c["ok"] for c in checks.values())


@pytest.mark.parametrize("workload", workloads("train") + workloads("serve"))
def test_control_is_not_correct_at_the_tiny_size(workload):
    torch.set_num_threads(1)
    controls = _control_checks(tiny_cell(workload), torch.device("cpu"), 777, 1.5)
    name = "fp8" if "fp8" in controls and len(controls) == 1 else "4bit"
    assert _fails(controls[name]), controls


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads("train") + workloads("serve"))
def test_control_is_not_correct_at_the_cells_size(workload, cuda_device):
    from bench_port.harness.spec import load_cell

    controls = _control_checks(load_cell(workload), cuda_device, 424242, 3.0)
    assert all(_fails(c) for c in controls.values()), controls
