"""What the benchmark loads: no JAX, no JAX package (top-level names
compared whole, since the system's name begins with the JAX package's),
and in the references nothing of the system either."""

import ast
import subprocess
import sys
from pathlib import Path

from bench_port.tests.tiny import ROOT

BENCH = ROOT / "bench_port"
JAX = {"jax", "jaxlib", "flax", "llm_qat_tpu"}


def _top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_harness_imports_no_jax():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for p in files:
        assert not _top_level_imports(p) & JAX, p


def test_reference_imports_only_torch():
    for p in (BENCH / "reference").glob("*.py"):
        names = _top_level_imports(p)
        assert not names & (JAX | {"llm_qat_tpu_torch", "bench_port"}), p
        assert names <= {"torch", "math", "typing", "__future__"}, (p, names)


def test_a_run_loads_no_jax():
    """Both cell runners at the tiny size, in a fresh process: no forbidden
    top-level module is loaded afterwards."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from bench_port.tests.tiny import tiny_cell\n"
        "from bench_port.run import run_cell, forbidden_modules\n"
        "for w in ('gpt2-124m.train-sp-vmap', 'gpt2-124m.serve-w8kv8-sharegpt'):\n"
        "    run_cell(tiny_cell(w), 5, 1.0, False, torch.device('cpu'), time.perf_counter())\n"
        "print(forbidden_modules())\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
