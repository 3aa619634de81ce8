#!/usr/bin/env python3
"""Mutation check of the bf16 test of the port's flash training kernels.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/flash_rounding_mutants.py

Each mutant is a copy of the checkout under `build/mutants/` in which one
rounding to the operand type is removed from
`llm_qat_tpu_torch/csrc/flash_attention.cu`: P before P.V in the forward,
P before dV, or dS before dQ and dK in the backward. The bf16 cases of
`tests/test_torch_cuda.py::test_flash_train_kernels_match_plain` (D = 64,
T = 128 and 1024) must fail on every mutant. The script prints the test's
own lines (largest error in bf16 ulps, share of outputs that differ) for
each mutant, removes the copies, and exits 1 unless the test failed on
every mutant.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = Path("llm_qat_tpu_torch/csrc/flash_attention.cu")
MUTANTS = {
    "forward P": [("s[i][j] = round_to<T>(p);", "s[i][j] = p;")],
    "backward P": [("Ps[r * PK + c] = round_to<T>(p);", "Ps[r * PK + c] = p;")],
    "backward dS": [
        ("dSs[r * PK + c] = round_to<T>(p * (dp[i][j] - d_s[r]));",
         "dSs[r * PK + c] = p * (dp[i][j] - d_s[r]);"),
        ("dSt[c * PQ + r] = round_to<T>(p * (dp[i][j] - d_s[r]));",
         "dSt[c * PQ + r] = p * (dp[i][j] - d_s[r]);")],
}
SELECT = "test_flash_train_kernels_match_plain and (64-128-dtype1 or 64-1024-dtype1)"


def main() -> int:
    survivors = []
    for i, (name, edits) in enumerate(MUTANTS.items()):
        dst = ROOT / "build" / "mutants" / str(i)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(
            ".git", "build", "__pycache__"))
        src = (dst / SOURCE).read_text()
        for old, new in edits:
            if src.count(old) != 1:
                raise RuntimeError(f"mutant {name!r}: {old!r} not found once")
            src = src.replace(old, new)
        (dst / SOURCE).write_text(src)
        run = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q", "-s",
             "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k", SELECT],
            cwd=dst, capture_output=True, text=True, timeout=600)
        shutil.rmtree(dst)
        for line in run.stdout.splitlines():
            line = line.lstrip(".F")
            if re.match(r"(o|dq|dk|dv) max bf16 ulps|\d+ (passed|failed)", line):
                print(f"mutant without the rounding of {name}: {line}")
        if run.returncode != 1:  # 1: tests ran and failed
            survivors.append(f"{name} (pytest exit {run.returncode})")
    print(f"mutants the test did not kill: {survivors or 'none'}")
    return 1 if survivors else 0


if __name__ == "__main__":
    sys.exit(main())
