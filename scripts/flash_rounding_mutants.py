#!/usr/bin/env python3
"""Mutation check of the bf16 tests of the port's flash training kernels
and of its packed decode attention kernel, and timed ablations of the
wgmma routes of kernels #5 and #6.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/flash_rounding_mutants.py
    python3 scripts/flash_rounding_mutants.py --decode-attention
    python3 scripts/flash_rounding_mutants.py --ablations

Each mutant or ablation is a copy of the checkout under `build/mutants/` in
which lines of `llm_qat_tpu_torch/csrc/flash_attention.cu` (or, for the
decode attention mutant, `csrc/decode_attention.cu`) are edited, as the
tables below say (an edit whose line is not found once stops the script).
The copies are removed at the end.

Mutants remove or move one rounding to the operand type: P before P.V in
the SIMT forward, P before dV, or dS before dQ and dK, in the SIMT
backward (float32 operands, and bf16 at head_dim 128: caught by the bf16
cases at head_dim 128); in the wgmma kernels (bf16 at head_dim 64, whose
products take bf16 operands, so a rounding cannot be removed, only
changed) P or dS rounded toward zero instead of to nearest, dS taken from
the rounded P instead of the float32 one, or the forward's row sum taken
from the rounded P instead of the float32 one. Two more move the forward's
rounding point: P rounded at the running max of each 64-key tile instead
of the JAX k-block's (128 or 256 keys), in the wgmma forward and in the
SIMT forward. The bf16 cases
of `tests/test_torch_cuda.py::test_flash_train_kernels_match_plain` at
head_dim 64 and 128 (T = 128 and 1024) must fail on every mutant. The
script prints the test's own lines (largest error in bf16 ulps, share of
outputs that differ) for each mutant and exits 1 unless the test failed on
every mutant.

The decode attention mutant splits as `k_decode_hbm` (#7/#8) does, but
rounds each JAX block's probabilities to bf16 at the maximum of the JAX
blocks that its block of the cluster owns, instead of at the TPU kernel's
running maximum (the result is the same in exact arithmetic; only the
rounding points move). The bf16 cases of
`tests/test_torch_cuda.py::test_decode_attention_kernels_match_plain` must
fail on it; the script prints their lines (largest error in bf16 ulps of
the row's max, share of bf16-rounded outputs that differ). With
--decode-attention only this mutant runs.

With --ablations each copy changes one part of the wgmma forward:
- "forward fast exp": expf becomes __expf; the bf16 holds at head_dim 64
  (T = 1024 and 200) run in the copy and their lines are printed;
- "forward no exp": P = 1 (one FFMA on S*scale - m, which keeps the row
  sum positive and the epilogue's division off its slow path), corr = 1
  (wrong results): the share of the exponentials;
- "forward no P.V": O is not accumulated (wrong results): the share of
  the register-form product and its wait;
- "forward one block per SM": `__launch_bounds__` asks for one block of
  288 threads per SM instead of two (right results): the cost of the
  register cap that two blocks set, against their overlap;
or of the wgmma backward:
- "fast exp": expf becomes __expf (ex2.approx); the bf16 holds at head_dim
  64 (T = 1024 and 200) run in the copy and their lines are printed;
- "no exp": P = S, with no scale, LSE or exp (wrong results): the share of
  the element-wise work;
- "no second products": dV, dK and dQ are not accumulated (wrong results):
  the share of the register-form wgmma products and their waits;
- "second products K-major": their B operands read K-major instead of
  MN-major (wrong results): the cost of the transposed reads;
- "second products not waited for": no wait after them within the step,
  the next step's wait covers them (a race on the ring: wrong results):
  the cost of the wait;
- "light first": the forward's and both backward kernels' blocks launch in
  the reverse order, the shortest walks first (right results): the cost
  of the order.
It prints how many kernels ptxas serializes wgmma in (warning C7515) for
each tree, then times `flash_fwd_lse` and `flash_bwd` at (B, H, T, D) =
(8, 12, 1024, 64) bf16 in the checkout and in each copy, in turns (the
checkout, each ablation, then the same in reverse), by CUDA-graph replay
(`chip_smoke.graph_ms`) and each wgmma kernel's device time by the
profiler (`chip_smoke.device_ms`), one JSON line per run.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SOURCE = Path("llm_qat_tpu_torch/csrc/flash_attention.cu")
DA_SOURCE = Path("llm_qat_tpu_torch/csrc/decode_attention.cu")
TRUNC = "__uint_as_float(__float_as_uint({}) & 0xffff0000u)"  # toward zero
ROUND = "__bfloat162float(__float2bfloat16_rn({}))"
D_ROWS = [("d2.x", "d2.y"), ("dr[h]", "dr[h]")]  # D in the dK/dV kernel, in the dQ kernel


def _both(f, a, b):
    return f"bf16x2({f.format(a)}, {f.format(b)})"


def _ds_edits(p0, p1, wrap):
    """Both kernels' dS line with dS = wrap(p0 * (dP - D), p1 * (dP - D))."""
    return [(f"sf[2 * j + h] = bf16x2(p0 * (pa[e] - {a}), p1 * (pa[e + 1] - {b}));",
             "sf[2 * j + h] = " + wrap(f"{p0} * (pa[e] - {a})", f"{p1} * (pa[e + 1] - {b})") + ";")
            for a, b in D_ROWS]


MUTANTS = {
    "forward P": [("s[i][j] = round_to<T>(p);", "s[i][j] = p;")],
    "SIMT backward P": [("Ps[r * PK + c] = round_to<T>(p);", "Ps[r * PK + c] = p;")],
    "SIMT backward dS": [
        ("dSs[r * PK + c] = round_to<T>(p * (dp[i][j] - d_s[r]));",
         "dSs[r * PK + c] = p * (dp[i][j] - d_s[r]);"),
        ("dSt[c * PQ + r] = round_to<T>(p * (dp[i][j] - d_s[r]));",
         "dSt[c * PQ + r] = p * (dp[i][j] - d_s[r]);")],
    "wgmma backward P, toward zero": [
        ("pf[2 * j + h] = bf16x2(p0, p1);", f"pf[2 * j + h] = {_both(TRUNC, 'p0', 'p1')};")],
    "wgmma backward dS, toward zero": _ds_edits(
        "p0", "p1", lambda a, b: _both(TRUNC, a, b)),
    "wgmma backward dS from the rounded P": _ds_edits(
        ROUND.format("p0"), ROUND.format("p1"), lambda a, b: f"bf16x2({a}, {b})"),
    "wgmma forward P, toward zero": [
        ("pf[2 * j + h] = bf16x2(p[0], p[1]);",
         f"pf[2 * j + h] = {_both(TRUNC, 'p[0]', 'p[1]')};")],
    "wgmma forward row sum from the rounded P": [
        ("rs[h] = __fadd_rn(__fadd_rn(rs[h], p[0]), p[1]);",
         f"rs[h] = __fadd_rn(__fadd_rn(rs[h], {ROUND.format('p[0]')}), {ROUND.format('p[1]')});")],
    "wgmma forward P at the 64-key tile's running max": [
        ("(gridDim.y - 1 - blockIdx.y) * W_TILE, seq, nb, sm_scale);",
         "(gridDim.y - 1 - blockIdx.y) * W_TILE, seq, 1, sm_scale);")],
    "SIMT forward P at the 64-key tile's running max": [
        ("const int blk = exact_p ? 1 : nb;", "const int blk = 1;")],
}
SELECT = ("test_flash_train_kernels_match_plain and (64-128-dtype1 or 64-1024-dtype1 "
          "or 128-128-dtype1 or 128-1024-dtype1)")
# (source, edits, the tests that must fail)
DA_MUTANTS = {
    "packed decode P at the cluster block's local maximum": (DA_SOURCE, [
        ("    mr = fmaxf(mr, allb[j]);  // m_run[j]\n",
         "    mr = allb[j0];\n    for (int k = j0 + 1; k < j1; ++k) mr = fmaxf(mr, allb[k]);\n")],
        "test_decode_attention_kernels_match_plain and dtype1"),
}

EXPS = [("p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), l2.x));", "sa[e]"),
        ("p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), l2.y));", "sa[e + 1]"),
        ("p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), lr[h]));", "sa[e]"),
        ("p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), lr[h]));", "sa[e + 1]")]
ISSUED = "      rs_accumulate({}, sf, {});\n      wgmma_commit();\n"
FWD_EXPS = [("corr[h] = expf(__fsub_rn(mr[h], mx[h]));", "corr[h] = 1.f;"),
            ("const float p[2] = {expf(__fsub_rn(sa[e], mr[h])), "
             "expf(__fsub_rn(sa[e + 1], mr[h]))};",
             "const float p[2] = {__fsub_rn(sa[e], mr[h]) * 0.f + 1.f, "
             "__fsub_rn(sa[e + 1], mr[h]) * 0.f + 1.f};")]
ABLATIONS = {
    "forward fast exp": [(old, old.replace("expf(", "__expf(")) for old, _ in FWD_EXPS],
    "forward no exp": FWD_EXPS,
    "forward no P.V": [("  rs_accumulate(oa, pf, vs);\n", "")],
    "forward one block per SM": [("__launch_bounds__(W_THREADS, 2)\nflash_fwd_wgmma",
                                  "__launch_bounds__(W_THREADS, 1)\nflash_fwd_wgmma")],
    "fast exp": [(old, old.replace("expf(", "__expf(")) for old, _ in EXPS],
    "no exp": [(old, old.split(" = ")[0] + f" = {s};") for old, s in EXPS],
    "no second products": [
        ("      rs_accumulate(dva, pf, dos);\n      rs_accumulate(dka, sf, qs);\n", ""),
        ("      rs_accumulate(dqa, sf, ks);\n", "")],
    "second products K-major": [
        ("wgmma_rs64<true>(d, a + 4 * kk, sdesc<true>(b, kk));",
         "wgmma_rs64<false>(d, a + 4 * kk, sdesc<false>(b, kk));")],
    "second products not waited for": [
        (ISSUED.format(a, b) + "      wgmma_wait<0>();\n", ISSUED.format(a, b))
        for a, b in (("dka", "qs"), ("dqa", "ks"))],
    "light first": [
        ("blockIdx.x, blockIdx.y * W_TILE, seq,",
         "blockIdx.x, (gridDim.y - 1 - blockIdx.y) * W_TILE, seq,"),
        ("const int y = gridDim.y - 1 - blockIdx.y;", "const int y = blockIdx.y;"),
        ("(gridDim.y - 1 - blockIdx.y) * W_TILE, seq, nb, sm_scale);",
         "blockIdx.y * W_TILE, seq, nb, sm_scale);")],
}
HOLD = "test_flash_train_kernels_match_plain and (64-1024-dtype1 or 64-200-dtype1)"
TIME = """
import json, sys
sys.path.insert(0, ".")
import torch
from chip_smoke import device_ms, graph_ms
from llm_qat_tpu_torch.ops import attention as att
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(3)
q, k, v, do = (torch.randn((8, 12, 1024, 64), generator=g, device=dev).to(torch.bfloat16)
               for _ in range(4))
o, lse = att.flash_fwd_lse_plain(q, k, v)  # the backward's inputs, whatever the copy's forward
run = lambda: att.flash_bwd(q, k, v, o, lse, do)
out = {"fwd_device_ms": graph_ms(lambda: att.flash_fwd_lse(q, k, v), 20),
       "device_ms": graph_ms(run, 20)}
out.update({n: device_ms(run, 10, [n]) for n in ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma")})
print(json.dumps(out))
"""
WORK = ROOT / "build" / "mutants"


def copy_with(i: int, name: str, edits, source: Path = SOURCE) -> Path:
    """A copy of the checkout with `edits` (old, new) applied to `source`."""
    dst = WORK / str(i)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT, dst, ignore=shutil.ignore_patterns(".git", "build", "__pycache__"))
    src = (dst / source).read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name!r}: {old!r} not found once")
        src = src.replace(old, new)
    (dst / source).write_text(src)
    return dst


def pytest_lines(tree: Path, select: str):
    """Runs the `cuda` tests `select` in `tree`: (exit code, the test's
    error lines and its summary line)."""
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q", "-s",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k", select],
        cwd=tree, capture_output=True, text=True, timeout=900)
    lines = [ln.lstrip(".F") for ln in run.stdout.splitlines()]
    return run.returncode, [ln for ln in lines
                            if re.match(r"(o|out|dq|dk|dv) max bf16 ulps|\d+ (passed|failed)", ln)]


def mutants(decode_only: bool) -> int:
    survivors = []
    table = [] if decode_only else [(name, SOURCE, edits, SELECT)
                                    for name, edits in MUTANTS.items()]
    table += [(name, *rest) for name, rest in DA_MUTANTS.items()]
    for i, (name, source, edits, select) in enumerate(table):
        rc, lines = pytest_lines(copy_with(i, name, edits, source), select)
        for line in lines:
            print(f"mutant {name}: {line}", flush=True)
        if rc != 1:  # 1: tests ran and failed
            survivors.append(f"{name} (pytest exit {rc})")
    print(f"mutants the test did not kill: {survivors or 'none'}")
    return 1 if survivors else 0


def ablations() -> int:
    trees = {"checkout": ROOT}
    trees.update({name: copy_with(i, name, edits)
                  for i, (name, edits) in enumerate(ABLATIONS.items())})
    for name in ("forward fast exp", "fast exp"):
        for line in pytest_lines(trees[name], HOLD)[1]:
            print(f"{name}, holds: {line}", flush=True)
    for name, tree in trees.items():
        rep = subprocess.run(
            [sys.executable, "-c", "from llm_qat_tpu_torch.ops import _build; "
             "print(_build.ptxas_report('flash_attention'))"],
            cwd=tree, capture_output=True, text=True, timeout=900)
        warn = [ln for ln in rep.stdout.splitlines() if "C7515" in ln]
        print(f"{name}: ptxas serializes wgmma in {len(warn)} kernel(s)", flush=True)
    order = list(trees)
    for name in order + order[::-1]:
        t = subprocess.run([sys.executable, "-c", TIME], cwd=trees[name],
                           capture_output=True, text=True, timeout=900)
        if t.returncode:
            print(t.stderr[-2000:], flush=True)
            return 1
        print(f"{name}: {t.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


def main() -> int:
    try:
        if "--ablations" in sys.argv[1:]:
            return ablations()
        return mutants("--decode-attention" in sys.argv[1:])
    finally:
        shutil.rmtree(WORK, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
