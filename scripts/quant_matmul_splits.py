#!/usr/bin/env python3
"""K splits of the port's int8 weight GEMM (kernel #10) at GPT-2's shapes.

Run from the repository root on a machine with a CUDA card:

    python3 scripts/quant_matmul_splits.py

For each of GPT-2 124M's four linear shapes, at M = 8 (a decode step, the
small-M kernel) and M = 1024 (path A's prefill, the large-M kernel), it
launches `csrc/quant_matmul.cu` with every K split from 1 to 8 that leaves
no block of a cluster without a K step, bypassing
`ops/quant_matmul.py::launch_plan`, and prints each split's device time per
call (20 calls captured in one CUDA graph, replayed between CUDA events;
random codes, x of ones) beside the split that `launch_plan` picks. One
line per shape and M, then one JSON line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768))  # (K, N)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("quant_matmul_splits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import graph_ms
    from llm_qat_tpu_torch.ops import _build
    from llm_qat_tpu_torch.ops import quant_matmul as qm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    lib = _build.load("quant_matmul")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows_of = {8: qm.SMALL_TILE[0], 1024: qm.LARGE_TILE[0]}
    out = []
    for M in (8, 1024):
        for K, N in SHAPES:
            x = torch.ones((M, K), dtype=torch.bfloat16, device=dev)
            w = torch.randint(-127, 128, (K, N), generator=gen, device=dev).to(torch.int8)
            s = torch.rand((N,), generator=gen, device=dev)
            o = torch.empty((M, N), dtype=torch.float32, device=dev)
            nk = -(-K // qm.K_STEP)
            times = {}
            for split in range(1, qm.MAX_SPLIT + 1):
                steps = -(-nk // split)
                if -(-nk // steps) != split:
                    continue  # a block of the cluster would get no K step

                def call(split=split):
                    rc = lib.quant_matmul(x.data_ptr(), w.data_ptr(), s.data_ptr(), o.data_ptr(),
                                          M, K, N, 8, rows_of[M], split, _build.stream(x))
                    _build.check(lib, rc, "quant_matmul_splits")

                times[split] = graph_ms(call, 20)
            plan = qm.launch_plan(M, K, N, sms)
            best = min(times, key=times.get)
            print(f"M={M} K={K} N={N}: " + "; ".join(
                f"split {k} {1e3 * v:.2f} us" for k, v in times.items())
                + f" | plan {plan.split} ({1e3 * times[plan.split]:.2f} us), fastest {best}",
                flush=True)
            out.append({"M": M, "K": K, "N": N, "us": {k: 1e3 * v for k, v in times.items()},
                        "plan": plan.split})
    print(json.dumps({"quant_matmul_splits": out, "device": torch.cuda.get_device_name(0)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
