#!/usr/bin/env python3
"""One turn of an A/B of the bf16 routes of #2/#5/#6 between two trees, at
head_dim 128 (or 64).

Run from the root of a tree on a machine with a CUDA card; to compare two
trees in one call, unpack the other under `build/` (listed in
`.gitignore`), copy this tree's `chip_smoke.py` into it, and run this
script from each root in turns (A B B A):

    python3 scripts/flash_hd128_ab.py [--head-dim 64]

It prints, as one JSON line tagged with the tree's directory name and the
head_dim D, `chip_smoke.py`'s bf16 rows (`flash_rows_bf16`: graph-replay
and event ms, the plain version's ms, SDPA's, the bound) of #2 at the
served prefill's (8, 768 / D, 128, D) and of #5 and #6 at the trainer's
(8, 768 / D, 1024, D), and the device ms a launch of each CUDA kernel the
three calls launch (by the profiler), whichever route the tree takes
there. The tree's own package and `chip_smoke.py` are imported from the
working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description="One A/B turn of the bf16 flash routes.")
    ap.add_argument("--head-dim", type=int, default=128, choices=(64, 128))
    D = ap.parse_args().head_dim
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from llm_qat_tpu_torch.ops import attention as att

    dev = torch.device("cuda")
    tag = os.path.basename(os.getcwd())
    B, H, T, T0 = 8, 768 // D, 1024, 128
    st = cs.flash_serve_timings(dev, H, D, shapes=((B, T0),))[f"{B}x{T0}"]
    tt = cs.flash_timings(dev, B, H, T, D, cross=False)
    rows = cs.flash_rows_bf16(tt, st, B, H, T, T0, D)
    for r in rows.values():  # the kernels each call launched are measured below
        r.pop("cuda_kernels")
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v, do = (torch.randn((B, H, T, D), generator=gen, device=dev).to(torch.bfloat16)
                   for _ in range(4))
    o, lse = att.flash_fwd_lse(q, k, v)
    qs, ks, vs = (t[:, :, :T0].contiguous() for t in (q, k, v))
    kernels = {
        "flash_attention": cs.kernel_launch_ms(lambda: att.flash_attention(qs, ks, vs), 10),
        "flash_fwd_lse": cs.kernel_launch_ms(lambda: att.flash_fwd_lse(q, k, v), 10),
        "flash_bwd": cs.kernel_launch_ms(lambda: att.flash_bwd(q, k, v, o, lse, do), 10)}
    print(f"AB {tag} D={D} " + json.dumps({"rows": rows, "kernels_device_ms": kernels}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
