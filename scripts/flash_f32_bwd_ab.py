#!/usr/bin/env python3
"""One turn of an A/B of kernel #6's float32 route between two trees.

Run from the root of a tree on a machine with a CUDA card; to compare two
trees in one call, unpack the other under `build/` (listed in
`.gitignore`), copy this tree's `chip_smoke.py` into it, and run this
script from each root in turns (A B B A):

    python3 scripts/flash_f32_bwd_ab.py
    python3 scripts/flash_f32_bwd_ab.py --importance

Without a flag it prints `chip_smoke.py`'s `flash_f32_timings` records of
#6 (`flash_bwd_simt_*`: graph-replay and event ms, each kernel's profiler
ms, SDPA's float32 backward, the bound) at the RPI importance's and the
float32 trainer's shapes. With --importance it runs the RPI gradient
importance (`make_gradient_importance_fn`) at GPT-2 124M, 12 layers,
random weights from seed 0, on a fixed text of 294 words (more than 1024
tokens), and prints its `call_profile` (wall, device ms, idle share) and
its flash kernels' device ms a launch. One JSON line, tagged with the
tree's directory name. The tree's own package and `chip_smoke.py` are
imported from the working directory.
"""

from __future__ import annotations

import json
import os
import sys

TEXT = ("the quick brown fox jumps over a lazy dog while seven tired sailors "
        "argue about maps and weather near the harbour ")


def main() -> int:
    sys.path.insert(0, os.getcwd())
    for var in ("HF_HUB_OFFLINE", "TRANSFORMERS_OFFLINE", "HF_DATASETS_OFFLINE"):
        os.environ[var] = "1"
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda")
    tag = os.path.basename(os.getcwd())
    if "--importance" not in sys.argv[1:]:
        out = cs.flash_f32_timings(dev)
        print(f"AB {tag} " + json.dumps({k: v for k, v in out.items()
                                         if k.startswith("flash_bwd")}), flush=True)
        return 0
    from llm_qat_tpu_torch.data import get_gpt2_tokenizer
    from llm_qat_tpu_torch.models.config import GPT2Config, QuantConfig, SPModelConfig
    from llm_qat_tpu_torch.models.sp_model import init_sp_params
    from llm_qat_tpu_torch.robustness.attacks import make_gradient_importance_fn

    cfg = SPModelConfig(model=GPT2Config(), quant=QuantConfig(bit_widths=cs.RPI_BITS))
    params = init_sp_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    words = TEXT.split() * 14
    imp = make_gradient_importance_fn(params, cfg, get_gpt2_tokenizer())
    prof = cs.call_profile(lambda: imp(words))
    flash = {n: ms for n, ms in cs.kernel_launch_ms(lambda: imp(words), 2).items()
             if "flash" in n}
    print(f"ABI {tag} " + json.dumps({"words": len(words), "profile": prof,
                                      "flash_kernels_ms": flash}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
