"""Device resolution for the port's entry points.

Entry points run on the card by default. Asking for CUDA where there is no
card raises instead of quietly running on the CPU: the CPU is used only when
the caller asks for it (`device="cpu"`, as the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None`/"cuda" → the current CUDA device (raises when none is
    present); anything else → `torch.device(device)`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "llm_qat_tpu_torch: device='cuda' requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
