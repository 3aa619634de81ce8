"""Seeded weights in the system's parameter layout, made on the device.

The benchmark makes the weights and hands the same tensors to the system
under test and to the references. The layout is the one the system reads:
(in, out) linear weights stacked over layers, per-precision banks with a
slot axis P (LoRA factors, LayerNorm gains and shifts, quantizer scales),
and the quantizer banks at their initial ones and zeros for the system's
calibration to fill. Distributions: the configuration file's `assumed`.
Three generator calls make every number: one of normals, one of uniforms,
and the quantizer banks as constants.
"""

from __future__ import annotations

import math

import torch

LINEAR_SHAPES = (("c_attn", 1, 3), ("attn_proj", 1, 1), ("c_fc", 1, 4), ("mlp_proj", 4, 1))


def make_params(config: dict, bit_widths, rank: int, per_channel: bool,
                gen: torch.Generator, device) -> dict:
    """The raw parameter tree of one model, drawn from `gen` on `device`."""
    V, d, L, npos = (config["vocab_size"], config["n_embd"], config["n_layer"],
                     config["n_positions"])
    bits = sorted(bit_widths)
    P = len(bits)
    enabled = torch.tensor([0.0 if b >= 32 else 1.0 for b in bits], device=device)
    lin_dims = [(name, a * d, b * d) for name, a, b in LINEAR_SHAPES]

    # one draw of normals: wte, wpe, biases, LoRA B, LayerNorm banks
    n_sizes = [V * d, npos * d] + [L * o for _, _, o in lin_dims] \
        + [L * P * rank * o for _, _, o in lin_dims] + [2 * (2 * L + 1) * P * d]
    normals = torch.randn(sum(n_sizes), generator=gen, device=device).split(n_sizes)
    # one draw of uniforms: linear weights, LoRA A
    u_sizes = [L * i * o for _, i, o in lin_dims] + [L * P * i * rank for _, i, _ in lin_dims]
    uniforms = torch.rand(sum(u_sizes), generator=gen, device=device).split(u_sizes)

    blocks = {}
    for j, (name, i, o) in enumerate(lin_dims):
        ch_w, ch_i = (o, i) if per_channel else (1, 1)
        lora_a = (uniforms[4 + j].view(L, P, i, rank) * 2 - 1) / math.sqrt(rank)
        lora_b = 0.02 * normals[6 + j].view(L, P, rank, o)
        blocks[name] = {
            "w": (uniforms[j].view(L, i, o) * 2 - 1) / math.sqrt(i),
            "b": 0.01 * normals[2 + j].view(L, o),
            "lora_A": lora_a * enabled[None, :, None, None],
            "lora_B": lora_b * enabled[None, :, None, None],
            "wq_scale": torch.ones((L, P, ch_w), device=device),
            "wq_zp": torch.zeros((L, P, ch_w), device=device),
            "iq_scale": torch.ones((L, P, ch_i), device=device),
            "iq_zp": torch.zeros((L, P, ch_i), device=device),
        }
    ln = 0.02 * normals[10].view(2, 2 * L + 1, P, d)
    blocks["ln1"] = {"g": 1 + ln[0, :L], "b": ln[1, :L]}
    blocks["ln2"] = {"g": 1 + ln[0, L:2 * L], "b": ln[1, L:2 * L]}
    return {"wte": 0.02 * normals[0].view(V, d), "wpe": 0.01 * normals[1].view(npos, d),
            "blocks": blocks, "ln_f": {"g": 1 + ln[0, 2 * L], "b": ln[1, 2 * L]}}
