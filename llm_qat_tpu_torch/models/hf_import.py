"""HuggingFace GPT-2 checkpoint import into the SP parameter banks.

Counterpart of `llm_qat_tpu/models/hf_import.py`. The linear layout is
(in, out), which is HF Conv1D's (nx, nf) layout, so no transpose is needed.
LayerNorm gamma/beta are replicated into every precision bank slot;
embeddings copy directly; LoRA banks and quantizer scale banks keep their
fresh initialization (adapters are re-initialized and quantizers
calibrated after loading).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ..data.lm_datasets import _offline_env_defaults
from .config import SPModelConfig


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, np.float32)


def hf_state_dict_to_sp_params(state_dict: Mapping[str, Any], params,
                               cfg: SPModelConfig):
    """Overlay a HF GPT2LMHeadModel/GPT2Model state_dict (torch tensors or
    numpy arrays) onto SP params.

    Accepts keys with or without the `transformer.` prefix. Returns a new
    params dict whose new tensors are float32 on the device of `params`;
    the existing LoRA/quantizer banks are kept.
    """
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        sd[k] = _to_np(v)

    m = cfg.model
    P = cfg.quant.n_prec
    L = m.n_layer
    dev = params["wte"].device

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=dev)  # a copy: sd may be the caller's

    out = dict(params)
    out["wte"] = put(sd["wte.weight"][: m.vocab_size])
    out["wpe"] = put(sd["wpe.weight"][: m.n_positions])

    def stack_layers(key_fmt: str) -> np.ndarray:
        return np.stack([sd[key_fmt.format(i)] for i in range(L)], axis=0)

    def ln_bank(prefix: str) -> Dict[str, Any]:
        # the pretrained LN replicated into every precision slot
        g = stack_layers(prefix + ".weight")  # (L, d)
        b = stack_layers(prefix + ".bias")
        return {
            "g": put(np.repeat(g[:, None], P, axis=1)),  # (L, P, d)
            "b": put(np.repeat(b[:, None], P, axis=1)),
        }

    blocks = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params["blocks"].items()}

    name_map = {
        "c_attn": "attn.c_attn",
        "attn_proj": "attn.c_proj",
        "c_fc": "mlp.c_fc",
        "mlp_proj": "mlp.c_proj",
    }
    for ours, hf in name_map.items():
        lin = dict(blocks[ours])
        # HF Conv1D weight is (in, out): our layout, no transpose.
        lin["w"] = put(stack_layers("h.{}." + hf + ".weight"))
        lin["b"] = put(stack_layers("h.{}." + hf + ".bias"))
        blocks[ours] = lin

    blocks["ln1"] = ln_bank("h.{}.ln_1")
    blocks["ln2"] = ln_bank("h.{}.ln_2")
    out["blocks"] = blocks

    out["ln_f"] = {
        "g": put(np.repeat(sd["ln_f.weight"][None], P, axis=0)),
        "b": put(np.repeat(sd["ln_f.bias"][None], P, axis=0)),
    }
    return out


def load_hf_gpt2(params, cfg: SPModelConfig, model_name_or_model="gpt2"):
    """Load pretrained GPT-2 weights. `model_name_or_model` is a
    transformers model instance or a hub name; a name needs `transformers`
    (ImportError without it) and its cache: the hub is not asked unless the
    caller exports HF_HUB_OFFLINE=0 (the data loaders' offline defaults).
    Returns updated params."""
    if isinstance(model_name_or_model, str):
        offline = _offline_env_defaults()  # before the import: the hub reads it there
        from transformers import GPT2LMHeadModel

        hf = GPT2LMHeadModel.from_pretrained(model_name_or_model,
                                             local_files_only=offline)
    else:
        hf = model_name_or_model
    return hf_state_dict_to_sp_params(hf.state_dict(), params, cfg)
