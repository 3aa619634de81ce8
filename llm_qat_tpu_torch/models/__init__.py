"""GPT-2 switchable-precision model: config, SP forward, inference, HF import."""

from .hf_import import hf_state_dict_to_sp_params, load_hf_gpt2

__all__ = [
    "hf_state_dict_to_sp_params",
    "load_hf_gpt2",
]
