"""GPT-2 switchable-precision model: config, SP forward, generation,
inference, HF import."""

from .generate import KVCache, forward_with_cache, generate, init_kv_cache
from .hf_import import hf_state_dict_to_sp_params, load_hf_gpt2
from .inference import (
    InferenceEngine,
    infer_forward_unrolled,
    infer_forward_with_cache,
    init_layer_caches,
    quantize_for_inference,
)

__all__ = [
    "KVCache",
    "forward_with_cache",
    "generate",
    "init_kv_cache",
    "hf_state_dict_to_sp_params",
    "load_hf_gpt2",
    "InferenceEngine",
    "infer_forward_unrolled",
    "infer_forward_with_cache",
    "init_layer_caches",
    "quantize_for_inference",
]
