"""GPT-2 model assemblies: switchable-precision (SP), CPT and QA variants,
generation, inference, HF import."""

from .config import (
    CPTConfig,
    GPT2Config,
    QuantConfig,
    SPModelConfig,
    TrainConfig,
    default_quantizer_kind,
    tiny_test_config,
)
from .cpt_model import (
    cpt_forward,
    cpt_generate,
    cpt_tables,
    init_cpt_params,
)
from .generate import KVCache, forward_with_cache, generate, init_kv_cache
from .hf_import import hf_state_dict_to_sp_params, load_hf_gpt2
from .inference import (
    InferenceEngine,
    infer_forward_unrolled,
    infer_forward_with_cache,
    init_layer_caches,
    quantize_for_inference,
)
from .qa import init_qa_params, qa_forward, qa_loss_fn
from .sp_model import (
    PrecTables,
    dynamic_scale,
    init_sp_params,
    lm_cross_entropy,
    prec_tables,
    sp_block,
    sp_forward,
    sp_linear,
    switchable_layernorm,
)

__all__ = [
    "CPTConfig",
    "GPT2Config",
    "QuantConfig",
    "SPModelConfig",
    "TrainConfig",
    "default_quantizer_kind",
    "tiny_test_config",
    "PrecTables",
    "dynamic_scale",
    "init_sp_params",
    "lm_cross_entropy",
    "prec_tables",
    "sp_block",
    "sp_forward",
    "sp_linear",
    "switchable_layernorm",
    "cpt_forward",
    "cpt_generate",
    "cpt_tables",
    "init_cpt_params",
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
    "init_qa_params",
    "qa_forward",
    "qa_loss_fn",
]
