"""Model / quantization configuration for the PyTorch port.

Counterpart of `llm_qat_tpu/models/config.py`: the same frozen dataclasses and
static precision tables. Every bank-indexed quantity (num_bits, quantizer
kind, LoRA scaling) is precomputed into small numpy arrays, so the active
precision is a single index into stacked parameter banks. `CPTConfig` is
the cyclic-precision-training configuration.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from ..quant.functional import KIND_LOG, KIND_MINMAX


def default_quantizer_kind(bits: int) -> str:
    """Reference default: minmax for <=4 bits, log for 5..16, none at 32."""
    if bits >= 32:
        return "none"
    return "minmax" if bits <= 4 else "log"


@dataclass(frozen=True)
class GPT2Config:
    """GPT-2 124M architecture."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    embd_pdrop: float = 0.1

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head


@dataclass(frozen=True)
class QuantConfig:
    """Switchable-precision quantization configuration.

    `bit_widths` lists every selectable precision (students + 32-bit
    teacher). Per-bit LoRA rank/alpha; `quantizer_per_bit` overrides the
    minmax/log default; `per_channel` selects per-channel vs per-tensor
    quantizer scales.
    """

    bit_widths: Tuple[int, ...] = (7, 32)
    lora_rank_per_bit: Dict[int, int] = field(
        default_factory=lambda: {b: 64 for b in range(3, 17)} | {32: 0}
    )
    lora_alpha_per_bit: Dict[int, int] = field(
        default_factory=lambda: {b: 64 for b in range(3, 17)} | {32: 0}
    )
    quantizer_per_bit: Dict[int, str] = field(default_factory=dict)
    per_channel: bool = True
    symmetric: bool = True
    eps: float = 1e-5

    def __post_init__(self):
        object.__setattr__(self, "bit_widths", tuple(sorted(self.bit_widths)))

    def __hash__(self):
        return hash((
            self.bit_widths,
            tuple(sorted(self.lora_rank_per_bit.items())),
            tuple(sorted(self.lora_alpha_per_bit.items())),
            tuple(sorted(self.quantizer_per_bit.items())),
            self.per_channel,
            self.symmetric,
            self.eps,
        ))

    @property
    def n_prec(self) -> int:
        return len(self.bit_widths)

    @property
    def teacher_bits(self) -> int:
        return max(self.bit_widths)

    @property
    def student_bits(self) -> Tuple[int, ...]:
        return tuple(b for b in self.bit_widths if b < 32)

    def kind_name(self, bits: int) -> str:
        return self.quantizer_per_bit.get(bits, default_quantizer_kind(bits))

    def prec_index(self, bits: int) -> int:
        """Static bits → bank index."""
        return self.bit_widths.index(bits)

    def bits_table(self) -> np.ndarray:
        """float32[n_prec] of bit-widths."""
        return np.asarray(self.bit_widths, np.float32)

    def kind_table(self) -> np.ndarray:
        """int32[n_prec]: KIND_MINMAX/KIND_LOG per precision (none→minmax;
        the >=32 passthrough makes the kind irrelevant there)."""
        return np.asarray(
            [
                KIND_LOG if self.kind_name(b) == "log" else KIND_MINMAX
                for b in self.bit_widths
            ],
            np.int32,
        )

    def rank_table(self) -> np.ndarray:
        return np.asarray(
            [self.lora_rank_per_bit.get(b, 0) for b in self.bit_widths], np.int32
        )

    def scaling_table(self) -> np.ndarray:
        """float32[n_prec]: LoRA alpha/rank per precision, 0 when disabled."""
        out = []
        for b in self.bit_widths:
            r = self.lora_rank_per_bit.get(b, 0)
            a = self.lora_alpha_per_bit.get(b, 0)
            out.append(0.0 if (b >= 32 or r <= 0) else a / r)
        return np.asarray(out, np.float32)

    @property
    def max_rank(self) -> int:
        """Stacked LoRA banks use one rank (max over bits); entries whose
        configured rank is 0 (the 32-bit slot) hold zeros with scaling 0."""
        return max([self.lora_rank_per_bit.get(b, 0) for b in self.bit_widths] + [0])


@dataclass(frozen=True)
class SPModelConfig:
    """Full switchable-precision model configuration.

    `compute_dtype` is the matmul operand dtype of the SP forward.
    `attention_impl`: "dense" and "flash" force the path; "auto" takes the
    trainable flash kernels on a CUDA tensor when the shape allows it (no
    mask, T % 128 == 0, head_dim 64/128) and T >= `ops.attention.FLASH_MIN_T`,
    and dense attention elsewhere. `linear_impl`: "auto"/"flat" run the flat
    quantized linear (`matmul_bf16`, whose backward rounds the cotangent to
    `compute_dtype` before its products); "fused" runs the fused QAT linear
    kernels #14-#16 (`ops.fused_linear.sp_linear_fused`) where the JAX shape
    gate `fused_linear_supported` passes, outside calibration, and the flat
    linear elsewhere; "cond" multiplies through the casts to
    `compute_dtype`, so its backward multiplies the unrounded float32
    cotangent and rounds each product, and it skips the AMP cast of q/k/v.
    """

    model: GPT2Config = field(default_factory=GPT2Config)
    quant: QuantConfig = field(default_factory=QuantConfig)
    compute_dtype: str = "float32"
    attention_impl: str = "auto"
    linear_impl: str = "auto"
    scan_unroll: int = 1

    def replace(self, **kw) -> "SPModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class CPTConfig:
    """Cyclic-precision-training configuration (the JAX package's
    `CPTConfig`): one shared LoRA pair, log quantizers at every bit-width,
    8-bit LoRA gradients."""

    model: GPT2Config = field(default_factory=GPT2Config)
    bit_widths: Tuple[int, ...] = tuple(range(2, 19)) + (32,)
    lora_rank: int = 16
    lora_alpha: int = 32
    gradient_bits: int = 8
    target_bits: int = 5
    quantizer_kind: str = "log"
    per_channel: bool = True
    symmetric: bool = True
    eps: float = 1e-5
    schedule_type: str = "cosine"
    total_epochs: int = 150
    total_cycles: int = 15
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """SP training hyperparameters (the JAX package's `TrainConfig`)."""

    batch_size: int = 32
    max_seq_length: int = 256
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    adam_epsilon: float = 1e-8
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    max_grad_norm: float = 1.0
    num_iterations: int = 550
    gradient_accumulation_steps: int = 8
    eval_interval: int = 50
    distill_alpha_kl: float = 1.0
    distill_alpha_feature: float = 1e-7
    distill_temperature: float = 3.0
    distill_accumulative: bool = False  # random-layer (False) vs all-layers feature loss
    # True lets the feature term carry gradient into the student (the
    # default detaches both sides, so the term adds loss value only)
    distill_feature_grad: bool = False
    # dtype of the cached teacher softmax probabilities shared by every
    # student micro-step; "bfloat16" rounds p_t, so sum(p_t) != 1
    distill_cache_dtype: str = "float32"
    unroll_students: bool = False
    # "scan" and "unroll" run the same Python loop over the students;
    # "vmap" is not ported. None -> "unroll" if unroll_students else "scan".
    student_mode: Optional[str] = None
    calibration_batches: int = 10


def tiny_test_config(n_prec_bits=(4, 32)) -> SPModelConfig:
    """Small config for CPU tests."""
    return SPModelConfig(
        model=GPT2Config(
            vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2
        ),
        quant=QuantConfig(
            bit_widths=tuple(n_prec_bits),
            lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
            lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0},
        ),
    )
