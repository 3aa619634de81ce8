"""Cyclic-precision-training GPT-2 over stacked parameters, forward and backward.

Counterpart of `llm_qat_tpu/models/cpt_model.py`, with its parameter names
and layouts (blocks stacked on a leading layer axis):
- a quantized linear (`cpt_linear`) holds a trainable-shape base `w`
  (in, out) and `b`, ONE weight and one input quantizer whose per-bit
  scales live in (P, ch) banks indexed by the precision slot, ONE shared
  LoRA pair `lora_A` (in, r) / `lora_B` (r, out) used at every bit-width,
  and the (1, 1) gradient-quantizer scales `gq_scale_A/B` of that pair.
  Forward: Q(x)@Q(W) + b + (Q(x)@Q(A))@Q(B)·alpha/r, where the LoRA branch
  takes the *quantized* input and the LoRA quantizers are calibrated inline
  from the live A/B;
- with `grad_quant`, A and B pass through `quantize_gradient` before their
  quantizers, so their cotangents are first clamped by the log STE (below
  32 bits) and then fake-quantized to `gradient_bits` (minmax, symmetric);
- a plain shared LayerNorm (no per-precision banks), dense causal attention
  with the additive padding mask (1 - mask)·(-10000) after the causal
  -1e30, exact GELU, and a quantized, untied `lm_head`.

The three products of a linear run through `matmul_bf16` at
`cfg.compute_dtype` (the LoRA product rounded to it between its two dots).
No kernel runs here: the JAX CPT path has no flash and no fused linear.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.matmul import matmul_bf16
from ..quant.calibration import dynamic_scale_flat
from ..quant.functional import KIND_LOG, KIND_MINMAX, quantize_gradient
from ..quant.functional import fake_quant_flat as fake_quant
from .config import CPTConfig
from .sp_model import _input_stats, _unstack, embed_tokens, lm_cross_entropy, torch_dtype


class CPTTables(NamedTuple):
    bits: torch.Tensor  # float32[P]
    kind: torch.Tensor  # int32[P]


def cpt_tables(cfg: CPTConfig, device=None) -> CPTTables:
    """The tables on `device` (the card by default)."""
    dev = resolve_device(device)
    kind = KIND_LOG if cfg.quantizer_kind == "log" else KIND_MINMAX
    P = len(cfg.bit_widths)
    return CPTTables(
        bits=torch.as_tensor(np.asarray(cfg.bit_widths, np.float32), device=dev),
        kind=torch.full((P,), kind, dtype=torch.int32, device=dev),
    )


def prec_index(cfg: CPTConfig, bits: int) -> int:
    return cfg.bit_widths.index(bits)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_cpt_linear(gen, lead, d_in: int, d_out: int, cfg: CPTConfig, device):
    P, r = len(cfg.bit_widths), cfg.lora_rank
    ch_w = d_out if cfg.per_channel else 1
    ch_i = d_in if cfg.per_channel else 1
    ones = lambda *s: torch.ones((*lead, *s), dtype=torch.float32, device=device)
    zeros = lambda *s: torch.zeros((*lead, *s), dtype=torch.float32, device=device)
    bound = 1.0 / math.sqrt(r)
    return {
        "w": 0.02 * torch.randn((*lead, d_in, d_out), generator=gen, device=device),
        "b": zeros(d_out),
        "wq_scale": ones(P, ch_w),
        "wq_zp": zeros(P, ch_w),
        "iq_scale": ones(P, ch_i),
        "iq_zp": zeros(P, ch_i),
        # the shared LoRA pair: A kaiming-uniform, B zeros
        "lora_A": torch.rand((*lead, d_in, r), generator=gen, device=device)
        * (2 * bound) - bound,
        "lora_B": zeros(r, d_out),
        # the LoRA gradient quantizers (`calibrate_gradient_quantizers`)
        "gq_scale_A": ones(1, 1),
        "gq_zp_A": zeros(1, 1),
        "gq_scale_B": ones(1, 1),
        "gq_zp_B": zeros(1, 1),
    }


def init_cpt_params(gen: torch.Generator, cfg: CPTConfig,
                    device=None) -> Dict[str, Any]:
    """Initialize the CPT parameter dict from a `torch.Generator`: the JAX
    `init_cpt_params`' distributions and layouts (N(0, 0.02²) weights and
    embeddings); the numbers differ, since the generators differ."""
    dev = resolve_device(device)
    m = cfg.model
    L, d = m.n_layer, m.n_embd
    ln = lambda *lead: {"g": torch.ones((*lead, d), device=dev),
                        "b": torch.zeros((*lead, d), device=dev)}
    wte = 0.02 * torch.randn((m.vocab_size, d), generator=gen, device=dev)
    wpe = 0.02 * torch.randn((m.n_positions, d), generator=gen, device=dev)
    blocks = {
        "ln1": ln(L),
        "c_attn": _init_cpt_linear(gen, (L,), d, 3 * d, cfg, dev),
        "attn_proj": _init_cpt_linear(gen, (L,), d, d, cfg, dev),
        "ln2": ln(L),
        "c_fc": _init_cpt_linear(gen, (L,), d, 4 * d, cfg, dev),
        "mlp_proj": _init_cpt_linear(gen, (L,), 4 * d, d, cfg, dev),
    }
    return {"wte": wte, "wpe": wpe, "blocks": blocks, "ln_f": ln(),
            "lm_head": _init_cpt_linear(gen, (), d, m.vocab_size, cfg, dev)}


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def cpt_linear(x, p, prec, tables: CPTTables, cfg: CPTConfig,
               calibration_mode: bool = False, collect_stats: bool = False,
               grad_quant: bool = False):
    """Quantized linear with the shared quantized LoRA. Returns (out,
    stats|None); while collecting stats the input quantizer passes
    through, and `calibration_mode` turns the LoRA branch off."""
    bits = tables.bits[prec]
    kind = tables.kind[prec]
    eps = cfg.eps
    stats = None
    if collect_stats:
        stats = _input_stats(x, cfg.per_channel, eps)
        xq = x
    else:
        xq = fake_quant(x, p["iq_scale"][prec], p["iq_zp"][prec], bits, kind,
                        cfg.symmetric, eps)
    wq = fake_quant(p["w"], p["wq_scale"][prec][None, :],
                    p["wq_zp"][prec][None, :], bits, kind, cfg.symmetric, eps)
    cdt = torch_dtype(cfg.compute_dtype)
    out = matmul_bf16(xq, wq, cdt) + p["b"]

    if not calibration_mode and cfg.lora_rank > 0:
        A, B = p["lora_A"], p["lora_B"]
        if grad_quant:
            gbits, gkind = float(cfg.gradient_bits), float(KIND_MINMAX)
            A = quantize_gradient(A, p["gq_scale_A"], p["gq_zp_A"], gbits, gkind)
            B = quantize_gradient(B, p["gq_scale_B"], p["gq_zp_B"], gbits, gkind)
        ch = 1 if cfg.per_channel else None
        a_s, a_z = dynamic_scale_flat(A, bits, kind, ch, cfg.symmetric, eps)
        b_s, b_z = dynamic_scale_flat(B, bits, kind, ch, cfg.symmetric, eps)
        Aq = fake_quant(A, a_s, a_z, bits, kind, cfg.symmetric, eps)
        Bq = fake_quant(B, b_s, b_z, bits, kind, cfg.symmetric, eps)
        # the LoRA branch takes the *quantized* input
        lora = matmul_bf16(matmul_bf16(xq, Aq, cdt), Bq, cdt)
        out = out + (cfg.lora_alpha / cfg.lora_rank) * lora
    return out, stats


def _layernorm(x, ln, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return (ln["g"] * (xf - mean) * torch.rsqrt(var + eps) + ln["b"]).to(x.dtype)


def cpt_block(x, bp, prec, tables, cfg: CPTConfig, *, attention_mask=None,
              calibration_mode=False, collect_stats=False, grad_quant=False):
    """Pre-LN block: dense causal attention (-1e30), then the additive
    padding mask, probabilities cast to v's dtype."""
    m = cfg.model
    B, T, C = x.shape
    lin = lambda h, name: cpt_linear(h, bp[name], prec, tables, cfg,
                                     calibration_mode, collect_stats, grad_quant)

    h = _layernorm(x, bp["ln1"], m.layer_norm_epsilon)
    qkv, s1 = lin(h, "c_attn")
    q, k, v = torch.split(qkv, C, dim=-1)

    def heads(t):
        return t.reshape(B, T, m.n_head, m.head_dim).permute(0, 2, 1, 3)

    q, k, v = heads(q), heads(k), heads(v)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(m.head_dim)
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool, device=x.device))
    scores = torch.where(causal[None, None], scores, torch.full_like(scores, -1e30))
    if attention_mask is not None:
        pad = 1.0 - attention_mask.to(scores.dtype)[:, None, None, :]
        scores = scores + pad * -10000.0
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    attn = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    attn = attn.permute(0, 2, 1, 3).reshape(B, T, C)
    attn_out, s2 = lin(attn, "attn_proj")
    x = x + attn_out

    h2 = _layernorm(x, bp["ln2"], m.layer_norm_epsilon)
    fc, s3 = lin(h2, "c_fc")
    fc = F.gelu(fc)  # exact erf
    proj, s4 = lin(fc, "mlp_proj")
    x = x + proj

    stats = None
    if collect_stats:
        stats = {"c_attn": s1, "attn_proj": s2, "c_fc": s3, "mlp_proj": s4}
    return x, stats


def cpt_forward(params, input_ids, prec, cfg: CPTConfig, *,
                tables: Optional[CPTTables] = None, attention_mask=None,
                labels=None, calibration_mode=False, collect_stats=False,
                grad_quant=False):
    """Full CPT LM forward. Returns a dict with `logits`, `loss` (shifted
    CE, ignoring -100, NaN for a label past the vocabulary as in JAX) when
    `labels` are given, and with `collect_stats` the per-layer input
    stats `stats` ({linear: {stat: (L, ch)}}) and `lm_head_stats`."""
    dev = params["wte"].device
    if tables is None:
        tables = cpt_tables(cfg, dev)
    prec = int(prec)
    T = input_ids.shape[1]
    h = embed_tokens(params["wte"], input_ids) + params["wpe"][:T][None]

    per_layer = []
    for bp in _unstack(params["blocks"], cfg.model.n_layer):
        h, s = cpt_block(h, bp, prec, tables, cfg, attention_mask=attention_mask,
                         calibration_mode=calibration_mode,
                         collect_stats=collect_stats, grad_quant=grad_quant)
        per_layer.append(s)
    h = _layernorm(h, params["ln_f"], cfg.model.layer_norm_epsilon)
    logits, head_stats = cpt_linear(h, params["lm_head"], prec, tables, cfg,
                                    calibration_mode, collect_stats, grad_quant)

    out = {"logits": logits}
    if collect_stats:
        out["stats"] = {
            name: {k: torch.stack([s[name][k] for s in per_layer])
                   for k in per_layer[0][name]}
            for name in per_layer[0]
        }
        out["lm_head_stats"] = head_stats
    if labels is not None:
        out["loss"] = lm_cross_entropy(logits, labels)
    return out


@torch.no_grad()
def cpt_generate(params, input_ids, prec, cfg: CPTConfig, *,
                 max_new_tokens: int = 32, temperature: float = 1.0,
                 do_sample: bool = True,
                 generator: Optional[torch.Generator] = None,
                 tables: Optional[CPTTables] = None):
    """Generation by a full forward per token, stopping at `n_positions`
    (the reference's generate has no KV cache). Sampled tokens are drawn
    from `generator`; greedy tokens equal the JAX package's."""
    ids = input_ids
    for _ in range(max_new_tokens):
        if ids.shape[1] >= cfg.model.n_positions:
            break
        logits = cpt_forward(params, ids, prec, cfg, tables=tables)["logits"][:, -1]
        if do_sample:
            probs = torch.softmax(logits / max(temperature, 1e-6), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        ids = torch.cat([ids, nxt[:, None].to(ids.dtype)], dim=1)
    return ids
