"""Plain switchable-precision GPT-2 forward, for the references.

GPT-2 (pre-LN blocks, exact erf GELU, tied head, embedding dropout) with
per-bit quantizers and LoRA at every linear, over the parameter layout the
benchmark makes (`bench_port/harness/weights.py`): (in, out) weights
stacked over layers, per-precision banks with a leading slot axis P. The
quantizer banks in that tree are ignored: the dict `calibrate` returns holds scales that
the references derive themselves (`calibrate`).

A linear at slot p with b bits: y = R(fq(x)) @ R(fq(W)) + bias
+ s * R(R(x) @ R(fq(A))) @ R(fq(B)), R the product precision, s = alpha /
rank (0 at 32 bits, where every quantizer passes through). The LoRA
factors are quantized with scales taken from their live values; the input
and weight quantizers are calibrated: weights from themselves, inputs
from a forward at the slot with LoRA off and inputs passing through.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .quant import bmatmul, fake_quant, kind_of, matmul, quantizer, rnd

LINEARS = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


class Dims:
    """What the references need of a configuration and its quantization."""

    def __init__(self, config: dict, bit_widths, rank: int, alpha: int,
                 per_channel: bool, kinds: Optional[dict] = None):
        self.V = config["vocab_size"]
        self.d = config["n_embd"]
        self.L = config["n_layer"]
        self.H = config["n_head"]
        self.D = self.d // self.H
        self.eps = config["layer_norm_epsilon"]
        self.pdrop = config["embd_pdrop"]
        self.bits = sorted(bit_widths)
        self.kinds = [kind_of(b, kinds) for b in self.bits]
        self.scaling = [0.0 if b >= 32 else alpha / rank for b in self.bits]
        self.per_channel = per_channel

    def slot(self, bits: int) -> int:
        return self.bits.index(bits)


def layer_norm(x, g, b, eps):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return g * (x - mean) * torch.rsqrt(var + eps) + b


def attention(q, k, v, precision: str):
    """Causal softmax attention on (B, H, T, D) heads: both products take
    operands (and, backward, cotangents) rounded to `precision`; float32
    softmax and sums."""
    T, D = q.shape[-2], q.shape[-1]
    s = bmatmul(q, k.transpose(-1, -2), precision) / math.sqrt(D)
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return rnd(bmatmul(p, v, precision), precision)


def weight_quantizers(params, dims: Dims) -> Dict:
    """{(linear, slot): quantizer of the stacked weight (L, in, out)}: per
    output column, or one per layer without `per_channel`."""
    out = {}
    red = (1,) if dims.per_channel else (1, 2)
    for name in LINEARS:
        w = params["blocks"][name]["w"]
        for p, (b, k) in enumerate(zip(dims.bits, dims.kinds)):
            if b < 32:
                out[(name, p)] = quantizer(w, b, k, red)
    return out


def _layer_q(q, li):
    if isinstance(q, tuple):
        return tuple(t[li] for t in q)
    return q[li]


def linear(x, lin, li, name, p, dims: Dims, quant, precision: str, *,
           lora: bool = True, quantize_input: bool = True, stats=None):
    """One switchable linear of layer li at slot p (see the module doc).
    `stats`, a dict, collects the input's per-channel (or per-tensor) min
    and max in both domains under (name, li)."""
    bits, kind = dims.bits[p], dims.kinds[p]
    w, bias = lin["w"][li], lin["b"][li]
    if stats is not None:
        red = tuple(range(x.ndim - 1)) if dims.per_channel else tuple(range(x.ndim))
        xd = x.detach()
        la = torch.log2(torch.clamp(xd.abs(), min=1e-5))
        stats[(name, li)] = (xd.amin(dim=red), xd.amax(dim=red), la.amin(dim=red),
                             la.amax(dim=red))
    if bits < 32:
        wq = fake_quant(w, _layer_q(quant["w"][(name, p)], li), bits, kind)
        xq = (fake_quant(x, _layer_q(quant["x"][(name, p)], li), bits, kind)
              if quantize_input else x)
    else:
        wq, xq = w, x
    y = matmul(xq, wq, precision) + bias
    s = dims.scaling[p]
    if lora and s > 0.0:
        A, B = lin["lora_A"][li, p], lin["lora_B"][li, p]
        red = (0,) if dims.per_channel else (0, 1)
        Aq = fake_quant(A, quantizer(A, bits, kind, red), bits, kind)
        Bq = fake_quant(B, quantizer(B, bits, kind, red), bits, kind)
        y = y + s * matmul(matmul(x, Aq, precision), Bq, precision)
    return y


def block(x, params, li, p, dims: Dims, quant, precision: str, **kw):
    bp = params["blocks"]
    B, T, d = x.shape
    h = layer_norm(x, bp["ln1"]["g"][li, p], bp["ln1"]["b"][li, p], dims.eps)
    qkv = linear(h, bp["c_attn"], li, "c_attn", p, dims, quant, precision, **kw)
    q, k, v = (t.reshape(B, T, dims.H, dims.D).transpose(1, 2) for t in qkv.split(d, dim=-1))
    a = attention(q, k, v, precision).transpose(1, 2).reshape(B, T, d)
    x = x + linear(a, bp["attn_proj"], li, "attn_proj", p, dims, quant, precision, **kw)
    h = layer_norm(x, bp["ln2"]["g"][li, p], bp["ln2"]["b"][li, p], dims.eps)
    f = F.gelu(linear(h, bp["c_fc"], li, "c_fc", p, dims, quant, precision, **kw))
    return x + linear(f, bp["mlp_proj"], li, "mlp_proj", p, dims, quant, precision, **kw)


def forward(params, ids, p, dims: Dims, quant, precision: str, *, dropout_u=None,
            remat: bool = False, **kw):
    """Logits (B, T, V) and hidden states [each block's input, then ln_f's
    output] at slot p. `dropout_u` (B, T, d) uniforms apply the embedding
    dropout; `remat` recomputes each block in the backward."""
    T = ids.shape[1]
    h = params["wte"][ids] + params["wpe"][:T][None]
    if dropout_u is not None:
        keep = 1.0 - dims.pdrop
        h = torch.where(dropout_u < keep, h / keep, torch.zeros_like(h))
    hidden: List[torch.Tensor] = []
    for li in range(dims.L):
        hidden.append(h.detach())
        if remat:
            h = checkpoint(block, h, params, li, p, dims, quant, precision,
                           use_reentrant=False, **kw)
        else:
            h = block(h, params, li, p, dims, quant, precision, **kw)
    h = layer_norm(h, params["ln_f"]["g"][p], params["ln_f"]["b"][p], dims.eps)
    hidden.append(h.detach())
    return matmul(h, params["wte"].T, precision), hidden


@torch.no_grad()
def calibrate(params, dims: Dims, batches, precision: str):
    """Weight quantizers, then each student slot's input quantizers from
    `batches` (LoRA off, inputs passing through, weights quantized):
    {"w": {...}, "x": {(linear, slot): (L, ch) scale or (lmin, lrange)}}.
    Per channel, each layer's quantizer has its own channels; per tensor,
    the system's calibration pools a linear's layers into one range."""
    quant = {"w": weight_quantizers(params, dims), "x": {}}
    for p, (bits, kind) in enumerate(zip(dims.bits, dims.kinds)):
        if bits >= 32:
            continue
        agg = {}
        for ids in batches:
            stats = {}
            forward(params, ids, p, dims, quant, precision, lora=False,
                    quantize_input=False, stats=stats)
            for key, (mn, mx, lmn, lmx) in stats.items():
                lo, hi = (lmn, lmx) if kind == "log" else (mn, mx)
                if key in agg:
                    lo, hi = torch.minimum(agg[key][0], lo), torch.maximum(agg[key][1], hi)
                agg[key] = (lo, hi)
        for name in LINEARS:
            lo = torch.stack([agg[(name, li)][0] for li in range(dims.L)]).reshape(dims.L, -1)
            hi = torch.stack([agg[(name, li)][1] for li in range(dims.L)]).reshape(dims.L, -1)
            if not dims.per_channel:
                # per tensor, one quantizer of a linear spans all its layers:
                # the min of their minima and the max of their maxima
                lo = lo.amin(dim=0, keepdim=True).expand(dims.L, 1)
                hi = hi.amax(dim=0, keepdim=True).expand(dims.L, 1)
            if kind == "log":
                quant["x"][(name, p)] = (lo, hi - lo)
            else:
                amax = torch.clamp(torch.maximum(lo.abs(), hi.abs()), min=1e-5)
                quant["x"][(name, p)] = amax / (2.0 ** (bits - 1) - 1.0)
    return quant
