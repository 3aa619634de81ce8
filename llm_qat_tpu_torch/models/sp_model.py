"""Switchable-precision GPT-2 over stacked parameter banks, forward and backward.

Counterpart of `llm_qat_tpu/models/sp_model.py`. Parameters
are a nested dict of tensors with the JAX package's names and layouts:
(in, out) weights, per-precision banks with a leading precision axis `P`,
and blocks stacked on a leading layer axis. The active precision is an index
into the banks, so switching precision re-specialises nothing.

Per quantized linear: `w` (in, out), `b` (out,), `wq_scale`/`wq_zp` (P, out)
or (P, 1), `iq_scale`/`iq_zp` (P, in) or (P, 1), `lora_A` (P, in, r),
`lora_B` (P, r, out). The switchable LayerNorm holds gamma/beta banks (P, d).

Gradients are autograd's, through the STEs of `quant.functional`, the
bf16-both-directions `matmul_bf16` (or the fused linear kernels of
`ops.fused_linear` at `linear_impl="fused"`), the LayerNorm's hand-written
backward and the flash attention kernels. Only leaves that require grad take any
gradient work: a frozen tied `wte` costs no (vocab, d) gradient.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.attention import FLASH_MIN_T, causal_attention
from ..ops.fused_linear import fused_linear_supported, sp_linear_fused
from ..ops.matmul import matmul_bf16
from ..ops.sharded import gather_dim, local_call, replicating
from ..quant.calibration import dynamic_scale_flat
from ..quant.functional import fake_quant_flat
from .config import QuantConfig, SPModelConfig


def torch_dtype(name) -> torch.dtype:
    """"bfloat16"/"float32"/torch.dtype → torch.dtype."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


class PrecTables(NamedTuple):
    """Static per-precision lookup tables, indexed by `prec`."""

    bits: torch.Tensor  # float32[P]
    kind: torch.Tensor  # int32[P]
    scaling: torch.Tensor  # float32[P] — LoRA alpha/rank (0 when disabled)


def prec_tables(qcfg: QuantConfig, device=None) -> PrecTables:
    """The tables on `device` (the card by default, as the port's other
    entry points; "cpu" when asked for)."""
    dev = resolve_device(device)
    return PrecTables(
        bits=torch.as_tensor(qcfg.bits_table(), device=dev),
        kind=torch.as_tensor(qcfg.kind_table(), device=dev),
        scaling=torch.as_tensor(qcfg.scaling_table(), device=dev),
    )


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def _uniform(gen, shape, bound, device):
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u * (2.0 * bound) - bound


def _init_linear(gen, L, d_in, d_out, qcfg: QuantConfig, device):
    P, r = qcfg.n_prec, qcfg.max_rank
    # base linear: torch nn.Linear default init (kaiming uniform, 1/sqrt(in))
    w = _uniform(gen, (L, d_in, d_out), 1.0 / math.sqrt(d_in), device)
    ch_w = d_out if qcfg.per_channel else 1
    ch_i = d_in if qcfg.per_channel else 1
    # LoRA A: kaiming_uniform(a=sqrt(5)) on (in, r) → U(±1/sqrt(r)); the
    # slots whose rank is 0 (the 32-bit slot) are zero
    lora_A = _uniform(gen, (L, P, d_in, r), 1.0 / math.sqrt(max(r, 1)), device)
    enabled = torch.as_tensor(
        [1.0 if s > 0 else 0.0 for s in qcfg.scaling_table()],
        dtype=torch.float32, device=device)
    lora_A = lora_A * enabled[None, :, None, None]
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    return {
        "w": w,
        "b": z(L, d_out),
        "wq_scale": torch.ones((L, P, ch_w), dtype=torch.float32, device=device),
        "wq_zp": z(L, P, ch_w),
        "iq_scale": torch.ones((L, P, ch_i), dtype=torch.float32, device=device),
        "iq_zp": z(L, P, ch_i),
        "lora_A": lora_A,
        "lora_B": z(L, P, r, d_out),
    }


def _init_ln(shape_lead, d, P, device):
    return {
        "g": torch.ones((*shape_lead, P, d), dtype=torch.float32, device=device),
        "b": torch.zeros((*shape_lead, P, d), dtype=torch.float32, device=device),
    }


def init_sp_params(gen: torch.Generator, cfg: SPModelConfig,
                   device=None) -> Dict[str, Any]:
    """Initialize the SP parameter dict from a `torch.Generator`.

    Same distributions and layouts as the JAX `init_sp_params`; the numbers
    differ because the generators differ (tests move JAX parameters over
    with `bridge.params_from_numpy` instead).
    """
    dev = resolve_device(device)
    m, q = cfg.model, cfg.quant
    L, d, P = m.n_layer, m.n_embd, q.n_prec
    wte = 0.02 * torch.randn((m.vocab_size, d), generator=gen, device=dev)
    wpe = 0.01 * torch.randn((m.n_positions, d), generator=gen, device=dev)
    blocks = {
        "ln1": _init_ln((L,), d, P, dev),
        "c_attn": _init_linear(gen, L, d, 3 * d, q, dev),
        "attn_proj": _init_linear(gen, L, d, d, q, dev),
        "ln2": _init_ln((L,), d, P, dev),
        "c_fc": _init_linear(gen, L, d, 4 * d, q, dev),
        "mlp_proj": _init_linear(gen, L, 4 * d, d, q, dev),
    }
    return {"wte": wte, "wpe": wpe, "blocks": blocks,
            "ln_f": _init_ln((), d, P, dev)}


# ---------------------------------------------------------------------------
# Forward pieces
# ---------------------------------------------------------------------------


def dynamic_scale(x, bits, kind, channel_dim: Optional[int],
                  symmetric: bool = True, eps: float = 1e-5):
    """(scale, zero_point) computed from `x` with bits/kind given as
    tensors; same values as the JAX `lax.switch` version."""
    return dynamic_scale_flat(x, bits, kind, channel_dim, symmetric, eps)


def _input_stats(x, per_channel: bool, eps: float):
    """Min/max stats of a linear's input in both quantizer domains."""
    axes = tuple(range(x.ndim - 1)) if per_channel else tuple(range(x.ndim))
    xf = x.to(torch.float32)
    la = torch.log2(torch.clamp(xf.abs(), min=eps))
    return {
        "mm_min": torch.amin(xf, dim=axes),
        "mm_max": torch.amax(xf, dim=axes),
        "lg_min": torch.amin(la, dim=axes),
        "lg_max": torch.amax(la, dim=axes),
    }


def sp_linear(x, p, prec, tables: PrecTables, cfg: SPModelConfig,
              calibration_mode: bool = False, collect_stats: bool = False,
              input_passthrough: bool = False):
    """Quantized linear with per-bit LoRA, on the path `cfg.linear_impl`
    selects, as in the JAX package: "fused" runs `sp_linear_fused` (kernels
    #14-#16) where `fused_linear_supported` passes, outside calibration and
    input pass-through, and the flat path otherwise; "auto" and "flat" run
    the flat path (`matmul_bf16`: g rounded to `compute_dtype` before the
    backward products); "cond" multiplies through the casts, so autograd
    multiplies the unrounded float32 g and rounds each product to
    `compute_dtype`.

    Returns (out, stats|None). At the 32-bit slot the quantizers pass
    through and scaling==0 zeroes the LoRA branch. `input_passthrough=True`
    is the input-calibration phase: the input quantizer is off while the
    weight quantizer stays active.
    """
    q = cfg.quant
    bits = tables.bits[prec]
    kind = tables.kind[prec]
    stats = _input_stats(x, q.per_channel, q.eps) if collect_stats else None
    if (cfg.linear_impl == "fused" and not (input_passthrough or calibration_mode)
            and fused_linear_supported(x, p, q)):
        keys = sorted(p)
        run = lambda x, *leaves: sp_linear_fused(x, dict(zip(keys, leaves)), prec, bits,
                                                 kind, tables.scaling[prec], cfg)
        # the kernels take plain tensors: DTensor operands are replicated
        # around them (`local_call`)
        return local_call(run, (x, *(p[k] for k in keys))), stats
    cdt = torch_dtype(cfg.compute_dtype)
    if cfg.linear_impl == "cond":
        mm = lambda a, b: a.to(cdt).to(torch.float32) @ b.to(cdt).to(torch.float32)
    else:
        mm = lambda a, b: matmul_bf16(a, b, cdt)

    if input_passthrough:
        xq = x
    else:
        xq = fake_quant_flat(x, p["iq_scale"][prec], p["iq_zp"][prec], bits,
                             kind, q.symmetric, q.eps)
    wq = fake_quant_flat(p["w"], p["wq_scale"][prec][None, :],
                         p["wq_zp"][prec][None, :], bits, kind, q.symmetric,
                         q.eps)
    base = mm(xq, wq) + p["b"]

    if not calibration_mode and q.max_rank > 0:
        A = p["lora_A"][prec]
        B = p["lora_B"][prec]
        ch = 1 if q.per_channel else None
        a_s, a_z = dynamic_scale_flat(A, bits, kind, ch, q.symmetric, q.eps)
        b_s, b_z = dynamic_scale_flat(B, bits, kind, ch, q.symmetric, q.eps)
        Aq = fake_quant_flat(A, a_s, a_z, bits, kind, q.symmetric, q.eps)
        Bq = fake_quant_flat(B, b_s, b_z, bits, kind, q.symmetric, q.eps)
        # the LoRA branch sees the *raw* input
        base = base + tables.scaling[prec] * mm(mm(x, Aq), Bq)
    return base, stats


def _ln_stats(x, eps):
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    return xf, mean, torch.rsqrt(var + eps)


class _LayerNormCVJP(torch.autograd.Function):
    """LayerNorm with the hand-written single-pass backward (the standard
    identity); it saves x and the two row statistics, not xn."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        xf, mean, rstd = _ln_stats(x, eps)
        ctx.save_for_backward(x, mean, rstd, g)
        return (g * ((xf - mean) * rstd) + b).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, mean, rstd, g = ctx.saved_tensors
        dyf = dy.to(torch.float32)
        xn = (x.to(torch.float32) - mean) * rstd
        lead = tuple(range(dyf.ndim - 1))
        dg = torch.sum(dyf * xn, dim=lead) if ctx.needs_input_grad[1] else None
        db = torch.sum(dyf, dim=lead) if ctx.needs_input_grad[2] else None
        t = dyf * g
        dx = (t - t.mean(dim=-1, keepdim=True)
              - xn * (t * xn).mean(dim=-1, keepdim=True)) * rstd
        return dx.to(x.dtype), dg, db, None


LN_IMPL = "cvjp"  # "cvjp" (hand-written backward) | "autodiff" (A/B switch)


def switchable_layernorm(x, ln, prec, eps: float):
    """Per-precision-affine LayerNorm: biased variance over the feature dim,
    gamma/beta gathered from the (P, d) bank by `prec`. The backward is
    `_LayerNormCVJP`'s unless `LN_IMPL` is "autodiff"."""
    if LN_IMPL == "cvjp":
        return _LayerNormCVJP.apply(x, ln["g"][prec], ln["b"][prec], eps)
    xf, mean, rstd = _ln_stats(x, eps)
    return (ln["g"][prec] * ((xf - mean) * rstd) + ln["b"][prec]).to(x.dtype)


def _layer(tree, li):
    return {k: _layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in tree.items()}


def _unstack(tree, n):
    """The layer-stacked tree as n per-layer trees (`unbind`, whose backward
    stacks the n gradients once)."""
    per = [dict() for _ in range(n)]
    for k, v in tree.items():
        parts = _unstack(v, n) if isinstance(v, dict) else torch.unbind(v, 0)
        for li in range(n):
            per[li][k] = parts[li]
    return per


def sp_block(x, bp, prec, tables, cfg: SPModelConfig, *, mask=None,
             calibration_mode=False, collect_stats=False,
             input_passthrough=False, attention_fn=None):
    """Pre-LN residual block. Attention follows `cfg.attention_impl`: "flash"
    forces the trainable flash path (where the shape allows it), "auto"
    takes it for CUDA tensors from T = FLASH_MIN_T on, and the dense path
    runs elsewhere. `attention_fn(q, k, v)`, on (B, H, T, head_dim) heads
    in the linears' dtype, replaces all of that (ring attention,
    `parallel.ring_attention`), as in the JAX package."""
    m = cfg.model
    B, T, C = x.shape
    lin = lambda h, name: sp_linear(h, bp[name], prec, tables, cfg,
                                    calibration_mode, collect_stats,
                                    input_passthrough)

    h = switchable_layernorm(x, bp["ln1"], prec, m.layer_norm_epsilon)
    qkv, s1 = lin(h, "c_attn")
    q, k, v = torch.split(qkv, C, dim=-1)

    def heads(t):
        return t.reshape(B, T, m.n_head, m.head_dim).permute(0, 2, 1, 3)

    # AMP-faithful attention: q/k/v in compute_dtype on the flat path; the
    # cast back below hands the backward a cotangent in compute_dtype
    cdt = torch_dtype(cfg.compute_dtype)
    cast = (lambda t: t.to(cdt)) if (cfg.linear_impl != "cond"
                                     and cdt != torch.float32) else (lambda t: t)
    impl = cfg.attention_impl
    use_flash = impl == "flash" or (impl == "auto" and x.is_cuda
                                    and T >= FLASH_MIN_T)
    if attention_fn is not None:
        attn = attention_fn(heads(q), heads(k), heads(v))
    else:
        attn = causal_attention(cast(heads(q)), cast(heads(k)), cast(heads(v)),
                                mask=mask, use_flash=use_flash)
    attn = attn.to(x.dtype).permute(0, 2, 1, 3).reshape(B, T, C)
    attn_out, s2 = lin(attn, "attn_proj")
    x = x + attn_out

    h2 = switchable_layernorm(x, bp["ln2"], prec, m.layer_norm_epsilon)
    fc, s3 = lin(h2, "c_fc")
    fc = F.gelu(fc)  # exact erf
    proj, s4 = lin(fc, "mlp_proj")
    x = x + proj

    stats = None
    if collect_stats:
        stats = {"c_attn": s1, "attn_proj": s2, "c_fc": s3, "mlp_proj": s4}
    return x, stats


@replicating
def sp_forward(params, input_ids, prec, cfg: SPModelConfig, *,
               tables: Optional[PrecTables] = None, inputs_embeds=None,
               mask=None, labels=None, deterministic: bool = True,
               dropout_gen: Optional[torch.Generator] = None,
               calibration_mode: bool = False, collect_stats: bool = False,
               input_passthrough: bool = False,
               output_hidden_states: bool = False,
               hidden_states_grad: bool = False, remat: bool = False,
               attention_fn=None, _skip_head: bool = False):
    """Full SP LM forward. Returns a dict with `logits`, `trunk` (the live
    ln_f output), optional `hidden_states`, `stats` ({linear: {stat:
    (L, ch)}}) and `loss` (shifted CE ignoring -100 labels).

    `deterministic=False` applies the embedding dropout, its mask drawn from
    `dropout_gen`: a generator, or the (B, T, d) uniforms themselves (the
    QA model's, which its own dropout reuses). `hidden_states` is (L+1, B,
    T, d): each block's input, then the final ln_f output, detached unless
    `hidden_states_grad`. `remat` recomputes each block in the backward
    (`torch.utils.checkpoint`). `_skip_head` leaves out the tied LM head and
    `logits` (the QA model reads only `trunk`; under `jit` JAX drops the
    unread head the same way). `attention_fn` replaces every block's
    attention (`sp_block`). DTensor parameters or ids (`parallel`) run
    under `replication_scope`.
    """
    dev = params["wte"].device
    if tables is None:
        tables = prec_tables(cfg.quant, dev)
    prec = int(prec)
    if inputs_embeds is not None:
        h = inputs_embeds
        T = h.shape[1]
    else:
        T = input_ids.shape[1]
        h = embed_tokens(params["wte"], input_ids) + params["wpe"][:T][None]

    if not deterministic and cfg.model.embd_pdrop > 0.0:
        keep = 1.0 - cfg.model.embd_pdrop
        drop = dropout_uniforms(dropout_gen, h.shape, h.device) < keep
        h = torch.where(drop, h / keep, torch.zeros_like(h))

    def block(x, bp):
        return sp_block(x, bp, prec, tables, cfg, mask=mask,
                        calibration_mode=calibration_mode,
                        collect_stats=collect_stats and not remat,
                        input_passthrough=input_passthrough,
                        attention_fn=attention_fn)

    per_layer, h_in = [], []
    for bp in _unstack(params["blocks"], cfg.model.n_layer):
        if output_hidden_states:
            h_in.append(h if hidden_states_grad else h.detach())
        if remat:
            h = checkpoint(lambda x, bp=bp: block(x, bp)[0], h,
                           use_reentrant=False)
            s = None
        else:
            h, s = block(h, bp)
        per_layer.append(s)

    h = switchable_layernorm(h, params["ln_f"], prec,
                             cfg.model.layer_norm_epsilon)
    out = {}
    if not _skip_head:
        # a sequence shard (context parallelism) is gathered for the head:
        # the shifted losses slice the sequence
        out["logits"] = matmul_bf16(gather_dim(h, 1), params["wte"].T,
                                    torch_dtype(cfg.compute_dtype))
    out["trunk"] = h
    if output_hidden_states:
        h_in.append(h if hidden_states_grad else h.detach())
        out["hidden_states"] = torch.stack(h_in)
    if collect_stats and not remat:
        out["stats"] = {
            name: {k: torch.stack([s[name][k] for s in per_layer])
                   for k in per_layer[0][name]}
            for name in per_layer[0]
        }
    if labels is not None:
        out["loss"] = lm_cross_entropy(out["logits"], labels)
    return out


def embed_tokens(wte, ids):
    """wte[ids], as JAX's gather: an id past the vocabulary reads the last
    row, and its gradient is dropped (JAX's scatter-add drops an update out
    of bounds)."""
    V = wte.shape[0]
    rows = wte[ids.clamp(max=V - 1)]
    if not wte.requires_grad:
        return rows
    return torch.where((ids < V)[..., None], rows, rows.detach())


def dropout_uniforms(source, shape, device):
    """The uniforms of a dropout mask: drawn from `source` when it is a
    generator, `source` itself when it is a tensor of them."""
    if isinstance(source, torch.Tensor):
        return source
    return torch.rand(shape, generator=source, device=device)


def lm_cross_entropy(logits, labels):
    """Shifted LM cross-entropy, mean over labels != -100. A label past the
    vocabulary gives NaN, as JAX's `take_along_axis` fills it."""
    shift_logits = logits[:, :-1].to(torch.float32)
    shift_labels = labels[:, 1:]
    V = shift_logits.shape[-1]
    valid = shift_labels != -100
    safe = torch.where(valid, shift_labels, torch.zeros_like(shift_labels))
    logp = torch.log_softmax(shift_logits, dim=-1)
    nll = -torch.gather(logp, -1, safe.clamp(max=V - 1)[..., None])[..., 0]
    nll = torch.where(safe < V, nll, torch.full_like(nll, math.nan))
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / torch.clamp(valid.sum(), min=1)
