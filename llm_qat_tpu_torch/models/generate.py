"""KV-cached autoregressive generation on SP parameters, and the sampling
filters (counterpart of `llm_qat_tpu/models/generate.py`).

`forward_with_cache` runs the SP model (`sp_linear`,
`switchable_layernorm`) over a preallocated (L, B, H, T_max, Dh) cache:
one prefill over the prompt, then one call per generated token. The
cache is written in place. As in JAX, the write's start is clamped so
that the rows fit (`lax.dynamic_update_slice`), and positions past
`n_positions` read the last `wpe` row (the gather clamps). `generate`
caps the cache at `n_positions` yet takes all `max_new_tokens` steps, as
the JAX function does. A Python loop replaces `lax.scan`, and the draws
come from one `torch.Generator`.

The filters follow the reference semantics: temperature scaling, top-k
(keep the k highest logits), top-p (sort descending, drop tokens whose
cumulative probability passes p, always keep the first); the engines'
sampling uses them too.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.kv_cache import clamped_start
from .config import SPModelConfig
from .sp_model import PrecTables, _layer, prec_tables, sp_linear, switchable_layernorm

NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, H, T_max, Dh)
    v: torch.Tensor  # (L, B, H, T_max, Dh)
    length: int  # number of valid positions


def init_kv_cache(cfg: SPModelConfig, batch: int, max_len: int,
                  dtype=torch.float32, device=None) -> KVCache:
    m = cfg.model
    dev = resolve_device(device)
    shape = (m.n_layer, batch, m.n_head, max_len, m.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=dev),
                   v=torch.zeros(shape, dtype=dtype, device=dev), length=0)


def update_rows(cache, rows, start):
    """Write rows (B, H, S, D) into cache (B, H, T, D) at timestep `start`
    in place, the start clamped as `lax.dynamic_update_slice` clamps it.
    Returns the cache."""
    S = rows.shape[2]
    s0 = clamped_start(start, S, cache.shape[2])
    cache[:, :, s0:s0 + S] = rows.to(cache.dtype)
    return cache


def embed_positions(wpe, start: int, S: int):
    """wpe rows of positions [start, start + S), clamped to the table as the
    JAX gather clamps."""
    pos = torch.arange(start, start + S, device=wpe.device)
    return wpe[pos.clamp(max=wpe.shape[0] - 1)]


def cached_attention(q, k, v, start: int):
    """Causal attention of q (B, H, S, D), the positions [start, start + S),
    over whole caches k, v (B, H, T, D) already holding those rows: float32
    scores, key t visible to query position p where t <= p, the
    probabilities rounded to the cache dtype before P·V, the output in the
    cache dtype."""
    f32 = torch.float32
    S, T = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhsd,bhtd->bhst", q.to(f32), k.to(f32)) * scale
    q_pos = start + torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    scores = torch.where((k_pos <= q_pos)[None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bhtd->bhsd", probs.to(f32), v.to(f32)).to(v.dtype)


def _block_with_cache(x, bp, prec, tables, cfg, k_cache, v_cache, start):
    """One transformer block over `x` (B, S, d) attending to cache[:start+S].

    Writes the S new positions' K/V into `k_cache`/`v_cache` (B, H, T_max,
    Dh) in place; returns (out, k_cache, v_cache)."""
    m = cfg.model
    B, S, C = x.shape

    h = switchable_layernorm(x, bp["ln1"], prec, m.layer_norm_epsilon)
    qkv, _ = sp_linear(h, bp["c_attn"], prec, tables, cfg)
    q, k, v = (t.reshape(B, S, m.n_head, m.head_dim).permute(0, 2, 1, 3)
               for t in torch.split(qkv, C, dim=-1))

    k_all = update_rows(k_cache, k, start)
    v_all = update_rows(v_cache, v, start)
    attn = cached_attention(q, k_all, v_all, start).permute(0, 2, 1, 3).reshape(B, S, C)
    attn_out, _ = sp_linear(attn, bp["attn_proj"], prec, tables, cfg)
    x = x + attn_out

    h2 = switchable_layernorm(x, bp["ln2"], prec, m.layer_norm_epsilon)
    fc, _ = sp_linear(h2, bp["c_fc"], prec, tables, cfg)
    fc = F.gelu(fc)  # exact erf
    proj, _ = sp_linear(fc, bp["mlp_proj"], prec, tables, cfg)
    return x + proj, k_all, v_all


@torch.no_grad()
def forward_with_cache(params, input_ids, prec, cfg: SPModelConfig,
                       cache: KVCache, tables: Optional[PrecTables] = None):
    """Forward `input_ids` (B, S) continuing from `cache.length` positions.

    Returns (logits (B, S, V) float32, the cache written in place with its
    length advanced by S). Used both for prefill (S = prompt length) and
    decode (S = 1)."""
    dev = params["wte"].device
    if tables is None:
        tables = prec_tables(cfg.quant, dev)
    prec = int(prec)
    B, S = input_ids.shape
    start = int(cache.length)
    ids = input_ids.clamp(max=params["wte"].shape[0] - 1)
    h = params["wte"][ids] + embed_positions(params["wpe"], start, S)[None]
    for li in range(cfg.model.n_layer):
        h, _, _ = _block_with_cache(h, _layer(params["blocks"], li), prec, tables, cfg,
                                    cache.k[li], cache.v[li], start)
    h = switchable_layernorm(h, params["ln_f"], prec, cfg.model.layer_norm_epsilon)
    logits = torch.matmul(h.to(torch.float32), params["wte"].to(torch.float32).T)
    return logits, KVCache(k=cache.k, v=cache.v, length=start + S)


def _filter_logits(logits, temperature, top_k, top_p):
    """Temperature / top-k / top-p filtering (reference semantics).

    Top-k keeps logits >= the k-th largest; top-p keeps the smallest set of
    sorted tokens whose cumulative probability passes `top_p`, the first
    token above the threshold included. Removed entries become -1e30.
    """
    logits = logits / max(float(temperature), 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove = cum > top_p
        remove = torch.cat([torch.zeros_like(remove[..., :1]), remove[..., :-1]],
                           dim=-1)
        thresh = torch.where(remove, torch.full_like(sorted_logits, float("inf")),
                             sorted_logits).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < thresh, torch.full_like(logits, NEG_INF),
                             logits)
    return logits


def _filter_logits_vec(logits, temperature, top_k, top_p):
    """Per-row temperature / top-k / top-p filtering (the JAX
    `_filter_logits_vec`): each row of `logits` (B, V) has its own
    temperature (B,), top_k (B,) int (0 disables) and top_p (B,) float (1.0
    disables), as continuous batching mixes requests in one step. Top-p acts
    on the top-k-filtered row, as the reference chains the filters."""
    V = logits.shape[-1]
    logits = logits / torch.clamp(temperature[:, None], min=1e-6)
    srt = torch.sort(logits, dim=-1).values  # ascending
    idx = torch.clamp(V - top_k, 0, V - 1).to(torch.int64)
    kth = torch.gather(srt, -1, idx[:, None])
    neg = torch.full_like(logits, NEG_INF)
    logits = torch.where((top_k[:, None] > 0) & (logits < kth), neg, logits)
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_desc, dim=-1), dim=-1)
    remove = cum > top_p[:, None]
    remove = torch.cat([torch.zeros_like(remove[:, :1]), remove[:, :-1]], dim=-1)
    thresh = torch.where(remove, torch.full_like(sorted_desc, float("inf")),
                         sorted_desc).amin(dim=-1, keepdim=True)
    return torch.where((top_p[:, None] < 1.0) & (logits < thresh), neg, logits)


def _sample(logits, temperature, top_k, top_p, do_sample, generator):
    if top_p is None and top_k is None and temperature == 1.0 and not do_sample:
        return torch.argmax(logits, dim=-1)
    filt = _filter_logits(logits, temperature, top_k, top_p)
    if do_sample:
        return torch.multinomial(torch.softmax(filt, dim=-1), 1, generator=generator)[:, 0]
    return torch.argmax(filt, dim=-1)


@torch.no_grad()
def generate(params, input_ids, prec, cfg: SPModelConfig, *,
             generator: Optional[torch.Generator] = None, max_new_tokens: int = 32,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None, do_sample: bool = True,
             eos_token_id: Optional[int] = None,
             tables: Optional[PrecTables] = None):
    """KV-cached generation: one prefill over the prompt, then
    `max_new_tokens` single-token steps (the last step's logits go unused,
    as in the JAX scan). The cache holds min(n_positions, T0 +
    max_new_tokens) rows; past them the writes clamp to the last row, as in
    JAX. Tokens after EOS are frozen to EOS. Returns (B, T0 +
    max_new_tokens) on the parameters' device."""
    dev = params["wte"].device
    if tables is None:
        tables = prec_tables(cfg.quant, dev)
    ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
    B, T0 = ids.shape
    max_len = min(cfg.model.n_positions, T0 + max_new_tokens)
    cache = init_kv_cache(cfg, B, max_len, device=dev)
    logits, cache = forward_with_cache(params, ids, prec, cfg, cache, tables)
    last = logits[:, -1]
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    toks = []
    for _ in range(max_new_tokens):
        tok = _sample(last, temperature, top_k, top_p, do_sample, generator)
        if eos_token_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_token_id), tok)
            done = done | (tok == eos_token_id)
        toks.append(tok)
        logits, cache = forward_with_cache(params, tok[:, None], prec, cfg, cache, tables)
        last = logits[:, 0]
    return torch.cat([ids] + [t[:, None] for t in toks], dim=1)
