"""Continuous-batching serving engine over the pre-quantized decode path.

Counterpart of `llm_qat_tpu/serving/engine.py`:
- N decode slots (batch rows) share one set of KV caches;
- queued requests are prefilled (B = 1, bucketed length) into free slots,
  and the first generated token is sampled from the prefill logits;
- one step advances every active slot by a token, each at its own position;
- a finished slot (EOS, max tokens, or the cache end) takes the next
  request at once.

Three KV layouts: "dense" (per-slot scatter, the CPU default), "packed"
(per layer and step one `decode_attention_hbm_multi`, the CUDA default) and
"mega" (one whole-model `mega_decode_step_cb` per token over read-only main
caches plus a chunk-local recent buffer, merged once per chunk with
`cb_merge_recent`). `step_chunk(k)` runs k steps with the tokens kept on
the device and reads them back once, at the end of the chunk.

Sampling is per slot (temperature / top-k / top-p / greedy). The JAX engine
draws token i of a request from `fold_in(request key, i)`; the port keeps
that property with its own generator: Gumbel-max over a counter-based
integer hash of (request key, i, vocab index), evaluated on the device, with
the request key a hash of the engine's seed and the request id. So chunked
and stepwise decode give the same tokens, and a request's tokens do not
depend on which slot or chunk it ran in. The draws are not JAX's: sampled
tokens are reproducible within the port, greedy tokens equal the JAX
engine's.
"""

from __future__ import annotations

import itertools
import math
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..models.config import SPModelConfig
from ..models.generate import _filter_logits_vec
from ..models.inference import (
    _infer_linear,
    _lm_head,
    _ln,
    _tree_to,
    head_planes,
    infer_forward_unrolled,
    init_layer_caches,
    quantize_for_inference,
    quantize_kv_rows,
)
from ..models.sp_model import _layer
from ..ops.decode_attention import (
    decode_attention_hbm_multi,
    decode_attention_hbm_multi_plain,
    kv_pack_factor,
)
from ..ops.mega_decode import (
    cb_merge_recent,
    mega_decode_step_cb,
    mega_decode_step_cb_plain,
    pack_mega_weights,
)


@dataclass
class Request:
    req_id: int
    prompt: np.ndarray  # (T0,) int32
    max_new_tokens: int
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    do_sample: bool = False
    generated: List[int] = field(default_factory=list)
    done: bool = False


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (murmur-style xorshift-multiply rounds with
    multipliers below 2^31, so every product fits in an int64). Works on
    Python ints and int64 tensors alike; values stay in [0, 2^32)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def request_key(seed: int, req_id: int) -> int:
    """The sampling key of request `req_id` under engine seed `seed`."""
    return _mix32(_mix32(int(seed) ^ 0x5BD1E995) ^ int(req_id))


def _gumbel(keys, counts, V: int):
    """(B, V) float32 Gumbel noise; entry (b, v) is a function of keys[b],
    counts[b] and v alone (keys, counts: (B,) int64 on the logits' device)."""
    base = _mix32(keys ^ _mix32(counts + 0x632BE5AB))[:, None]
    v = torch.arange(V, device=keys.device, dtype=torch.int64)[None]
    h = _mix32(_mix32(base + v * 0x1B873593) ^ base)
    u = ((h >> 8).to(torch.float64) + 0.5) / float(1 << 24)   # in (0, 1)
    return (-torch.log(-torch.log(u))).to(torch.float32)


def _sample_slots(logits, keys, counts, temp, top_k, top_p, do_sample,
                  greedy_only: bool = False):
    """Per-slot sampling: logits (B, V); keys (B,) int64 request keys;
    counts (B,) token index within each request; temp/top_k/top_p/do_sample
    (B,) per-slot settings. Greedy rows take the argmax of the filtered
    logits (the filters keep the max, so it is the plain argmax); sampled
    rows the argmax of filtered logits plus Gumbel noise (a categorical
    draw). `greedy_only` (every active request greedy) skips the filters'
    sorts over the vocabulary."""
    if greedy_only:
        return torch.argmax(logits, dim=-1)
    filt = _filter_logits_vec(logits.to(torch.float32), temp, top_k, top_p)
    sampled = torch.argmax(filt + _gumbel(keys, counts, filt.shape[-1]), dim=-1)
    return torch.where(do_sample, sampled, torch.argmax(filt, dim=-1))


def _decode_step(iparams, tokens, caches, pos, slot_pos, cfg: SPModelConfig,
                 static, use_kernels: bool = True):
    """One token for every slot over dense or packed caches (updated in
    place). tokens (B,) and pos (B,) (each slot's position, clipped to the
    model's positions) on the device; slot_pos (B,) on the host, each active
    slot's position and -1 for an inactive one (the packed kernel writes
    nothing for it). Returns the logits (B, V) of the float tied head
    `h @ wte.T`, as the JAX engine's step does even when the tree carries an
    int8/int4 head (its prefill and mega step use that head)."""
    m = cfg.model
    B = tokens.shape[0]
    D = m.head_dim
    P = kv_pack_factor(D)
    packed = P > 1 and caches[0].shape[-1] == P * D
    bits, kind = iparams["_bits"], iparams["_kind"]
    f32 = torch.float32
    wte = iparams["wte"]
    h = wte[tokens][:, None] + iparams["wpe"][pos][:, None].to(wte.dtype)
    lin = lambda x, p: _infer_linear(x, p, cfg, True, static, bits, kind, use_kernels)
    rows = torch.arange(B, device=tokens.device)
    scale = 1.0 / math.sqrt(D)
    hbm = decode_attention_hbm_multi if use_kernels else decode_attention_hbm_multi_plain

    for li in range(m.n_layer):
        bp = _layer(iparams["blocks"], li)
        hn = _ln(h, bp["ln1"]["g"], bp["ln1"]["b"], m.layer_norm_epsilon)
        qkv = lin(hn, bp["c_attn"])
        qh, kh, vh = (t.reshape(B, 1, m.n_head, D).permute(0, 2, 1, 3)
                      for t in torch.split(qkv, m.n_embd, dim=-1))
        kc, vc = caches[2 * li], caches[2 * li + 1]
        if packed:
            attn = hbm(qh, kh, vh, kc, vc, slot_pos)[0]
        else:
            # per-slot scatter: slot b writes its K/V at its own position
            kc[rows, :, pos] = kh[:, :, 0].to(kc.dtype)
            vc[rows, :, pos] = vh[:, :, 0].to(vc.dtype)
            scores = torch.einsum("bhsd,bhtd->bhst", qh.to(f32), kc.to(f32)) * scale
            k_pos = torch.arange(kc.shape[2], device=tokens.device)
            valid = k_pos[None] <= pos[:, None]                  # causal per slot
            scores = torch.where(valid[:, None, None], scores,
                                 torch.full_like(scores, -1e30))
            probs = torch.softmax(scores, dim=-1).to(vc.dtype)
            attn = torch.einsum("bhst,bhtd->bhsd", probs.to(f32),
                                vc.to(f32)).to(vc.dtype)
        attn = attn.permute(0, 2, 1, 3).reshape(B, 1, -1).to(h.dtype)
        h = h + lin(attn, bp["attn_proj"]).to(h.dtype)
        h2 = _ln(h, bp["ln2"]["g"], bp["ln2"]["b"], m.layer_norm_epsilon)
        fc = F.gelu(lin(h2, bp["c_fc"])).to(h.dtype)  # exact erf
        h = h + lin(fc, bp["mlp_proj"]).to(h.dtype)

    h = _ln(h, iparams["ln_f"]["g"], iparams["ln_f"]["b"], m.layer_norm_epsilon)
    return torch.matmul(h[:, 0].to(f32), wte.to(f32).T)


class ContinuousBatchingEngine:
    """Continuous-batching decode server (one card) with per-slot sampling
    (temperature / top-k / top-p / greedy per request).

    Runs on `device` ("cuda" by default; "cpu" runs every kernel's plain
    version). `use_kernels=False` runs the plain versions on the card too.
    `rng` is the sampling seed: an int, or a `torch.Generator` from which
    one seed is drawn (None: seed 0). No global random state is read.
    """

    def __init__(self, params, cfg: SPModelConfig, bits: int,
                 n_slots: int = 8, max_len: int = 512,
                 eos_token_id: Optional[int] = None, dtype=torch.bfloat16,
                 weight_format: str = "dense", lm_head_int8: bool = False,
                 lm_head_bits: Optional[int] = None,
                 kv_layout: str = "auto", kv_bits: int = 8,
                 mega_tbp: int = 64, rng=None, device=None,
                 use_kernels: bool = True):
        self.device = resolve_device(device)
        self.use_kernels = use_kernels
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = min(max_len, cfg.model.n_positions)
        self.eos_token_id = eos_token_id
        self.dtype = dtype
        if kv_layout == "auto":
            kv_layout = "packed" if self.device.type == "cuda" else "dense"
        if kv_layout not in ("dense", "packed", "mega"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        self.kv_layout = kv_layout
        self._pack = (kv_pack_factor(cfg.model.head_dim)
                      if kv_layout == "packed" else 1)
        self.iparams = quantize_for_inference(
            _tree_to(params, self.device), cfg, bits, dtype,
            weight_format=weight_format, lm_head_int8=lm_head_int8,
            lm_head_bits=lm_head_bits)
        self.static = self.iparams.pop("_static")
        self._planes = head_planes(self.iparams)
        self._prefill_layout = "packed" if kv_layout == "packed" else "dense"

        self.lengths = np.zeros((n_slots,), np.int64)
        self.last_token = np.zeros((n_slots,), np.int64)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: deque = deque()
        self.finished: Dict[int, Request] = {}
        self._ids = itertools.count()
        # per-slot sampling state (host mirrors, uploaded once per chunk)
        if isinstance(rng, torch.Generator):
            rng = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                                    device=rng.device))
        self.seed = 0 if rng is None else int(rng)
        self.slot_keys = np.zeros((n_slots,), np.int64)
        self.gen_counts = np.zeros((n_slots,), np.int64)
        self.temp = np.ones((n_slots,), np.float32)
        self.top_k = np.zeros((n_slots,), np.int64)
        self.top_p = np.ones((n_slots,), np.float32)
        self.do_sample = np.zeros((n_slots,), bool)
        self._mega_chunk_cap = None
        self.decode_steps = 0  # decode steps run (each advances every slot)
        if kv_layout == "mega":
            self._setup_mega(kv_bits, mega_tbp)
        else:
            self.caches = init_layer_caches(cfg, n_slots, self.max_len, dtype,
                                            kv_layout=kv_layout, device=self.device)

    def _setup_mega(self, kv_bits: int, mega_tbp: int):
        """Megakernel decode for mixed per-slot positions: two-level KV, the
        per-slot main caches (read only within a chunk) plus a chunk-local
        recent buffer of one stream block, appended at the step index within
        the chunk and merged into main once per chunk."""
        m = self.cfg.model
        if kv_bits not in (8, 4):
            raise ValueError(f"mega CB needs kv_bits 8 or 4; got {kv_bits}")
        self.kv_bits = kv_bits
        self.mega = pack_mega_weights(self.iparams, self.cfg)
        self._has_lora = "lora_A" in self.iparams["blocks"]["c_attn"]
        ca = self.iparams["blocks"]["c_attn"]
        self._aq_max = float(ca["qmax"][0]) if "qmax" in ca else 127.0
        dc = m.n_embd if kv_bits == 8 else m.n_embd // 2
        L, B, T = m.n_layer, self.n_slots, self.max_len
        tbp = min(mega_tbp, T)
        while T % tbp and tbp > 8:
            tbp -= 8
        self._tbp = tbp
        # the recent buffer is one stream block: a chunk decodes at most tbp
        # tokens between merges; step_chunk caps larger asks
        self._mega_chunk_cap = tbp
        dev, i8, f32 = self.device, torch.int8, torch.float32
        self.caches = (torch.zeros((L, B, T, dc), dtype=i8, device=dev),
                       torch.zeros((L, B, T, dc), dtype=i8, device=dev),
                       torch.ones((L, B, T), dtype=f32, device=dev),
                       torch.ones((L, B, T), dtype=f32, device=dev))
        self._recent = (torch.zeros((L, B, tbp, dc), dtype=i8, device=dev),
                        torch.zeros((L, B, tbp, dc), dtype=i8, device=dev),
                        torch.ones((L, B, tbp), dtype=f32, device=dev),
                        torch.ones((L, B, tbp), dtype=f32, device=dev))

    # -- device-side pieces ---------------------------------------------------

    def _prefill(self, ids):
        """B = 1 prefill of (1, pad) ids into fresh caches; (logits, caches)."""
        caches1 = init_layer_caches(self.cfg, 1, self.max_len, self.dtype,
                                    kv_layout=self._prefill_layout, device=self.device)
        logits, caches1, _ = infer_forward_unrolled(
            self.iparams, ids, self.cfg, caches1, 0, static=self.static,
            initial_prefill=True, use_kernels=self.use_kernels)
        return logits, caches1

    def _insert_slot(self, caches1, slot: int, t0: int):
        """Copy the first t0 timesteps of a B = 1 prefill into `slot` (packed
        rows hold P timesteps: ceil(t0 / P) rows; the pad token's K/V in the
        second half of an odd prompt's last row is never attended, and the
        first append overwrites it)."""
        if self.kv_layout != "mega":
            thr = -(-t0 // self._pack)
            for c, c1 in zip(self.caches, caches1):
                c[slot, :, :thr] = c1[0, :, :thr]
            return
        def rows(cs):  # (1, H, T, D) per layer -> (L, T, d)
            return torch.stack([c[0].permute(1, 0, 2).reshape(c.shape[2], -1)
                                for c in cs])

        kc, vc, ksc, vsc = self.caches
        for cache, scale, src in ((kc, ksc, caches1[0::2]), (vc, vsc, caches1[1::2])):
            codes, s = quantize_kv_rows(rows(src), self.kv_bits)
            cache[:, slot, :t0] = codes[:, :t0]
            scale[:, slot, :t0] = s[:, :t0]

    def _mega_token(self, tokens, lengths0, lengths0_dev, rpos):
        """One mega token for every slot at lengths0 + rpos; returns logits."""
        m = self.cfg.model
        ip = self.iparams
        pos = torch.clamp(lengths0_dev + rpos, 0, m.n_positions - 1)
        h = (ip["wte"][tokens] + ip["wpe"][pos].to(ip["wte"].dtype)).to(torch.float32)
        step = mega_decode_step_cb if self.use_kernels else mega_decode_step_cb_plain
        h_out = step(h, self.mega, *self.caches, *self._recent, lengths0, rpos,
                     n_head=m.n_head, head_dim=m.head_dim, has_lora=self._has_lora,
                     eps=m.layer_norm_epsilon, tbp=self._tbp, act_dtype=self.dtype,
                     aq_max=self._aq_max, kv_bits=self.kv_bits, tiles_per_step=4)[0]
        hf = _ln(h_out[:, None, :].to(self.dtype), ip["ln_f"]["g"], ip["ln_f"]["b"],
                 m.layer_norm_epsilon)
        return _lm_head(ip, hf, self._planes)[:, 0]

    def _run_chunk(self, k: int, active: np.ndarray) -> np.ndarray:
        """k decode steps for every slot (inactive slots compute and are
        ignored), tokens kept on the device between steps; returns the
        (B, k) tokens on the host (the chunk's one host sync)."""
        dev = self.device
        up = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)
        i64 = torch.int64
        act = up(active, torch.bool)
        lengths0 = up(self.lengths, i64)
        counts0 = up(self.gen_counts, i64)
        keys, temp = up(self.slot_keys, i64), up(self.temp, torch.float32)
        top_k, top_p = up(self.top_k, i64), up(self.top_p, torch.float32)
        do_sample = up(self.do_sample, torch.bool)
        greedy = self._all_greedy(active)
        toks = up(self.last_token, i64)
        step_i = act.to(i64)
        outs = []
        for i in range(k):
            if self.kv_layout == "mega":
                logits = self._mega_token(toks, self.lengths, lengths0, i)
            else:
                pos = torch.clamp(lengths0 + i * step_i, 0, self.cfg.model.n_positions - 1)
                slot_pos = np.where(active, self.lengths + i, -1)
                logits = _decode_step(self.iparams, toks, self.caches, pos, slot_pos,
                                      self.cfg, self.static, self.use_kernels)
            nxt = _sample_slots(logits, keys, counts0 + i * step_i, temp, top_k, top_p,
                                do_sample, greedy)
            toks = torch.where(act, nxt, torch.zeros_like(nxt))
            outs.append(toks)
        if self.kv_layout == "mega":
            cb_merge_recent(*self.caches, *self._recent, self.lengths, k)
        self.decode_steps += k
        return torch.stack(outs, dim=1).cpu().numpy()

    # -- public API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32, *,
               temperature: float = 1.0, top_k: Optional[int] = None,
               top_p: Optional[float] = None, do_sample: bool = False) -> int:
        """Queue a request; returns its id.

        Capacity contract: the prompt must leave room for at least one
        decoded token (`len(prompt) <= max_len - 1`); beyond that a decode
        step would append K/V past the cache end. Requests whose prompt +
        max_new_tokens exceed capacity are accepted but finish early at the
        cache limit, as the reference stops at `n_positions`.
        """
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be 1-D; got shape {prompt.shape}")
        if len(prompt) > self.max_len - 1:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds engine capacity "
                f"(max_len={self.max_len} leaves room for at most "
                f"{self.max_len - 1} prompt tokens + 1 generated)")
        req = Request(next(self._ids), prompt, max_new_tokens,
                      temperature=temperature, top_k=top_k, top_p=top_p,
                      do_sample=do_sample)
        self.queue.append(req)
        return req.req_id

    def _all_greedy(self, active) -> bool:
        """True when every active request is plain greedy (skips the
        vocabulary sorts of the filters)."""
        return bool(not self.do_sample[active].any()
                    and (self.top_k[active] == 0).all()
                    and (self.top_p[active] == 1.0).all())

    def _bucket(self, n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def _finish(self, slot: int, req: Request):
        req.done = True
        self.finished[req.req_id] = req
        if slot >= 0:
            self.slot_req[slot] = None
            self.lengths[slot] = 0
            self.last_token[slot] = 0
            self.gen_counts[slot] = 0

    def _fill_slots(self):
        dev = self.device
        for slot in range(self.n_slots):
            while self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                if req.max_new_tokens <= 0:
                    # nothing to generate: don't sample the prefill token
                    self._finish(-1, req)
                    continue
                T0 = len(req.prompt)
                ids = torch.zeros((1, self._bucket(T0)), dtype=torch.int64, device=dev)
                ids[0, :T0] = torch.as_tensor(req.prompt, device=dev)
                logits, caches1 = self._prefill(ids)
                # the first generated token comes from the prefill logits,
                # sampled under the request's own settings (token index 0)
                key = request_key(self.seed, req.req_id)
                first = int(_sample_slots(
                    logits[:, T0 - 1],
                    torch.tensor([key], device=dev), torch.zeros((1,), dtype=torch.int64,
                                                                  device=dev),
                    torch.tensor([req.temperature], dtype=torch.float32, device=dev),
                    torch.tensor([req.top_k or 0], device=dev),
                    torch.tensor([1.0 if req.top_p is None else req.top_p],
                                 dtype=torch.float32, device=dev),
                    torch.tensor([req.do_sample], device=dev))[0])
                req.generated.append(first)
                hit_eos = self.eos_token_id is not None and first == self.eos_token_id
                if len(req.generated) >= req.max_new_tokens or hit_eos:
                    self._finish(-1, req)
                    continue  # the slot stays free; try the next request
                self._insert_slot(caches1, slot, T0)
                self.lengths[slot] = T0
                self.last_token[slot] = first
                self.gen_counts[slot] = 1
                self.slot_keys[slot] = key
                self.temp[slot] = req.temperature
                self.top_k[slot] = req.top_k or 0
                self.top_p[slot] = 1.0 if req.top_p is None else req.top_p
                self.do_sample[slot] = req.do_sample
                self.slot_req[slot] = req

    def step(self) -> int:
        """Advance every active slot one token; returns #active slots."""
        self._fill_slots()
        active = np.asarray([r is not None for r in self.slot_req])
        if not active.any():
            return 0
        nxt = self._run_chunk(1, active)[:, 0]
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.lengths[slot] += 1
            self.gen_counts[slot] += 1
            self.last_token[slot] = tok
            hit_eos = self.eos_token_id is not None and tok == self.eos_token_id
            out_of_room = self.lengths[slot] + 1 >= self.max_len
            if len(req.generated) >= req.max_new_tokens or hit_eos or out_of_room:
                self._finish(slot, req)
        return int(active.sum())

    def step_chunk(self, k: int = 16) -> int:
        """Advance active slots up to k tokens with one host sync.

        Slot bookkeeping (EOS, max tokens, recycling) happens once per
        chunk; tokens generated after a slot's stop condition within the
        chunk are discarded. k is capped so no slot overruns its cache and,
        on the mega layout, at the recent buffer's one block (mega_tbp).
        """
        self._fill_slots()
        active = np.asarray([r is not None for r in self.slot_req])
        if not active.any():
            return 0
        max_room = int(self.max_len - 1 - self.lengths[active].max())
        if self._mega_chunk_cap is not None:
            k = min(k, self._mega_chunk_cap)
        k_eff = max(1, min(k, max_room))
        toks_out = self._run_chunk(k_eff, active)
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            taken = 0
            for j in range(k_eff):
                tok = int(toks_out[slot, j])
                req.generated.append(tok)
                taken += 1
                if ((self.eos_token_id is not None and tok == self.eos_token_id)
                        or len(req.generated) >= req.max_new_tokens):
                    break
            self.lengths[slot] += taken
            self.gen_counts[slot] += taken
            self.last_token[slot] = int(toks_out[slot, taken - 1])
            hit_eos = (self.eos_token_id is not None
                       and req.generated[-1] == self.eos_token_id)
            out_of_room = self.lengths[slot] + 1 >= self.max_len
            if len(req.generated) >= req.max_new_tokens or hit_eos or out_of_room:
                self._finish(slot, req)
        return int(active.sum())

    def run_until_done(self, max_steps: int = 10_000,
                       chunk: int = 1) -> Dict[int, Request]:
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            if chunk > 1:
                self.step_chunk(chunk)
            else:
                self.step()
            steps += 1
        return self.finished
