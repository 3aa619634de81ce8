"""Plain reference of the served 4-bit model, for the serving cells.

The served model is the SP model at one student slot with its quantizers
frozen: weights on their symmetric b-bit grid (one scale per layer and
linear when per tensor), linear inputs quantized to the same grid by their
calibrated static scales, the LoRA factors on the grid of their own max,
added on the raw input; a tied LM head with `head_bits` codes per
vocabulary row and 8-bit activation codes per position. Activations are
rounded to the served activation precision `act` (bf16) where the system
states it: the embedding sum, each LayerNorm's output, the attention
output, the GELU output, each sub-layer's output before the residual add
and the residual sum, and the LoRA input and its rank-r product; sums are
float32.

Attention follows the served path's stated arithmetic. The prompt's own
forward (the prefill, over the prompt padded to a power of two from 8)
attends in float32 from 128 padded rows on, and below that over K, V and
probabilities in the activation precision. Its K and V rows, in the
activation precision, are then quantized per row (the max over all lanes)
to `kv_bits`, as is every generated row. A generated token attends with
8-bit query codes per head and 8-bit probabilities per block: the cached
rows before its chunk in blocks of `block` rows from row 0, then its
chunk's rows before it as one block, each block's probabilities taken at
the running maximum and times the row's V scale, quantized to 127 steps of
the block's largest; then itself, in float32 from its dequantized row.
The prefill's GELU is the exact erf's; decode's takes Abramowitz and
Stegun's rational erf.
Chunks of `chunk` decode steps start at the prompt's end.

`logits(...)` is one forward over a prompt and the tokens served after it,
so each served token's logits come out at the position before it, as
prefill and decode produced them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .quant import fq_minmax, minmax_scale, round_to
from .sp_model import LINEARS, Dims, calibrate, layer_norm


def gelu_as(x):
    """GELU through Abramowitz and Stegun's rational erf (7.1.26, absolute
    error under 1.5e-7), the served decode step's GELU."""
    z = x * 0.7071067811865476
    t = 1.0 / (1.0 + 0.3275911 * z.abs())
    poly = ((((1.061405429 * t - 1.453152027) * t + 1.421413741) * t
             - 0.284496736) * t + 0.254829592) * t
    return 0.5 * x * (1.0 + torch.sign(z) * (1.0 - poly * torch.exp(-z * z)))


def _grid(x, bits, dims):
    return fq_minmax(x, minmax_scale(x, bits, dims), bits)


class Served:
    """The frozen served tree, derived from the raw weights at one slot."""

    def __init__(self, params, dims: Dims, bits: int, cal_batches, kv_bits: int,
                 head_bits: int, chunk: int, block: int):
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            quant = calibrate(params, dims, cal_batches, "bf16")
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
        if dims.kinds[dims.slot(bits)] != "minmax":
            raise ValueError("the served reference takes a minmax slot")
        p = dims.slot(bits)
        self.dims, self.bits, self.kv_bits, self.head_bits = dims, bits, kv_bits, head_bits
        self.chunk, self.block = min(chunk, block), block
        red = (0,) if dims.per_channel else (0, 1)
        self.layers = []
        for li in range(dims.L):
            layer = {"ln1": (params["blocks"]["ln1"]["g"][li, p], params["blocks"]["ln1"]["b"][li, p]),
                     "ln2": (params["blocks"]["ln2"]["g"][li, p], params["blocks"]["ln2"]["b"][li, p])}
            for name in LINEARS:
                lin = params["blocks"][name]
                ws = quant["w"][(name, p)][li]
                A, B = lin["lora_A"][li, p], lin["lora_B"][li, p]
                layer[name] = {
                    "w": fq_minmax(lin["w"][li], ws, bits), "b": lin["b"][li],
                    "xs": quant["x"][(name, p)][li],
                    "A": _grid(A, bits, red), "B": dims.scaling[p] * _grid(B, bits, red)}
            self.layers.append(layer)
        self.ln_f = (params["ln_f"]["g"][p], params["ln_f"]["b"][p])
        self.wte, self.wpe = params["wte"].to(torch.float32), params["wpe"]

    def _linear(self, x, lin, act, n_prompt):
        """The rows before `n_prompt` are the prefill's, whose LoRA factors
        are held in the activation precision; decode keeps their codes."""
        y = fq_minmax(x, lin["xs"], self.bits) @ lin["w"] + lin["b"]
        lora = lambda t, A, B: round_to(round_to(t, act) @ A, act) @ B
        R = lambda t: round_to(t, act)
        return y + torch.cat([lora(x[:n_prompt], R(lin["A"]), R(lin["B"])),
                              lora(x[n_prompt:], lin["A"], lin["B"])])

    def _prefill_attention(self, q, k, v, act):
        T, d = q.shape
        H, D = self.dims.H, self.dims.D
        heads = lambda t: t.reshape(T, H, D).transpose(0, 1)
        bucket = 8
        while bucket < T:
            bucket *= 2
        lowp = (lambda t: round_to(t, act)) if bucket < 128 else (lambda t: t)
        s = heads(q) @ heads(lowp(k)).transpose(-1, -2) / math.sqrt(D)
        causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
        return (lowp(p) @ heads(lowp(v))).transpose(0, 1).reshape(T, d)

    def _kv_codes(self, t, n_prompt, act):
        """Per-row codes and scales of K or V rows: the prompt's as the
        prefill stored them (in the activation precision), the rest as
        computed."""
        rows = torch.cat([round_to(t[:n_prompt], act), t[n_prompt:]])
        qmax = 2.0 ** (self.kv_bits - 1) - 1.0
        scale = torch.clamp(rows.abs().amax(-1), min=1e-8) / qmax
        return torch.clamp(torch.round(rows / scale[:, None]), -qmax, qmax), scale

    def _decode_attention(self, q, k, v, n_prompt, act):
        """Attention of the generated positions (see the module doc)."""
        T, d = q.shape
        H, D = self.dims.H, self.dims.D
        if T <= n_prompt:
            return q.new_zeros((0, d))
        dev = q.device
        kc, ks = self._kv_codes(k, n_prompt, act)
        vc, vs = self._kv_codes(v, n_prompt, act)
        pos = torch.arange(n_prompt, T, device=dev)                    # query positions
        l0 = n_prompt + (pos - n_prompt) // self.chunk * self.chunk    # chunk starts
        qf = (q[n_prompt:] / math.sqrt(D)).reshape(-1, H, D).transpose(0, 1)   # (H, Q, D)
        qs = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-8) / 127.0
        qcode = torch.clamp(torch.round(qf / qs), -127, 127)
        kh = kc.reshape(T, H, D).transpose(0, 1)                        # (H, T, D)
        s = (qcode @ kh.transpose(-1, -2)) * qs * ks                    # (H, Q, T)
        t = torch.arange(T, device=dev)[None]
        n_main = -(-int(l0.max()) // self.block)
        blk = torch.where(t < l0[:, None], t // self.block,
                          torch.full_like(t.expand(len(pos), T), n_main))
        valid = t < pos[:, None]
        dump = n_main + 1                                               # invalid keys
        blk = torch.where(valid, blk, torch.full_like(blk, dump)).expand(H, -1, -1)
        s = s.masked_fill(~valid, float("-inf"))
        bmax = torch.full((H, len(pos), dump + 1), float("-inf"), device=dev)
        bmax = bmax.scatter_reduce(2, blk, s, reduce="amax")[..., :dump]
        m_run = torch.cummax(bmax, dim=2).values
        m_last = m_run[..., -1:]
        m_t = torch.gather(torch.cat([m_run, m_last], 2), 2, blk)
        p = torch.where(valid, torch.exp(s - m_t), torch.zeros_like(s))
        pscaled = p * vs
        ps = torch.zeros((H, len(pos), dump + 1), device=dev).scatter_reduce(
            2, blk, pscaled, reduce="amax")
        ps = torch.clamp(ps, min=1e-30) / 127.0
        pq = torch.round(pscaled / torch.gather(ps, 2, blk))
        # rescale each block from its running max to the last: exp(m_b - m_last)
        corr = torch.where(valid, torch.exp(m_t - m_last), torch.zeros_like(s))
        acc = (pq * torch.gather(ps, 2, blk) * corr) @ vc.reshape(T, H, D).transpose(0, 1)
        lsum = (p * corr).sum(-1)
        # the new row itself, merged in float32 from its dequantized codes
        kn = (kc * ks[:, None])[n_prompt:].reshape(-1, H, D).transpose(0, 1)
        vn = (vc * vs[:, None])[n_prompt:].reshape(-1, H, D).transpose(0, 1)
        s_new = (qf * kn).sum(-1)
        m_prev = torch.nan_to_num(m_last[..., 0], neginf=-1e30)
        m_f = torch.maximum(m_prev, s_new)
        c = torch.exp(m_prev - m_f)
        p_new = torch.exp(s_new - m_f)
        out = (acc * c[..., None] + p_new[..., None] * vn) / (lsum * c + p_new)[..., None]
        return out.transpose(0, 1).reshape(-1, d)

    def _head(self, h, head_bits):
        qmax = 2.0 ** (head_bits - 1) - 1.0
        w_s = torch.clamp(self.wte.abs().amax(dim=1), min=1e-8) / qmax
        codes = torch.clamp(torch.round(self.wte / w_s[:, None]), -qmax, qmax)
        x_s = torch.clamp(h.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
        qh = torch.clamp(torch.round(h / x_s), -127, 127)
        return (qh @ codes.T) * x_s * w_s

    @torch.no_grad()
    def logits(self, ids, n_prompt: int, head_bits=None, act: str = "bf16"):
        """(T, V) float32 logits of one sequence `ids` (T,) whose first
        `n_prompt` tokens are the prompt; `head_bits` replaces the head's
        bits and `act` the activation precision (the controls)."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(ids, n_prompt, head_bits or self.head_bits, act)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _logits(self, ids, n_prompt, head_bits, act):
        dims = self.dims
        T, d, H, D = ids.shape[0], dims.d, dims.H, dims.D
        R = lambda t: round_to(t, act)
        h = R(R(self.wte[ids]) + R(self.wpe[:T]))
        for layer in self.layers:
            x = R(layer_norm(h, *layer["ln1"], dims.eps))
            q, k, v = self._linear(x, layer["c_attn"], act, n_prompt).split(d, dim=-1)
            a = torch.cat([self._prefill_attention(q[:n_prompt], k[:n_prompt], v[:n_prompt], act),
                           self._decode_attention(q, k, v, n_prompt, act)])
            h = R(h + R(self._linear(R(a), layer["attn_proj"], act, n_prompt)))
            x = R(layer_norm(h, *layer["ln2"], dims.eps))
            y = self._linear(x, layer["c_fc"], act, n_prompt)
            f = R(torch.cat([F.gelu(y[:n_prompt]), gelu_as(y[n_prompt:])]))
            h = R(h + R(self._linear(f, layer["mlp_proj"], act, n_prompt)))
        return self._head(R(layer_norm(h, *self.ln_f, dims.eps)), head_bits)


def served_gaps(logits, tokens):
    """Per served token, how far its logit lies below the row's best:
    logits (n, V) at the positions before each of `tokens` (n,)."""
    best = logits.max(dim=-1).values
    return best - logits.gather(-1, tokens[:, None])[:, 0]
