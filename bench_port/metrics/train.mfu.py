"""train.mfu: the SP step's required operations over the unprofiled
iteration time and the card's bf16 peak, in %.

Counted from shapes, per data token of a micro-step: the forward's
linears (24·d²·L), LoRA at a student slot (32·d·r·L), causal attention
(2·(T+1)·d·L: q·kᵀ and p·v over (t+1) keys at position t) and the tied
head (2·d·V); the backward's dX through every product, dW of the linears
and of LoRA, and attention's four products (twice the forward's), but no
dW of the frozen head and nothing recomputed. An iteration is the teacher
micro-step (32 bits, LoRA off) and accum - 1 students on B·T tokens.
"""

from bench_port.harness.peaks import peaks_of


def microstep_flops_per_token(d, L, V, T, r, student: bool) -> int:
    lora = 32 * d * r * L if student else 0
    attn = 2 * (T + 1) * d * L
    fwd = 24 * d * d * L + lora + attn + 2 * d * V
    bwd = 48 * d * d * L + 2 * lora + 2 * attn + 2 * d * V
    return fwd + bwd


def iteration_flops(config: dict, traffic: dict) -> int:
    d, L, V = config["n_embd"], config["n_layer"], config["vocab_size"]
    T, B, r = traffic["seq_len"], traffic["batch_size"], config["quant"]["lora_rank"]
    per_token = (microstep_flops_per_token(d, L, V, T, r, False)
                 + (traffic["accum"] - 1) * microstep_flops_per_token(d, L, V, T, r, True))
    return per_token * B * T


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    if peaks is None:
        return None
    flops = iteration_flops(ctx["config"], ctx["traffic"])
    return 100.0 * flops / (ctx["window"]["iter_s"] * peaks["bf16_flops"])
