"""serve.mfu: the window's served tokens against the card's peaks, in %:
the time the products they require would take at the peak of their type,
over the window.

Integer products run at the int8 peak (1979 TOP/s on the H100): the b-bit
linears (24·d²·L a token), decode's int8 LoRA banks (32·d·r·L a token),
decode's attention over 8-bit query and probability codes (4·d·c·L for a
token that attends c rows) and the 8-bit head (2·d·V). Float products run
at the bf16 peak (989 TFLOP/s), the configuration's compute type: the
prefill's LoRA (32·d·r·L a token) and its causal attention
(2·d·L·T0·(T0+1) for T0 tokens). A prefill computes the head at its last
position only. The window's tokens are each request's tokens that reached
the host inside it: token 0 from the prefill, token i from a decode step
over T0 + i rows."""

from bench_port.harness.peaks import peaks_of


def prefill_ops(T0, d, L, V, r):
    """(integer operations, float operations) of a prefill of T0 tokens."""
    return T0 * 24 * d * d * L + 2 * d * V, T0 * 32 * d * r * L + 2 * d * L * T0 * (T0 + 1)


def decode_ops(c, d, L, V, r):
    """(integer operations, float operations) of a token attending c rows."""
    return 24 * d * d * L + 32 * d * r * L + 4 * d * c * L + 2 * d * V, 0


def window_ops(config: dict, prefills, contexts):
    """(integer operations, float operations) of the window's tokens."""
    d, L, V, r = (config["n_embd"], config["n_layer"], config["vocab_size"],
                  config["quant"]["lora_rank"])
    parts = [prefill_ops(t, d, L, V, r) for t in prefills] \
        + [decode_ops(c, d, L, V, r) for c in contexts]
    return sum(p[0] for p in parts), sum(p[1] for p in parts)


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    if peaks is None:
        return None
    w = ctx["window"]
    int_ops, float_ops = window_ops(ctx["config"], w["prefills"], w["decode_contexts"])
    at_peak = int_ops / peaks["int8_ops"] + float_ops / peaks["bf16_flops"]
    return 100.0 * at_peak / w["seconds"]
