"""serve.slot_occupancy: generated tokens kept over decode slot-steps in
the window, in %: (tokens that reached the host from decode steps in the
window's chunks) / (decode steps run in them x slots). A slot-step is
wasted in a free slot, or after its request ended mid-chunk. Read from the
engine's `decode_steps` counter and the requests' tokens."""


def read(ctx):
    w = ctx["window"]
    if not w["decode_steps"]:
        return None
    return 100.0 * w["decode_tokens"] / (w["decode_steps"] * w["slots"])
