"""train.device_idle_share: the share of an unprofiled iteration in which
no operation ran on the card, in %: 1 - (device busy seconds of the
profiled iterations, the union of their kernel, copy and set intervals,
per iteration) / (the window's wall time per iteration). Records the
profiler drops make it read high."""


def read(ctx):
    busy = ctx["busy_s"] / ctx["slice"]["iterations"]
    return 100.0 * (1.0 - busy / ctx["window"]["iter_s"])
