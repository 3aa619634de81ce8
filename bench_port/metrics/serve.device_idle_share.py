"""serve.device_idle_share: the share of an unprofiled chunk in which no
operation ran on the card, in %: 1 - (device busy seconds of the profiled
chunks, the union of their kernel, copy and set intervals, per chunk) /
(the window's wall time per chunk, prefills and bookkeeping included).
The profiled chunks take the schedule's arrivals at the window's pace, so
each holds the prefills of a chunk of the window."""


def read(ctx):
    busy = ctx["busy_s"] / len(ctx["slice"]["chunks"])
    return 100.0 * (1.0 - busy / ctx["window"]["chunk_s"])
