"""The one generator of the benchmark's inputs, from a mix file and a seed.

Training mixes (`kind: train`): a ring of seeded batches of ids made on
the device, the calibration batches, and for every step the student slots
and feature layers, drawn on the host.

Serving mixes (`kind: serve`): an open loop. Every seed serves the same
set of request sizes and the same set of gaps between arrivals, each in
its own order. The sizes are `strata` (prompt, new tokens) pairs at the
quantiles of their distributions, prompt lengths paired with new token
counts by a fixed stride permutation; the gaps are `strata` quantiles of
the exponential distribution at the mix's rate (Poisson arrivals). The
prompt ids are drawn from the seed. The warm-up wave holds one request of
every prefill bucket the window uses.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np
import torch

_SALT_STEPS, _SALT_ORDER, _SALT_IDS, _SALT_CHECK = 0x51, 0x52, 0x53, 0x54


def host_rng(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


# -- training -----------------------------------------------------------------


def train_data(traffic: dict, vocab: int, gen: torch.Generator, device):
    """(ring (R, B, T), calibration batches [(B, T)]) drawn from `gen`."""
    B, T = traffic["batch_size"], traffic["seq_len"]
    n = traffic["ring"] + traffic["calibration_batches"]
    ids = torch.randint(0, vocab, (n, B, T), generator=gen, device=device)
    return ids[: traffic["ring"]], list(ids[traffic["ring"]:])


class StudentDraws:
    """Each step's student slots and feature layers: accum - 1 slots drawn
    from the student bit-widths, layers from [0, n_layer]."""

    def __init__(self, traffic: dict, student_slots: List[int], n_layer: int, seed: int):
        self.n = traffic["accum"] - 1
        self.slots = np.asarray(student_slots)
        self.n_layer = n_layer
        self.rng = host_rng(seed, _SALT_STEPS)

    def next(self) -> Tuple[List[int], List[int]]:
        slots = self.slots[self.rng.integers(0, len(self.slots), self.n)]
        layers = self.rng.integers(0, self.n_layer + 1, self.n)
        return [int(s) for s in slots], [int(x) for x in layers]


# -- serving ------------------------------------------------------------------


def _quantiles(spec: dict, n: int) -> np.ndarray:
    """n values of a log-normal distribution, given by its mean and the
    sigma of its logarithm, at the quantiles (i + 0.5) / n, rounded and
    clipped to [min, max]."""
    if spec["dist"] != "log_normal":
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.exp(math.log(spec["mean"]) - 0.5 * spec["sigma"] ** 2 + spec["sigma"] * z)
    return np.clip(np.rint(v), spec["min"], spec["max"]).astype(np.int64)


def request_sizes(traffic: dict) -> List[Tuple[int, int]]:
    """The mix's (prompt length, new tokens) pairs, sorted by prompt: prompt
    lengths paired with new-token counts by a fixed stride permutation, the
    new tokens cut to what the context leaves (`max_len` - prompt - 1)."""
    n = traffic["strata"]
    prompts = _quantiles(traffic["prompt_len"], n)
    news = _quantiles(traffic["new_tokens"], n)
    stride = next(s for s in range(n // 2 + 1, n) if math.gcd(s, n) == 1)
    room = traffic["max_len"] - 1
    return [(int(prompts[i]), int(min(news[(i * stride) % n], room - prompts[i])))
            for i in range(n)]


def arrival_gaps(traffic: dict) -> np.ndarray:
    """The mix's `strata` gaps between arrivals, in seconds: a Poisson
    process at `rate_per_s`, as the exponential distribution's quantiles."""
    n = traffic["strata"]
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / traffic["rate_per_s"]


def warmup_sizes(traffic: dict) -> List[Tuple[int, int]]:
    """One request of each prefill bucket (powers of two from 8) that the
    mix's prompts fall in: its shortest prompt there, with the fewest new
    tokens of the mix."""
    sizes = request_sizes(traffic)
    few = min(k for _, k in sizes)
    first = {}
    for p, _ in sizes:
        first.setdefault(1 << max(3, (p - 1).bit_length()), p)
    return [(p, few) for p in first.values()]


def cycle_order(n: int, blocks: int, rng: np.random.Generator) -> List[int]:
    """One cycle through n sizes sorted by prompt: `blocks` blocks, block b
    holding every blocks-th size from b, so that each spans the whole
    range; the blocks and the sizes within each in orders drawn by rng."""
    return [int(i) for b in rng.permutation(blocks)
            for i in rng.permutation(np.arange(b, n, blocks))]


def request_stream(traffic: dict, vocab: int, seed: int
                   ) -> Iterator[Tuple[float, np.ndarray, int]]:
    """(arrival offset in s, prompt ids, new tokens) forever. Each cycle
    holds every size of the set and every gap of `arrival_gaps` once: the
    sizes in an order drawn from the seed (`cycle_order` over blocks of
    `block` sizes, so any stretch of requests holds nearly the same mix of
    sizes for every seed), the gaps in another; prompt ids from the seed."""
    sizes, gaps = request_sizes(traffic), arrival_gaps(traffic)
    order_rng, ids_rng = host_rng(seed, _SALT_ORDER), host_rng(seed, _SALT_IDS)
    blocks = max(1, len(sizes) // traffic["block"])
    t = 0.0
    while True:
        gap_order = order_rng.permutation(len(gaps))
        for j, i in enumerate(cycle_order(len(sizes), blocks, order_rng)):
            n_prompt, n_new = sizes[i]
            t += float(gaps[gap_order[j]])
            yield (t, ids_rng.integers(0, vocab, n_prompt, dtype=np.int64).astype(np.int32),
                   n_new)


def check_sample(n_done: int, longest: int, k: int, seed: int) -> List[int]:
    """k indices among n_done finished requests, drawn from the seed, the
    longest among them."""
    rng = host_rng(seed, _SALT_CHECK)
    rest = [i for i in rng.permutation(n_done).tolist() if i != longest]
    return [longest] + rest[: max(0, k - 1)]
