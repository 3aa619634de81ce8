"""The generator: the same seed gives the same inputs, another seed other
ones, and every seed serves the same set of request sizes."""

import itertools

import numpy as np
import pytest
import torch

from bench_port.harness import traffic as tr
from bench_port.tests.tiny import tiny_cell, workloads

SEEDS = (7, 2 ** 31 + 12345)


def _train_inputs(seed):
    cell = tiny_cell("gpt2-124m.train-sp-vmap")
    gen = torch.Generator().manual_seed(seed)
    ring, cal = tr.train_data(cell.traffic, 512, gen, "cpu")
    draws = tr.StudentDraws(cell.traffic, [0, 1], 2, seed)
    return ring, cal, [draws.next() for _ in range(6)]


def test_train_inputs_repeat_from_a_seed_and_differ_across_seeds():
    a, b, c = _train_inputs(SEEDS[0]), _train_inputs(SEEDS[0]), _train_inputs(SEEDS[1])
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0]) and a[2] == b[2]
    assert not torch.equal(a[0], c[0]) and a[2] != c[2]
    ring, cal, draws = a
    assert ring.shape == (4, 2, 128) and len(cal) == 1
    # every row of the ring differs
    rows = ring.reshape(-1, 128)
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    # three students a step, slots among the students, layers in [0, L]
    assert all(len(s) == 3 and set(s) <= {0, 1} and set(l) <= {0, 1, 2} for s, l in draws)


def _stream(seed, n, workload=None):
    cell = tiny_cell(workload or workloads("serve")[0])
    return list(itertools.islice(tr.request_stream(cell.traffic, 512, seed), n))


def test_serve_stream_repeats_from_a_seed_and_differs_across_seeds():
    a, b, c = _stream(SEEDS[0], 20), _stream(SEEDS[0], 20), _stream(SEEDS[1], 20)
    assert all(x[0] == y[0] and np.array_equal(x[1], y[1]) and x[2] == y[2]
               for x, y in zip(a, b))
    assert any(not np.array_equal(x[1], y[1]) for x, y in zip(a, c))
    assert [x[0] for x in a] != [x[0] for x in c]


def test_every_seed_serves_the_same_sizes_and_gaps_in_another_order():
    cell = tiny_cell(workloads("serve")[0])
    n = cell.traffic["strata"]
    sizes = sorted(tr.request_sizes(cell.traffic))
    gaps = sorted(tr.arrival_gaps(cell.traffic))
    orders = []
    for seed in SEEDS:
        cycle = _stream(seed, n)
        assert sorted((len(p), k) for _, p, k in cycle) == sizes
        t = [0.0] + [off for off, _, _ in cycle]
        assert np.allclose(sorted(np.diff(t)), gaps)
        orders.append([(len(p), k) for _, p, k in cycle])
    assert orders[0] != orders[1]


@pytest.mark.parametrize("workload", workloads("serve"))
def test_sizes_and_arrivals_follow_the_mix(workload):
    from bench_port.harness.spec import load_cell
    mix = load_cell(workload).traffic
    sizes = tr.request_sizes(mix)
    assert len(sizes) == mix["strata"]
    assert all(4 <= p <= 768 and 8 <= k and p + k < mix["max_len"] for p, k in sizes)
    # log-normal about the source's means: the median prompt near
    # mean / exp(sigma^2 / 2); the means a little under the source's, cut
    # by the context
    med = float(np.median([p for p, _ in sizes]))
    assert abs(med - 162 / np.exp(0.5)) < 3
    assert 140 < np.mean([p for p, _ in sizes]) <= 162
    assert 250 < np.mean([k for _, k in sizes]) <= 338
    # Poisson at the mix's rate: the mean gap is 1 / rate
    assert abs(np.mean(tr.arrival_gaps(mix)) * mix["rate_per_s"] - 1) < 0.02
    # the warm-up wave prefills every bucket the window uses (powers of two from 8)
    bucket = lambda n: 1 << max(3, (n - 1).bit_length())
    assert sorted(bucket(p) for p, _ in tr.warmup_sizes(mix)) == sorted(
        {bucket(p) for p, _ in sizes})


def test_check_sample_holds_the_longest():
    pick = tr.check_sample(20, 13, 6, 99)
    assert pick[0] == 13 and len(set(pick)) == 6 and all(0 <= i < 20 for i in pick)
    assert pick == tr.check_sample(20, 13, 6, 99)
