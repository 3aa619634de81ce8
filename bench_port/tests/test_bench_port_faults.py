"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven at the tiny
size on the CPU against each cell's own limits. One fault a kind the cell
can have: a train step that returns its state unchanged, a step that sees
half its batch (the mean taken over the rest), a served token altered
where the engine produces it. (No cell spans chips: there is no exchange
between chips to leave out.)"""

import time

import pytest
import torch

from bench_port.run import run_cell
from bench_port.tests.tiny import tiny_cell, workloads


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def unchanged(step):
    def broken(state, ids, gen, **kw):
        _, metrics = step(state, ids, gen, **kw)
        return state, metrics
    return broken


def half_batch(step):
    def broken(state, ids, gen, **kw):
        return step(state, ids[: ids.shape[0] // 2], gen, **kw)
    return broken


def altered_token(eng):
    run_chunk = eng._run_chunk

    def broken(k, active):
        toks = run_chunk(k, active)
        toks[:, k // 2] = (toks[:, k // 2] + 1) % eng.cfg.model.vocab_size
        return toks
    eng._run_chunk = broken
    return eng


def _run(workload, faults, seed=4242):
    return run_cell(tiny_cell(workload), seed, 1.5, False, torch.device("cpu"),
                    time.perf_counter(), faults=faults)


@pytest.mark.parametrize("workload", workloads("train"))
@pytest.mark.parametrize("fault,number", [(unchanged, "change"), (half_batch, "grad1")])
def test_broken_train_step_is_not_correct(workload, fault, number):
    res = _run(workload, fault)
    assert res["correct"] is False
    assert res["checks"][number]["ok"] is False


@pytest.mark.parametrize("workload", workloads("serve"))
def test_altered_token_is_not_correct(workload):
    res = _run(workload, altered_token)
    assert res["correct"] is False
    assert res["checks"]["served_gap"]["ok"] is False
