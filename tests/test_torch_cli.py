"""PyTorch port: the SP command line `main_sp` (`--tiny`, on the CPU)
against the JAX package's formats: per-bit checkpoints that the JAX
package loads, `--checkpoint` from a JAX-written file, the stats JSON's
keys, and an `--auto-resume` run equal bit for bit to an uninterrupted one."""

import json
import sys
import types

import jax
import numpy as np
import pytest
import torch

import llm_qat_tpu.deploy as JD
import llm_qat_tpu.models as J
from llm_qat_tpu.utils.stats import StatsTracker as JStatsTracker
from llm_qat_tpu_torch.cli import main_sp
from llm_qat_tpu_torch.deploy import elastic
from llm_qat_tpu_torch.models import config as tc

@pytest.fixture(autouse=True)
def no_hub(monkeypatch):
    """A `transformers` stand-in whose tokenizer load fails as an offline
    load does, so `main_sp` never asks the hub, whatever the process
    imported before (the hub library reads HF_HUB_OFFLINE once, at its
    import): the byte tokenizer, as offline."""
    def fail(*a, **k):
        raise OSError("offline")

    monkeypatch.setitem(sys.modules, "transformers", types.SimpleNamespace(
        GPT2TokenizerFast=types.SimpleNamespace(from_pretrained=fail)))


COMMON = ["--tiny", "--batch-size", "2", "--max-seq-length", "32", "--grad-accum", "2",
          "--bit-widths", "4", "32"]


def _run(out, *extra):
    return main_sp.main(COMMON + ["--output-dir", str(out), *extra], device="cpu")


def _assert_states_equal(a, b):
    la, lb = elastic.tree_leaves(a), elastic.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


def _keys(tree):
    """Nested key structure of a JSON object (lists by their first item)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    if isinstance(tree, list) and tree and isinstance(tree[0], dict):
        return [_keys(tree[0])]
    return None


def test_tiny_run_per_bit_checkpoints_and_stats(tmp_path, capsys):
    state, stats = _run(tmp_path, "--num-iterations", "3", "--eval-interval", "2",
                        "--bit-widths", "4", "8", "32")
    out = capsys.readouterr().out
    assert "train windows: 661, val windows: 190" in out
    assert "iter 0: loss=" in out and "  eval@2: 4bit=" in out
    assert state.step == 3 and len(stats.iteration_losses) == 3
    assert all(np.isfinite(stats.iteration_losses))
    assert sum(stats.precision_counts.values()) == 3  # one student a step
    assert set(stats.precision_counts) <= {4, 8}
    for bits in (4, 8):
        params, meta = JD.load_checkpoint(tmp_path / f"sp_{bits}bit.npz")
        assert meta["bit_width"] == bits
        assert meta["config"]["quant"]["bit_widths"] == [4, 8, 32]
        flat = jax.tree_util.tree_leaves_with_path(params)
        assert len(flat) == len(elastic.tree_leaves(state.params))
        for path, leaf in flat:
            t = state.params
            for k in path:
                t = t[k.key]
            np.testing.assert_array_equal(np.asarray(leaf), t.numpy())
    assert not (tmp_path / "sp_32bit.npz").exists()

    # the stats JSON: the JAX package's keys, and its config dicts
    (path,) = tmp_path.glob("training_stats_*.json")
    data = json.loads(path.read_text())
    jcfg = J.tiny_test_config((4, 8, 32))
    jt = J.TrainConfig(batch_size=2, max_seq_length=32, num_iterations=3,
                       gradient_accumulation_steps=2, eval_interval=2)
    js = JStatsTracker(jcfg.quant.bit_widths)
    js.record_iteration(1.0, 1e-4)
    js.record_precision_usage(4)
    js.record_eval(2, {"val_loss": {"4": 1.0}})
    js.save(str(tmp_path / "jax_stats.json"), jcfg, jt)
    want = json.loads((tmp_path / "jax_stats.json").read_text())
    assert set(data) == set(want)
    assert _keys(data["eval_results"][0]) == {"iteration": None,
                                              "val_loss": {"4": None, "8": None, "32": None}}
    assert _keys(want["eval_results"][0]).keys() == _keys(data["eval_results"][0]).keys()
    assert data["model_config"] == want["model_config"]
    assert data["training_config"] == want["training_config"]
    assert data["memory_mb"] == [0.0] * 3  # CPU run
    assert [e["iteration"] for e in data["eval_results"]] == [2]


class Preempted(Exception):
    pass


def _preempted_run(monkeypatch, out, after, *flags):
    """`main_sp` stopped before iteration `after` as a preemption would stop
    it, once the elastic save it started has landed. Returns the number of
    train steps taken."""
    steps, managers = [], []
    make = main_sp.make_sp_train_step

    def make_preemptible(*a, **k):
        init_state, step = make(*a, **k)

        def train_step(*sa, **sk):
            if len(steps) == after:
                raise Preempted
            steps.append(1)
            return step(*sa, **sk)

        return init_state, train_step

    class Manager(main_sp.AsyncCheckpointManager):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            managers.append(self)

    with monkeypatch.context() as m:
        m.setattr(main_sp, "make_sp_train_step", make_preemptible)
        m.setattr(main_sp, "AsyncCheckpointManager", Manager)
        with pytest.raises(Preempted):
            _run(out, *flags)
    for mgr in managers:
        mgr.wait()
    return len(steps)


def test_auto_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A 5-iteration run with elastic saves, preempted after 3 iterations
    and relaunched with --auto-resume, against 5 uninterrupted: every
    parameter, both AdamW moments, the count and the step equal bit for
    bit. (The learning-rate schedule spans --num-iterations, so the
    relaunch repeats the preempted command.)"""
    flags = ["--num-iterations", "5", "--eval-interval", "2"]
    resume = ["--save-every", "1", "--auto-resume"]
    assert _preempted_run(monkeypatch, tmp_path / "a", 3, *flags, *resume) == 3
    assert sorted(p.name for p in (tmp_path / "a" / "elastic").iterdir()) == [
        f"step_{s:010d}.npz" for s in (0, 1, 2)]
    assert not list((tmp_path / "a").glob("sp_*bit.npz"))
    resumed, s2 = _run(tmp_path / "a", *flags, *resume)
    assert len(s2.iteration_losses) == 2  # resumed at iteration 3
    assert resumed.step == 5 and type(resumed.step) is int
    full, s3 = _run(tmp_path / "b", *flags)
    assert s3.iteration_losses[3:] == s2.iteration_losses
    _assert_states_equal(resumed, full)


def test_auto_resume_continues_a_shorter_run(tmp_path):
    """The JAX package's flow: 3 iterations, then the command relaunched
    with --num-iterations 5 --auto-resume records only the last 2."""
    common = ["--save-every", "1", "--auto-resume"]
    first, s1 = _run(tmp_path, "--num-iterations", "3", *common)
    assert len(s1.iteration_losses) == 3 and first.step == 3
    state, stats = _run(tmp_path, "--num-iterations", "5", *common)
    assert len(stats.iteration_losses) == 2
    assert state.step == 5 and int(state.opt_state.count) == 5
    assert not torch.equal(first.params["blocks"]["c_fc"]["w"],
                           state.params["blocks"]["c_fc"]["w"])


def test_checkpoint_flag_resumes_from_jax_file(tmp_path, capsys):
    jcfg = J.tiny_test_config((4, 32))
    jp = J.init_sp_params(jax.random.PRNGKey(7), jcfg)
    path = tmp_path / "jax_4bit.npz"
    JD.save_checkpoint(path, jp, jcfg, bit_width=4)
    state, stats = _run(tmp_path / "out", "--num-iterations", "1",
                        "--checkpoint", str(path))
    assert f"resumed from {path} (bit=4)" in capsys.readouterr().out
    assert len(stats.iteration_losses) == 1 and np.isfinite(stats.iteration_losses[0])
    # frozen leaves come out of training as the JAX file held them
    for name in ("wte", "wpe"):
        np.testing.assert_array_equal(state.params[name].numpy(), np.asarray(jp[name]))
    lin = state.params["blocks"]["c_attn"]
    assert not np.array_equal(lin["w"].numpy(), np.asarray(jp["blocks"]["c_attn"]["w"]))


def test_iteration_generator_is_a_function_of_seed_and_iteration():
    draw = lambda s, it: torch.rand(4, generator=main_sp.iteration_generator(s, it, "cpu"))
    assert torch.equal(draw(1, 3), draw(1, 3))
    assert not torch.equal(draw(1, 3), draw(1, 4))
    assert not torch.equal(draw(1, 3), draw(2, 3))
    assert torch.equal(draw(-1, 0), draw(-1, 0))


def test_flags_and_defaults_match_jax():
    from llm_qat_tpu.cli.main_sp import build_arg_parser as jax_parser

    def table(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.type, a.nargs)
                for a in p._actions if a.dest != "help"}

    assert table(main_sp.build_arg_parser()) == table(jax_parser())


def test_main_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_sp.main(COMMON + ["--output-dir", str(tmp_path), "--num-iterations", "1"])
    assert not any(tmp_path.iterdir())


def test_full_size_config_matches_jax(monkeypatch):
    """The GPT-2 124M config main_sp builds without --tiny (bf16 on the
    card, float32 on the CPU), against the JAX package's on the TPU and on
    the CPU: same fields. Nothing is built at that size here."""
    captured = {}

    def stop(params, cfg, tables):
        captured["cfg"] = cfg
        raise KeyboardInterrupt

    monkeypatch.setattr(main_sp, "init_sp_params", lambda gen, cfg, device: stop(0, cfg, 0))
    with pytest.raises(KeyboardInterrupt):
        main_sp.main(["--bit-widths", "4", "8", "32", "--lora-rank", "16"], device="cpu")
    cfg = captured["cfg"]
    want = J.SPModelConfig(
        model=J.GPT2Config(),
        quant=J.QuantConfig(bit_widths=(4, 8, 32),
                            lora_rank_per_bit={b: 16 for b in range(2, 17)} | {32: 0},
                            lora_alpha_per_bit={b: 64 for b in range(2, 17)} | {32: 0}),
        compute_dtype="float32", scan_unroll=12)
    from llm_qat_tpu.deploy.checkpoint import _config_to_dict as jdict
    from llm_qat_tpu_torch.deploy.checkpoint import _config_to_dict as tdict
    assert tdict(cfg) == jdict(want)
    assert isinstance(cfg, tc.SPModelConfig)
