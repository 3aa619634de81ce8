"""PyTorch port: checkpoints across packages, per-bit files, the int8
export and the elastic manager (`llm_qat_tpu_torch/deploy/`).

A checkpoint either package writes loads in the other, key for key and bit
for bit, and the port's SP forward on it matches JAX's within the limits of
`test_torch_sp_model.py` (logits 2e-4 absolute, loss 1e-5 relative, float32)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.deploy as JD
import llm_qat_tpu.models as J
from llm_qat_tpu.train import calibration_manager as jcm
import llm_qat_tpu_torch.deploy as TD
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.deploy import elastic
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train.sp_trainer import SPTrainState, make_sp_train_step


@pytest.fixture(scope="module")
def pair():
    """Calibrated JAX tiny params (LoRA B non-zero) and both configs; the
    8-bit slot minmax, as in `test_torch_sp_model.py` (at the log kind
    XLA's and PyTorch's float32 log2 differ by an ulp, which moves a code
    on a boundary)."""
    q = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"},
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=64, n_embd=32, n_layer=2, n_head=2)
    jcfg = J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q))
    tcfg = tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q))
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    jp = jcm.calibrate_weight_quantizers(jax.tree.map(jnp.asarray, p), jcfg)
    batches = [jnp.asarray(rng.integers(0, 256, (2, 16))) for _ in range(2)]
    jp = jcm.calibrate_input_quantizers(jp, jcfg, batches)
    return jcfg, tcfg, jax.tree.map(np.asarray, jp)


def _assert_same_tree(t_tree, np_tree):
    """Same keys and every array equal, dtype and bits."""
    assert set(t_tree) == set(np_tree)
    for k, v in np_tree.items():
        if isinstance(v, dict):
            _assert_same_tree(t_tree[k], v)
        else:
            got = t_tree[k]
            got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
            assert got.dtype == v.dtype and got.shape == v.shape, k
            np.testing.assert_array_equal(got, v, err_msg=k)


def _forwards_match(tparams, jparams, jcfg, tcfg):
    ids = np.random.default_rng(5).integers(0, 256, (2, 24))
    for prec in range(3):
        jl = J.sp_forward(jax.tree.map(jnp.asarray, jparams), jnp.asarray(ids), prec,
                          jcfg, labels=jnp.asarray(ids))
        tl = tsp.sp_forward(tparams, torch.tensor(ids), prec, tcfg,
                            labels=torch.tensor(ids))
        np.testing.assert_allclose(tl["logits"].numpy(), np.asarray(jl["logits"]),
                                   atol=2e-4, err_msg=f"prec {prec}")
        np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-5)


def test_jax_checkpoint_loads_in_port(pair, tmp_path):
    jcfg, tcfg, jp = pair
    path = tmp_path / "jax.npz"
    assert JD.save_checkpoint(path, jax.tree.map(jnp.asarray, jp), jcfg, bit_width=8,
                              extra={"note": "x"})
    tp, meta = TD.load_checkpoint(path, device="cpu")
    assert meta["bit_width"] == 8 and meta["extra"] == {"note": "x"}
    assert meta["config"]["model"]["n_embd"] == tcfg.model.n_embd
    _assert_same_tree(tp, jp)
    assert tp["blocks"]["c_fc"]["w"].device.type == "cpu"
    _forwards_match(tp, jp, jcfg, tcfg)


def test_port_checkpoint_loads_in_jax(pair, tmp_path):
    jcfg, tcfg, jp = pair
    tp = bridge.params_from_numpy(jp, "cpu")
    path = tmp_path / "port"  # no suffix: ".npz" is appended, as in JAX
    assert TD.save_checkpoint(path, tp, tcfg, bit_width=4)
    loaded, meta = JD.load_checkpoint(path)
    loaded = jax.tree.map(np.asarray, loaded)
    _assert_same_tree(bridge.params_from_numpy(loaded, "cpu"), jp)
    assert meta["bit_width"] == 4
    # the config sidecar is the JAX package's, key for key
    jpath = tmp_path / "jax.npz"
    JD.save_checkpoint(jpath, jax.tree.map(jnp.asarray, jp), jcfg, bit_width=4)
    assert meta["config"] == JD.load_checkpoint(jpath)[1]["config"]
    with np.load(str(path) + ".npz") as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
    _forwards_match(bridge.params_from_numpy(loaded, "cpu"), jp, jcfg, tcfg)


def test_per_bit_files_and_meta_match_jax(pair, tmp_path):
    jcfg, tcfg, jp = pair
    tpaths = TD.save_per_bit_checkpoints(tmp_path / "t", bridge.params_from_numpy(jp, "cpu"),
                                         tcfg)
    jpaths = JD.save_per_bit_checkpoints(tmp_path / "j", jax.tree.map(jnp.asarray, jp), jcfg)
    assert sorted(tpaths) == sorted(jpaths) == [4, 8]
    for bits in (4, 8):
        assert tpaths[bits].endswith(f"sp_{bits}bit.npz")
        assert tpaths[bits].split("/")[-1] == jpaths[bits].split("/")[-1]
        tl, tm = TD.load_checkpoint(tpaths[bits], device="cpu")
        jl, jm = JD.load_checkpoint(jpaths[bits])
        assert tm["bit_width"] == jm["bit_width"] == bits
        assert tm["config"] == jm["config"] and tm["extra"] == jm["extra"] == {}
        _assert_same_tree(tl, jax.tree.map(np.asarray, jl))
    assert TD.save_per_bit_checkpoints(tmp_path / "o", bridge.params_from_numpy(jp, "cpu"),
                                       tcfg, prefix="x", bits_list=[8]) == {
        8: str(tmp_path / "o" / "x_8bit.npz")}


def test_export_int8_matches_jax(pair):
    jcfg, tcfg, jp = pair
    t_tree, t_rep = TD.export_int8(bridge.params_from_numpy(jp, "cpu"), tcfg)
    j_tree, j_rep = JD.export_int8(jax.tree.map(jnp.asarray, jp), jcfg)
    assert t_rep == j_rep and t_rep["compression_ratio"] > 1.0
    j_tree = jax.tree.map(np.asarray, j_tree)
    _assert_same_tree(t_tree, j_tree)
    assert t_tree["blocks"]["c_attn"]["w"]["int8"].dtype == np.int8
    assert t_tree["blocks"]["c_attn"]["lora_A"].dtype == np.float32


# -- AsyncCheckpointManager -------------------------------------------------


def _train_state(seed):
    """A port SPTrainState after one step: AdamW moments keyed by path
    tuples, an int32 count, an int step."""
    cfg = tc.tiny_test_config((4, 32))
    tcfg = tc.TrainConfig(batch_size=2, max_seq_length=16, gradient_accumulation_steps=2,
                          num_iterations=4)
    params = tsp.init_sp_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
    init_state, step = make_sp_train_step(cfg, tcfg, tsp.prec_tables(cfg.quant, "cpu"))
    ids = torch.randint(0, 256, (2, 16), generator=torch.Generator().manual_seed(seed))
    state, _ = step(init_state(params), ids, torch.Generator().manual_seed(seed))
    return init_state(params), state


def test_elastic_train_state_round_trip(tmp_path):
    template, state = _train_state(1)
    assert isinstance(state.step, int) and state.step == 1
    mgr = TD.AsyncCheckpointManager(tmp_path)
    mgr.save(1, state, meta={"tag": "a"})
    mgr.wait()
    got = mgr.restore_latest(template)
    assert got is not None
    step, restored, meta = got
    assert step == 1 and meta["step"] == 1 and meta["extra"] == {"tag": "a"}
    assert isinstance(restored, SPTrainState)
    assert type(restored.step) is int and restored.step == state.step
    assert int(restored.opt_state.count) == 1
    assert restored.opt_state.count.dtype == torch.int32
    assert set(restored.opt_state.mu) == set(state.opt_state.mu)
    assert all(isinstance(k, tuple) for k in restored.opt_state.mu)
    a, b = elastic.tree_leaves(state), elastic.tree_leaves(restored)
    assert len(a) == len(b) == meta["n_leaves"]
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device
            assert torch.equal(x, y)
        else:
            assert type(x) is type(y) and x == y
    # the moments restored under the right path tuples
    for p, v in state.opt_state.nu.items():
        assert torch.equal(restored.opt_state.nu[p], v)
    for p, v in optim.leaves_with_paths(state.params):
        assert torch.equal(optim.get_leaf(restored.params, p), v)


def test_elastic_bf16_and_scalars_round_trip(tmp_path):
    state = {"b": [torch.randn(3).to(torch.bfloat16), 2.5], "a": (7, True),
             "c": None}
    mgr = TD.AsyncCheckpointManager(tmp_path)
    mgr.save(5, state)
    mgr.wait()
    template = {"a": (0, False), "b": [torch.zeros(3, dtype=torch.bfloat16), 0.0],
                "c": None}
    _, got, _ = mgr.restore_latest(template)
    assert torch.equal(got["b"][0], state["b"][0]) and got["b"][0].dtype == torch.bfloat16
    assert got["b"][1] == 2.5 and got["a"] == (7, True) and got["c"] is None
    assert list(got) == ["a", "b", "c"]


def test_elastic_keep_gc_and_latest(tmp_path):
    mgr = TD.AsyncCheckpointManager(tmp_path, keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest({"x": torch.zeros(4)}) is None
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((4,), float(s))})
    mgr.wait()
    assert mgr.latest_step() == 4
    assert sorted(mgr._steps()) == [3, 4]
    assert not list(tmp_path.glob("*.tmp.npz"))
    step, got, _ = mgr.restore_latest({"x": torch.zeros(4)})
    assert step == 4 and torch.equal(got["x"], torch.full((4,), 4.0))


def test_elastic_corrupt_latest_falls_back(tmp_path, capsys):
    mgr = TD.AsyncCheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.ones(4)})
    mgr.save(2, {"x": torch.full((4,), 2.0)})
    mgr.save(3, {"x": torch.full((4,), 3.0), "y": torch.ones(1)})  # other structure
    mgr.wait()
    (tmp_path / "step_0000000002.npz").write_bytes(b"torn write")
    got = mgr.restore_latest({"x": torch.zeros(4)})
    assert got is not None and got[0] == 1
    assert torch.equal(got[1]["x"], torch.ones(4))
    out = capsys.readouterr().out
    assert "skipping corrupt checkpoint" in out and "step_0000000002" in out
    assert "step_0000000003" in out


def test_elastic_save_snapshots_cpu_tensors(tmp_path):
    """The snapshot is taken at save(): a later in-place update of a CPU
    tensor does not reach the file."""
    x = torch.zeros(4)
    mgr = TD.AsyncCheckpointManager(tmp_path)
    mgr.save(1, {"x": x})
    x.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore_latest({"x": torch.ones(4)})[1]["x"], torch.zeros(4))


def test_elastic_background_error_surfaces(tmp_path, monkeypatch):
    mgr = TD.AsyncCheckpointManager(tmp_path)

    def fail(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(elastic, "_atomic_savez", fail)
    mgr.save(1, {"x": torch.ones(1)})
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()  # reported once


def test_meta_is_json(pair, tmp_path):
    jcfg, tcfg, jp = pair
    TD.save_checkpoint(tmp_path / "m.npz", bridge.params_from_numpy(jp, "cpu"), tcfg)
    with np.load(tmp_path / "m.npz") as d:
        meta = json.loads(str(d["__meta__"]))
    assert meta["config"]["quant"]["bit_widths"] == [4, 8, 32]
    assert meta["bit_width"] is None
