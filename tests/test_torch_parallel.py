"""PyTorch port, parallel layer (`llm_qat_tpu_torch.parallel`): the mesh,
the TP placements of the training and serving trees, TP and TP+DP on a
(data 2, model 2) mesh of four gloo ranks, TP decode, the flash wrappers
on DTensor operands, and the multi-process helpers on two processes, each
held against the single-device port and against the JAX package's
`llm_qat_tpu.parallel` on the virtual CPU devices.

The ranks run in their own processes (`torch_parallel_ranks.py`, which
imports no JAX); this process computes the JAX references and sends the
ranks numpy inputs. One group runs every case of a suite, and each test
asserts its case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as PS

import llm_qat_tpu.models as J
from llm_qat_tpu.models import inference as jinf
from llm_qat_tpu.parallel import mesh as jmesh
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch import parallel as P
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import inference as tinf
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
from torch_parallel_ranks import RankRun

LORA = dict(lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
            lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
DEC_MODEL = dict(vocab_size=512, n_positions=64, n_embd=64, n_layer=2, n_head=4)
DEC_QUANT = dict(bit_widths=(4, 8, 32), quantizer_per_bit={8: "minmax"}, **LORA)
TRAIN = dict(gradient_accumulation_steps=2, num_iterations=10, adam_epsilon=1.0)


def _placements(spec, dims=("data", "model")):
    """A JAX PartitionSpec as the port's placements over `dims`."""
    out = []
    for name in dims:
        hit = [d for d, s in enumerate(tuple(spec)) if s == name]
        out.append(f"Shard(dim={hit[0]})" if hit else "Replicate()")
    return tuple(out)


def _str(placements):
    return tuple(repr(p) for p in placements)


def _init(tcfg, seed=0):
    """Initial parameters from a seed (the port's init: the numbers feed
    both packages, and it spares a JAX compile)."""
    return tsp.init_sp_params(torch.Generator().manual_seed(seed), tcfg, device="cpu")


def _calibrated(tcfg, shape, n_batches=1, seed=0):
    """Initial parameters calibrated as the JAX test calibrates them (by
    the port's CalibrationManager, which test_torch_train_quant.py holds
    against JAX's); a numpy tree both packages read, and the first batch."""
    params = _init(tcfg, seed)
    rng = np.random.default_rng(seed)
    batches = [torch.tensor(rng.integers(0, tcfg.model.vocab_size, shape))
               for _ in range(n_batches)]
    params = CalibrationManager(tcfg, n_batches).calibrate_all_precisions(params, batches)
    return bridge.params_to_numpy(params), batches[0].numpy()


def _dec_cfgs(per_channel):
    q = dict(DEC_QUANT, per_channel=per_channel)
    return (J.SPModelConfig(model=J.GPT2Config(**DEC_MODEL), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**DEC_MODEL), quant=tc.QuantConfig(**q)))


@pytest.fixture(scope="module")
def tp_setup():
    """The JAX test's setup: tiny (4, 32) config, calibrated on one batch."""
    jcfg, tcfg = J.tiny_test_config((4, 32)), tc.tiny_test_config((4, 32))
    jp, ids = _calibrated(tcfg, (4, 16))
    return jcfg, tcfg, jp, ids


@pytest.fixture(scope="module")
def tp_ranks(tp_setup, tmp_path_factory):
    jcfg, tcfg, jp, ids = tp_setup
    djcfg, dtcfg = _dec_cfgs(per_channel=False)
    # the fused linear's shape gate passes: M = 256, K and N multiples of
    # 128, rank 8
    fused_cfg = tc.SPModelConfig(
        model=tc.GPT2Config(vocab_size=64, n_positions=128, n_embd=128, n_layer=1, n_head=2),
        quant=tc.QuantConfig(bit_widths=(4, 32), lora_rank_per_bit={4: 8, 32: 0},
                             lora_alpha_per_bit={4: 8, 32: 0}),
        linear_impl="fused")
    dp, dbatch = _calibrated(dtcfg, (2, 16), n_batches=2)
    rng = np.random.default_rng(1)
    data = {
        "tp_cfg": tcfg, "tp_params": jp, "tp_ids": ids,
        "tp_tcfg": tc.TrainConfig(**TRAIN),
        "dec_cfg": dtcfg, "dec_params": dp, "dec_ids": dbatch[:, :8],
        "flash_qkv": [rng.normal(size=(2, 2, 128, 64)).astype(np.float32)
                      for _ in range(3)],
        "fused_cfg": fused_cfg,
        "fused_params": bridge.params_to_numpy(_init(fused_cfg)),
        "fused_ids": rng.integers(0, 64, (2, 128)),
    }
    run = RankRun("tp", 4, data, tmp_path_factory.mktemp("tp"))
    yield data, run
    run.close()


@pytest.fixture(scope="module")
def multihost_ranks(tmp_path_factory):
    run = RankRun("multihost", 2, {}, tmp_path_factory.mktemp("multihost"), timeout=180)
    yield run
    run.close()


def _case(ranks, name, rank=0):
    res = ranks[1].results()[rank][name]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank}, case {name}:\n{res['error']}")
    return res


@pytest.mark.parametrize("per_channel", [True, False])
def test_sp_param_specs_match_jax(tp_setup, tp_ranks, multihost_ranks, per_channel):
    """Leaf by leaf, the port's placements are JAX's PartitionSpecs over
    (data, model), per-channel and per-tensor (per-tensor banks stay
    replicated through the flag)."""
    jcfg, _, jp, _ = tp_setup
    want = jmesh.sp_param_specs(jax.tree.map(jnp.asarray, jp), per_channel)
    got = P.sp_param_specs(bridge.params_from_numpy(jp, "cpu"), per_channel)
    leaves = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, PS))
    assert len(leaves) == len(optim.leaves_with_paths(got))
    for path, spec in leaves:
        leaf = optim.get_leaf(got, tuple(k.key for k in path))
        assert _str(leaf) == _placements(spec), path
    blocks = got["blocks"]
    assert _str(blocks["c_attn"]["w"]) == ("Replicate()", "Shard(dim=2)")
    assert _str(blocks["mlp_proj"]["w"]) == ("Replicate()", "Shard(dim=1)")
    assert _str(got["wte"]) == ("Replicate()", "Shard(dim=0)")
    channel = "Shard(dim=2)" if per_channel else "Replicate()"
    assert _str(blocks["c_attn"]["wq_scale"])[1] == channel
    assert _str(blocks["mlp_proj"]["iq_scale"])[1] == channel


@pytest.mark.parametrize("per_channel,weight_format", [(False, "int8_xla"), (True, "int8_xla")])
def test_infer_param_specs_match_jax(tp_ranks, per_channel, weight_format):
    """The serving tree's placements, leaf by leaf, against JAX's
    `infer_param_specs` on the same tree: int8 codes and their scale
    vectors on the channel axis, (L,) and (L, 1) leaves replicated by their
    shape, 0-d leaves replicated on both dimensions."""
    jcfg, tcfg = _dec_cfgs(per_channel)
    jp = bridge.params_to_numpy(_init(tcfg))
    bits = 4 if weight_format == "int4_xla" else 8
    jip = jinf.quantize_for_inference(jax.tree.map(jnp.asarray, jp), jcfg, bits,
                                      jnp.float32, weight_format=weight_format,
                                      lm_head_int8=True)
    jip.pop("_static")
    tip = tinf.quantize_for_inference(bridge.params_from_numpy(jp, "cpu"), tcfg, bits,
                                      torch.float32, weight_format=weight_format,
                                      lm_head_int8=True)
    static = tip.pop("_static")
    want = jmesh.infer_param_specs(jip, per_channel)
    got = P.infer_param_specs(dict(tip, _static=static), per_channel)
    assert got["_static"] is static
    leaves = jax.tree_util.tree_leaves_with_path(want, is_leaf=lambda x: isinstance(x, PS))
    assert len(leaves) == len(optim.leaves_with_paths(tip))
    for path, spec in leaves:
        leaf = optim.get_leaf(got, tuple(k.key for k in path))
        assert _str(leaf) == _placements(spec), path


def test_make_mesh_needs_a_card_unless_asked(monkeypatch):
    """make_mesh() and initialize_multihost() default to CUDA and NCCL:
    without a card they raise before touching a process group."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.initialize_multihost("127.0.0.1:1", 2, 0)


def test_tp_forward_matches_single_device_and_jax(tp_setup, tp_ranks):
    """The SP forward on TP-sharded parameters over the (2, 2) mesh with a
    batch-sharded input against the single-device port and JAX's sharded
    forward on a (2, 2) mesh of virtual devices: 2e-4, as in JAX."""
    jcfg, _, jp, ids = tp_setup
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    sharded, _ = jmesh.shard_params(jax.tree.map(jnp.asarray, jp), mesh)
    tables = J.prec_tables(jcfg.quant)
    fwd = jax.jit(lambda p, i: J.sp_forward(p, i, 0, jcfg, tables=tables)["logits"])
    want = np.asarray(fwd(sharded, jax.device_put(jnp.asarray(ids),
                                                  jmesh.batch_sharding(mesh))))
    res = _case(tp_ranks, "tp_forward")
    assert res["c_attn_w_local"] == (2, 32, 48)  # out axis 96 over "model"
    np.testing.assert_allclose(res["got"], res["want"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(res["got"], want, rtol=2e-4, atol=2e-4)


def test_tp_dp_train_step_keeps_placements(tp_ranks):
    """One distillation step over the (2, 2) mesh (TP + DP, with the
    generator's dropout and draws) against the same step on one device,
    which test_torch_train_step.py holds against JAX's: the losses and
    grad_norm within 2e-6 on every rank, every updated leaf within 1e-5 of
    the one-device update and with its TP placements (c_attn.w's out axis
    over "model", as JAX asserts)."""
    for rank in range(4):
        res = _case(tp_ranks, "tp_dp_step", rank)
        for key in ("loss", "teacher_loss", "grad_norm"):
            np.testing.assert_allclose(*res[key], rtol=2e-6, err_msg=key)
    specs = P.sp_param_specs(bridge.params_from_numpy(tp_ranks[0]["tp_params"], "cpu"))
    short = {"Replicate()": "R", "Shard(dim=0)": "S(0)", "Shard(dim=1)": "S(1)",
             "Shard(dim=2)": "S(2)", "Shard(dim=3)": "S(3)"}
    res = _case(tp_ranks, "tp_dp_step")
    assert res["placements"]["blocks/c_attn/w"] == ("R", "S(2)")
    for path, spec in optim.leaves_with_paths(specs):
        assert res["placements"]["/".join(path)] == tuple(short[p] for p in _str(spec)), path
    for path, (got, want) in res["params"].items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=path)


def test_tp_decode_matches_single_device_and_jax(tp_ranks):
    """The int8_xla serving tree (per-tensor scales, int8 head) sharded
    over the (2, 2) mesh, KV caches with batch over "data" and heads over
    "model": the 8-token prefill and one greedy step against the
    single-device port and JAX's TP decode on a (2, 2) mesh, 1e-4."""
    data = tp_ranks[0]
    jcfg, _ = _dec_cfgs(per_channel=False)
    ip = jinf.quantize_for_inference(jax.tree.map(jnp.asarray, data["dec_params"]), jcfg, 8,
                                     jnp.float32, weight_format="int8_xla",
                                     lm_head_int8=True)
    static = ip.pop("_static")
    mesh = jmesh.make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    ip_sh, _ = jmesh.shard_infer_params(ip, mesh, per_channel=False)
    caches = jax.device_put(jinf.init_layer_caches(jcfg, 2, 16, jnp.float32),
                            jmesh.kv_cache_sharding(mesh))
    fwd = jax.jit(lambda ip, ids, c, n: jinf.infer_forward_unrolled(ip, ids, jcfg, c, n,
                                                                     static=static))
    ids = jax.device_put(jnp.asarray(data["dec_ids"]), jmesh.batch_sharding(mesh))
    got, csh, _ = fwd(ip_sh, ids, caches, jnp.int32(0))
    got2, _, _ = fwd(ip_sh, jnp.argmax(got[:, -1:], axis=-1), csh, jnp.int32(8))
    res = _case(tp_ranks, "tp_decode")
    assert res["cache_placements"] == ("S(0)", "S(1)")
    for k in ("", "2"):
        np.testing.assert_allclose(res["got" + k], res["want" + k], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["got"], np.asarray(got), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res["got2"], np.asarray(got2), rtol=1e-4, atol=1e-4)


def test_mesh_shapes(tp_ranks):
    """JAX's defaults: every rank on "data" unless told; n_data·n_model
    must be the rank count; the batch, KV-cache and replicated
    placements."""
    res = _case(tp_ranks, "mesh_shapes")
    assert res["shapes"] == {
        "[]": ((4, 1), ("data", "model")),
        "[('n_model', 2)]": ((2, 2), ("data", "model")),
        "[('n_data', 1)]": ((1, 4), ("data", "model")),
        "[('n_data', 2), ('n_model', 2)]": ((2, 2), ("data", "model"))}
    assert res["refused"]
    assert res["replicated"] == ("R", "R")
    assert res["batch"] == ("S(0)", "R")
    assert res["kv"] == ("S(0)", "S(1)")


def test_fused_linear_takes_dtensor_operands(tp_ranks):
    """`linear_impl="fused"` on TP-sharded parameters over the (2, 2) mesh:
    the fused linear's kernel entries get replicated local operands
    (`local_call`), so the logits equal the single-device fused forward's
    bit for bit."""
    res = _case(tp_ranks, "tp_fused")
    np.testing.assert_array_equal(res["got"], res["want"])


@pytest.mark.parametrize("name", ["trainable", "serving"])
def test_flash_wrappers_take_dtensor_operands(tp_ranks, name):
    """`flash_attention_trainable` (#5/#6) and `flash_attention` (#2) on
    DTensors with batch over "data" and heads over "model": the local
    shards go to the kernel's entry (its plain version on the CPU), the
    output keeps those placements, and forward and gradients equal the
    call on whole tensors bit for bit."""
    res = _case(tp_ranks, "flash_boundary")[name]
    assert res["placements"] == ("S(0)", "S(1)")
    np.testing.assert_array_equal(res["got"], res["want"])
    for got, want in res["grads"]:
        np.testing.assert_array_equal(got, want)


def test_single_process_noop(monkeypatch):
    """No coordinator and no WORLD_SIZE: no process group is made, one
    process owns the whole batch."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    info = P.initialize_multihost(device="cpu")
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1,
                    "global_devices": 1}
    assert P.host_local_batch_slice(16) == slice(0, 16)
    assert not torch.distributed.is_initialized()


def test_two_process_global_batch(multihost_ranks):
    """Two processes join through `initialize_multihost` (a FileStore URL as
    the coordinator), each takes its `host_local_batch_slice` of an (8, 4)
    batch, and `make_global_batch` assembles a DTensor whose sum spans both
    processes' rows."""
    for rank, res in enumerate(multihost_ranks.results()):
        assert res["jax_imported"] == []  # a rank imports neither JAX nor llm_qat_tpu
        assert res["init"] == {"process_index": rank, "process_count": 2,
                               "local_devices": 1, "global_devices": 2}
        got = res["multihost"]
        assert "error" not in got, got.get("error")
        assert got["info"] == res["init"]
        assert got["slice"] == (4 * rank, 4 * rank + 4)
        assert got["shape"] == (8, 4)
        assert abs(got["sum"] - got["want"]) < 1e-3

