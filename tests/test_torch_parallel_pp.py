"""PyTorch port, parallel layer (`llm_qat_tpu_torch.parallel`): ring
attention, the context-parallel forward and train step (the trainer's
`attention_fn`), and GPipe pipeline parallelism (its forward, gradients,
DP x PP, the distillation step through the trainer's `forward_fn`, and the
single-precision train step) on four gloo ranks, held against the
single-device port and the JAX package's `llm_qat_tpu.parallel` on the
virtual CPU devices.

The ranks run in their own processes (`torch_parallel_ranks.py`, which
imports no JAX); this process computes the JAX references while they run.
One group runs every case, and each test asserts its case."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import llm_qat_tpu.models as J
from llm_qat_tpu.ops.attention import causal_attention_reference
from llm_qat_tpu.parallel import cp_forward as jcp
from llm_qat_tpu.parallel import pipeline as jpp
from llm_qat_tpu.parallel.ring_attention import ring_attention as j_ring_attention
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train.calibration_manager import CalibrationManager
from torch_parallel_ranks import RankRun

WORLD = 4
LORA = dict(lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
            lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
PP_MODEL = dict(vocab_size=256, n_positions=32, n_embd=32, n_layer=4, n_head=2)
PP_STEP = dict(gradient_accumulation_steps=3, num_iterations=10)


def _calibrated(tcfg, shape, seed=0):
    """Initial parameters from a seed (the port's init), calibrated by the
    port's CalibrationManager (held against JAX's in
    test_torch_train_quant.py) on one batch, as the JAX tests calibrate;
    a numpy tree both packages read, and the batch."""
    params = tsp.init_sp_params(torch.Generator().manual_seed(seed), tcfg, device="cpu")
    batch = torch.tensor(np.random.default_rng(seed).integers(0, tcfg.model.vocab_size, shape))
    params = CalibrationManager(tcfg, 1).calibrate_all_precisions(params, [batch])
    return bridge.params_to_numpy(params), batch.numpy()


def _pp_cfgs(**model):
    m = dict(PP_MODEL, **model)
    q = dict(bit_widths=(4, 32), **LORA)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q)))


def _cp_cfgs():
    """JAX's CP test config, tiny (8, 32), with the 8-bit slot on the minmax
    grid: at the log grid XLA's and PyTorch's float32 log2 differ by an
    ulp, which moves an activation on a code boundary (see
    test_torch_train_model.py)."""
    return tuple(c.replace(quant=dataclasses.replace(c.quant, quantizer_per_bit={8: "minmax"}))
                 for c in (J.tiny_test_config((8, 32)), tc.tiny_test_config((8, 32))))


def _replayed_draws(rng, jcfg, n):
    """The student slots and feature layers the JAX step draws from rng."""
    q = jcfg.quant
    _, rng_prec, rng_layer, _ = jax.random.split(rng, 4)
    slots = jnp.asarray([q.prec_index(b) for b in q.student_bits], jnp.int32)
    precs = jax.random.choice(rng_prec, slots, shape=(n,))
    layers = jax.random.randint(rng_layer, (n,), 0, jcfg.model.n_layer + 1)
    return {"precs": np.array(precs), "layers": np.array(layers)}


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jpp_cfg, pp_cfg = _pp_cfgs()
    _, pp_nodrop = _pp_cfgs(embd_pdrop=0.0)
    pp_params, pp_ids = _calibrated(pp_cfg, (8, 16))
    tp_cfg, cp_cfg = tc.tiny_test_config((4, 32)), _cp_cfgs()[1]
    tp_params, tp_ids = _calibrated(tp_cfg, (4, 16))
    cp_params, _ = _calibrated(cp_cfg, (2, 64))
    return {
        "ring_qkv": [rng.normal(size=(2, 4, 32, 16)).astype(np.float32) for _ in range(3)],
        "cp_cfg": cp_cfg,
        "cp_params": cp_params,
        "cp_ids": rng.integers(0, 200, (2, 64)),
        "tp_cfg": tp_cfg, "tp_params": tp_params, "tp_ids": tp_ids,
        "cp_tcfg": tc.TrainConfig(gradient_accumulation_steps=3, num_iterations=4),
        "pp_cfg": pp_cfg, "pp_cfg_nodrop": pp_nodrop, "pp_params": pp_params,
        "pp_ids": pp_ids, "pp_tcfg": tc.TrainConfig(**PP_STEP),
        "pp_draws": _replayed_draws(jax.random.PRNGKey(3), jpp_cfg,
                                    PP_STEP["gradient_accumulation_steps"] - 1),
        "pp_train_tcfg": tc.TrainConfig(learning_rate=1e-2, num_iterations=6),
        "pp_train_ids": np.random.default_rng(1).integers(0, 256, (8, 16)),
    }


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    run = RankRun("pp", WORLD, setup, tmp_path_factory.mktemp("pp"))
    yield run
    run.close()


def _case(ranks, name, rank=0):
    res = ranks.results()[rank][name]
    if isinstance(res, dict) and "error" in res:
        pytest.fail(f"rank {rank}, case {name}:\n{res['error']}")
    return res


def _jax_mesh(shape, names):
    return Mesh(np.asarray(jax.devices()[:WORLD]).reshape(shape), names)


def test_pp_distillation_step_matches_jax(setup, ranks):
    """The pipelined step without dropout, with the JAX step's draws,
    against JAX's unsharded step (which JAX's own test holds equal to its
    pipelined one): loss and teacher loss 1e-4 relative, grad_norm 1e-3,
    precisions equal."""
    jcfg, _ = _pp_cfgs(embd_pdrop=0.0)
    init, step = jst.make_sp_train_step(jcfg, J.TrainConfig(**PP_STEP))
    _, jm = jax.jit(step)(init(jax.tree.map(jnp.asarray, setup["pp_params"])),
                          jnp.asarray(setup["pp_ids"]), jax.random.PRNGKey(3))
    res = _case(ranks, "pp_distill_step")["replayed"]
    for key, rtol in (("loss", 1e-4), ("teacher_loss", 1e-4), ("grad_norm", 1e-3)):
        np.testing.assert_allclose(res[key][0], float(jm[key]), rtol=rtol, err_msg=key)
    np.testing.assert_array_equal(res["precisions"][0], np.asarray(jm["precisions"]))


def test_pp_grads_match_single_device_and_jax(setup, ranks):
    """Gradients through the schedule (wte, wpe, a LoRA B bank, a weight
    bank, ln_f) against the unsharded forward's and JAX's pipeline's on a
    (2, 2) mesh: 5e-4, as in JAX."""
    jcfg, _ = _pp_cfgs()
    mesh = _jax_mesh((2, 2), ("data", "pipe"))
    jp, _ = jpp.shard_params_pp(jax.tree.map(jnp.asarray, setup["pp_params"]), mesh)
    tables = J.prec_tables(jcfg.quant)
    ids = jnp.asarray(setup["pp_ids"])

    def loss_pp(p):
        return jpp.pipeline_sp_forward(p, ids, 0, jcfg, mesh, tables=tables,
                                       labels=ids)["loss"]

    with pytest.warns(UserWarning, match="batch_axis_name"):
        want = jax.jit(jax.grad(loss_pp))(jp)
    res = _case(ranks, "pp_grads")
    for name, (got, single) in res.items():
        leaf = want
        for k in name.split("/"):
            leaf = leaf[k]
        np.testing.assert_allclose(got, single, rtol=5e-4, atol=5e-4, err_msg=name)
        np.testing.assert_allclose(got, np.asarray(leaf), rtol=5e-4, atol=5e-4,
                                   err_msg=name)


def test_pp_forward_matches_single_device_and_jax(setup, ranks):
    """The GPipe forward over a (data 2, pipe 2) mesh, two blocks a stage,
    DP over "data": logits 2e-4 and the loss 1e-5 against the unsharded
    forward and JAX's pipeline on a (2, 2) mesh; each stage holds its two
    blocks; the gathered hidden states equal the unsharded ones."""
    jcfg, _ = _pp_cfgs()
    mesh = _jax_mesh((2, 2), ("data", "pipe"))
    jp, _ = jpp.shard_params_pp(jax.tree.map(jnp.asarray, setup["pp_params"]), mesh)
    tables = J.prec_tables(jcfg.quant)
    ids = jnp.asarray(setup["pp_ids"])
    with pytest.warns(UserWarning, match="batch_axis_name"):
        want = jax.jit(lambda p, i: jpp.pipeline_sp_forward(p, i, 0, jcfg, mesh,
                                                            tables=tables, labels=i))(jp, ids)
    res = _case(ranks, "pp_forward")
    assert res["local_layers"] == 2
    for ref_logits, ref_loss in ((res["want"], res["loss"][1]),
                                 (np.asarray(want["logits"]), float(want["loss"]))):
        np.testing.assert_allclose(res["got"], ref_logits, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["loss"][0], ref_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(*res["hidden"], rtol=2e-4, atol=2e-4)


def test_cp_forward_matches_single_device_and_jax(setup, ranks):
    """`sp_forward_context_parallel` with T = 64 over four ranks against
    the unsharded forward and JAX's over four devices: logits 5e-4 (JAX's
    limit) and the loss with labels, whose shift crosses every shard
    boundary, 1e-5."""
    jcfg = _cp_cfgs()[0]
    jp = jax.tree.map(jnp.asarray, setup["cp_params"])
    ids = jnp.asarray(setup["cp_ids"])
    want = jcp.sp_forward_context_parallel(jp, ids, 0, jcfg, _jax_mesh((WORLD,), ("sp",)),
                                           "sp", labels=ids)
    res = _case(ranks, "cp_forward")
    np.testing.assert_allclose(res["got"], res["want"], rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(res["got"], np.asarray(want["logits"]), rtol=5e-4, atol=5e-4)
    np.testing.assert_allclose(res["loss"][0], res["loss"][1], rtol=1e-5)
    np.testing.assert_allclose(res["loss"][0], float(want["loss"]), rtol=1e-5)


def test_ring_attention_matches_dense_and_jax(setup, ranks):
    """Ring attention over four ranks, T = 32 sharded 8 a rank, against the
    dense causal reference and JAX's `ring_attention` over four devices:
    2e-4, as in JAX. A DTensor input gives a DTensor sharded on T; plain
    tensors (taken as replicated) give the same numbers."""
    q, k, v = (jnp.asarray(a) for a in setup["ring_qkv"])
    want = np.asarray(j_ring_attention(q, k, v, _jax_mesh((WORLD,), ("sp",)), "sp"))
    np.testing.assert_allclose(want, np.asarray(causal_attention_reference(q, k, v)),
                               rtol=2e-4, atol=2e-4)
    res = _case(ranks, "ring")
    assert res["placements"] == ("S(2)",)
    for key in ("got", "plain"):
        np.testing.assert_allclose(res[key], res["dense"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res[key], want, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(res["got"], res["plain"])


def test_ring_attention_causality_across_shards(ranks):
    """Poisoning the last rank's K/V (positions 24..31) leaves every earlier
    query's output as it was: 1e-5, as in JAX."""
    res = _case(ranks, "ring")
    cut = res["cut"]
    np.testing.assert_allclose(res["poisoned"][:, :, :cut], res["got"][:, :, :cut],
                               rtol=1e-5, atol=1e-5)
    assert np.abs(res["poisoned"][:, :, cut:] - res["got"][:, :, cut:]).max() > 1.0


def test_ring_attention_gradients(ranks):
    """The ring's backward (the rotation's transpose turns the cotangents
    the other way) against the dense reference's gradients: 2e-6 relative
    to the largest."""
    for got, want in _case(ranks, "ring_grads")["grads"]:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-6 * np.abs(want).max())


def test_cp_train_step_matches_plain_step(ranks):
    """`make_sp_train_step(attention_fn=partial(ring_attention, mesh,
    "model"))` on ids sharded on T over "model" of a (2, 2) mesh, against
    the plain step from the same state and generator: 2e-4, as in JAX."""
    res = _case(ranks, "cp_step")
    for key in ("loss", "teacher_loss", "grad_norm"):
        np.testing.assert_allclose(*res[key], rtol=2e-4, atol=2e-4, err_msg=key)


def test_pp_refuses_what_jax_refuses(ranks):
    """JAX's checks: fewer than one microbatch, a batch the microbatches do
    not divide, and layers the stages do not divide raise ValueError."""
    res = _case(ranks, "pp_forward")
    assert [m.split()[0] for m in res["refused"]] == ["n_microbatches", "batch", "n_layer=3"]


def test_pp_more_microbatches_than_stages(ranks):
    """Four microbatches through two stages: logits 2e-4."""
    res = _case(ranks, "pp_forward")
    np.testing.assert_allclose(res["more"], res["want"], rtol=2e-4, atol=2e-4)


def test_pp_replicates_over_an_unused_axis_with_a_warning(ranks):
    """No batch axis on a (data 2, pipe 2) mesh: the pipeline warns, as
    JAX's does, and the logits still match (2e-4)."""
    res = _case(ranks, "pp_replicated")
    assert res["warned"]
    np.testing.assert_allclose(res["got"], res["want"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("draws", ["drawn", "replayed"])
def test_pp_distillation_step_matches_unsharded(ranks, draws):
    """`make_pp_sp_train_step` (DP x PP on a (2, 2) mesh) against
    `make_sp_train_step` from the same state and generator: with the
    embedding dropout on ("drawn": the pipeline draws the same mask) and
    with JAX's draws: loss and teacher loss 1e-4 relative, grad_norm 1e-3,
    precisions equal (JAX's limits); every updated leaf within 1e-6, the
    blocks still sharded over "pipe"."""
    res = _case(ranks, "pp_distill_step")[draws]
    for key, rtol in (("loss", 1e-4), ("teacher_loss", 1e-4), ("grad_norm", 1e-3)):
        np.testing.assert_allclose(*res[key], rtol=rtol, err_msg=key)
    np.testing.assert_array_equal(*res["precisions"])
    assert res["placements"] == ("R", "S(0)")
    for path, (got, want) in res["params"].items():
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=path)


def test_pp_train_step_decreases_loss(ranks):
    """`make_pp_train_step` on a (pipe 2, data 2) mesh with DP: six CE steps
    with AdamW on one batch lower the loss by more than 0.05, and the frozen
    leaves (embeddings, quantizer banks) stay as they were, as in JAX; the
    trainable ones move."""
    res = _case(ranks, "pp_train_step")
    losses = res["losses"]
    assert all(np.isfinite(losses)) and all(np.isfinite(res["grad_norms"]))
    assert losses[-1] < losses[0] - 0.05, losses
    np.testing.assert_array_equal(*res["wte"])
    np.testing.assert_array_equal(*res["wq_scale"])
    for rank in range(1, WORLD):
        assert _case(ranks, "pp_train_step", rank)["losses"] == losses
