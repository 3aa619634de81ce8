"""PyTorch port, training slice as a whole: two SP distillation train steps
of both packages on the same parameters and batch, with the JAX step's
student slots and feature layers replayed into the port's (the JAX flash
kernels run in interpret mode; the port's CPU path runs their plain
versions). Config as in test_torch_train_model.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst
from test_torch_train_model import B, T, calibrated_params, configs

ACCUM = 3
# A large Adam epsilon makes the first updates about lr·g, linear in the
# gradient: with the default 1e-8 every element moves by about ±lr whatever
# its gradient, and an element whose gradient is near zero moves by ±lr in
# either package depending on float rounding.
TRAIN = dict(batch_size=B, max_seq_length=T, gradient_accumulation_steps=ACCUM,
             learning_rate=1e-2, adam_epsilon=1.0, num_iterations=4)
# The students run at the 4-bit minmax and 8-bit log slots; at the log slot
# an activation on a code boundary may take the neighbouring code in the
# other package (see test_torch_train_model.TOLS). Relative limits, each
# about 5x the spread measured over the two steps: the teacher loss (no
# quantizer) 1e-6 (measured 1.7e-7); the total loss 2e-5 (4.0e-6); the
# student loss, a KL of about 0.03 taken as the difference of two terms
# near 3, 2e-3 (3.1e-4); grad_norm 2e-4 (3.7e-5); lr 1e-6. Each trainable
# leaf's update (new - old) within 5e-3 of its largest magnitude (7.0e-4);
# frozen leaves bit for bit unchanged.
RTOL = {"loss": 2e-5, "teacher_loss": 1e-6, "student_loss_mean": 2e-3,
        "grad_norm": 2e-4, "lr": 1e-6}
UPDATE_TOL = 5e-3


def _replayed_draws(rng, jcfg, tcfg):
    """The student slots and feature layers the JAX step draws from rng."""
    q = jcfg.quant
    _, rng_prec, rng_layer, _ = jax.random.split(rng, 4)
    slots = np.asarray([q.prec_index(b) for b in q.student_bits], np.int32)
    n = tcfg.gradient_accumulation_steps - 1
    precs = jax.random.choice(rng_prec, jnp.asarray(slots), shape=(n,))
    layers = jax.random.randint(rng_layer, (n,), 0, jcfg.model.n_layer + 1)
    return np.array(precs), np.array(layers)  # writable copies


def test_two_train_steps_match_jax():
    jcfg, tcfg = configs()
    jp = calibrated_params(jcfg, seed=3)
    ids = np.random.default_rng(21).integers(0, 256, (B, T))
    jtc, ttc = J.TrainConfig(**TRAIN), tc.TrainConfig(**TRAIN)

    j_init, j_step = jst.make_sp_train_step(jcfg, jtc)
    t_init, t_step = tst.make_sp_train_step(tcfg, ttc)
    j_state = j_init(jax.tree.map(jnp.asarray, jp))
    t_state = t_init(bridge.params_from_numpy(jp, "cpu"))
    t_params0 = t_state.params
    frozen = [p for p, m in optim.leaves_with_paths(tst.trainable_mask(jp)) if not m]
    trainable = tst.trainable_paths(jp)
    j_step = jax.jit(j_step)
    seen_slots = set()
    for step in range(2):
        rng = jax.random.PRNGKey(100 + step)
        precs, layers = _replayed_draws(rng, jcfg, jtc)
        seen_slots.update(precs.tolist())
        j_old, t_old = j_state.params, t_state.params
        j_state, jm = j_step(j_state, jnp.asarray(ids), rng)
        t_state, tm = t_step(t_state, torch.tensor(ids), torch.Generator().manual_seed(step),
                             precs=precs, layers=layers)
        np.testing.assert_array_equal(tm["precisions"].numpy(), np.asarray(jm["precisions"]))
        assert t_state.step == int(j_state.step) == step + 1
        for key, rtol in RTOL.items():
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol,
                                       err_msg=f"step {step} {key}")
        for path in trainable:
            dj = np.asarray(optim.get_leaf(j_state.params, path)) - np.asarray(
                optim.get_leaf(j_old, path))
            dt = (optim.get_leaf(t_state.params, path) - optim.get_leaf(t_old, path)).numpy()
            err = np.abs(dt - dj).max() / np.abs(dj).max()
            assert err <= UPDATE_TOL, f"step {step} {path}: update err {err:.2e}"
        for path in frozen:
            assert optim.get_leaf(t_state.params, path) is optim.get_leaf(t_params0, path)
            np.testing.assert_array_equal(np.asarray(optim.get_leaf(j_state.params, path)),
                                          optim.get_leaf(jp, path))
    assert int(t_state.opt_state.count) == 2
    assert seen_slots == {0, 1}  # both student kinds ran
