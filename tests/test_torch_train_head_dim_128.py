"""PyTorch port, bf16 flash at head_dim 128 as a whole: one SP distillation
train step of both packages at head_dim 128 (n_embd 256 as 2 heads of 128,
2 layers, T = 128, B = 2, attention_impl "flash"), in float32 and in bf16
compute, from the same numpy parameters (the weight bridge) and batch, with
the JAX step's student slots and feature layers replayed into the port's.
The JAX flash kernels #5/#6 run in interpret mode; the port's CPU path runs
their plain versions, which the card's wgmma kernels are held against."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.ops import attention as ta
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst
from test_torch_train_model import B, T, calibrated_params
from test_torch_train_step import RTOL, TRAIN, UPDATE_TOL, _replayed_draws

# bf16 compute rounds every linear's operands and output, the attention
# operands, P and dS to bf16 in both packages at the same points; the
# float32 sums between them run in another order, so now and then a value
# on a bf16 rounding boundary takes the neighbouring bf16 value in one
# package, and two layers carry it on. Relative limits, about 5x the spread
# measured over the step (or test_torch_train_step.py's, where larger): the
# total loss 2e-5 (measured 2.4e-6), the teacher loss 1e-5 (1.6e-6), the
# student loss 2e-3 (3.1e-5), grad_norm 1e-3 (2.2e-4), lr 1e-6; each
# trainable leaf's update within 2e-2 of its largest magnitude (4.0e-3).
# float32 takes the limits of test_torch_train_step.py (measured: loss
# 2.4e-6, student loss 9.4e-5, grad_norm 1.7e-6, update 5.8e-4).
RTOL_BF16 = {"loss": 2e-5, "teacher_loss": 1e-5, "student_loss_mean": 2e-3,
             "grad_norm": 1e-3, "lr": 1e-6}
UPDATE_TOL_BF16 = 2e-2


def configs(compute_dtype):
    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 4 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=T, n_embd=256, n_layer=2, n_head=2,
             embd_pdrop=0.0)
    kw = dict(attention_impl="flash", compute_dtype=compute_dtype)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q), **kw),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q), **kw))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_step_at_head_dim_128_matches_jax(monkeypatch, compute_dtype):
    """Metrics and every trainable leaf's update of one step within the
    limits for `compute_dtype`, frozen leaves unchanged; both packages ran
    the flash path at head_dim 128: the port's #5 and #6 (plain versions on
    the CPU, on the card's route "wgmma") once a layer and micro-step."""
    jcfg, tcfg = configs(compute_dtype)
    assert tcfg.model.head_dim == 128 and ta.flash_route(torch.bfloat16, 128) == "wgmma"
    rtol, update_tol = ((RTOL, UPDATE_TOL) if compute_dtype == "float32"
                        else (RTOL_BF16, UPDATE_TOL_BF16))
    jp = calibrated_params(jcfg, seed=5)
    ids = np.random.default_rng(23).integers(0, 256, (B, T))
    jtc, ttc = J.TrainConfig(**TRAIN), tc.TrainConfig(**TRAIN)
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = ta.flash_fwd_lse_plain, ta.flash_bwd_plain

    def fwd(q, *a):
        assert q.shape[-1] == 128
        calls["fwd"] += 1
        return real_fwd(q, *a)

    def bwd(*a):
        calls["bwd"] += 1
        return real_bwd(*a)

    monkeypatch.setattr(ta, "flash_fwd_lse_plain", fwd)
    monkeypatch.setattr(ta, "flash_bwd_plain", bwd)
    j_init, j_step = jst.make_sp_train_step(jcfg, jtc)
    t_init, t_step = tst.make_sp_train_step(tcfg, ttc)
    j_state = j_init(jax.tree.map(jnp.asarray, jp))
    t_state = t_init(bridge.params_from_numpy(jp, "cpu"))
    rng = jax.random.PRNGKey(102)
    precs, layers = _replayed_draws(rng, jcfg, jtc)
    j_new, jm = jax.jit(j_step)(j_state, jnp.asarray(ids), rng)
    t_new, tm = t_step(t_state, torch.tensor(ids), torch.Generator().manual_seed(0),
                       precs=precs, layers=layers)
    per_step = jcfg.model.n_layer * ttc.gradient_accumulation_steps
    assert calls == {"fwd": per_step, "bwd": per_step}
    np.testing.assert_array_equal(tm["precisions"].numpy(), np.asarray(jm["precisions"]))
    for key, tol in rtol.items():
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=tol, err_msg=key)
    for path in tst.trainable_paths(jp):
        dj = np.asarray(optim.get_leaf(j_new.params, path)) - np.asarray(
            optim.get_leaf(j_state.params, path))
        dt = (optim.get_leaf(t_new.params, path) - optim.get_leaf(t_state.params, path)).numpy()
        err = np.abs(dt - dj).max() / np.abs(dj).max()
        assert err <= update_tol, f"{path}: update err {err:.2e}"
    for path, trainable in optim.leaves_with_paths(tst.trainable_mask(jp)):
        if not trainable:
            np.testing.assert_array_equal(optim.get_leaf(t_new.params, path).numpy(),
                                          optim.get_leaf(jp, path))
