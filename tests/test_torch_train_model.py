"""PyTorch port, training slice: the SP forward with the trainable flash
path and its gradients, held against the JAX package on the CPU (the JAX
flash kernels in interpret mode); the embedding dropout and remat.

Tiny config: L = 2, n_embd 128, n_head 2 (head_dim 64, which flash needs),
LoRA rank 4, vocab 256, T = 128, B = 2, bits (4, 8, 32) with the default
kinds (4: minmax, 8: log), float32 compute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst

T, B = 128, 2
LINEARS = ("c_attn", "attn_proj", "c_fc", "mlp_proj")


def configs(**model_kw):
    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 4 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=256, n_positions=T, n_embd=128, n_layer=2, n_head=2,
             embd_pdrop=0.0) | model_kw
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q),
                            attention_impl="flash"),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q),
                             attention_impl="flash"))


def clear_log_ties(p, qcfg, margin=0.02):
    """Moves every base weight that sits within `margin` of a rounding
    boundary of a log-kind slot's code grid 2·margin codes away from it.

    XLA's and PyTorch's float32 log2 may differ by an ulp; a weight that
    close to a tie then takes neighbouring codes in the two packages, and
    a weight's code reaches every token. The extremes, which set the
    calibrated range, sit on the grid's ends and never move."""
    for slot, bits in enumerate(qcfg.bit_widths):
        if bits >= 32 or qcfg.kind_name(bits) != "log":
            continue
        n = 2.0 ** (bits - 1) - 1
        for lin in LINEARS:
            b = p["blocks"][lin]
            w = b["w"].astype(np.float64)  # (L, in, out); per-channel scales (L, P, out)
            lmin, lrange = b["wq_zp"][:, slot][:, None], b["wq_scale"][:, slot][:, None]
            la = np.log2(np.maximum(np.abs(w), 1e-5))
            pos = (np.clip((la - lmin) / lrange, 0, 1) - 0.5) * 2 * n
            near = np.abs(pos - np.floor(pos) - 0.5) < margin
            b["w"] = np.where(near, w * 2.0 ** (-2 * margin * lrange / (2 * n)),
                              w).astype(np.float32)
    return p


def calibrated_params(jcfg, seed=0):
    """JAX init with non-zero LoRA B banks, calibrated by the JAX package,
    clear of log-grid ties (numpy tree)."""
    p = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lin in LINEARS:
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    cal = [jnp.asarray(rng.integers(0, 256, (B, T))) for _ in range(2)]
    p = jcm.CalibrationManager(jcfg, 2).calibrate_all_precisions(
        jax.tree.map(jnp.asarray, p), cal)
    return clear_log_ties(jax.tree.map(np.asarray, p), jcfg.quant)


def live(params):
    """The port's tree with the trainable leaves requiring grad."""
    return optim.replace_leaves(params, {
        p: optim.get_leaf(params, p).detach().clone().requires_grad_(True)
        for p in tst.trainable_paths(params)})


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = configs()
    jp = calibrated_params(jcfg)
    ids = np.random.default_rng(9).integers(0, 256, (B, T))
    return jcfg, tcfg, jp, ids


# (logits abs, hidden states abs, loss rel, grad leaf rel to its max) per
# slot. At the teacher slot (32-bit, no quantizer) and the 4-bit minmax
# slot only float32 summation order differs (measured: logits 1e-6, grads
# 1.2e-6). The 8-bit log slot quantizes every activation through
# log2/exp2, whose float32 results differ by an ulp between XLA and
# PyTorch; an activation that close to a code boundary takes the
# neighbouring code (1.6 % apart) in the other package, and through
# attention that reaches every later token (measured: logits 8.8e-3 of a
# 0.22 std, hidden states 4.7e-2 in 0.16 % of them, loss 1.2e-5, grads
# 6.2e-3).
TOLS = {2: (2e-4, 2e-4, 1e-5, 1e-5), 0: (2e-4, 2e-4, 1e-5, 1e-5),
        1: (2e-2, 1e-1, 1e-4, 2e-2)}


@pytest.mark.parametrize("prec", [2, 0, 1])
def test_sp_forward_and_grads_match_jax(setup, prec):
    """Logits, loss and hidden states with attention_impl="flash" and
    output_hidden_states=True, and the CE loss's gradient for every
    trainable leaf, at the teacher slot and both student slots (4-bit
    minmax, 8-bit log STEs), within TOLS."""
    jcfg, tcfg, jp, ids = setup
    tol_out, tol_hidden, tol_loss, tol_grad = TOLS[prec]

    def jloss(params):
        out = J.sp_forward(params, jnp.asarray(ids), prec, jcfg, labels=jnp.asarray(ids),
                           output_hidden_states=True)
        return out["loss"], (out["logits"], out["hidden_states"])

    (jl, (jlog, jhs)), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp))
    tp = live(bridge.params_from_numpy(jp, "cpu"))
    out = tsp.sp_forward(tp, torch.tensor(ids), prec, tcfg, labels=torch.tensor(ids),
                         output_hidden_states=True)
    out["loss"].backward()
    assert tuple(out["hidden_states"].shape) == (3, B, T, 128)
    assert not out["hidden_states"].requires_grad
    np.testing.assert_allclose(out["logits"].detach().numpy(), np.asarray(jlog), atol=tol_out)
    np.testing.assert_allclose(out["hidden_states"].numpy(), np.asarray(jhs), atol=tol_hidden)
    np.testing.assert_allclose(float(out["loss"].detach()), float(jl), rtol=tol_loss)
    paths = tst.trainable_paths(tp)
    for path in paths:
        got = optim.get_leaf(tp, path).grad.numpy()
        want = np.asarray(optim.get_leaf(jg, path))
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
        assert err <= tol_grad, f"{path}: {err:.2e}"
    assert len(paths) == 4 * 4 + 3 * 2  # linears' w/b/A/B, LayerNorms' g/b
    assert tp["wte"].grad is None


def test_embedding_dropout():
    """Keep rate 1 - p, survivors scaled by 1/keep, the mask drawn from the
    given generator: the same seed gives the same mask, another seed
    another."""
    _, tcfg = configs(embd_pdrop=0.25)
    p = tsp.init_sp_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    emb = torch.randn(4, 64, 128, generator=torch.Generator().manual_seed(1)) + 3.0
    outs = []
    for seed in (5, 5, 6):
        out = tsp.sp_forward(p, None, 2, tcfg, inputs_embeds=emb, deterministic=False,
                             dropout_gen=torch.Generator().manual_seed(seed),
                             output_hidden_states=True)
        outs.append(out["hidden_states"][0])
    h0 = outs[0]
    kept = h0 != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.01
    torch.testing.assert_close(h0[kept], emb[kept] / 0.75)
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    det = tsp.sp_forward(p, None, 2, tcfg, inputs_embeds=emb, output_hidden_states=True)
    assert torch.equal(det["hidden_states"][0], emb)


def test_remat_gives_the_same_gradients(setup):
    """`remat=True` (torch.utils.checkpoint per block) recomputes the same
    float32 ops: loss and gradients equal the plain backward's."""
    _, tcfg, jp, ids = setup
    grads = []
    for remat in (False, True):
        tp = live(bridge.params_from_numpy(jp, "cpu"))
        tsp.sp_forward(tp, torch.tensor(ids), 0, tcfg, labels=torch.tensor(ids),
                       remat=remat)["loss"].backward()
        grads.append([optim.get_leaf(tp, p).grad for p in tst.trainable_paths(tp)])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_eval_step_matches_jax(setup):
    """The eval loss at the 4-bit slot (float32 summation order: 1e-5), with
    no gradient recorded."""
    jcfg, tcfg, jp, ids = setup
    want = jst.make_eval_step(jcfg)(jax.tree.map(jnp.asarray, jp), jnp.asarray(ids), 0)
    tp = live(bridge.params_from_numpy(jp, "cpu"))
    got = tst.make_eval_step(tcfg)(tp, torch.tensor(ids), 0)
    assert not got.requires_grad
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
