"""PyTorch port, training slice: the distillation losses, the trainable
mask, the LR schedule and clip + AdamW, each held against the JAX package
(and optax) on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.train import distillation as jd
from llm_qat_tpu.train import sp_trainer as jst
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import distillation as td
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst

TEMP = 3.0


def _logits(seed, shape=(2, 9, 40), scale=2.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(np.float32)


def test_kl_cross_value_and_gradient_match_jax():
    """`_kl_cross` forward (logsumexp identity) and its hand-written
    backward, with a non-unit cotangent: float32 rounding, 1e-6."""
    s = _logits(0)
    p = np.asarray(jax.nn.softmax(jnp.asarray(_logits(1)) / TEMP, axis=-1))
    want, vjp = jax.vjp(lambda a: jd._kl_cross(a, jnp.asarray(p), TEMP), jnp.asarray(s))
    want_ds = vjp(jnp.float32(1.7))[0]
    st = torch.tensor(s, requires_grad=True)
    pt = torch.tensor(p, requires_grad=True)
    got = td._kl_cross(st, pt, TEMP)
    (1.7 * got).backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_ds), rtol=1e-5, atol=1e-8)
    assert pt.grad is None  # p_t takes no gradient


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_prepare_teacher_and_kl_loss_match_jax(cache_dtype):
    """Cached probabilities (bf16 rounds them: one bf16 ulp, 2^-8 relative,
    where the float32 values straddle a rounding boundary), the negative
    entropy, and the KL loss with its gradient through both branches
    (prepared teacher, raw logits): 1e-5."""
    t, s = _logits(2), _logits(3)
    hs = np.zeros((3, 2, 9, 4), np.float32)
    jt = jd.prepare_teacher(jnp.asarray(t), jnp.asarray(hs), TEMP,
                            cache_dtype=jnp.dtype(cache_dtype))
    tt = td.prepare_teacher(torch.tensor(t), torch.tensor(hs), TEMP,
                            cache_dtype=getattr(torch, cache_dtype))
    assert tt.probs.dtype == getattr(torch, cache_dtype)
    np.testing.assert_allclose(tt.probs.float().numpy(), np.asarray(jt.probs, np.float32),
                               rtol=2.0 ** -8 if cache_dtype == "bfloat16" else 1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(tt.neg_entropy), float(jt.neg_entropy), rtol=1e-6)
    for j_teacher, t_teacher in ((jt, tt), (jnp.asarray(t), torch.tensor(t))):
        want, vjp = jax.vjp(lambda a: jd.kl_distillation_loss(a, j_teacher, TEMP),
                            jnp.asarray(s))
        st = torch.tensor(s, requires_grad=True)
        got = td.kl_distillation_loss(st, t_teacher, TEMP)
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
        np.testing.assert_allclose(st.grad.numpy(), np.asarray(vjp(jnp.float32(1.0))[0]),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("accumulative", [False, True])
def test_feature_and_total_loss_match_jax(accumulative):
    """The feature MSE at a layer (or over all layers), and the total with
    a zero alpha: a skipped term is never computed (the teacher passed here
    has no logits, which the KL term would need)."""
    rng = np.random.default_rng(4)
    sh, th = (rng.normal(0, 1, (3, 2, 9, 8)).astype(np.float32) for _ in range(2))
    want = jd.feature_distillation_loss(jnp.asarray(sh), jnp.asarray(th), 2, accumulative)
    got = td.feature_distillation_loss(torch.tensor(sh), torch.tensor(th), 2, accumulative)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    teacher = td.TeacherOutputs(logits=None, hidden_states=torch.tensor(th))
    total = td.distillation_loss(torch.zeros(2, 9, 40), torch.tensor(sh), teacher, 2,
                                 alpha_kl=0.0, alpha_feature=0.5, temperature=TEMP,
                                 accumulative=accumulative)
    np.testing.assert_allclose(float(total), 0.5 * float(want), rtol=1e-6)
    s = _logits(5)
    jt = jd.prepare_teacher(jnp.asarray(_logits(6)), jnp.asarray(th), TEMP, jnp.float32)
    tt = td.prepare_teacher(torch.tensor(_logits(6)), torch.tensor(th), TEMP, torch.float32)
    kw = dict(alpha_kl=1.0, alpha_feature=0.0, temperature=TEMP)
    np.testing.assert_allclose(
        float(td.distillation_loss(torch.tensor(s), None, tt, 1, **kw)),
        float(jd.distillation_loss(jnp.asarray(s), jnp.asarray(sh), jt, 1, **kw)), rtol=1e-5)


def _tiny():
    q = dict(bit_widths=(4, 8, 32),
             lora_rank_per_bit={b: 4 for b in range(2, 17)} | {32: 0},
             lora_alpha_per_bit={b: 8 for b in range(2, 17)} | {32: 0})
    m = dict(vocab_size=64, n_positions=16, n_embd=16, n_layer=2, n_head=2)
    return (J.SPModelConfig(model=J.GPT2Config(**m), quant=J.QuantConfig(**q)),
            tc.SPModelConfig(model=tc.GPT2Config(**m), quant=tc.QuantConfig(**q)))


def test_trainable_mask_matches_jax():
    jcfg, tcfg = _tiny()
    jp = J.init_sp_params(jax.random.PRNGKey(0), jcfg)
    want = jst.trainable_mask(jp)
    got = tst.trainable_mask(tsp.init_sp_params(torch.Generator().manual_seed(0), tcfg,
                                                device="cpu"))
    for path, m in jax.tree_util.tree_leaves_with_path(want):
        assert optim.get_leaf(got, tuple(k.key for k in path)) == bool(m), path
    assert not got["wte"] and not got["blocks"]["c_fc"]["iq_zp"]
    assert got["blocks"]["c_fc"]["lora_A"] and got["ln_f"]["g"]


def test_cosine_lr_matches_jax():
    want = jst.cosine_lr(3e-4, 40, 8)
    got = tst.cosine_lr(3e-4, 40, 8)
    for count in (0, 1, 2, 4, 5, 9):
        np.testing.assert_allclose(float(got(count)), float(want(jnp.int32(count))),
                                   rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_clip_adamw_matches_optax(grad_scale):
    """Three steps of clip + AdamW with a cosine LR on a random tree with
    frozen leaves, against the optax chain the JAX trainer builds. With the
    global norm below (0.01) and above (10) max_grad_norm. Updates to 1e-6
    relative of the parameters (float32 rounding); frozen leaves exactly
    unchanged."""
    rng = np.random.default_rng(5)
    tree = {"wte": rng.normal(0, 1, (6, 4)).astype(np.float32),
            "blocks": {"c_fc": {"w": rng.normal(0, 1, (4, 8)).astype(np.float32),
                                "b": rng.normal(0, 1, (8,)).astype(np.float32),
                                "wq_scale": rng.uniform(0.1, 1, (1, 8)).astype(np.float32)}}}
    tcfg = tc.TrainConfig(learning_rate=1e-2, weight_decay=0.1, max_grad_norm=1.0)
    schedule = jst.cosine_lr(tcfg.learning_rate, 24, 8)
    chain = optax.chain(optax.clip_by_global_norm(tcfg.max_grad_norm),
                        optax.adamw(learning_rate=schedule, b1=tcfg.adam_b1,
                                    b2=tcfg.adam_b2, eps=tcfg.adam_epsilon,
                                    weight_decay=tcfg.weight_decay))
    labels = jax.tree.map(lambda m: "train" if m else "freeze", jst.trainable_mask(tree))
    opt = optax.multi_transform({"train": chain, "freeze": optax.set_to_zero()}, labels)
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = opt.init(jp)
    tp = bridge.params_from_numpy(tree, "cpu")
    paths = tst.trainable_paths(tp)
    tstate = optim.adamw_init(tp, paths)
    t_schedule = tst.cosine_lr(tcfg.learning_rate, 24, 8)
    for step in range(3):
        g = jax.tree.map(lambda x: (grad_scale * rng.normal(0, 1, x.shape)).astype(np.float32),
                         tree)
        upd, jstate = opt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        new, tstate = optim.clip_adamw_update(
            tp, {p: torch.tensor(optim.get_leaf(g, p)) for p in paths}, tstate,
            t_schedule(step), max_norm=tcfg.max_grad_norm, b1=tcfg.adam_b1,
            b2=tcfg.adam_b2, eps=tcfg.adam_epsilon, weight_decay=tcfg.weight_decay)
        assert new["wte"] is tp["wte"]
        assert new["blocks"]["c_fc"]["wq_scale"] is tp["blocks"]["c_fc"]["wq_scale"]
        tp = new
        for path, want in jax.tree_util.tree_leaves_with_path(jp):
            got = optim.get_leaf(tp, tuple(k.key for k in path)).numpy()
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {path}")
    assert int(tstate.count) == 3
    np.testing.assert_array_equal(tp["wte"].numpy(), tree["wte"])


def test_unported_trainer_options_raise():
    """The option whose module is not ported raises, naming its ROADMAP
    item, instead of running something else; an unknown student mode
    raises; `forward_fn` and `attention_fn` together raise ValueError, as in
    JAX."""
    _, tcfg = _tiny()
    for kw, item in ((dict(student_mode="vmap"), "A.1b"),
                     (dict(student_mode="nope"), "scan/unroll/vmap")):
        with pytest.raises((NotImplementedError, ValueError), match=item):
            tst.make_sp_train_step(tcfg, tc.TrainConfig(**kw))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tst.make_sp_train_step(tcfg, tc.TrainConfig(), attention_fn=lambda *a: a[0],
                               forward_fn=lambda *a, **k: None)
    with pytest.raises(ValueError, match="mutually exclusive"):
        jst.make_sp_train_step(_tiny()[0], J.TrainConfig(), attention_fn=lambda *a: a[0],
                               forward_fn=lambda *a, **k: None)


def _hooked_steps(**hook):
    """One plain and one hooked train step of the port from the same state,
    generator seed and batch (the students' draws from the generator)."""
    jcfg, tcfg = _tiny()
    jp = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(1), jcfg))
    ids = torch.tensor(np.random.default_rng(1).integers(0, 64, (2, 16)))
    train = tc.TrainConfig(gradient_accumulation_steps=3, num_iterations=4)
    out = []
    for kw in ({}, hook):
        init, step = tst.make_sp_train_step(tcfg, train, **kw)
        out.append(step(init(bridge.params_from_numpy(jp, "cpu")), ids,
                        torch.Generator().manual_seed(5)))
    return out


def test_train_step_forward_fn_replays_the_plain_step():
    """`forward_fn` gets `sp_forward`'s keyword subset (tables, labels,
    deterministic=False, the generator, output_hidden_states=True) and
    replaces the forward of every micro-step; given `sp_forward` itself the
    step is the plain one, bit for bit."""
    calls = []

    def fwd(*a, **kw):
        calls.append(sorted(kw))
        return tsp.sp_forward(*a, **kw)

    (s0, m0), (s1, m1) = _hooked_steps(forward_fn=fwd)
    assert calls == [["deterministic", "dropout_gen", "labels", "output_hidden_states",
                      "tables"]] * 3
    for k in ("loss", "teacher_loss", "student_loss_mean", "grad_norm"):
        assert torch.equal(m1[k], m0[k]), k
    for path, v in optim.leaves_with_paths(s0.params):
        assert torch.equal(optim.get_leaf(s1.params, path), v), path


def test_train_step_attention_fn_matches_the_plain_step():
    """`attention_fn` reaches every block of every micro-step; the dense
    reference given as the hook replays the plain step (which runs the
    same dense path on the CPU) bit for bit."""
    from llm_qat_tpu_torch.ops import attention as ta

    calls = []

    def attn(q, k, v):
        calls.append(q.shape)
        return ta.causal_attention_reference(q, k, v)

    (s0, m0), (s1, m1) = _hooked_steps(attention_fn=attn)
    assert len(calls) == 3 * 2
    for k in ("loss", "teacher_loss", "student_loss_mean", "grad_norm"):
        assert torch.equal(m1[k], m0[k]), k
    for path, v in optim.leaves_with_paths(s0.params):
        assert torch.equal(optim.get_leaf(s1.params, path), v), path
