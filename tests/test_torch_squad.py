"""PyTorch port, SQuAD QA: the windows, spans and batches, `extract_answer`,
`qa_forward` (deterministic and with the dropout uniforms it shares with
the trunk's embedding dropout), `qa_kl_loss`, one squad train step with
JAX's draws replayed, and `evaluate_squad_model`, each held against the
JAX package on the CPU.

Tiny config: `tiny_test_config((4, 8, 32))` (L = 2, n_embd 32, n_head 2,
vocab 256, n_positions 64, LoRA rank 4; 4 bits minmax, 8 bits log),
embedding dropout 0.1, float32; windows of 64 from the synthetic SQuAD
set under `OffsetByteTokenizer`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.data import squad as jsq
from llm_qat_tpu.evals import squad_eval as jse
from llm_qat_tpu.models import qa as jqa
from llm_qat_tpu.train import calibration_manager as jcm
from llm_qat_tpu.train import squad_trainer as jtr
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.data import squad as tsq
from llm_qat_tpu_torch.evals import squad_eval as tse
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import qa as tqa
from llm_qat_tpu_torch.models import sp_model as tsp
from llm_qat_tpu_torch.train import optim
from llm_qat_tpu_torch.train import sp_trainer as tst
from llm_qat_tpu_torch.train import squad_trainer as ttr
from test_torch_train_model import clear_log_ties

BITS = (4, 8, 32)
MAXLEN, B = 64, 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops (restored
    after the module): pytest-xdist runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch_tensors(batch):
    out = {k: torch.as_tensor(v) for k, v in batch.items() if k != "example_ids"}
    out["input_ids"] = out["input_ids"].long()
    return out


@pytest.fixture(scope="module")
def setup():
    """JAX QA init with non-zero LoRA B, calibrated by the JAX package at 4
    and 8 bits and clear of 8-bit log ties (numpy tree), and a batch of
    windows with padding."""
    jcfg, tcfg = J.tiny_test_config(BITS), tc.tiny_test_config(BITS)
    p = jax.tree.map(np.asarray, jqa.init_qa_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    cal = [jnp.asarray(rng.integers(0, 256, (2, MAXLEN))) for _ in range(2)]
    p = jcm.CalibrationManager(jcfg, 2).calibrate_all_precisions(
        jax.tree.map(jnp.asarray, p), cal)
    p = clear_log_ties(jax.tree.map(np.asarray, p), jcfg.quant)
    ds = tsq.SQuADDataset(tsq.synthetic_squad(12, seed=1), tsq.OffsetByteTokenizer(),
                          MAXLEN, 32, max_query_length=16)
    batch = next(ds.batches(B))
    assert batch["attention_mask"].min() == 0  # padded windows
    return jcfg, tcfg, p, ds, batch


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


def _long_examples():
    """Synthetic examples with contexts long enough for several windows,
    answers early, late and past the end of a window, one unanswerable."""
    base = tsq.synthetic_squad(6, seed=3)
    out = []
    for i, ex in enumerate(base):
        pad = "filler words go here. " * (3 + 2 * i)
        ctx = (pad + ex["context"]) if i % 2 else (ex["context"] + pad)
        ans = dict(ex["answers"])
        if ans["text"]:
            ans = {"text": ans["text"], "answer_start": [ctx.index(ans["text"][0])]}
        out.append({**ex, "context": ctx, "answers": ans})
    out.append({"id": "none", "question": "Why?", "context": "No answer here.",
                "answers": {"text": [], "answer_start": []}})
    return out


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("max_length,stride,max_q", [(64, 64, 64), (48, 16, 8),
                                                     (40, 12, 64), (384, 128, 64)])
def test_windows_and_spans_match_jax(version, max_length, stride, max_q):
    """`preprocess_squad_examples` on the synthetic set (v2: every fourth
    example unanswerable) and on long contexts: every window's ids, mask,
    span, example id and question length equal JAX's."""
    examples = jsq.synthetic_squad(16, seed=2, unanswerable=version == "v2")
    examples = examples + _long_examples()
    want = jsq.preprocess_squad_examples(examples, jsq.OffsetByteTokenizer(),
                                         max_length, stride, max_q)
    got = tsq.preprocess_squad_examples(examples, tsq.OffsetByteTokenizer(),
                                        max_length, stride, max_q)
    assert len(got) == len(want) > len(examples) - 1
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert any(f["start_positions"] > 0 for f in got)
    assert any(f["start_positions"] == 0 for f in got)


def test_find_answer_span_matches_jax():
    offsets = [(i, i + 1) for i in range(40)]
    for answers in ({"text": ["abc"], "answer_start": [5]},
                    {"text": ["abc"], "answer_start": [38]},
                    {"text": [], "answer_start": []}, {}):
        for chunk in ((0, 40), (0, 6), (4, 20), (30, 40)):
            assert tsq.find_answer_span(answers, offsets, *chunk, 3) == \
                jsq.find_answer_span(answers, offsets, *chunk, 3)


@pytest.mark.parametrize("shuffle,seed,drop_last", [(False, 0, True), (True, 3, True),
                                                    (True, 4, False)])
def test_batches_match_jax(shuffle, seed, drop_last):
    """`SQuADDataset.batches`: the same windows in the same order
    (`np.random.default_rng(seed)`'s shuffle), with the same dtypes."""
    examples = jsq.synthetic_squad(10, seed=5) + _long_examples()
    jd = jsq.SQuADDataset(examples, jsq.OffsetByteTokenizer(), 48, 16)
    td = tsq.SQuADDataset(examples, tsq.OffsetByteTokenizer(), 48, 16)
    assert len(td) == len(jd)
    jb = list(jd.batches(3, shuffle=shuffle, seed=seed, drop_last=drop_last))
    tb = list(td.batches(3, shuffle=shuffle, seed=seed, drop_last=drop_last))
    assert len(tb) == len(jb)
    for g, w in zip(tb, jb):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            if k != "example_ids":
                assert g[k].dtype == w[k].dtype


def test_synthetic_squad_and_offline_load(monkeypatch):
    """The synthetic set equals JAX's; `load_squad_examples` passes
    `local_files_only` when the hub is off and falls back to it."""
    import sys
    import types

    assert tsq.synthetic_squad(9, 4, True) == jsq.synthetic_squad(9, 4, True)
    seen = {}

    def load_dataset(name, split, download_config):
        seen.update(name=name, split=split, cfg=download_config)
        raise OSError("offline")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setitem(sys.modules, "datasets", types.SimpleNamespace(
        load_dataset=load_dataset, DownloadConfig=lambda **k: k))
    assert tsq.load_squad_examples("v2", "validation", limit=7) == \
        jsq.synthetic_squad(n=7, unanswerable=True)
    assert seen == {"name": "squad_v2", "split": "validation",
                    "cfg": {"local_files_only": True}}
    tok = tsq.OffsetByteTokenizer()
    assert tok.decode(tok("héllo")) == jsq.OffsetByteTokenizer().decode(
        jsq.OffsetByteTokenizer()("héllo"))


# ---------------------------------------------------------------------------
# Answer extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_extract_answer_matches_jax(seed):
    """The same best span, score and text on identical logits, with and
    without the question exclusion, at several length limits."""
    rng = np.random.default_rng(seed)
    s = rng.normal(size=48).astype(np.float32)
    e = rng.normal(size=48).astype(np.float32)
    ids = rng.integers(97, 123, 48)
    tok = tsq.OffsetByteTokenizer()
    for kw in (dict(), dict(max_answer_length=3, n_best_size=5, question_length=10),
               dict(max_answer_length=1, n_best_size=2, question_length=47)):
        assert tse.extract_answer(s, e, ids, tok, **kw) == \
            jse.extract_answer(s, e, ids, jsq.OffsetByteTokenizer(), **kw)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------


# start/end logits and hidden states within 1e-5 absolute (logits about
# 0.1; float32 summation order, measured 1.5e-7 and 1.6e-6), the loss
# within 1e-5 relative (measured 1.1e-7). At the 8-bit log slot an
# activation on a code boundary takes the neighbouring code in the other
# package (XLA's and PyTorch's float32 log2 differ by an ulp) and moves the
# positions after it: at most 5 % of the values beyond 1e-5 (measured 1.6
# %), none beyond FLIP_ATOL (measured 5.1e-4 on the logits, 4.7e-3 on the
# hidden states).
QA_ATOL, QA_RTOL = 1e-5, 1e-5
FLIP_SHARE = 0.05
FLIP_ATOL = {"start_logits": 5e-3, "end_logits": 5e-3, "hidden_states": 5e-2}


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("dropout", [False, True])
def test_qa_forward_matches_jax(setup, slot, dropout):
    """`qa_forward` at each slot, deterministic and with dropout: JAX draws
    the QA dropout with the same key and shape as the trunk's embedding
    dropout, so both masks come from the same uniforms (and, at keep 0.9
    for both, are the same mask). The port takes those uniforms."""
    jcfg, tcfg, p, _, batch = setup
    key = jax.random.PRNGKey(11 + slot)
    shape = (B, MAXLEN, jcfg.model.n_embd)
    u = jax.random.uniform(key, shape)
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(key, 0.9, shape)),
                                  np.asarray(u < 0.9))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "example_ids"}
    jo = jqa.qa_forward(jax.tree.map(jnp.asarray, p), jb["input_ids"], slot, jcfg,
                        attention_mask=jb["attention_mask"],
                        start_positions=jb["start_positions"],
                        end_positions=jb["end_positions"],
                        deterministic=not dropout, dropout_rng=key if dropout else None,
                        output_hidden_states=True)
    tb = _batch_tensors(batch)
    with torch.no_grad():
        to = tqa.qa_forward(bridge.params_from_numpy(p, "cpu"), tb["input_ids"], slot, tcfg,
                            attention_mask=tb["attention_mask"],
                            start_positions=tb["start_positions"],
                            end_positions=tb["end_positions"],
                            deterministic=not dropout,
                            dropout_gen=torch.tensor(np.asarray(u)) if dropout else None,
                            output_hidden_states=True)
    log_slot = jcfg.quant.kind_name(BITS[slot]) == "log"
    for k in ("start_logits", "end_logits", "hidden_states"):
        d = np.abs(to[k].numpy() - np.asarray(jo[k]))
        if log_slot:
            assert (d > QA_ATOL).mean() <= FLIP_SHARE, k
            assert d.max() <= FLIP_ATOL[k], (k, d.max())
        else:
            assert d.max() <= QA_ATOL, (k, d.max())
    np.testing.assert_allclose(float(to["loss"]), float(jo["loss"]), rtol=QA_RTOL)


def test_qa_dropout_from_a_generator_shares_the_trunks_uniforms(setup):
    """With a generator, the uniforms are drawn once a forward and shared:
    the QA mask and the embedding mask are the same draw (the forward
    equals one given those uniforms), and the generator moves on."""
    _, tcfg, p, _, batch = setup
    tb = _batch_tensors(batch)
    tp = bridge.params_from_numpy(p, "cpu")
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((B, MAXLEN, tcfg.model.n_embd), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        a = tqa.qa_forward(tp, tb["input_ids"], 0, tcfg, deterministic=False,
                           dropout_gen=gen, attention_mask=tb["attention_mask"])
        b = tqa.qa_forward(tp, tb["input_ids"], 0, tcfg, deterministic=False,
                           dropout_gen=u, attention_mask=tb["attention_mask"])
        c = tqa.qa_forward(tp, tb["input_ids"], 0, tcfg, deterministic=False,
                           dropout_gen=gen, attention_mask=tb["attention_mask"])
    assert torch.equal(a["start_logits"], b["start_logits"])
    assert not torch.equal(a["start_logits"], c["start_logits"])


def test_skipped_head_leaves_qa_and_sp_outputs_unchanged(setup):
    """`sp_forward(_skip_head=True)` (what `qa_forward` runs) gives the same
    trunk, hidden states and stats as the full forward and no logits; the
    full forward keeps its logits; the QA heads read that trunk."""
    _, tcfg, p, _, batch = setup
    tb = _batch_tensors(batch)
    tp = bridge.params_from_numpy(p, "cpu")
    kw = dict(mask=tb["attention_mask"], output_hidden_states=True, collect_stats=True)
    with torch.no_grad():
        full = tsp.sp_forward(tp, tb["input_ids"], 1, tcfg, **kw)
        skip = tsp.sp_forward(tp, tb["input_ids"], 1, tcfg, _skip_head=True, **kw)
        qa = tqa.qa_forward(tp, tb["input_ids"], 1, tcfg,
                            attention_mask=tb["attention_mask"])
    assert "logits" not in skip and tuple(full["logits"].shape) == (B, MAXLEN, 256)
    for k in ("trunk", "hidden_states"):
        assert torch.equal(full[k], skip[k]), k
    for name, st in full["stats"].items():
        for k, v in st.items():
            assert torch.equal(v, skip["stats"][name][k])
    want = (full["trunk"] @ tp["qa_start"]["w"] + tp["qa_start"]["b"])[..., 0]
    assert torch.equal(qa["start_logits"], want)
    with pytest.raises(KeyError):
        tsp.sp_forward(tp, tb["input_ids"], 1, tcfg, labels=tb["input_ids"], _skip_head=True)


def test_qa_loss_and_kl_match_jax():
    """`qa_loss_fn` with ignored (-1) positions (float32 log-softmax:
    1e-5 relative, measured 1.5e-6), and `qa_kl_loss` at two temperatures
    (1e-5 relative, measured 1.2e-6)."""
    rng = np.random.default_rng(7)
    s = rng.normal(size=(3, 20)).astype(np.float32)
    t = rng.normal(size=(3, 20)).astype(np.float32)
    pos = np.asarray([4, -1, 19], np.int32)
    np.testing.assert_allclose(
        float(tqa.qa_loss_fn(torch.tensor(s), torch.tensor(t), torch.tensor(pos),
                             torch.tensor(pos[::-1].copy()))),
        float(jqa.qa_loss_fn(jnp.asarray(s), jnp.asarray(t), jnp.asarray(pos),
                             jnp.asarray(pos[::-1].copy()))), rtol=1e-5)
    all_ignored = torch.full((3,), -1)
    assert float(tqa.qa_loss_fn(torch.tensor(s), torch.tensor(s), all_ignored,
                                all_ignored)) == 0.0
    for temp in (1.0, 3.0):
        np.testing.assert_allclose(
            float(ttr.qa_kl_loss(torch.tensor(s), torch.tensor(t), temp)),
            float(jtr.qa_kl_loss(jnp.asarray(s), jnp.asarray(t), temp)), rtol=1e-5)
    assert abs(float(ttr.qa_kl_loss(torch.tensor(s), torch.tensor(s), 3.0))) < 1e-6


def test_init_qa_params_layout():
    jcfg, tcfg = J.tiny_test_config(BITS), tc.tiny_test_config(BITS)
    jp = jax.tree.map(np.asarray, jqa.init_qa_params(jax.random.PRNGKey(0), jcfg))
    tp = tqa.init_qa_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    jl = {tuple(k.key for k in path): a.shape
          for path, a in jax.tree_util.tree_leaves_with_path(jp)}
    assert jl == {path: tuple(t.shape) for path, t in optim.leaves_with_paths(tp)}
    assert not tp["qa_end"]["b"].any() and abs(float(tp["qa_start"]["w"].std()) - 0.02) < 0.01


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_setup(setup):
    """The squad step's config: bits (3, 4, 32), both students minmax (the
    log slot's code flips are held in test_qa_forward_matches_jax and the
    SP step's tests), calibrated by the JAX package."""
    _, _, _, ds, batch = setup
    bits = (3, 4, 32)
    jcfg, tcfg = J.tiny_test_config(bits), tc.tiny_test_config(bits)
    p = jax.tree.map(np.asarray, jqa.init_qa_params(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(1)
    for lin in ("c_attn", "attn_proj", "c_fc", "mlp_proj"):
        b = p["blocks"][lin]["lora_B"]
        p["blocks"][lin]["lora_B"] = rng.normal(0, 0.05, b.shape).astype(np.float32)
    cal = [jnp.asarray(rng.integers(0, 256, (2, MAXLEN))) for _ in range(2)]
    p = jcm.CalibrationManager(jcfg, 2).calibrate_all_precisions(
        jax.tree.map(jnp.asarray, p), cal)
    return jcfg, tcfg, jax.tree.map(np.asarray, p), batch


ACCUM = 3
TRAIN = dict(batch_size=B, learning_rate=1e-2, adam_epsilon=1.0, num_iterations=4,
             gradient_accumulation_steps=ACCUM)
# Relative limits, about 10x the spread measured: loss 1e-6 (measured
# 1.1e-7), teacher loss 1e-6 (0), grad_norm 1e-6 (1.2e-7). A large Adam
# epsilon makes the first updates about lr·g, linear in the gradient (as in
# test_torch_train_step.py); each trainable leaf's update within 1e-3 of
# its largest magnitude (measured 1.6e-4, attn_proj's LoRA A; 5.7e-5 at
# most elsewhere). Frozen leaves unchanged.
SQ_RTOL = {"loss": 1e-6, "teacher_loss": 1e-6, "grad_norm": 1e-6}
SQ_UPDATE_TOL = 1e-3


def _replayed_draws(rng, jcfg, shape):
    """The student slots, feature layers and dropout uniforms (teacher
    first) the JAX step draws from rng."""
    q = jcfg.quant
    rng_t, rng_p, rng_l, rng_d = jax.random.split(rng, 4)
    slots = np.asarray([q.prec_index(b) for b in q.student_bits], np.int32)
    n = ACCUM - 1
    precs = jax.random.choice(rng_p, jnp.asarray(slots), shape=(n,))
    layers = jax.random.randint(rng_l, (n,), 0, jcfg.model.n_layer + 1)
    keys = [rng_t] + list(jax.random.split(rng_d, n))
    uniforms = [torch.tensor(np.asarray(jax.random.uniform(k, shape))) for k in keys]
    return np.array(precs), np.array(layers), uniforms


def test_squad_train_step_matches_jax(train_setup):
    """One step of both packages from the same parameters and batch, with
    the JAX step's student slots, feature layers and dropout uniforms
    replayed: loss, teacher loss, `grad_norm` (over every gradient, wte and
    wpe included, as JAX reports it), the updated trainable leaves (the QA
    heads among them), the frozen leaves unchanged."""
    jcfg, tcfg, p, batch = train_setup
    jtc, ttc = J.TrainConfig(**TRAIN), tc.TrainConfig(**TRAIN)
    j_init, j_step = jtr.make_squad_train_step(jcfg, jtc)
    t_init, t_step = ttr.make_squad_train_step(tcfg, ttc)
    j_state = j_init(jax.tree.map(jnp.asarray, p))
    t_state = t_init(bridge.params_from_numpy(p, "cpu"))
    rng = jax.random.PRNGKey(21)
    precs, layers, uniforms = _replayed_draws(rng, jcfg, (B, MAXLEN, jcfg.model.n_embd))
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "example_ids"}
    j_new, jm = jax.jit(j_step)(j_state, jb, rng)
    t_new, tm = t_step(t_state, _batch_tensors(batch), torch.Generator().manual_seed(0),
                       precs=precs, layers=layers, uniforms=uniforms)
    assert t_new.step == int(j_new.step) == 1
    for key, rtol in SQ_RTOL.items():
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=rtol, err_msg=key)
    mask = dict(optim.leaves_with_paths(tst.trainable_mask(p)))
    assert mask[("qa_start", "w")] and mask[("qa_end", "b")] and not mask[("wte",)]
    for path, trainable in mask.items():
        jn = np.asarray(optim.get_leaf(j_new.params, path))
        tn = optim.get_leaf(t_new.params, path)
        if not trainable:
            assert tn is optim.get_leaf(t_state.params, path), path
            np.testing.assert_array_equal(jn, optim.get_leaf(p, path))
            continue
        dj = jn - optim.get_leaf(p, path)
        dt = tn.numpy() - optim.get_leaf(p, path)
        if path[0].startswith("qa_") and path[1] == "b":
            # Σ(softmax - one-hot) = 0: float32 leaves about 1e-8 of gradient
            assert np.abs(dt - dj).max() <= 1e-9, path
            continue
        err = np.abs(dt - dj).max() / np.abs(dj).max()
        assert err <= SQ_UPDATE_TOL, f"{path}: {err:.2e}"


def test_squad_grad_norm_counts_wte_and_wpe(setup, monkeypatch):
    """The step's grad_norm is over the trainable leaves' gradients and
    wte's and wpe's (non-zero: the embedding gather), while the clip sees
    the trainable leaves alone."""
    _, tcfg, p, _, batch = setup
    norms = []
    monkeypatch.setattr(optim, "global_norm",
                        lambda ts, f=optim.global_norm: norms.append(list(ts)) or f(ts))
    t_init, t_step = ttr.make_squad_train_step(tcfg, tc.TrainConfig(**TRAIN))
    state = t_init(bridge.params_from_numpy(p, "cpu"))
    _, m = t_step(state, _batch_tensors(batch), torch.Generator().manual_seed(0))
    n_train = len(tst.trainable_paths(p))
    clip, metric = norms
    assert len(clip) == n_train and len(metric) == n_train + 2
    wpe, wte = metric[-2:]
    assert wte.shape == (256, 32) and wpe.shape == (64, 32)
    assert float(wte.abs().sum()) > 0 and float(wpe.abs().sum()) > 0
    assert float(m["grad_norm"]) > float(optim.global_norm(metric[:n_train]))


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


def test_evaluate_squad_model_matches_jax(setup):
    """EM/F1 over every window (several windows per example, the best span
    kept) from the same logits function in both packages (a fixed
    function of the ids, so the logits are identical); and with the QA
    model of each package at the teacher slot, the same EM/F1."""
    jcfg, tcfg, p, ds, _ = setup
    examples = tsq.synthetic_squad(12, seed=1)
    refs = {ex["id"]: list(ex["answers"]["text"]) for ex in examples}
    w = np.random.default_rng(9).normal(size=(256, 2)).astype(np.float32)

    def np_logits(ids):
        ids = np.clip(np.asarray(ids), 0, 255)
        return w[ids, 0] + 0.01 * np.arange(ids.shape[1]), w[ids, 1]

    jds = jsq.SQuADDataset(examples, jsq.OffsetByteTokenizer(), MAXLEN, 32, 16)
    want = jse.evaluate_squad_model(lambda ids, m: np_logits(ids), jds,
                                    jsq.OffsetByteTokenizer(), refs, batch_size=5)
    got = tse.evaluate_squad_model(
        lambda ids, m: tuple(torch.tensor(x) for x in np_logits(ids.numpy())), ds,
        tsq.OffsetByteTokenizer(), refs, batch_size=5, device="cpu")
    assert got == want and got["total"] == 12

    jp, tp = jax.tree.map(jnp.asarray, p), bridge.params_from_numpy(p, "cpu")

    @jax.jit
    def jfn(ids, mask):
        out = jqa.qa_forward(jp, ids, 2, jcfg, attention_mask=mask)
        return out["start_logits"], out["end_logits"]

    def tfn(ids, mask):
        out = tqa.qa_forward(tp, ids, 2, tcfg, attention_mask=mask)
        return out["start_logits"], out["end_logits"]

    want = jse.evaluate_squad_model(jfn, jds, jsq.OffsetByteTokenizer(), refs, batch_size=8)
    got = tse.evaluate_squad_model(tfn, ds, tsq.OffsetByteTokenizer(), refs, batch_size=8,
                                   device="cpu")
    assert got == want
