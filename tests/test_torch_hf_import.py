"""PyTorch port: HF GPT-2 import (`models/hf_import.py`) and the
checkpoint-vs-pretrained report (`cli/check_init.py`) against the JAX
package, and, where `transformers` is installed, the port's 32-bit forward
on imported weights against `GPT2LMHeadModel` (offline: a random model the
test builds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import llm_qat_tpu.models as J
from llm_qat_tpu.cli import check_init as jci
from llm_qat_tpu.models import hf_import as jhf
from llm_qat_tpu_torch import bridge
from llm_qat_tpu_torch.cli import check_init as tci
from llm_qat_tpu_torch.deploy import save_checkpoint
from llm_qat_tpu_torch.models import config as tc
from llm_qat_tpu_torch.models import hf_import as thf
from llm_qat_tpu_torch.models import load_hf_gpt2
from llm_qat_tpu_torch.models import sp_model as tsp

M = dict(vocab_size=128, n_positions=32, n_embd=48, n_layer=2, n_head=3)
Q = dict(bit_widths=(8, 32), lora_rank_per_bit={8: 4, 32: 0},
         lora_alpha_per_bit={8: 8, 32: 0})


def _cfgs():
    return (J.SPModelConfig(model=J.GPT2Config(**M), quant=J.QuantConfig(**Q)),
            tc.SPModelConfig(model=tc.GPT2Config(**M), quant=tc.QuantConfig(**Q)))


def _random_state_dict(rng, prefix="transformer.", vocab=140, n_pos=40):
    """Random float32 arrays under GPT-2's names (HF Conv1D (in, out)
    layout); embeddings larger than the config, which the import slices."""
    d, L = M["n_embd"], M["n_layer"]
    sd = {prefix + "wte.weight": rng.normal(size=(vocab, d)),
          prefix + "wpe.weight": rng.normal(size=(n_pos, d)),
          prefix + "ln_f.weight": rng.normal(size=(d,)),
          prefix + "ln_f.bias": rng.normal(size=(d,))}
    shapes = {"attn.c_attn": (d, 3 * d), "attn.c_proj": (d, d),
              "mlp.c_fc": (d, 4 * d), "mlp.c_proj": (4 * d, d)}
    for i in range(L):
        for name, (a, b) in shapes.items():
            sd[f"{prefix}h.{i}.{name}.weight"] = rng.normal(size=(a, b))
            sd[f"{prefix}h.{i}.{name}.bias"] = rng.normal(size=(b,))
        for ln in ("ln_1", "ln_2"):
            sd[f"{prefix}h.{i}.{ln}.weight"] = rng.normal(size=(d,))
            sd[f"{prefix}h.{i}.{ln}.bias"] = rng.normal(size=(d,))
    return {k: v.astype(np.float32) for k, v in sd.items()}


def _assert_tree_equal(t_tree, j_tree):
    assert set(t_tree) == set(j_tree)
    for k, v in j_tree.items():
        if isinstance(v, dict):
            _assert_tree_equal(t_tree[k], v)
        else:
            got = t_tree[k]
            assert got.dtype == torch.float32 and got.device.type == "cpu"
            np.testing.assert_array_equal(got.numpy(), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("prefix,as_torch", [("transformer.", False), ("", True)])
def test_state_dict_import_matches_jax(prefix, as_torch):
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, J.init_sp_params(jax.random.PRNGKey(0), jcfg))
    sd = _random_state_dict(np.random.default_rng(1), prefix)
    want = jhf.hf_state_dict_to_sp_params(sd, jax.tree.map(jnp.asarray, jp), jcfg)
    t_sd = {k: torch.from_numpy(v) for k, v in sd.items()} if as_torch else sd
    tp = bridge.params_from_numpy(jp, "cpu")
    got = thf.hf_state_dict_to_sp_params(t_sd, tp, tcfg)
    _assert_tree_equal(got, jax.tree.map(np.asarray, want))
    # the input tree is left as it was; LoRA and quantizer banks kept
    assert torch.equal(tp["wte"], torch.tensor(jp["wte"]))
    assert got["blocks"]["c_attn"]["lora_A"] is tp["blocks"]["c_attn"]["lora_A"]


@pytest.fixture(scope="module")
def hf_pair():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=128, n_positions=32, n_embd=48, n_layer=2, n_head=3,
        activation_function="gelu",  # exact erf GELU, as the SP forward
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    hf = transformers.GPT2LMHeadModel(hf_cfg).eval()
    jcfg, tcfg = _cfgs()
    jp = J.init_sp_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return hf, tcfg, load_hf_gpt2(tp, tcfg, hf), jcfg, jhf.load_hf_gpt2(jp, jcfg, hf)


def test_logits_and_loss_match_gpt2lmheadmodel(hf_pair):
    """At the 32-bit slot, the limits of `tests/test_hf_import.py`."""
    hf, tcfg, tp, _, _ = hf_pair
    ids = torch.tensor(np.random.default_rng(0).integers(0, 128, (2, 16)))
    with torch.no_grad():
        want = hf(ids, labels=ids)
    got = tsp.sp_forward(tp, ids, tcfg.quant.prec_index(32), tcfg, labels=ids)
    np.testing.assert_allclose(got["logits"].numpy(), want.logits.numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(got["loss"]), float(want.loss), rtol=1e-3, atol=1e-3)
    g = tp["blocks"]["ln1"]["g"]
    assert torch.equal(g[:, 0], g[:, 1])
    assert torch.equal(g[0, 0], hf.transformer.h[0].ln_1.weight.detach())


def test_model_object_import_matches_jax(hf_pair):
    _, _, tp, _, jp = hf_pair
    _assert_tree_equal(tp, jax.tree.map(np.asarray, jp))


def test_check_init_report_matches_jax(hf_pair):
    hf, _, tp, _, jp = hf_pair
    sd = hf.state_dict()
    got, want = tci.compare_with_pretrained(tp, sd), jci.compare_with_pretrained(jp, sd)
    assert got == want
    assert got["summary"]["initialized_from_pretrained"]
    assert got["summary"]["n_mismatch"] == 0
    moved = dict(tp, wte=tp["wte"] + 1.0)
    got = tci.compare_with_pretrained(moved, sd)
    assert got == jci.compare_with_pretrained(dict(jp, wte=jp["wte"] + 1.0), sd)
    assert not got["summary"]["initialized_from_pretrained"]
    assert any(m[0] == "wte" for m in got["mismatches"])


def test_check_init_main(hf_pair, tmp_path, monkeypatch, capsys):
    """The command on a saved checkpoint, its pretrained model the test's
    (no hub)."""
    import transformers

    hf, tcfg, tp, _, _ = hf_pair
    path = tmp_path / "ckpt.npz"
    save_checkpoint(path, tp, tcfg, bit_width=8)
    monkeypatch.setattr(transformers.GPT2LMHeadModel, "from_pretrained",
                        classmethod(lambda cls, name, **k: hf))
    report = tci.main(["--model-path", str(path), "--pretrained", "x"], device="cpu")
    assert report["summary"]["initialized_from_pretrained"]
    assert "initialized_from_pretrained" in capsys.readouterr().out


def test_load_by_name_asks_no_hub(monkeypatch):
    """A model name is asked for with the data loaders' offline defaults
    set and local files only, so an offline run fails fast instead of
    asking the hub (whatever the process imported before); a caller's own
    HF_HUB_OFFLINE=0 is kept."""
    import os
    import sys
    import types

    seen = []

    class Model:
        @classmethod
        def from_pretrained(cls, name, local_files_only=False):
            seen.append((name, os.environ.get("HF_HUB_OFFLINE"),
                         os.environ.get("TRANSFORMERS_OFFLINE"), local_files_only))
            raise OSError("not cached")

    fake = types.ModuleType("transformers")
    fake.GPT2LMHeadModel = Model
    monkeypatch.setitem(sys.modules, "transformers", fake)
    env = {k: v for k, v in os.environ.items() if not k.endswith("_OFFLINE")}
    monkeypatch.setattr(os, "environ", env)
    _, tcfg = _cfgs()
    tp = {"wte": torch.zeros(1)}
    with pytest.raises(OSError, match="not cached"):
        load_hf_gpt2(tp, tcfg, "gpt2")
    assert seen == [("gpt2", "1", "1", True)]
    env["HF_HUB_OFFLINE"] = "0"
    with pytest.raises(OSError):
        load_hf_gpt2(tp, tcfg, "gpt2")
    assert seen[-1] == ("gpt2", "0", "1", False)
