"""PyTorch port: the int8-weight / int8-KV cases of mega_decode_step_kv8
against the JAX megakernel in interpret mode (bf16 LoRA banks, and
has_lora=False), plus the host-side `pos` check. The shared setup and the
case runner live in test_torch_mega_decode.py."""

import pytest
import torch

from llm_qat_tpu_torch.models import inference as ti
from llm_qat_tpu_torch.ops import mega_decode as tm
from test_torch_mega_decode import B, D_MODEL, H, L, T, calibrated, run_case  # noqa: F401


@pytest.mark.parametrize("case", ["w8kv8_bf16lora_f32", "w8kv8_nolora_f32"])
def test_mega_step_int8_matches_jax_interpret(calibrated, case):  # noqa: F811
    run_case(calibrated, case)


def test_mega_step_checks_pos_on_the_host(calibrated):  # noqa: F811
    """pos outside [0, T) is refused before anything is launched."""
    jcfg, tcfg, jp, tp = calibrated
    tt = ti.quantize_for_inference(tp, tcfg, 4, weight_format="int4_xla")
    tt.pop("_static")
    mw = tm.pack_mega_weights(tt, tcfg)
    kc = torch.zeros((L, B, T, D_MODEL // 2), dtype=torch.int8)
    ks = torch.ones((L, B, T))
    h = torch.zeros((B, D_MODEL))
    for pos in (T, -1):
        with pytest.raises(ValueError, match="outside the cache"):
            tm.mega_decode_step_kv8(h, mw, kc, kc.clone(), ks, ks.clone(), pos,
                                    n_head=H, head_dim=D_MODEL // H,
                                    has_lora=True, kv_bits=4)
