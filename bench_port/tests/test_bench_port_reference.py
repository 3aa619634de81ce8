"""The references against the system's plain path at a tiny size on the CPU,
where every kernel wrapper of the system runs its plain version."""

import time

import numpy as np
import pytest
import torch

from bench_port.tests.tiny import tiny_cell, workloads


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_train_reference_follows_the_system_step():
    from bench_port.harness import train_cell

    cell = tiny_cell("gpt2-124m.train-sp-vmap")
    out = train_cell.run(cell, 20261018, 0.2, False, torch.device("cpu"), time.perf_counter())
    n = {k: v["value"] for k, v in out["numbers"].items()}
    # both in bf16 products with float32 sums; they differ in summation order,
    # the fused weight fake-quant's rounding of the log code, and attention's
    assert n["teacher_loss"] < 1e-4 and n["student_loss"] < 5e-3
    assert n["grad1"] < 5e-3 and n["change"] < 0.1
    assert out["attempted"] >= 1 and out["failed"] == 0


def _served(act_dtype, seed=1):
    """One request through the system's engine on the CPU, the logits of
    every token it produced, and the reference beside it."""
    import llm_qat_tpu_torch.serving.engine as E
    from llm_qat_tpu_torch.train.calibration_manager import (
        calibrate_input_quantizers,
        calibrate_weight_quantizers,
    )

    from bench_port.harness.serve_cell import decode_block
    from bench_port.harness.train_cell import build_cfg, ref_dims
    from bench_port.harness.weights import make_params
    from bench_port.reference.served import Served

    cell = tiny_cell(workloads("serve")[-1])
    config, traffic = cell.config, cell.traffic
    cfg, _ = build_cfg(config, traffic)
    gen = torch.Generator().manual_seed(seed)
    params = make_params(config, cfg.quant.bit_widths, cfg.quant.max_rank,
                         cfg.quant.per_channel, gen, "cpu")
    cal = [torch.randint(0, 512, (2, 32), generator=gen)]
    calp = calibrate_input_quantizers(calibrate_weight_quantizers(params, cfg), cfg, cal,
                                      precisions=[4])
    seen = []
    orig = E._sample_slots

    def spy(logits, *a, **k):
        seen.append(logits.detach().clone())
        return orig(logits, *a, **k)

    E._sample_slots = spy
    try:
        eng = E.ContinuousBatchingEngine(
            calp, cfg, bits=4, n_slots=1, max_len=256, weight_format="int4_xla",
            lm_head_bits=8, kv_layout="mega", kv_bits=4, mega_tbp=traffic["mega_tbp"],
            device="cpu", dtype=act_dtype)
        prompt = torch.randint(0, 512, (20,), generator=gen).numpy().astype(np.int32)
        eng.submit(prompt, max_new_tokens=40)
        while eng.queue or any(r is not None for r in eng.slot_req):
            eng.step_chunk(traffic["chunk"])
    finally:
        E._sample_slots = orig
    served = torch.tensor(eng.finished[0].generated)
    prog = torch.cat(seen)[: len(served)]
    ref = Served(params, ref_dims(config, traffic), 4, cal, 4, 8, traffic["chunk"],
                 decode_block(traffic))
    ids = torch.cat([torch.as_tensor(prompt).long(), served[:-1]])
    return prog, ref, ids, served


def test_served_reference_is_the_engine_in_float32():
    """In float32 activations the engine's prefill and decode come out of
    the reference's one forward; the first token differs by the prefill
    head's activation scale, taken over the padded prompt."""
    prog, ref, ids, served = _served(torch.float32)
    r = ref.logits(ids, 20, act="f32")[19:]
    assert (prog[0] - r[0]).abs().max() < 0.02
    assert (prog[1:] - r[1:]).abs().max() < 1e-3
    assert torch.equal(r.argmax(-1), served)


def test_served_reference_holds_the_engine_in_bf16():
    prog, ref, ids, served = _served(torch.bfloat16)
    r = ref.logits(ids, 20)[19:]
    assert (prog[0] - r[0]).abs().max() < 0.02
    # a float32 ulp in another summation order can move an activation code
    # at a rounding boundary, after which the rest differs a little
    assert (prog.argmax(-1) == r.argmax(-1)).float().mean() > 0.8
