"""Each operation and byte counter of the per-layer metrics against a count
by hand at a tiny shape: every product of the step listed and summed."""

import pytest

from bench_port.harness.spec import load_reader

LINEAR_SHAPES = lambda d: [(d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)]


def _attention_macs(T, d):
    """q·kᵀ and p·v, causal: position t meets t + 1 keys, over all heads."""
    return sum(2 * d * (t + 1) for t in range(T))


def _token_forward(d, L, V, T, r, student):
    """FLOPs of one micro-step's forward over T tokens, by product."""
    total = 0
    for _ in range(L):
        for k, n in LINEAR_SHAPES(d):
            total += 2 * T * k * n
            if student:
                total += 2 * T * (k * r + r * n)
        total += 2 * _attention_macs(T, d)
    return total + 2 * T * d * V


def _token_backward(d, L, V, T, r, student):
    total = 0
    for _ in range(L):
        for k, n in LINEAR_SHAPES(d):
            total += 2 * (2 * T * k * n)              # dX and dW
            if student:
                total += 2 * (2 * T * (k * r + r * n))  # dX through A, B; dA, dB
        total += 2 * (2 * _attention_macs(T, d))      # dQ, dK, dV, dP
    return total + 2 * T * d * V                        # dX of the head only


@pytest.mark.parametrize("student", [False, True])
def test_train_mfu_microstep_count(student):
    mfu = load_reader("train.mfu")
    d, L, V, T, r = 4, 2, 7, 3, 2
    by_hand = _token_forward(d, L, V, T, r, student) + _token_backward(d, L, V, T, r, student)
    assert mfu.microstep_flops_per_token(d, L, V, T, r, student) * T == by_hand


def test_train_mfu_iteration_and_share():
    mfu = load_reader("train.mfu")
    config = {"n_embd": 4, "n_layer": 2, "vocab_size": 7, "quant": {"lora_rank": 2}}
    traffic = {"seq_len": 3, "batch_size": 5, "accum": 4}
    want = 5 * (_token_forward(4, 2, 7, 3, 2, False) + _token_backward(4, 2, 7, 3, 2, False)
                + 3 * (_token_forward(4, 2, 7, 3, 2, True) + _token_backward(4, 2, 7, 3, 2, True)))
    assert mfu.iteration_flops(config, traffic) == want
    ctx = {"device_name": "NVIDIA H100 80GB HBM3", "config": config,
           "traffic": traffic, "window": {"iter_s": want / 989e12}}
    assert mfu.read(ctx) == pytest.approx(100.0)
    assert mfu.read(dict(ctx, device_name="a card the table lacks")) is None


def test_fused_linear_launch_costs():
    fl = load_reader("train.fused_linear_roofline")
    S, M, K, N, r = 2, 4, 8, 16, 2
    # #14: xq, xa, bq (bf16), scales and zero points (f32) per student, the
    # shared f32 weight and bias once, the f32 output
    assert fl.launch_cost("fwd", S, M, K, N, r) == (
        S * (2 * M * K * N + 2 * M * r * N),
        S * M * K * 2 + S * M * r * 2 + S * r * N * 2 + S * N * 4 * 2 + K * N * 4 + N * 4
        + S * M * N * 4)
    # #15: g, bq in; dxq and dxa (f32) out
    assert fl.launch_cost("dx", S, M, K, N, r) == (
        S * (2 * M * N * K + 2 * M * N * r),
        S * M * N * 2 + S * r * N * 2 + S * N * 8 + K * N * 4 + S * M * K * 4 + S * M * r * 4)
    # #16: xq, g in; each student's dW (f32) out
    assert fl.launch_cost("dw", S, M, K, N, r) == (S * 2 * M * K * N,
                                                   S * (M * K * 2 + M * N * 2 + K * N * 4))


def test_fused_linear_launches_of_an_iteration():
    fl = load_reader("train.fused_linear_roofline")
    config = {"n_embd": 4, "n_layer": 3, "quant": {"lora_rank": 2}}
    traffic = {"batch_size": 2, "seq_len": 8, "accum": 4}
    launches = fl.iteration_launches(config, traffic)
    # per layer: 4 linears x 3 kernels x (teacher, students)
    assert len(launches) == 3 * 4 * 3 * 2
    assert {x[1:] for x in launches if x[0] == "fwd"} == {
        (1, 16, 4, 12, 0), (3, 16, 4, 12, 2), (1, 16, 4, 4, 0), (3, 16, 4, 4, 2),
        (1, 16, 4, 16, 0), (3, 16, 4, 16, 2), (1, 16, 16, 4, 0), (3, 16, 16, 4, 2)}


def test_flash_launch_costs():
    fa = load_reader("train.flash_roofline")
    B, H, T, D = 2, 3, 4, 8
    causal_pairs = sum(t + 1 for t in range(T))
    fwd_ops = 2 * (2 * B * H * causal_pairs * D)        # q·kᵀ and p·v
    qkv_bytes = B * H * T * D * 2
    assert fa.launch_cost("fwd", B, H, T, D) == (fwd_ops, 4 * qkv_bytes + B * H * T * 4)
    assert fa.launch_cost("bwd", B, H, T, D) == (2 * fwd_ops, 8 * qkv_bytes + B * H * T * 4)
    config = {"n_head": H, "n_layer": 2, "n_embd": H * D}
    traffic = {"seq_len": T, "batch_size": B, "accum": 4}
    assert sorted(fa.iteration_launches(config, traffic)) == sorted(
        [(k, b, H, T, D) for _ in range(2) for k in ("fwd", "bwd") for b in (B, 3 * B)])


def test_serve_ops():
    mfu = load_reader("serve.mfu")
    d, L, V, r = 4, 2, 7, 2
    lin = sum(2 * k * n for k, n in LINEAR_SHAPES(d)) * L           # b-bit codes
    lora = sum(2 * (k * r + r * n) for k, n in LINEAR_SHAPES(d)) * L
    T0 = 5
    # a prefill: integer linears and head (last position); float LoRA and attention
    assert mfu.prefill_ops(T0, d, L, V, r) == (T0 * lin + 2 * d * V,
                                                T0 * lora + 2 * _attention_macs(T0, d) * L)
    c = 9   # rows the decoded token attends, itself among them
    # a decoded token: every product on integer codes (int8 LoRA banks, 8-bit
    # query and probability codes, the 8-bit head)
    assert mfu.decode_ops(c, d, L, V, r) == (lin + lora + 2 * (2 * d * c) * L + 2 * d * V, 0)
    config = {"n_embd": d, "n_layer": L, "vocab_size": V, "quant": {"lora_rank": r}}
    p, q = mfu.prefill_ops(T0, d, L, V, r), mfu.decode_ops(c, d, L, V, r)
    assert mfu.window_ops(config, [T0], [c, c]) == (p[0] + 2 * q[0], p[1] + 2 * q[1])
    ctx = {"device_name": "NVIDIA H100 80GB HBM3", "config": config,
           "window": {"seconds": 2.0, "prefills": [T0], "decode_contexts": [c, c]}}
    want = 100.0 * ((p[0] + 2 * q[0]) / 1979e12 + (p[1] + 2 * q[1]) / 989e12) / 2.0
    assert mfu.read(ctx) == pytest.approx(want)


def test_k_mega_step_cost():
    km = load_reader("serve.k_mega_roofline")
    d, L, r = 8, 2, 2
    attended = [4, 6]                     # rows each slot attends, its new row among them
    tiles = 12 * d * d                    # 3 qkv, 1 proj, 4 fc, 4 mlp tiles of d x d
    per_layer = (tiles // 2                # int4 codes
                 + 9 * d * 4 * 2           # f32 column scales and biases: qkv, proj, fc, mlp sum
                 + (7 * d * r + 9 * r * d) # int8 LoRA: A of qkv, proj, fc, 4 mlp quarters;
                 #                           B of q, k, v, proj, 4 fc, mlp
                 + 16 * 4                  # their scalar scales
                 + 4 * d * 4               # LayerNorm gains and shifts
                 + 4 * 4)                  # static activation scales
    kv_row = 2 * (d // 2 + 4)             # K and V: 4-bit codes and a f32 scale
    # every row attended read, the new row written
    want_bytes = L * per_layer + L * kv_row * (sum(attended) + len(attended)) \
        + len(attended) * d * 4 * 2
    want_ops = sum(2 * L * (tiles + 16 * d * r + 2 * d * a) for a in attended)
    assert km.step_cost(attended, d, L, r, 4, 4) == (want_ops, want_bytes)


def test_readers_report_nothing_without_a_reading():
    unknown = {"device_name": "a card the table lacks"}
    for name in ("train.mfu", "train.fused_linear_roofline", "train.flash_roofline",
                 "serve.mfu", "serve.k_mega_roofline"):
        assert load_reader(name).read(unknown) is None
    km = load_reader("serve.k_mega_roofline")
    ctx = {"device_name": "NVIDIA H100 80GB HBM3", "kernels": {},
           "config": {"n_embd": 8, "n_layer": 1, "quant": {"lora_rank": 2}},
           "traffic": {"bits": 4, "kv_bits": 4}, "made": {"mega_decode_step_cb": 3},
           "slice": {"chunks": [{"steps": 3, "lengths0": [4]}]}}
    assert km.read(ctx) is None   # no k_mega record in the trace: no share, not 0
