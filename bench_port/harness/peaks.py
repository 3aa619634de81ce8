"""Published peaks of the cards the benchmark knows (NVIDIA data sheets,
dense rates, no sparsity), by `torch.cuda.get_device_name()`."""

PEAKS = {
    # H100 SXM5 80 GB at its 700 W limit
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "int8_ops": 1979e12,
                              "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_of(device_name: str):
    """The card's peaks, or None for a card the table does not hold (the
    readers then report nothing)."""
    return PEAKS.get(device_name)
