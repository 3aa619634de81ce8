"""PyTorch port: `ContinuousBatchingEngine` with `kv_layout="mega"` (the
continuous-batching megakernel step #4, KV8 and KV4) against the JAX engine
on the CPU; the setup and the check are test_torch_serving.py's."""

import pytest

from test_torch_serving import calibrated, check_greedy_against_jax  # noqa: F401


@pytest.mark.parametrize("layout", ["mega_kv8", "mega_kv4"])
def test_greedy_tokens_match_jax_engine(calibrated, layout):
    """Three greedy requests on two slots, prompts of 5, 130 and 9 tokens,
    6 new tokens each, equal token for token (see
    test_torch_serving.check_greedy_against_jax)."""
    check_greedy_against_jax(calibrated, layout)
