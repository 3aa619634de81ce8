"""PyTorch / CUDA port of llm_qat_tpu for NVIDIA Hopper.

Mirrors the JAX package's module layout and names. This package imports
`torch` and never `jax` or `llm_qat_tpu`. Entry points run on the card by
default (`device="cuda"`) and on the CPU only when the caller asks for it.
"""
