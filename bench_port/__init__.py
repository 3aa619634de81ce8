"""The benchmark of llm_qat_tpu_torch on one NVIDIA H100 (see run.py)."""
