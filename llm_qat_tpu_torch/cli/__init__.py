"""Command-line entry points.

- `python -m llm_qat_tpu_torch.cli.main_sp` — SP training
- `python -m llm_qat_tpu_torch.cli.check_init` — checkpoint vs pretrained GPT-2
"""
