"""Command-line entry points.

- `python -m llm_qat_tpu_torch.cli.main_sp` — SP training
- `python -m llm_qat_tpu_torch.cli.eval_sp` — SP evaluation
- `python -m llm_qat_tpu_torch.cli.main_cpt` — cyclic precision training
- `python -m llm_qat_tpu_torch.cli.eval_cpt` — CPT evaluation
- `python -m llm_qat_tpu_torch.cli.main_squad` — SQuAD QA training and evaluation
- `python -m llm_qat_tpu_torch.cli.run_rpi` — random-precision defence evaluation
- `python -m llm_qat_tpu_torch.cli.check_init` — checkpoint vs pretrained GPT-2
"""
