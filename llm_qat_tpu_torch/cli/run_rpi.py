"""RPI defence evaluation entry point, the port's `python -m
llm_qat_tpu_torch.cli.run_rpi` (reference
`part4_randomSwitching/run_evaluation.py:270-412`).

Counterpart of `llm_qat_tpu/cli/run_rpi.py`, with its flags, defaults and
`rpi_report.json` keys. Clean baseline at max bits → TextFooler +
BERT-Attack → replay the adversarial texts under random switching at the
requested probabilities → JSON report with defence success rates and the
optimal p.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). The config keeps the JAX
command's float32 compute dtype; each text is cut to `n_positions` tokens,
so at GPT-2 124M a text of 1024 tokens or more runs its forwards' attention
through the flash kernel #5 on its float32 (SIMT) route, and a shorter one
the dense path. Without `--model-path` the parameters are a random,
uncalibrated initialisation from seed 0, as in JAX. Offline, the data falls
back to `ByteTokenizer` and the synthetic corpus, and the attacks to the
static synonym table and MLM stand-in.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from ..data import get_gpt2_tokenizer, load_wikitext
from ..deploy import load_checkpoint
from ..device import resolve_device
from ..models.config import GPT2Config, QuantConfig, SPModelConfig, tiny_test_config
from ..models.sp_model import embed_tokens, init_sp_params, prec_tables, sp_forward
from ..robustness import (
    BERTAttack,
    SimplifiedRandomSwitching,
    TextFoolerAttack,
    make_mlm_proposer,
    run_rpi_evaluation,
    token_level_metrics,
)


def rpi_functions(params, cfg, tables, tokenizer, device):
    """The command's victim functions over the SP forward on `device`
    (float32, in inference mode), each text cut to `n_positions` tokens:
    `metrics_at(text, prec_idx)` and `metrics_fn(text)` (at the largest
    width) give (mean loss, accuracy); `switched_metrics_fn(text, p, seed)`
    gives them under one random precision draw; `embed_fn(text)` is the
    mean `wte` row, gathered on the device (only the mean comes back)."""
    bits_to_idx = {b: cfg.quant.prec_index(b) for b in cfg.quant.bit_widths}
    max_bits = max(cfg.quant.bit_widths)
    max_pos = cfg.model.n_positions

    @torch.inference_mode()
    def forward(ids, prec):
        return sp_forward(params, ids, prec, cfg, tables=tables)["logits"]

    def token_ids(text):
        return torch.as_tensor(tokenizer(text)[:max_pos], dtype=torch.int64,
                               device=device)

    def metrics_at(text, prec_idx):
        ids = token_ids(text)
        if len(ids) < 3:
            return 0.0, 0.0
        ids2 = ids[None]
        loss_sum, correct, n = token_level_metrics(forward(ids2, prec_idx), ids2)
        return loss_sum / max(n, 1), correct / max(n, 1)

    def metrics_fn(text):
        return metrics_at(text, bits_to_idx[max_bits])

    def switched_metrics_fn(text, p, seed):
        sw = SimplifiedRandomSwitching(
            lambda ids, prec: {"logits": forward(ids, prec)},
            cfg.quant.bit_widths, bits_to_idx, p, seed, device=device,
        )
        ids = token_ids(text)
        if len(ids) < 3:
            return 0.0, 0.0
        out, _ = sw.forward_with_switching(ids[None])
        loss_sum, correct, n = token_level_metrics(out["logits"], ids[None])
        return loss_sum / max(n, 1), correct / max(n, 1)

    def embed_fn(text):
        ids = token_ids(text)
        if len(ids) == 0:
            return np.zeros(cfg.model.n_embd)
        return embed_tokens(params["wte"], ids).mean(0).cpu().numpy()

    return SimpleNamespace(metrics_at=metrics_at, metrics_fn=metrics_fn,
                           switched_metrics_fn=switched_metrics_fn, embed_fn=embed_fn)


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser(description="Random-precision defense eval")
    p.add_argument("--model-path", default=None,
                   help="SP checkpoint; random init when omitted")
    p.add_argument("--output-dir", default="outputs/rpi")
    p.add_argument("--switch-probs", type=float, nargs="+",
                   default=[0.0, 0.3, 0.5, 0.7])
    p.add_argument("--num-samples", type=int, default=30)
    p.add_argument("--bit-widths", type=int, nargs="+", default=[4, 8, 32])
    p.add_argument("--tiny", action="store_true")
    args = p.parse_args(argv)
    dev = resolve_device(device)

    if args.tiny:
        cfg = tiny_test_config(tuple(args.bit_widths))
    else:
        cfg = SPModelConfig(
            model=GPT2Config(),
            quant=QuantConfig(bit_widths=tuple(args.bit_widths)),
        )
    tables = prec_tables(cfg.quant, dev)
    if args.model_path:
        params, _ = load_checkpoint(args.model_path, device=dev)
    else:
        params = init_sp_params(torch.Generator(device=dev).manual_seed(0), cfg,
                                device=dev)

    fns = rpi_functions(params, cfg, tables, get_gpt2_tokenizer(), dev)

    texts = [t for t in load_wikitext("wikitext-2-raw-v1", "test",
                                      limit=args.num_samples * 3)
             if len(t.split()) >= 5][: args.num_samples]

    attacks = {
        "TextFooler": TextFoolerAttack(fns.metrics_fn, fns.embed_fn),
        "BERT-Attack": BERTAttack(fns.metrics_fn, fns.embed_fn,
                                  proposer=make_mlm_proposer(device=dev)),
    }
    report = run_rpi_evaluation(
        fns.metrics_fn, fns.switched_metrics_fn, attacks, texts,
        switch_probs=tuple(args.switch_probs),
        max_samples=args.num_samples,
    )

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "rpi_report.json").write_text(json.dumps(report, indent=2))
    print(json.dumps(report, indent=2)[:2000])
    return report


if __name__ == "__main__":
    main()
