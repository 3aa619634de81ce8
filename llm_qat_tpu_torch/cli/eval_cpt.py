"""CPT evaluation entry point, the port's `python -m llm_qat_tpu_torch.cli.eval_cpt`.

Counterpart of `llm_qat_tpu/cli/eval_cpt.py`, with its flags, defaults,
printed lines and `results.json` keys. Loads a CPT checkpoint of either
package (the config rebuilt from its metadata), reports which bit slots
hold calibrated scales (`calibration_forensics`), re-calibrates the
evaluation bit-width from four (2, 64) batches when it is not calibrated,
then evaluates sliding-window perplexity with `PerplexityEvaluator`.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). Offline, the data falls
back to `ByteTokenizer` and the synthetic corpus.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..data import get_gpt2_tokenizer, load_wikitext
from ..deploy import load_checkpoint
from ..device import resolve_device
from ..evals import PerplexityEvaluator
from ..models.config import CPTConfig, GPT2Config
from ..models.cpt_model import cpt_forward, cpt_tables, prec_index
from ..train.cpt_trainer import CPTCalibrationManager


def calibration_forensics(params, cfg) -> dict:
    """Which bit slots hold calibrated (not all 1.0) weight scales."""
    ws = params["blocks"]["c_attn"]["wq_scale"].detach().cpu().numpy()  # (L, P, ch)
    return {bits: not np.allclose(ws[:, prec_index(cfg, bits)], 1.0)
            for bits in cfg.bit_widths if bits < 32}


def build_arg_parser():
    p = argparse.ArgumentParser(description="CPT model evaluation")
    p.add_argument("--model-path", required=True)
    p.add_argument("--output-dir", default="outputs/eval_cpt")
    p.add_argument("--max-length", type=int, default=1024)
    p.add_argument("--stride", type=int, default=512)
    p.add_argument("--bits", type=int, default=None,
                   help="eval bit-width (default: checkpoint target)")
    return p


def main(argv=None, *, device=None):
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(device)

    params, meta = load_checkpoint(args.model_path, device=dev)
    c = meta["config"]
    cfg = CPTConfig(
        model=GPT2Config(**{k: c["model"][k] for k in
                            ("vocab_size", "n_positions", "n_embd",
                             "n_layer", "n_head")}),
        bit_widths=tuple(c["bit_widths"]),
        lora_rank=c["lora_rank"], lora_alpha=c["lora_alpha"],
        gradient_bits=c["gradient_bits"], target_bits=c["target_bits"],
        quantizer_kind=c["quantizer_kind"], per_channel=c["per_channel"],
    )
    bits = args.bits or meta.get("bit_width") or cfg.target_bits

    forensics = calibration_forensics(params, cfg)
    print(f"calibration status by bits: {forensics}")

    mgr = CPTCalibrationManager(cfg, calibration_batches=4)
    mgr.calibrated = {b for b, ok in forensics.items() if ok}
    if not forensics.get(bits, False):
        print(f"emergency re-calibration at {bits} bits")
        tokenizer = get_gpt2_tokenizer()
        texts = load_wikitext("wikitext-2-raw-v1", "validation", limit=32)
        stream = []
        for t in texts:
            stream.extend(tokenizer(t))
        stream = np.asarray(stream[: 4 * 2 * 64], np.int32)
        need = 4 * 2 * 64 - len(stream)
        if need > 0:
            stream = np.concatenate([stream, np.zeros(need, np.int32)])
        batches = [torch.as_tensor(stream[i * 128:(i + 1) * 128].reshape(2, 64),
                                   dtype=torch.long, device=dev)
                   for i in range(4)]
        params = mgr.ensure_calibrated(params, bits, batches)

    tables = cpt_tables(cfg, dev)
    prec = prec_index(cfg, bits)

    def logits_fn(ids):
        return cpt_forward(params, ids, prec, cfg, tables=tables)["logits"]

    tokenizer = get_gpt2_tokenizer()
    texts = load_wikitext("wikitext-2-raw-v1", "validation", limit=100)
    seqs = [np.asarray(tokenizer(t), np.int32) for t in texts if t.strip()]
    ml = min(args.max_length, cfg.model.n_positions)
    ev = PerplexityEvaluator(logits_fn, ml, min(args.stride, ml), device=dev)
    ppl = ev.calculate_perplexity(seqs)
    print(f"WikiText-2 PPL @ {bits} bits: {ppl:.1f}")

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {"bit_width": bits, "perplexity": {"wikitext2": round(ppl, 1)},
               "calibration_forensics": {str(k): v
                                         for k, v in forensics.items()}}
    (out_dir / "results.json").write_text(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
