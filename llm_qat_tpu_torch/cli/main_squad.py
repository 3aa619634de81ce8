"""SQuAD QA training and evaluation, the port's `python -m llm_qat_tpu_torch.cli.main_squad`.

Counterpart of `llm_qat_tpu/cli/main_squad.py`, with its flags, defaults,
printed lines and `squad_results.json`. Flow: examples (offline: the
synthetic SQuAD set) → windows (the GPT-2 fast tokenizer from the local
cache, else `OffsetByteTokenizer`) → the QA model (random init from
`--seed`, or `--checkpoint`) → multi-precision self-distillation training
→ per-bit checkpoints `squad_<bits>bit.npz` → EM/F1 at every bit-width.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). The config keeps the JAX
command's float32 compute dtype. The attention always has a padding mask,
so it is dense and no kernel runs, as in JAX. Each iteration's draws come
from a generator seeded from (seed + 1, iteration).
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from ..data.lm_datasets import _offline_env_defaults
from ..data.squad import OffsetByteTokenizer, SQuADDataset, load_squad_examples
from ..deploy import load_checkpoint, save_per_bit_checkpoints
from ..device import resolve_device
from ..evals.squad_eval import evaluate_squad_model
from ..models.config import GPT2Config, QuantConfig, SPModelConfig, TrainConfig, tiny_test_config
from ..models.qa import init_qa_params, qa_forward
from ..models.sp_model import prec_tables
from ..train.squad_trainer import make_squad_train_step
from .main_sp import iteration_generator


def build_arg_parser():
    p = argparse.ArgumentParser(description="SQuAD QA training/eval")
    p.add_argument("--output-dir", default="outputs/squad")
    p.add_argument("--squad-version", choices=["v1", "v2"], default="v1")
    p.add_argument("--num-iterations", type=int, default=1000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--max-seq-length", type=int, default=384)
    p.add_argument("--doc-stride", type=int, default=128)
    p.add_argument("--learning-rate", type=float, default=3e-5)
    p.add_argument("--bit-widths", type=int, nargs="+", default=[7, 32])
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    return p


def get_squad_tokenizer():
    """The GPT-2 fast tokenizer with offsets from the local cache when the
    hub is off, else `OffsetByteTokenizer`."""
    offline = _offline_env_defaults()
    try:
        from transformers import GPT2TokenizerFast

        hf_tok = GPT2TokenizerFast.from_pretrained("gpt2", local_files_only=offline)
        if not hf_tok.vocab_size or hf_tok.eos_token_id is None:
            raise OSError("GPT-2 tokenizer files not found")

        class Tok:
            eos_token_id = hf_tok.eos_token_id
            pad_token_id = hf_tok.eos_token_id

            def __call__(self, text):
                return hf_tok(text)["input_ids"]

            def tokenize_with_offsets(self, text):
                enc = hf_tok(text, return_offsets_mapping=True)
                return enc["input_ids"], enc["offset_mapping"]

            def decode(self, ids):
                return hf_tok.decode(ids)

        return Tok()
    except Exception:
        return OffsetByteTokenizer()


def main(argv=None, *, device=None):
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(device)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.tiny:
        cfg = tiny_test_config(tuple(args.bit_widths))
        max_len, stride = 64, 64
        examples = load_squad_examples(args.squad_version, "train", limit=16)
    else:
        cfg = SPModelConfig(
            model=GPT2Config(),
            quant=QuantConfig(bit_widths=tuple(args.bit_widths)),
        )
        max_len, stride = args.max_seq_length, args.doc_stride
        examples = load_squad_examples(args.squad_version, "train", limit=5000)

    tokenizer = get_squad_tokenizer()
    ds = SQuADDataset(examples, tokenizer, max_len, stride)
    print(f"SQuAD {args.squad_version}: {len(ds)} windows")

    tables = prec_tables(cfg.quant, dev)
    if args.checkpoint:
        params, _ = load_checkpoint(args.checkpoint, device=dev)
    else:
        params = init_qa_params(torch.Generator(device=dev).manual_seed(args.seed),
                                cfg, device=dev)

    if not args.eval_only:
        tcfg = TrainConfig(
            batch_size=args.batch_size, learning_rate=args.learning_rate,
            num_iterations=args.num_iterations,
            gradient_accumulation_steps=4,
        )
        init_state, train_step = make_squad_train_step(cfg, tcfg, tables)
        state = init_state(params)
        it = 0
        while it < tcfg.num_iterations:
            for batch in ds.batches(min(tcfg.batch_size, len(ds)),
                                    shuffle=True, seed=it):
                tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
                      if k != "example_ids"}
                tb["input_ids"] = tb["input_ids"].long()
                state, m = train_step(state, tb, iteration_generator(args.seed + 1, it, dev))
                if it % 50 == 0:
                    print(f"iter {it}: loss={float(m['loss']):.4f}")
                it += 1
                if it >= tcfg.num_iterations:
                    break
        params = state.params
        save_per_bit_checkpoints(out_dir, params, cfg, prefix="squad")

    # evaluation at every bit-width
    references = {
        ex["id"]: list(ex["answers"].get("text", [])) for ex in examples
    }
    results = {}
    for bits in cfg.quant.bit_widths:
        prec = cfg.quant.prec_index(bits)

        def qa_logits(ids, mask, prec=prec):
            out = qa_forward(params, ids, prec, cfg, tables=tables,
                             attention_mask=mask)
            return out["start_logits"], out["end_logits"]

        res = evaluate_squad_model(qa_logits, ds, tokenizer, references,
                                   batch_size=8, device=dev)
        results[bits] = res
        print(f"{bits}-bit: EM={res['exact_match']:.2f} F1={res['f1']:.2f}")

    (out_dir / "squad_results.json").write_text(
        json.dumps({str(k): v for k, v in results.items()}, indent=2)
    )
    return results


if __name__ == "__main__":
    main()
