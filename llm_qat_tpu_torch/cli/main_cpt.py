"""CPT training entry point, the port's `python -m llm_qat_tpu_torch.cli.main_cpt`.

Counterpart of `llm_qat_tpu/cli/main_cpt.py`, with its flags, defaults and
printed lines. Flow: build the CPT model (random init from `--seed`) →
WikiText-2 windows without overlap (offline: `ByteTokenizer` and the
synthetic corpus) → gradient-quantizer calibration → the cyclic scheduler
and, unless `--skip-prt`, the precision range test (each bit calibrated
lazily) → one epoch at each scheduled bit → the final save at
`--target-bits` with `save_checkpoint`, and the training-stats JSON.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). The config keeps the JAX
command's float32 compute dtype. The model runs no kernel: its attention
is dense and its linears are plain products, as in JAX.
"""

from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path

import torch

from ..data import create_dataloaders, get_gpt2_tokenizer, synthetic_corpus
from ..deploy import save_checkpoint
from ..device import resolve_device
from ..models.config import CPTConfig, GPT2Config
from ..models.cpt_model import cpt_forward, cpt_tables, init_cpt_params, prec_index
from ..train.cpt_trainer import (
    CPTCalibrationManager,
    CyclicPrecisionScheduler,
    PrecisionRangeTest,
    make_cpt_train_step,
)
from ..utils.stats import StatsTracker


def build_arg_parser():
    p = argparse.ArgumentParser(description="Cyclic precision training")
    p.add_argument("--output-dir", default="outputs/cpt")
    p.add_argument("--total-epochs", type=int, default=150)
    p.add_argument("--total-cycles", type=int, default=15)
    p.add_argument("--schedule", choices=["cosine", "triangular"],
                   default="cosine")
    p.add_argument("--target-bits", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--max-seq-length", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--skip-prt", action="store_true",
                   help="skip the precision range test")
    return p


def main(argv=None, *, device=None):
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(device)

    def to_dev(ids) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=dev)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.tiny:
        cfg = CPTConfig(
            model=GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                             n_layer=2, n_head=2),
            bit_widths=(3, 4, 5, 6, 7, 8, 32),
            lora_rank=4, lora_alpha=8,
            target_bits=args.target_bits,
            total_epochs=args.total_epochs, total_cycles=args.total_cycles,
            schedule_type=args.schedule,
        )
    else:
        cfg = CPTConfig(
            target_bits=args.target_bits, total_epochs=args.total_epochs,
            total_cycles=args.total_cycles, schedule_type=args.schedule,
        )

    params = init_cpt_params(torch.Generator(device=dev).manual_seed(args.seed),
                             cfg, device=dev)

    tokenizer = get_gpt2_tokenizer()
    if args.tiny:
        train_ds, val_ds = create_dataloaders(
            tokenizer, synthetic_corpus(32, 0), synthetic_corpus(8, 1),
            max_length=min(args.max_seq_length, 48), doc_stride=0,
        )
    else:
        # WikiText-2, non-overlapping windows
        train_ds, val_ds = create_dataloaders(
            tokenizer, max_length=args.max_seq_length, doc_stride=0,
            dataset="wikitext-2-raw-v1",
        )

    batches = [to_dev(ids) for ids, _ in
               itertools.islice(train_ds.batches(args.batch_size), 10)]

    mgr = CPTCalibrationManager(cfg, calibration_batches=min(len(batches), 10))
    params = mgr.calibrate_gradient_quantizers(params, batches[0])
    print("gradient quantizers calibrated")

    scheduler = CyclicPrecisionScheduler(
        [b for b in cfg.bit_widths if b < 32], cfg.schedule_type,
        cfg.total_epochs, cfg.total_cycles,
    )
    tables = cpt_tables(cfg, dev)

    if not args.skip_prt:
        @torch.no_grad()
        def eval_fn(bits, batch):
            nonlocal params
            params = mgr.ensure_calibrated(params, bits, batches)
            out = cpt_forward(params, batch, prec_index(cfg, bits), cfg,
                              tables=tables, labels=batch)
            preds = torch.argmax(out["logits"][:, :-1], -1)
            labels = batch[:, 1:]
            return (float((preds == labels).sum()), labels.numel(),
                    float(out["loss"]))

        prt = PrecisionRangeTest(
            eval_fn, start_bits=min(scheduler.bit_widths),
            max_bits=max(scheduler.bit_widths), threshold=0.1,
            test_iterations=2, target_bits=cfg.target_bits,
        )
        lower, upper = prt.find_bounds(batches[:2])
        scheduler.min_bits, scheduler.max_bits = lower, upper
        print(f"PRT bounds: [{lower}, {upper}]")

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    init_state, train_step = make_cpt_train_step(
        cfg, args.learning_rate,
        total_steps=args.total_epochs * steps_per_epoch,
    )
    state = init_state(params)
    stats = StatsTracker(cfg.bit_widths, device=dev)

    for epoch in range(args.total_epochs):
        bits = scheduler.get_precision_for_epoch(epoch)
        state = {**state, "params": mgr.ensure_calibrated(state["params"], bits,
                                                          batches)}
        p_idx = prec_index(cfg, bits)
        epoch_loss, n = 0.0, 0
        for ids, _ in train_ds.batches(args.batch_size, shuffle=True,
                                       seed=epoch):
            state, m = train_step(state, to_dev(ids), p_idx)
            epoch_loss += float(m["loss"])
            n += 1
        stats.record_iteration(epoch_loss / max(n, 1), args.learning_rate)
        stats.record_precision_usage(bits)
        if epoch % max(args.total_epochs // 10, 1) == 0:
            print(f"epoch {epoch}: bits={bits} loss={epoch_loss/max(n,1):.4f}")

    # the final save at target_bits
    state = {**state, "params": mgr.ensure_calibrated(
        state["params"], cfg.target_bits, batches)}
    ckpt = out_dir / f"cpt_target_{cfg.target_bits}bit.npz"
    save_checkpoint(ckpt, state["params"], cfg, bit_width=cfg.target_bits)
    stats.save(str(out_dir / f"cpt_stats_{int(time.time())}.json"), cfg)
    print(f"saved {ckpt}")
    return state, stats


if __name__ == "__main__":
    main()
