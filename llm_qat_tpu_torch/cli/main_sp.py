"""SP training entry point, the port's `python -m llm_qat_tpu_torch.cli.main_sp`.

Counterpart of `llm_qat_tpu/cli/main_sp.py`, with its flags, defaults and
printed lines. Flow: build SP GPT-2 → load pretrained HF weights (when
reachable; offline runs keep random init) → dataloaders (offline: the
synthetic corpus and `ByteTokenizer`) → calibrate → multi-precision
distillation training → per-bit checkpoints + training-stats JSON.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). On the card the matmul
operands are bf16, and at `--max-seq-length 1024` the attention runs the
trainable flash kernels #5 and #6. Each iteration's randomness (student
slots, feature layers, dropout) comes from a fresh generator seeded from
(seed + 1, iteration), and the data order is a per-epoch shuffle, so a run
resumed with `--auto-resume` repeats an uninterrupted one exactly.
"""

from __future__ import annotations

import argparse
import itertools
import time
from pathlib import Path

import numpy as np
import torch

from ..data import create_dataloaders, get_gpt2_tokenizer, synthetic_corpus
from ..deploy import AsyncCheckpointManager, load_checkpoint, save_per_bit_checkpoints
from ..device import resolve_device
from ..models.config import (
    GPT2Config,
    QuantConfig,
    SPModelConfig,
    TrainConfig,
    tiny_test_config,
)
from ..models.hf_import import load_hf_gpt2
from ..models.sp_model import init_sp_params, prec_tables
from ..train.calibration_manager import CalibrationManager
from ..train.sp_trainer import make_eval_step, make_sp_train_step
from ..utils.stats import StatsTracker


def build_arg_parser():
    p = argparse.ArgumentParser(description="Switchable-precision QAT training")
    p.add_argument("--output-dir", default="outputs/sp")
    p.add_argument("--bit-widths", type=int, nargs="+", default=[7, 32])
    p.add_argument("--num-iterations", type=int, default=550)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-seq-length", type=int, default=256)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--grad-accum", type=int, default=8)
    p.add_argument("--eval-interval", type=int, default=50)
    p.add_argument("--lora-rank", type=int, default=64)
    p.add_argument("--lora-alpha", type=int, default=64)
    p.add_argument("--pretrained", default="gpt2",
                   help="HF model name, or 'none' for random init")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true",
                   help="tiny model + synthetic data (smoke runs)")
    p.add_argument("--checkpoint", default=None,
                   help="resume checkpoint (a per-bit .npz of either package)")
    p.add_argument("--save-every", type=int, default=0,
                   help="async elastic checkpoint every N iterations "
                        "(params + optimizer state; 0 disables)")
    p.add_argument("--auto-resume", action="store_true",
                   help="resume from the newest elastic checkpoint in "
                        "OUTPUT_DIR/elastic (preemption-restart flow)")
    return p


def iteration_generator(seed: int, it: int, device) -> torch.Generator:
    """The generator of iteration `it`: a pure function of (seed, it), as
    JAX's `fold_in(PRNGKey(seed), it)` is."""
    entropy = [seed & 0xFFFFFFFFFFFFFFFF, it]
    s = int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def main(argv=None, *, device=None):
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(device)

    def to_dev(ids: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(ids, dtype=torch.long, device=dev)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.tiny:
        cfg = tiny_test_config(tuple(args.bit_widths))
    else:
        cfg = SPModelConfig(
            model=GPT2Config(),
            quant=QuantConfig(
                bit_widths=tuple(args.bit_widths),
                lora_rank_per_bit={b: args.lora_rank for b in range(2, 17)}
                | {32: 0},
                lora_alpha_per_bit={b: args.lora_alpha for b in range(2, 17)}
                | {32: 0},
            ),
            # bf16 matmul operands on the card, as the JAX package on the TPU
            compute_dtype="bfloat16" if dev.type == "cuda" else "float32",
            # the JAX package's layer-scan unroll; kept so the config matches
            scan_unroll=GPT2Config().n_layer,
        )
    tcfg = TrainConfig(
        batch_size=args.batch_size, max_seq_length=args.max_seq_length,
        learning_rate=args.learning_rate, num_iterations=args.num_iterations,
        gradient_accumulation_steps=args.grad_accum,
        eval_interval=args.eval_interval,
    )
    tables = prec_tables(cfg.quant, dev)

    params = init_sp_params(torch.Generator(device=dev).manual_seed(args.seed),
                            cfg, device=dev)
    if args.checkpoint:
        params, meta = load_checkpoint(args.checkpoint, device=dev)
        print(f"resumed from {args.checkpoint} (bit={meta.get('bit_width')})")
    elif args.pretrained != "none" and not args.tiny:
        try:
            params = load_hf_gpt2(params, cfg, args.pretrained)
            print(f"loaded pretrained weights: {args.pretrained}")
        except Exception as e:  # offline, or no transformers: keep random init
            print(f"WARNING: pretrained load failed ({e}); using random init")

    tokenizer = get_gpt2_tokenizer()
    if args.tiny:
        train_ds, val_ds = create_dataloaders(
            tokenizer, synthetic_corpus(64, 0), synthetic_corpus(16, 1),
            max_length=args.max_seq_length,
        )
    else:
        train_ds, val_ds = create_dataloaders(
            tokenizer, max_length=args.max_seq_length,
        )
    print(f"train windows: {len(train_ds)}, val windows: {len(val_ds)}")

    # the first `calibration_batches` batches, taken lazily: at T = 1024 the
    # whole list would hold every window of the corpus
    calib_batches = [
        to_dev(ids) for ids, _ in itertools.islice(
            train_ds.batches(min(args.batch_size, 8)), tcfg.calibration_batches)
    ]
    mgr = CalibrationManager(cfg, tcfg.calibration_batches)
    t0 = time.time()
    params = mgr.calibrate_all_precisions(params, calib_batches)
    print(f"calibrated {cfg.quant.student_bits} in {time.time()-t0:.1f}s")

    init_state, train_step = make_sp_train_step(cfg, tcfg, tables)
    eval_step = make_eval_step(cfg, tables)
    state = init_state(params)
    stats = StatsTracker(cfg.quant.bit_widths, device=dev)

    ckpt_mgr, start_iter = None, 0
    if args.save_every > 0 or args.auto_resume:
        ckpt_mgr = AsyncCheckpointManager(out_dir / "elastic")
        if args.auto_resume:
            restored = ckpt_mgr.restore_latest(state)
            if restored is not None:
                saved_it, state, _ = restored
                start_iter = saved_it + 1  # that iteration completed
                print(f"auto-resumed from elastic step {saved_it}")

    # Determinism under --auto-resume: both the per-step generator and the
    # data order are pure functions of the iteration index (generator seeded
    # from (seed + 1, it); shuffle seeded by epoch = it // batches_per_epoch,
    # skipping to it % batches_per_epoch), so a resumed run replays the exact
    # precision sampling and batch sequence of an uninterrupted one.
    per_epoch = max(1, len(train_ds) // tcfg.batch_size)
    batch_iter, cur_epoch = None, -1
    for it in range(start_iter, tcfg.num_iterations):
        epoch, pos = divmod(it, per_epoch)
        if epoch != cur_epoch:
            batch_iter = train_ds.batches(tcfg.batch_size, shuffle=True,
                                          seed=epoch)
            cur_epoch = epoch
            for _ in range(pos):  # resume mid-epoch: skip consumed batches
                next(batch_iter)
        ids, _ = next(batch_iter)
        gen = iteration_generator(args.seed + 1, it, dev)
        state, metrics = train_step(state, to_dev(ids), gen)
        stats.record_iteration(float(metrics["loss"]), float(metrics["lr"]))
        for prec in metrics["precisions"].tolist():
            stats.record_precision_usage(cfg.quant.bit_widths[int(prec)])

        if it % 10 == 0:
            print(f"iter {it}: loss={float(metrics['loss']):.4f} "
                  f"teacher={float(metrics['teacher_loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e}")
        if it > 0 and it % tcfg.eval_interval == 0:
            evals = {}
            for bits in cfg.quant.bit_widths:
                vb = next(val_ds.batches(min(tcfg.batch_size, 8)))
                evals[bits] = float(eval_step(
                    state.params, to_dev(vb[0]), cfg.quant.prec_index(bits)))
            stats.record_eval(it, {"val_loss": {str(k): v
                                                for k, v in evals.items()}})
            print(f"  eval@{it}: " + " ".join(
                f"{b}bit={v:.3f}" for b, v in evals.items()))
        if ckpt_mgr is not None and args.save_every > 0 \
                and it % args.save_every == 0:
            ckpt_mgr.save(it, state)

    if ckpt_mgr is not None:
        ckpt_mgr.wait()
    paths = save_per_bit_checkpoints(out_dir, state.params, cfg)
    stats_path = stats.save(str(out_dir / f"training_stats_{int(time.time())}.json"),
                            cfg, tcfg)
    print(f"checkpoints: {paths}")
    print(f"stats: {stats_path}")
    return state, stats


if __name__ == "__main__":
    main()
