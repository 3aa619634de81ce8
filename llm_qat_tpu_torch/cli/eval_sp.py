"""SP evaluation entry point, the port's `python -m llm_qat_tpu_torch.cli.eval_sp`
(reference `part3_eval_sp/main_sp_eval.py:120-203`).

Counterpart of `llm_qat_tpu/cli/eval_sp.py`, with its flags, defaults,
printed lines and `results.json` keys. Loads an SP checkpoint of either
package (rebuilding the config from its metadata, pinning the checkpoint's
bit-width — and like the reference, eval can force per-tensor
quantization, `main_sp_eval.py:60`), verifies calibration status, runs
sliding-window perplexity + zero-shot tasks, and writes a results JSON with
model-size/compression metrics.

It runs on the card (`device=None`) unless the caller asks for the CPU
(`main([...], device="cpu")`, as the tests do). The config keeps the JAX
command's float32 compute dtype, so at `--max-length 1024` the forward's
attention runs the flash kernel #5 on its float32 (SIMT) route. Offline,
the data falls back to `ByteTokenizer` and the synthetic corpus.
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
from ..evals import (
    STANDARD_CONFIGS,
    FewShotEvaluator,
    PerplexityEvaluator,
    ResultTableGenerator,
    ZeroShotEvaluator,
    compression_ratio,
    count_parameters_m,
    get_config_string,
    load_mmlu,
    model_size_gb,
)
from ..evals.task_loading import load_all_tasks, synthetic_tasks
from ..models.config import GPT2Config, QuantConfig, SPModelConfig
from ..models.sp_model import prec_tables, sp_forward


def load_switchable_model(ckpt_path, per_tensor_eval: bool = False, device=None):
    """Rebuild (params, cfg, bit_width) from a checkpoint
    (reference `load_switchable_model`, `main_sp_eval.py:22-78`).

    NOTE on per-tensor eval: the reference rebuilds quantizers per-tensor and
    re-calibrates at load; the banks store per-channel scales, and a
    per-tensor eval reduces them (`_reduce_to_per_tensor`) — same effect as
    the reference's recalibration from the same stats.
    """
    params, meta = load_checkpoint(ckpt_path, device=device)
    mc = meta["config"]["model"]
    qc = meta["config"]["quant"]
    # n_positions inferred from the saved wpe (main_sp_eval.py:40-48)
    n_positions = int(params["wpe"].shape[0])
    cfg = SPModelConfig(
        model=GPT2Config(
            vocab_size=mc["vocab_size"], n_positions=n_positions,
            n_embd=mc["n_embd"], n_layer=mc["n_layer"], n_head=mc["n_head"],
        ),
        quant=QuantConfig(
            bit_widths=tuple(qc["bit_widths"]),
            lora_rank_per_bit={int(k): v
                               for k, v in qc["lora_rank_per_bit"].items()},
            lora_alpha_per_bit={int(k): v
                                for k, v in qc["lora_alpha_per_bit"].items()},
            per_channel=qc["per_channel"] and not per_tensor_eval,
        ),
    )
    if per_tensor_eval and qc["per_channel"]:
        params = _reduce_to_per_tensor(params, cfg.quant)
    return params, cfg, meta.get("bit_width")


def _reduce_to_per_tensor(params, q):
    """Collapse per-channel scale banks to per-tensor (reference forces
    per_channel=False at eval load, `main_sp_eval.py:60`, `deploy.py:210`).

    The reduction happens in the quantizer's STAT space, per precision slot,
    because the finalized (scale, zp) params mean different things per kind
    (`quant/calibration.py::finalize`):

    - log kind (default ≥5 bits): zp holds log_min, scale holds log_range;
      per-tensor log_min_t = min_c(log_min_c) and log_range_t =
      max_c(log_min_c + range_c) − log_min_t.
    - minmax symmetric: scale_c = abs_max_c / qmax is monotone in the stat,
      so max over channels IS the stat-space reduction; zp stays 0.
    - minmax asymmetric: invert scale/zp back to (rmin_c, rmax_c) (exact up
      to the reference's zp rounding), reduce, re-finalize.
    """
    def reduce_slot(s, z, bits):
        kind = q.kind_name(bits)
        if bits >= 32 or kind == "none":
            # passthrough precision: params unused; keep a max for shape
            return s.amax(dim=-1, keepdim=True), z.amax(dim=-1, keepdim=True)
        if kind == "log":
            log_min = z.amin(dim=-1, keepdim=True)
            log_max = (z + s).amax(dim=-1, keepdim=True)
            return log_max - log_min, log_min
        if q.symmetric:
            s_t = s.amax(dim=-1, keepdim=True)
            return s_t, torch.zeros_like(s_t)
        qmax = 2.0 ** bits - 1.0
        rmin_c = -z * s
        rmax_c = rmin_c + s * qmax
        rmin = rmin_c.amin(dim=-1, keepdim=True)
        rmax = rmax_c.amax(dim=-1, keepdim=True)
        scale = torch.clamp(rmax - rmin, min=q.eps) / qmax
        return scale, torch.round(-rmin / scale)

    def reduce_bank(scale, zp):
        # banks are (..., P, C): precision slot on -2, channels on -1
        outs = [reduce_slot(scale[..., p, :], zp[..., p, :], b)
                for p, b in enumerate(q.bit_widths)]
        return (torch.stack([o[0] for o in outs], dim=-2),
                torch.stack([o[1] for o in outs], dim=-2))

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {k: walk(v) for k, v in node.items()}
        for sk, zk in (("wq_scale", "wq_zp"), ("iq_scale", "iq_zp")):
            if sk in out:
                out[sk], out[zk] = reduce_bank(out[sk], out[zk])
        return out

    return walk(params)


def verify_calibration_status(params) -> dict:
    """Count calibrated input-quantizer slots (scale != 1 heuristic; the
    reference counts `calibrated` flags, `main_sp_eval.py:80-107`)."""
    total = calibrated = 0

    def walk(node):
        nonlocal total, calibrated
        for key in sorted(node):
            leaf = node[key]
            if isinstance(leaf, dict):
                walk(leaf)
            elif key == "iq_scale":
                arr = leaf.detach().cpu().numpy()
                for p_idx in range(arr.shape[-2] if arr.ndim >= 2 else 1):
                    total += 1
                    sl = arr[..., p_idx, :] if arr.ndim >= 2 else arr
                    if not np.allclose(sl, 1.0):
                        calibrated += 1

    walk(params)
    return {"total": total, "calibrated": calibrated}


def build_arg_parser():
    p = argparse.ArgumentParser(description="SP model evaluation")
    p.add_argument("--model-path", required=True)
    p.add_argument("--output-dir", default="outputs/eval_sp")
    p.add_argument("--max-length", type=int, default=256)
    p.add_argument("--stride", type=int, default=256)
    p.add_argument("--max-samples", type=int, default=500)
    p.add_argument("--per-tensor", action="store_true",
                   help="force per-tensor quantization (reference eval mode)")
    p.add_argument("--datasets", nargs="+", default=["wikitext2"])
    p.add_argument("--tasks", nargs="+", default=None,
                   help="zero-shot tasks (default: all six)")
    p.add_argument("--skip-zero-shot", action="store_true")
    p.add_argument("--synthetic-tasks", action="store_true",
                   help="use synthetic zero-shot examples (offline testing)")
    p.add_argument("--few-shot", action="store_true",
                   help="also run MMLU few-shot (needs hub access)")
    return p


def main(argv=None, *, device=None):
    args = build_arg_parser().parse_args(argv)
    dev = resolve_device(device)

    params, cfg, bit_width = load_switchable_model(
        args.model_path, args.per_tensor, device=dev
    )
    tables = prec_tables(cfg.quant, dev)
    prec = cfg.quant.prec_index(bit_width or 32)
    print(f"loaded {args.model_path}: bit={bit_width}, "
          f"calibration={verify_calibration_status(params)}")

    def logits_fn(ids):
        return sp_forward(params, ids, prec, cfg, tables=tables)["logits"]

    tokenizer = get_gpt2_tokenizer()
    ppl_eval = PerplexityEvaluator(logits_fn, args.max_length, args.stride, device=dev)

    dataset_map = {
        "wikitext2": ("wikitext-2-raw-v1", "test"),
        "wikitext103": ("wikitext-103-raw-v1", "test"),
    }
    results = {"bit_width": bit_width, "perplexity": {}}
    for name in args.datasets:
        version, split = dataset_map.get(name, ("wikitext-2-raw-v1", "test"))
        texts = load_wikitext(version, split, limit=200)
        seqs = [np.asarray(tokenizer(t), np.int32) for t in texts if t.strip()]
        ppl = ppl_eval.calculate_perplexity(seqs)
        results["perplexity"][name] = round(ppl, 1)
        print(f"{name} PPL: {ppl:.1f}")

    # -- zero-shot suite (reference `main_sp_eval.py:164-187` runs it right
    # after perplexity and writes both into the same results JSON) ---------
    if not args.skip_zero_shot:
        if args.synthetic_tasks:
            tasks = synthetic_tasks()
            if args.tasks:
                tasks = {k: v for k, v in tasks.items() if k in args.tasks}
        else:
            tasks = load_all_tasks(args.tasks, args.max_samples)
        avail = {k: v for k, v in tasks.items() if v}
        missing = sorted(set(tasks) - set(avail))
        if missing:
            print(f"zero-shot: no data for {missing} (offline hub?) — "
                  "skipped those tasks")
        if avail:
            zs_eval = ZeroShotEvaluator(
                logits_fn, tokenizer, max_length=args.max_length,
                max_samples=args.max_samples, device=dev)
            results["zero_shot"] = zs_eval.evaluate_all_tasks(avail)
            for t, acc in results["zero_shot"].items():
                print(f"zero-shot {t}: {acc:.1f}")

    if args.few_shot:
        mmlu = load_mmlu()
        if mmlu is None:
            print("few-shot: MMLU unavailable (offline hub?) — skipped")
        else:
            fs_eval = FewShotEvaluator(logits_fn, tokenizer,
                                       max_length=args.max_length, device=dev)
            results["few_shot"] = fs_eval.evaluate_all(mmlu_subjects=mmlu)
            print(f"few-shot: {results['few_shot']}")

    # -- model-size / compression over the 13 standard W-A-KV configs
    # (reference `sp_metrics.py:64-101` sweep) ----------------------------
    params_m = count_parameters_m(params)
    w = bit_width or 32
    cfg_bits = {"W": w, "A": w, "KV": w}
    results["model_size_gb"] = model_size_gb(
        params_m, cfg.model.n_layer, cfg.model.n_head, cfg.model.head_dim,
        cfg_bits,
    )
    results["compression_ratio"] = 32.0 / w
    results["model_size_sweep"] = {
        name: {
            "bits": get_config_string(c),
            "model_size_gb": round(model_size_gb(
                params_m, cfg.model.n_layer, cfg.model.n_head,
                cfg.model.head_dim, c), 4),
            "compression_ratio": round(
                compression_ratio(c, STANDARD_CONFIGS["FP32"]), 2),
        }
        for name, c in STANDARD_CONFIGS.items()
    }

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # -- result tables (reference `generate_tables.py`; files land next to
    # the results JSON) ----------------------------------------------------
    tbl_input = {
        f"SP-{w}bit": {
            "bits": w,
            "model_size_gb": results["model_size_gb"],
            "zero_shot": results.get("zero_shot"),
            "perplexity": {k.replace("wikitext2", "WikiText2")
                           .replace("wikitext103", "WikiText103"): v
                           for k, v in results["perplexity"].items()},
            "few_shot": results.get("few_shot"),
        }
    }
    gen = ResultTableGenerator(tbl_input, output_dir=str(out_dir))
    print(gen.generate_table_2_perplexity())
    if results.get("zero_shot"):
        print(gen.generate_table_1_zero_shot())
        gen.export_to_latex()
    if results.get("few_shot"):
        print(gen.generate_table_7_few_shot())

    out_path = out_dir / "results.json"
    out_path.write_text(json.dumps(results, indent=2))
    print(f"results → {out_path}")
    return results


if __name__ == "__main__":
    main()
