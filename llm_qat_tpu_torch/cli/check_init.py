"""Checkpoint-vs-pretrained weight verification.

Counterpart of `llm_qat_tpu/cli/check_init.py`: load a checkpoint, map its
parameter names onto a pretrained (or reference) GPT-2 state dict, and
report per-tensor match/mismatch, to tell whether a trained model actually
started from the pretrained weights. The comparison runs on the host in
numpy; `main` needs `transformers` and the hub or its cache for the
pretrained weights.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

from ..bridge import params_to_numpy
from ..data.lm_datasets import _offline_env_defaults
from ..deploy import load_checkpoint

# our param path → HF GPT-2 state_dict key (per layer where applicable)
NAME_MAP = {
    "wte": "wte.weight",
    "wpe": "wpe.weight",
    "blocks/c_attn/w": "h.{i}.attn.c_attn.weight",
    "blocks/c_attn/b": "h.{i}.attn.c_attn.bias",
    "blocks/attn_proj/w": "h.{i}.attn.c_proj.weight",
    "blocks/attn_proj/b": "h.{i}.attn.c_proj.bias",
    "blocks/c_fc/w": "h.{i}.mlp.c_fc.weight",
    "blocks/c_fc/b": "h.{i}.mlp.c_fc.bias",
    "blocks/mlp_proj/w": "h.{i}.mlp.c_proj.weight",
    "blocks/mlp_proj/b": "h.{i}.mlp.c_proj.bias",
}


def compare_with_pretrained(params, hf_state_dict, atol: float = 1e-5) -> Dict:
    """Per-tensor comparison report of `params` (the port's tensors or
    numpy arrays) against a HF GPT-2 state dict.

    LN banks compare each precision slot against the single pretrained LN
    (they are replicated at load).
    """
    params = params_to_numpy(params)
    sd = {}
    for k, v in hf_state_dict.items():
        if k.startswith("transformer."):
            k = k[len("transformer."):]
        sd[k] = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach")
                           else v, np.float32)

    report = {"matches": [], "mismatches": [], "missing": []}

    def check(name, ours, theirs):
        ours = np.asarray(ours)
        if ours.shape != theirs.shape:
            report["mismatches"].append((name, "shape", ours.shape,
                                         theirs.shape))
        elif np.allclose(ours, theirs, atol=atol):
            report["matches"].append(name)
        else:
            diff = float(np.abs(ours - theirs).max())
            report["mismatches"].append((name, "value", diff))

    for ours_key, hf_key in NAME_MAP.items():
        parts = ours_key.split("/")
        if parts[0] == "blocks":
            leaf = params["blocks"][parts[1]][parts[2]]
            L = leaf.shape[0]
            for i in range(L):
                k = hf_key.format(i=i)
                if k not in sd:
                    report["missing"].append(k)
                    continue
                check(f"{ours_key}[{i}]", leaf[i], sd[k])
        else:
            k = hf_key
            if k not in sd:
                report["missing"].append(k)
                continue
            check(ours_key, params[parts[0]], sd[k])

    # LN banks: every precision slot should equal the pretrained LN at init
    for ln_name, hf_prefix in (("ln1", "h.{i}.ln_1"), ("ln2", "h.{i}.ln_2")):
        bank = params["blocks"][ln_name]
        L, P = bank["g"].shape[:2]
        for i in range(L):
            for suffix, leaf in (("weight", bank["g"]), ("bias", bank["b"])):
                k = hf_prefix.format(i=i) + "." + suffix
                if k not in sd:
                    report["missing"].append(k)
                    continue
                for p in range(P):
                    check(f"blocks/{ln_name}/{suffix}[{i},prec{p}]",
                          leaf[i, p], sd[k])
    for suffix, leaf in (("weight", params["ln_f"]["g"]),
                         ("bias", params["ln_f"]["b"])):
        k = "ln_f." + suffix
        if k in sd:
            for p in range(leaf.shape[0]):
                check(f"ln_f/{suffix}[prec{p}]", leaf[p], sd[k])

    report["summary"] = {
        "n_match": len(report["matches"]),
        "n_mismatch": len(report["mismatches"]),
        "n_missing": len(report["missing"]),
        "initialized_from_pretrained": len(report["mismatches"]) == 0
        and len(report["matches"]) > 0,
    }
    return report


def main(argv=None, *, device=None):
    p = argparse.ArgumentParser(
        description="Verify a checkpoint started from pretrained GPT-2"
    )
    p.add_argument("--model-path", required=True)
    p.add_argument("--pretrained", default="gpt2")
    args = p.parse_args(argv)

    offline = _offline_env_defaults()
    params, _ = load_checkpoint(args.model_path, device=device)
    from transformers import GPT2LMHeadModel

    hf = GPT2LMHeadModel.from_pretrained(args.pretrained, local_files_only=offline)
    report = compare_with_pretrained(params, hf.state_dict())
    print(report["summary"])
    for m in report["mismatches"][:20]:
        print("MISMATCH:", m)
    return report


if __name__ == "__main__":
    main()
