"""A cell of BENCHMARK.json cut to a size the CPU tests hold: GPT-2's
structure at width 128, 2 layers of 2 heads of 64, vocabulary 512, LoRA
rank 8; B = 2 x T = 128 training batches; 4 serving slots, prompts of
8-32 and 16-48 new tokens arriving at 4 a second. The cell runners run on the CPU, where every
kernel wrapper of the system takes its plain version."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_MODEL = dict(vocab_size=512, n_positions=256, n_ctx=256, n_embd=128, n_layer=2, n_head=2)


def tiny_cell(workload: str):
    from bench_port.harness.spec import load_cell

    cell = load_cell(workload)
    cell.config.update(TINY_MODEL)
    cell.config["quant"] = dict(cell.config["quant"], lora_rank=8, lora_alpha=8)
    if cell.traffic["kind"] == "train":
        cell.traffic.update(batch_size=2, seq_len=128)
    else:
        cell.traffic.update(slots=4, max_len=256, chunk=16, strata=8, block=4,
                            rate_per_s=4.0, warmup_s=0.0,
                            prompt_len=dict(dist="log_normal", mean=16, sigma=0.5, min=8,
                                            max=32),
                            new_tokens=dict(dist="log_normal", mean=28, sigma=0.5, min=16,
                                            max=48),
                            calibration=dict(batch=2, seq_len=32), check_requests=3)
    return cell


def workloads(kind: str):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mixes = {w["traffic"]: json.loads((ROOT / "bench_port" / "traffic" /
                                       f"{w['traffic']}.json").read_text())["kind"]
             for w in bench["workloads"]}
    return [w["name"] for w in bench["workloads"] if mixes[w["traffic"]] == kind]
