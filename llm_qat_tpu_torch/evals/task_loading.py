"""Zero-shot task dataset loaders (reference `zero_shot_tasks.py:load_all_tasks`).

Counterpart of `llm_qat_tpu/evals/task_loading.py`. Loads BoolQ / HellaSwag
/ WinoGrande / ARC-e / ARC-c / OBQA via HF datasets when reachable; a task
whose load fails maps to None and is skipped, the reference's
error-tolerant behavior (`zero_shot_tasks.py:223-238`). Offline, the loads
ask for local files only (the hub libraries read HF_HUB_OFFLINE once, at
their import). A deterministic synthetic generator is provided for offline
pipeline testing (clearly labeled — not comparable to hub accuracy
numbers); its examples equal the JAX package's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.lm_datasets import _offline_env_defaults

TASK_SOURCES = {
    "BoolQ": ("google/boolq", None, "validation"),
    "HellaSwag": ("hellaswag", None, "validation"),
    "WinoGrande": ("winogrande", "winogrande_xl", "validation"),
    "ARC-e": ("ai2_arc", "ARC-Easy", "test"),
    "ARC-c": ("ai2_arc", "ARC-Challenge", "test"),
    "OBQA": ("openbookqa", "main", "test"),
}


def load_task(name: str, max_samples: int = 500) -> Optional[List[Dict]]:
    offline = _offline_env_defaults()
    src = TASK_SOURCES.get(name)
    if src is None:
        return None
    ds_name, config, split = src
    try:
        from datasets import DownloadConfig, load_dataset

        ds = load_dataset(ds_name, config, split=split,
                          download_config=DownloadConfig(local_files_only=offline))
        out = []
        for i, ex in enumerate(ds):
            if i >= max_samples:
                break
            out.append(dict(ex))
        return out
    except Exception:
        return None


def load_all_tasks(tasks=None, max_samples: int = 500) -> Dict[str, Optional[List]]:
    """{task: examples|None} (reference `zero_shot_tasks.py:223-238`)."""
    tasks = tasks or list(TASK_SOURCES)
    return {t: load_task(t, max_samples) for t in tasks}


def synthetic_tasks(n: int = 20, seed: int = 0) -> Dict[str, List[Dict]]:
    """Offline synthetic examples in each task's schema (pipeline testing)."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta"]

    def sent(k=6):
        return " ".join(rng.choice(words, k).tolist())

    boolq = [{"passage": sent(20), "question": sent(5) + "?",
              "answer": bool(rng.integers(2))} for _ in range(n)]
    hella = [{"ctx": sent(8), "endings": [sent(4) for _ in range(4)],
              "label": str(int(rng.integers(4)))} for _ in range(n)]
    wino = [{"sentence": sent(3) + " _ " + sent(3),
             "option1": words[0], "option2": words[1],
             "answer": str(int(rng.integers(2)) + 1)} for _ in range(n)]
    arc = [{"question": sent(6) + "?", "answerKey": "A",
            "choices": {"text": [sent(3) for _ in range(4)],
                        "label": ["A", "B", "C", "D"]}} for _ in range(n)]
    obqa = [{"question_stem": sent(6), "answerKey": "B",
             "choices": {"text": [sent(3) for _ in range(4)],
                         "label": ["A", "B", "C", "D"]}} for _ in range(n)]
    return {"BoolQ": boolq, "HellaSwag": hella, "WinoGrande": wino,
            "ARC-e": arc, "ARC-c": arc, "OBQA": obqa}
