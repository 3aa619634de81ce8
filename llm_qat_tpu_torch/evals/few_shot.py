"""Few-shot evaluation: MMLU (k-shot multiple choice) and TriviaQA (free-form).

The reference only *renders* few-shot results (Table 7,
`part3_eval_sp/generate_tables.py:91-119`) — it contains no few-shot
evaluator. This module completes the pipeline so Table 7 can actually be
produced:

- MMLU: k-shot prompt (dev examples with answers) + likelihood scoring of
  the lettered choices, same mean-logprob scorer as the zero-shot suite;
  subject scores aggregate into the Humanities/STEM/Social Sciences/Other
  groups Table 7 expects.
- TriviaQA: k-shot Q/A prompt + greedy generation, scored by normalized
  exact-match against any alias (SQuAD-style normalization).

Datasets load from HF when reachable (`load_dataset("cais/mmlu", ...)`,
`trivia_qa`); the evaluators take example lists so synthetic offline data
exercises the full path in tests.

Counterpart of `llm_qat_tpu/evals/few_shot.py`. Scoring runs through the
port's `ZeroShotEvaluator` on its device (the card unless the caller asks
for the CPU); offline, `load_mmlu` asks for local files only and returns
None.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.lm_datasets import _offline_env_defaults
from .squad_metrics import normalize_answer
from .zero_shot import ZeroShotEvaluator

# cais/mmlu subject → Table-7 category (standard grouping)
MMLU_CATEGORIES = {
    "Humanities": {
        "formal_logic", "high_school_european_history", "high_school_us_history",
        "high_school_world_history", "international_law", "jurisprudence",
        "logical_fallacies", "moral_disputes", "moral_scenarios", "philosophy",
        "prehistory", "professional_law", "world_religions",
    },
    "STEM": {
        "abstract_algebra", "anatomy", "astronomy", "college_biology",
        "college_chemistry", "college_computer_science", "college_mathematics",
        "college_physics", "computer_security", "conceptual_physics",
        "electrical_engineering", "elementary_mathematics",
        "high_school_biology", "high_school_chemistry",
        "high_school_computer_science", "high_school_mathematics",
        "high_school_physics", "high_school_statistics", "machine_learning",
    },
    "Social Sciences": {
        "econometrics", "high_school_geography",
        "high_school_government_and_politics", "high_school_macroeconomics",
        "high_school_microeconomics", "high_school_psychology",
        "human_sexuality", "professional_psychology", "public_relations",
        "security_studies", "sociology", "us_foreign_policy",
    },
}


def mmlu_category(subject: str) -> str:
    for cat, subjects in MMLU_CATEGORIES.items():
        if subject in subjects:
            return cat
    return "Other"


def format_mmlu_prompt(example: Dict, shots: Sequence[Dict]) -> str:
    """k-shot prompt: dev Q/A pairs then the target question."""
    letters = "ABCD"

    def block(ex, with_answer):
        lines = [f"Question: {ex['question']}"]
        for i, c in enumerate(ex["choices"]):
            lines.append(f"{letters[i]}. {c}")
        lines.append("Answer:" + (f" {letters[int(ex['answer'])]}"
                                  if with_answer else ""))
        return "\n".join(lines)

    parts = [block(s, True) for s in shots] + [block(example, False)]
    return "\n\n".join(parts)


class FewShotEvaluator:
    """MMLU + TriviaQA over a logits_fn / generate_fn."""

    def __init__(self, logits_fn: Callable, tokenizer: Callable,
                 generate_fn: Optional[Callable] = None,
                 max_length: int = 512, max_samples: int = 100,
                 n_shots: int = 5, device=None):
        self.zs = ZeroShotEvaluator(logits_fn, tokenizer,
                                    max_length=max_length,
                                    context_max_tokens=max_length - 16,
                                    max_samples=max_samples, device=device)
        self.tokenizer = tokenizer
        self.generate_fn = generate_fn
        self.max_samples = max_samples
        self.n_shots = n_shots

    # -- MMLU --------------------------------------------------------------
    def evaluate_mmlu_subject(self, test_examples: Sequence[Dict],
                              dev_examples: Sequence[Dict]) -> float:
        """Accuracy% for one subject; examples: {question, choices, answer}."""
        letters = [" A", " B", " C", " D"]
        shots = list(dev_examples)[: self.n_shots]
        correct = total = 0
        for ex in list(test_examples)[: self.max_samples]:
            prompt = format_mmlu_prompt(ex, shots)
            pred = self.zs.compute_choice_likelihood(prompt, letters)
            correct += int(pred == int(ex["answer"]))
            total += 1
        return 100.0 * correct / max(total, 1)

    def evaluate_mmlu(self, subjects: Dict[str, Dict]) -> Dict[str, float]:
        """subjects: {name: {"test": [...], "dev": [...]}} →
        Table-7 group averages {Humanities, STEM, Social Sciences, Other,
        Average}."""
        by_cat: Dict[str, List[float]] = {}
        for name, data in subjects.items():
            acc = self.evaluate_mmlu_subject(data["test"], data.get("dev", []))
            by_cat.setdefault(mmlu_category(name), []).append(acc)
        out = {cat: round(float(np.mean(v)), 1) for cat, v in by_cat.items()}
        all_scores = [s for v in by_cat.values() for s in v]
        out["Average"] = round(float(np.mean(all_scores)), 1) if all_scores else 0.0
        return out

    # -- TriviaQA ----------------------------------------------------------
    def evaluate_triviaqa(self, examples: Sequence[Dict],
                          shots: Sequence[Dict] = (),
                          max_new_tokens: int = 16) -> float:
        """EM% by normalized match against any alias;
        examples: {question, answers: [aliases]}."""
        if self.generate_fn is None:
            raise ValueError("TriviaQA needs generate_fn")
        shot_text = "".join(
            f"Q: {s['question']}\nA: {s['answers'][0]}\n\n"
            for s in list(shots)[: self.n_shots]
        )
        correct = total = 0
        for ex in list(examples)[: self.max_samples]:
            prompt = shot_text + f"Q: {ex['question']}\nA:"
            text = self.generate_fn(prompt, max_new_tokens)
            pred = normalize_answer(text.split("\n")[0])
            gold = {normalize_answer(a) for a in ex["answers"]}
            correct += int(pred in gold and pred != "")
            total += 1
        return 100.0 * correct / max(total, 1)

    def evaluate_all(self, mmlu_subjects: Optional[Dict] = None,
                     triviaqa: Optional[Sequence[Dict]] = None,
                     triviaqa_shots: Sequence[Dict] = ()) -> Dict:
        """→ the `few_shot` dict `generate_tables.generate_table_7_few_shot`
        consumes: {"MMLU": {...}, "TriviaQA": acc}."""
        out: Dict = {}
        if mmlu_subjects:
            out["MMLU"] = self.evaluate_mmlu(mmlu_subjects)
        if triviaqa is not None:
            out["TriviaQA"] = round(
                self.evaluate_triviaqa(triviaqa, triviaqa_shots), 1)
        return out


def load_mmlu(subjects: Optional[Sequence[str]] = None,
              max_samples: int = 100) -> Optional[Dict]:
    """HF cais/mmlu loader (None when offline)."""
    offline = _offline_env_defaults()
    try:
        from datasets import DownloadConfig, load_dataset

        subjects = subjects or ["abstract_algebra", "philosophy", "sociology"]
        local = lambda: DownloadConfig(local_files_only=offline)
        out = {}
        for s in subjects:
            test = load_dataset("cais/mmlu", s, split="test", download_config=local())
            dev = load_dataset("cais/mmlu", s, split="dev", download_config=local())
            out[s] = {
                "test": [dict(e) for e in list(test)[:max_samples]],
                "dev": [dict(e) for e in list(dev)[:8]],
            }
        return out
    except Exception:
        return None
