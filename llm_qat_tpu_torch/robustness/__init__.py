"""Adversarial robustness: RPI defense, TextFooler / BERT-Attack."""

from .attacks import (
    AttackEvaluator,
    BERTAttack,
    StaticMLMProposer,
    StaticSynonyms,
    TextFoolerAttack,
    make_mlm_proposer,
    make_synonym_provider,
)
from .defense_eval import run_rpi_evaluation
from .random_switching import (
    DefenseEvaluator,
    SimplifiedRandomSwitching,
    defense_success_rate,
    token_level_metrics,
)

__all__ = [
    "AttackEvaluator",
    "BERTAttack",
    "StaticMLMProposer",
    "StaticSynonyms",
    "TextFoolerAttack",
    "make_mlm_proposer",
    "make_synonym_provider",
    "run_rpi_evaluation",
    "DefenseEvaluator",
    "SimplifiedRandomSwitching",
    "defense_success_rate",
    "token_level_metrics",
]
