"""Adversarial attacks: TextFooler and BERT-Attack (host-side, driving the
port's model).

Counterpart of `llm_qat_tpu/robustness/attacks.py`
(reference `part4_randomSwitching/adversarial_attacks.py`):
- `TextFoolerAttack` (`:21-320`): word importance via the gradient norm of
  the input embeddings (SP path, `:75-133`) or per-word masking Δloss;
  candidate synonyms (WordNet ≤10, `:54-73`); greedy word substitution
  maximizing model loss subject to an embedding-cosine similarity
  constraint (`:135-320`). Attack success = token-accuracy drop > 0.05
  (`:291`).
- `BERTAttack` (`:322-645`): a masked LM proposes top-k substitutes for the
  most important words (mask-based importance `:422-464`); semantic gate
  via sequence-embedding cosine >= 0.4 (`:466-490`); same success
  criterion (`:616`).

WordNet and bert-base-uncased sit behind the `get_synonyms` / `propose`
providers, with deterministic offline stand-ins: without their files the
attacks run on `StaticSynonyms` and `StaticMLMProposer`, as in the JAX
package. Loads ask for local files only while the hub is off.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.lm_datasets import _offline_env_defaults
from ..models.sp_model import embed_tokens, lm_cross_entropy, prec_tables, sp_forward


# ---------------------------------------------------------------------------
# Substitution providers
# ---------------------------------------------------------------------------


class StaticSynonyms:
    """Deterministic offline synonym table (fallback for WordNet)."""

    TABLE = {
        "big": ["large", "huge", "great"],
        "small": ["little", "tiny", "minor"],
        "good": ["fine", "great", "nice"],
        "bad": ["poor", "awful", "terrible"],
        "fast": ["quick", "rapid", "speedy"],
        "slow": ["sluggish", "gradual"],
        "happy": ["glad", "joyful", "pleased"],
        "sad": ["unhappy", "sorrowful"],
        "cat": ["feline", "kitty"],
        "dog": ["canine", "hound"],
        "run": ["sprint", "dash", "jog"],
        "walk": ["stroll", "pace"],
        "say": ["state", "tell", "declare"],
        "make": ["create", "build", "produce"],
        "house": ["home", "dwelling"],
        "car": ["vehicle", "automobile"],
        "man": ["person", "fellow"],
        "woman": ["lady", "person"],
        "old": ["ancient", "aged", "elderly"],
        "new": ["fresh", "recent", "modern"],
        # coverage for the offline synthetic corpus vocabulary
        # (`data/lm_datasets.py::synthetic_corpus`) so the attack loop has
        # substitution candidates in zero-egress runs
        "model": ["system", "network", "architecture"],
        "precision": ["accuracy", "exactness"],
        "quantization": ["discretization", "rounding"],
        "tensor": ["array", "matrix"],
        "layer": ["level", "block"],
        "training": ["learning", "optimization"],
        "gradient": ["slope", "derivative"],
        "attention": ["focus", "concentration"],
        "language": ["speech", "text"],
        "compute": ["calculation", "processing"],
        "memory": ["storage", "cache"],
        "scale": ["size", "magnitude"],
    }

    def get_synonyms(self, word: str, max_candidates: int = 10) -> List[str]:
        return self.TABLE.get(word.lower(), [])[:max_candidates]


class WordNetSynonyms:
    """WordNet synonyms (reference `:54-73`); requires nltk + corpus."""

    def __init__(self):
        from nltk.corpus import wordnet

        # the corpus reader is lazy — force a lookup so a missing corpus
        # raises HERE and make_synonym_provider falls back to StaticSynonyms
        wordnet.synsets("test")
        self._wn = wordnet

    def get_synonyms(self, word: str, max_candidates: int = 10) -> List[str]:
        syns = []
        for synset in self._wn.synsets(word):
            for lemma in synset.lemmas():
                w = lemma.name().replace("_", " ")
                if w.lower() != word.lower() and w not in syns:
                    syns.append(w)
                if len(syns) >= max_candidates:
                    return syns
        return syns


def make_synonym_provider():
    """WordNet where nltk and its corpus are installed, else StaticSynonyms
    (nltk without the corpus raises LookupError)."""
    try:
        return WordNetSynonyms()
    except Exception:  # a missing provider of any kind: the offline table
        return StaticSynonyms()


class StaticMLMProposer:
    """Offline MLM stand-in: proposes common words (fallback for BERT MLM)."""

    COMMON = ["the", "one", "thing", "way", "place", "time", "part", "kind",
              "form", "case", "fact", "point", "group", "number"]

    def propose(self, words: Sequence[str], idx: int, k: int = 8) -> List[str]:
        return [w for w in self.COMMON if w != words[idx].lower()][:k]


class BertMLMProposer:
    """bert-base-uncased masked-LM proposals (reference `:322-420`), on
    `device` (the CPU by default, as in the JAX package: the masked LM
    proposes words, it is not the model under attack). With the hub off
    (the default) it loads local files only."""

    def __init__(self, model_name: str = "bert-base-uncased", device="cpu"):
        offline = _offline_env_defaults()  # before the import: the hub reads it there
        from transformers import BertForMaskedLM, BertTokenizer

        self.device = torch.device(device)
        self.tokenizer = BertTokenizer.from_pretrained(model_name,
                                                       local_files_only=offline)
        self.model = BertForMaskedLM.from_pretrained(
            model_name, local_files_only=offline).to(self.device).eval()

    def propose(self, words: Sequence[str], idx: int, k: int = 8) -> List[str]:
        masked = list(words)
        masked[idx] = self.tokenizer.mask_token
        enc = self.tokenizer(" ".join(masked), return_tensors="pt",
                             truncation=True, max_length=128)
        enc = {n: t.to(self.device) for n, t in enc.items()}
        with torch.no_grad():
            logits = self.model(**enc).logits
        mask_pos = (enc["input_ids"][0] ==
                    self.tokenizer.mask_token_id).nonzero()
        if len(mask_pos) == 0:
            return []
        top = logits[0, mask_pos[0, 0]].topk(k).indices.tolist()
        return [self.tokenizer.decode([t]).strip() for t in top]


def make_mlm_proposer(device="cpu"):
    """BertMLMProposer where `transformers` and the model's files are
    present, else StaticMLMProposer. A missing file surfaces as whatever
    the installed `transformers` raises (4.57 raises TypeError from the
    tokenizer's constructor), so any failure of the load falls back."""
    try:
        return BertMLMProposer(device=device)
    except Exception:
        return StaticMLMProposer()


# ---------------------------------------------------------------------------
# Shared attack machinery
# ---------------------------------------------------------------------------


class _AttackBase:
    """Common scoring utilities.

    `metrics_fn(text) -> (loss, accuracy)`: the victim LM's loss and
    next-token accuracy on the text (host scalars).
    `embed_fn(text) -> vector`: sequence embedding for semantic similarity
    (reference uses mean GPT-2 wte embedding, `:466-490`).
    """

    def __init__(self, metrics_fn: Callable, embed_fn: Optional[Callable] = None,
                 sim_threshold: float = 0.7, max_perturb_ratio: float = 0.3,
                 importance_fn: Optional[Callable] = None):
        self.metrics_fn = metrics_fn
        self.embed_fn = embed_fn
        self.sim_threshold = sim_threshold
        self.max_perturb_ratio = max_perturb_ratio
        # optional override: importance_fn(words) -> list[float]; the SP
        # reference ranks words by grad-norm of inputs_embeds
        # (adversarial_attacks.py:75-103) — see make_gradient_importance_fn
        self.importance_fn = importance_fn

    def _similar(self, a: str, b: str, threshold: Optional[float] = None) -> bool:
        if self.embed_fn is None:
            return True
        va, vb = np.asarray(self.embed_fn(a)), np.asarray(self.embed_fn(b))
        denom = np.linalg.norm(va) * np.linalg.norm(vb)
        if denom < 1e-9:
            return True
        sim = float(np.dot(va, vb) / denom)
        return sim >= (threshold if threshold is not None else self.sim_threshold)

    def word_importance(self, words: Sequence[str],
                        base_loss: float) -> List[float]:
        """Per-word Δloss when the word is dropped (masking importance,
        reference CPT path `:104-133`)."""
        scores = []
        for i in range(len(words)):
            reduced = " ".join(words[:i] + list(words[i + 1:]))
            if not reduced.strip():
                scores.append(0.0)
                continue
            loss, _ = self.metrics_fn(reduced)
            scores.append(abs(loss - base_loss))
        return scores

    def _greedy_attack(self, text: str, candidate_fn, sim_threshold) -> Dict:
        orig_loss, orig_acc = self.metrics_fn(text)
        words = text.split()
        if len(words) < 2:
            return {"success": False, "original_text": text,
                    "adversarial_text": text, "num_changes": 0,
                    "perturb_ratio": 0.0, "accuracy_drop": 0.0}

        if self.importance_fn is not None:
            importance = self.importance_fn(words)
        else:
            importance = self.word_importance(words, orig_loss)
        order = np.argsort(importance)[::-1]
        max_changes = max(1, int(len(words) * self.max_perturb_ratio))

        adv = list(words)
        cur_loss, cur_acc = orig_loss, orig_acc
        changes = 0
        for widx in order:
            if changes >= max_changes:
                break
            candidates = candidate_fn(adv, int(widx))
            best = None
            for cand in candidates:
                if cand.lower() == adv[widx].lower():
                    continue
                trial = list(adv)
                trial[widx] = cand
                trial_text = " ".join(trial)
                if not self._similar(text, trial_text, sim_threshold):
                    continue
                loss, acc = self.metrics_fn(trial_text)
                if loss > cur_loss and (best is None or loss > best[0]):
                    best = (loss, acc, cand)
            if best is not None:
                adv[widx] = best[2]
                cur_loss, cur_acc = best[0], best[1]
                changes += 1

        acc_drop = orig_acc - cur_acc
        return {
            "success": acc_drop > 0.05,  # reference `:291,616`
            "original_text": text,
            "adversarial_text": " ".join(adv),
            "num_changes": changes,
            "perturb_ratio": changes / len(words),
            "orig_loss": orig_loss,
            "adv_loss": cur_loss,
            "orig_accuracy": orig_acc,
            "adv_accuracy": cur_acc,
            "accuracy_drop": acc_drop,
        }


class TextFoolerAttack(_AttackBase):
    """WordNet-synonym greedy substitution (reference `:21-320`)."""

    def __init__(self, metrics_fn, embed_fn=None, synonyms=None,
                 max_candidates: int = 10, sim_threshold: float = 0.7,
                 max_perturb_ratio: float = 0.3, importance_fn=None):
        super().__init__(metrics_fn, embed_fn, sim_threshold,
                         max_perturb_ratio, importance_fn)
        self.synonyms = synonyms or make_synonym_provider()
        self.max_candidates = max_candidates

    def generate_adversarial(self, text: str,
                             max_perturb_ratio: Optional[float] = None) -> Dict:
        if max_perturb_ratio is not None:
            self.max_perturb_ratio = max_perturb_ratio

        def candidates(words, idx):
            return self.synonyms.get_synonyms(words[idx], self.max_candidates)

        return self._greedy_attack(text, candidates, self.sim_threshold)


class BERTAttack(_AttackBase):
    """MLM-substitution attack (reference `:322-645`); semantic gate 0.4."""

    def __init__(self, metrics_fn, embed_fn=None, proposer=None,
                 top_k: int = 8, sim_threshold: float = 0.4,
                 max_perturb_ratio: float = 0.3, importance_fn=None):
        super().__init__(metrics_fn, embed_fn, sim_threshold,
                         max_perturb_ratio, importance_fn)
        self.proposer = proposer or make_mlm_proposer()
        self.top_k = top_k

    def generate_adversarial(self, text: str,
                             max_perturb_ratio: Optional[float] = None) -> Dict:
        if max_perturb_ratio is not None:
            self.max_perturb_ratio = max_perturb_ratio

        def candidates(words, idx):
            return self.proposer.propose(words, idx, self.top_k)

        return self._greedy_attack(text, candidates, self.sim_threshold)


class AttackEvaluator:
    """Batch attack runner (reference `:647-836`): per-sample attacks,
    success-rate bookkeeping, storing successful adversarial texts for the
    defence evaluation."""

    def __init__(self, attack):
        self.attack = attack

    def evaluate(self, texts: Sequence[str], max_samples: int = 30) -> Dict:
        results = {
            "total_samples": 0,
            "successful_attacks": 0,
            "attack_success_rate": 0.0,
            "adversarial_examples": [],
            "details": [],
        }
        for text in texts[:max_samples]:
            r = self.attack.generate_adversarial(text)
            results["total_samples"] += 1
            results["details"].append(r)
            if r["success"]:
                results["successful_attacks"] += 1
                results["adversarial_examples"].append({
                    "original": r["original_text"],
                    "adversarial": r["adversarial_text"],
                })
        if results["total_samples"]:
            results["attack_success_rate"] = (
                results["successful_attacks"] / results["total_samples"]
            )
        return results


def make_gradient_importance_fn(params, cfg, tokenizer, tables=None,
                                prec_idx: int = 0):
    """Word importance via grad-norm of input embeddings (reference SP path,
    `adversarial_attacks.py:75-103`): backprop the LM loss to inputs_embeds
    through `sp_forward` on the parameters' device, take the per-token
    gradient L2 norm, average tokens per word (tokens past `n_positions`
    are cut). Only the (T,) norms come back to the host.
    """
    dev = params["wte"].device
    if tables is None:
        tables = prec_tables(cfg.quant, dev)

    def token_grad_norms(ids):
        embeds = embed_tokens(params["wte"], ids).detach().requires_grad_(True)
        with torch.enable_grad():
            out = sp_forward(params, None, prec_idx, cfg, tables=tables,
                             inputs_embeds=embeds)
            loss = lm_cross_entropy(out["logits"], ids)
            (g,) = torch.autograd.grad(loss, embeds)
        return torch.linalg.vector_norm(g, dim=-1)[0]  # (T,)

    def importance_fn(words):
        # map words to token ranges, then average grad norms per word
        tok_ranges = []
        all_ids = []
        for w in words:
            ids = tokenizer(w)
            tok_ranges.append((len(all_ids), len(all_ids) + len(ids)))
            all_ids.extend(ids)
        if len(all_ids) < 2:
            return [0.0] * len(words)
        ids = torch.as_tensor(all_ids[:cfg.model.n_positions], dtype=torch.int64,
                              device=dev)[None]
        norms = token_grad_norms(ids).cpu().numpy()
        out = []
        for (a, b) in tok_ranges:
            b = min(b, len(norms))
            out.append(float(norms[a:b].mean()) if b > a else 0.0)
        return out

    return importance_fn
