"""Data layer: LM datasets (WikiText with offline fallbacks), tokenizers;
SQuAD preprocessing in `data.squad`."""

from .lm_datasets import (
    ByteTokenizer,
    LMDataset,
    chunk_tokens,
    create_dataloaders,
    get_gpt2_tokenizer,
    load_wikitext,
    synthetic_corpus,
    synthetic_markov_corpus,
    WordTokenizer,
)

__all__ = [
    "ByteTokenizer",
    "LMDataset",
    "chunk_tokens",
    "create_dataloaders",
    "get_gpt2_tokenizer",
    "load_wikitext",
    "synthetic_corpus",
    "synthetic_markov_corpus",
    "WordTokenizer",
]
