"""Text tokenization.

A copy of the JAX package's data/tokenizer.py. The reference uses the HF
xlm-roberta-base SentencePiece tokenizer (src/models/text_encoder.py:11,
51-53). This module keeps that as the primary path when the tokenizer
files exist locally, with a deterministic hash-vocabulary fallback so the
system runs hermetically (no network, tests) — both produce
XLM-R-convention special ids (bos=0, pad=1, eos=2, unk=3).
"""

from __future__ import annotations

import hashlib
from typing import Protocol, Sequence, Tuple

import numpy as np


class Tokenizer(Protocol):
    pad_id: int

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (ids [B, max_len] int32, mask [B, max_len] float32)."""
        ...


class HashTokenizer:
    """Deterministic whitespace tokenizer hashing each token into a fixed
    vocabulary. BOS/EOS framing and padding follow XLM-R conventions."""

    BOS, PAD, EOS, UNK = 0, 1, 2, 3
    pad_id = PAD

    def __init__(self, vocab_size: int = 250002):
        self.vocab_size = vocab_size
        self._reserved = 4

    def _token_id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.md5(tok.lower().encode()).digest()[:4], "little")
        return self._reserved + h % (self.vocab_size - self._reserved)

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        B = len(texts)
        ids = np.full((B, max_len), self.PAD, np.int32)
        mask = np.zeros((B, max_len), np.float32)
        for i, text in enumerate(texts):
            toks = [self._token_id(t) for t in (text or "").split()]
            toks = [self.BOS] + toks[: max_len - 2] + [self.EOS]
            ids[i, :len(toks)] = toks
            mask[i, :len(toks)] = 1.0
        return ids, mask


class HFTokenizer:
    """Wrapper over a locally-available HF tokenizer (sentencepiece)."""

    def __init__(self, name_or_path: str = "xlm-roberta-base",
                 local_files_only: bool = True):
        # local_files_only avoids minutes of HTTP retries on air-gapped
        # hosts; pass False explicitly to allow a hub download.
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(
            name_or_path, local_files_only=local_files_only)
        self.pad_id = self._tok.pad_token_id

    def encode_batch(self, texts: Sequence[str], max_len: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
        enc = self._tok(list(texts), padding="max_length", truncation=True,
                        max_length=max_len, return_tensors="np")
        return (enc["input_ids"].astype(np.int32),
                enc["attention_mask"].astype(np.float32))


def get_tokenizer(name_or_path: str = "xlm-roberta-base",
                  vocab_size: int = 250002) -> Tokenizer:
    """HF tokenizer if its files are reachable, hash fallback otherwise."""
    try:
        return HFTokenizer(name_or_path)
    except Exception:
        return HashTokenizer(vocab_size)
