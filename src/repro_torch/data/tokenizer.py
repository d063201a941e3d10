"""Deterministic hash tokenizer (no external vocab files).

A copy of the reference's ``repro/data/tokenizer.py`` (numpy + hashlib
only): words are feature-hashed into a fixed id space, so the same text
gives the same ids in both packages.  Ids: 0 = PAD, 1 = CLS, 2 = UNK,
3+ = hashed.
"""
from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import numpy as np

PAD, CLS, UNK = 0, 1, 2
_RESERVED = 3


def _hash_word(word: str, vocab: int) -> int:
    h = hashlib.blake2b(word.lower().encode("utf-8"), digest_size=8)
    return _RESERVED + int.from_bytes(h.digest(), "little") % (vocab - _RESERVED)


def encode(text: str, vocab: int, max_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """→ (ids (max_len,) int32, mask (max_len,) bool); CLS prepended."""
    words = text.split()
    ids = [CLS] + [_hash_word(w, vocab) for w in words][: max_len - 1]
    mask = np.zeros(max_len, bool)
    mask[: len(ids)] = True
    out = np.full(max_len, PAD, np.int32)
    out[: len(ids)] = ids
    return out, mask


def encode_batch(texts: Sequence[str], vocab: int, max_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    pairs = [encode(t, vocab, max_len) for t in texts]
    return (np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))
