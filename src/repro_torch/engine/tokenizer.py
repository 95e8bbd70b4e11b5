"""Deterministic hash tokenizer for real-mode end-to-end runs.

Halo is semantics-preserving at the SYSTEM level: what matters for the
reproduction is that identical prompts produce identical token streams
(so coalescing/batching can be verified bit-exact), not linguistic
quality.  A stable per-word hash into the model vocab provides exactly
that, with zero external assets.

A copy of the JAX package's module of the same name; the port imports
nothing of it.
"""
from __future__ import annotations

import hashlib
from typing import List

BOS = 1
EOS = 2
_RESERVED = 8          # ids [0, 8) reserved: pad/bos/eos/...


def _word_id(word: str, vocab_size: int) -> int:
    h = hashlib.blake2b(word.encode("utf-8"), digest_size=8).digest()
    return _RESERVED + int.from_bytes(h, "little") % (vocab_size - _RESERVED)


def tokenize(text: str, vocab_size: int, add_bos: bool = True) -> List[int]:
    toks = [BOS] if add_bos else []
    toks += [_word_id(w, vocab_size) for w in text.split()]
    return toks


def detokenize(tokens: List[int]) -> str:
    return " ".join(f"t{t}" for t in tokens)
