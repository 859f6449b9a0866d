"""Tokenizer protocol and the deterministic hash tokenizer.

A copy of ``musev_tpu/utils/tokenizer.py``'s ``Tokenizer`` and
``HashTokenizer``: with no CLIP vocabulary files in the repository, the hash
tokenizer lets the whole stack run weight-free.
"""

from __future__ import annotations

import hashlib
from typing import List, Protocol


class Tokenizer(Protocol):
    bos_token_id: int
    eos_token_id: int
    pad_token_id: int
    model_max_length: int

    def encode(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens."""
        ...


class HashTokenizer:
    """One token per whitespace word, hashed into the CLIP vocab range. Not
    linguistically meaningful; for running without tokenizer data files."""

    def __init__(self, vocab_size: int = 49408, model_max_length: int = 77):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos_token_id = vocab_size - 2  # mirror CLIP's 49406
        self.eos_token_id = vocab_size - 1  # 49407
        self.pad_token_id = self.eos_token_id

    def encode(self, text: str) -> List[int]:
        out = []
        for word in text.lower().split():
            h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
            out.append(h % (self.vocab_size - 3) + 1)
        return out
