"""Tokenizer protocol, the deterministic hash tokenizer and the CLIP BPE one.

A copy of ``musev_tpu/utils/tokenizer.py``: ``HFCLIPTokenizer`` wraps
transformers' ``CLIPTokenizer`` over local vocabulary files (transformers is
imported only when a path is given); with no such files in the repository,
the hash tokenizer lets the whole stack run weight-free.
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Protocol


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


class HFCLIPTokenizer:
    """Wraps transformers.CLIPTokenizer loaded from a local path."""

    def __init__(self, path: str):
        from transformers import CLIPTokenizer

        self._tok = CLIPTokenizer.from_pretrained(path)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self.eos_token_id
        self.model_max_length = self._tok.model_max_length

    def encode(self, text: str) -> List[int]:
        return self._tok(text).input_ids[1:-1]


def get_tokenizer(path: Optional[str] = None, vocab_size: int = 49408) -> Tokenizer:
    """Real CLIP tokenizer from ``path``, or the hash fallback over
    ``vocab_size`` ids when no path is given. A given path that fails to
    load raises: a mistyped tokenizer path must not silently hash-tokenize."""
    if path is not None:
        try:
            return HFCLIPTokenizer(path)
        except Exception as e:
            raise ValueError(
                f"tokenizer path {path!r} failed to load: {e}. Omit the path "
                "to use the hash fallback tokenizer."
            ) from e
    return HashTokenizer(vocab_size=vocab_size)
