"""A1111-style weighted prompt encoding (counterpart of ``musev_tpu/utils/text_emb.py``).

Reference: musev/utils/text_emb_util.py (the diffusers lpw_stable_diffusion
pipeline): ``(word:1.3)`` raises attention, ``[word]`` lowers it; token
embeddings are scaled by their weight and the whole embedding rescaled to
keep its mean; long prompts run in 77-token chunks whose embeddings are
concatenated.
"""

from __future__ import annotations

import re
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .tokenizer import Tokenizer

_RE_ATTENTION = re.compile(
    r"""
    \\\(|\\\)|\\\[|\\]|\\\\|\\|\(|\[|:([+-]?[.\d]+)\)|\)|]|[^\\()\[\]:]+|:
    """,
    re.X,
)


def parse_prompt_attention(text: str) -> List[List]:
    """Split a prompt into (text, weight) runs (text_emb_util.py:32-115)."""
    res: List[List] = []
    round_brackets: List[int] = []
    square_brackets: List[int] = []
    round_mult = 1.1
    square_mult = 1 / 1.1

    def multiply_range(start: int, mult: float):
        for p in range(start, len(res)):
            res[p][1] *= mult

    for m in _RE_ATTENTION.finditer(text):
        tok = m.group(0)
        weight = m.group(1)
        if tok.startswith("\\"):
            res.append([tok[1:], 1.0])
        elif tok == "(":
            round_brackets.append(len(res))
        elif tok == "[":
            square_brackets.append(len(res))
        elif weight is not None and round_brackets:
            multiply_range(round_brackets.pop(), float(weight))
        elif tok == ")" and round_brackets:
            multiply_range(round_brackets.pop(), round_mult)
        elif tok == "]" and square_brackets:
            multiply_range(square_brackets.pop(), square_mult)
        else:
            res.append([tok, 1.0])
    for pos in round_brackets:
        multiply_range(pos, round_mult)
    for pos in square_brackets:
        multiply_range(pos, square_mult)
    if not res:
        res = [["", 1.0]]
    i = 0
    while i + 1 < len(res):
        if res[i][1] == res[i + 1][1]:
            res[i][0] += res[i + 1][0]
            res.pop(i + 1)
        else:
            i += 1
    return res


def _tokens_with_weights(
    tokenizer: Tokenizer, text: str, max_length: int
) -> Tuple[List[int], List[float]]:
    tokens: List[int] = []
    weights: List[float] = []
    for word, weight in parse_prompt_attention(text):
        ids = tokenizer.encode(word)
        tokens += ids
        weights += [weight] * len(ids)
        if len(tokens) > max_length:
            break
    return tokens[:max_length], weights[:max_length]


def _pad(tokens, weights, max_length, bos, eos, pad):
    tokens = [bos] + tokens + [pad] * (max_length - 2 - len(tokens)) + [eos]
    weights = [1.0] + weights + [1.0] * (max_length - 1 - len(weights))
    return tokens, weights


def encode_weighted_prompt(
    tokenizer: Tokenizer,
    text_encode_fn: Callable[[np.ndarray], torch.Tensor],
    prompts: Sequence[str],
    max_embeddings_multiples: int = 3,
) -> torch.Tensor:
    """Encode prompts -> (B, S, D) weighted embeddings.

    ``text_encode_fn`` maps (B, chunk_len) int64 ids to (B, chunk_len, D).
    Long prompts are chunked with bos/eos re-wrapped per chunk and the
    interior bos/eos embeddings dropped (text_emb_util.py:178-215).
    """
    chunk = tokenizer.model_max_length
    cap = (chunk - 2) * max_embeddings_multiples
    toks, wts = zip(*[_tokens_with_weights(tokenizer, p, cap) for p in prompts])
    longest = max(len(t) for t in toks)
    multiples = max(1, min(max_embeddings_multiples, (longest - 1) // (chunk - 2) + 1))
    max_length = (chunk - 2) * multiples + 2
    bos, eos, pad = tokenizer.bos_token_id, tokenizer.eos_token_id, tokenizer.pad_token_id
    padded = [_pad(list(t), list(w), max_length, bos, eos, pad) for t, w in zip(toks, wts)]
    ids = np.asarray([p[0] for p in padded], dtype=np.int64)
    weights = np.asarray([p[1] for p in padded], dtype=np.float32)

    if multiples == 1:
        emb = text_encode_fn(ids)
    else:
        pieces = []
        for i in range(multiples):
            sl = ids[:, i * (chunk - 2): (i + 1) * (chunk - 2) + 2].copy()
            sl[:, 0] = ids[0, 0]
            sl[:, -1] = ids[0, -1]
            e = text_encode_fn(sl)
            if i == 0:
                e = e[:, :-1]
            elif i == multiples - 1:
                e = e[:, 1:]
            else:
                e = e[:, 1:-1]
            pieces.append(e)
        emb = torch.cat(pieces, dim=1)

    w = torch.as_tensor(weights, device=emb.device)
    prev_mean = emb.float().mean(dim=(-2, -1))
    emb = emb * w[..., None].to(emb.dtype)
    cur_mean = emb.float().mean(dim=(-2, -1))
    # near-zero means (random-weight models) skip the rescale
    ratio = torch.where(cur_mean.abs() > 1e-6, prev_mean / cur_mean, torch.ones_like(cur_mean))
    return emb * ratio[:, None, None].to(emb.dtype)
