"""Textual-inversion embeddings (counterpart of ``musev_tpu/utils/textual_inversion.py``).

Reference: DiffusersPipelinePredictor loads four negative textual-inversion
embeddings (easynegative, badhandv4, ng_deepnegative_v1_75t,
bad_prompt_version2-neg) at pipeline_controlnet_predictor.py:248-254. A
learned embedding maps a trigger word to one or more new token vectors,
appended to the CLIP token-embedding table; ``InversionTokenizer`` maps the
trigger to the appended ids.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import torch
from torch import nn


class InversionTokenizer:
    """Wraps a tokenizer, mapping registered trigger words to appended ids."""

    def __init__(self, base):
        self._base = base
        self._triggers: Dict[str, List[int]] = {}
        self.bos_token_id = base.bos_token_id
        self.eos_token_id = base.eos_token_id
        self.pad_token_id = base.pad_token_id
        self.model_max_length = base.model_max_length
        self.vocab_size = getattr(base, "vocab_size", None)

    def register(self, trigger: str, n_vectors: int, first_id: int) -> List[int]:
        ids = list(range(first_id, first_id + n_vectors))
        self._triggers[trigger.lower()] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        """Ids without special tokens; with triggers registered, word by word
        (commas split off), a trigger word giving its appended ids."""
        if not self._triggers:
            return self._base.encode(text)
        out: List[int] = []
        for word in text.replace(",", " , ").split():
            ids = self._triggers.get(word.lower())
            out.extend(ids if ids is not None else self._base.encode(word))
        return out


def load_inversion_state_dict(sd: Mapping[str, object]) -> torch.Tensor:
    """The (n_vectors, dim) embedding of the common file layouts:
    {'emb_params': ...} (safetensors), {'string_to_param': {'*': ...}} (A1111
    .pt), or a single-tensor dict."""
    if "emb_params" in sd:
        emb = sd["emb_params"]
    elif "string_to_param" in sd:
        emb = list(sd["string_to_param"].values())[0]
    else:
        emb = list(sd.values())[0]
    emb = torch.as_tensor(emb)
    return emb[None] if emb.ndim == 1 else emb


@torch.no_grad()
def add_textual_inversion(text_encoder: nn.Module, tokenizer: InversionTokenizer,
                          trigger: str, embedding) -> None:
    """Append the embedding's rows to the text encoder's token table (a new,
    larger ``nn.Embedding`` on the table's device and dtype) and register
    the trigger to their ids."""
    embeddings = text_encoder.text_model.embeddings
    table = embeddings.token_embedding.weight
    emb = torch.as_tensor(embedding).to(device=table.device, dtype=table.dtype)
    if emb.shape[-1] != table.shape[-1]:
        raise ValueError(f"inversion dim {emb.shape[-1]} != text hidden {table.shape[-1]}")
    first_id = table.shape[0]
    grown = nn.Embedding(first_id + emb.shape[0], table.shape[1], device=table.device,
                         dtype=table.dtype)
    grown.weight.copy_(torch.cat([table, emb]))
    grown.requires_grad_(table.requires_grad)
    embeddings.token_embedding = grown
    tokenizer.register(trigger, emb.shape[0], first_id)
