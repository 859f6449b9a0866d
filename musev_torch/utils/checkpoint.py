"""Save and restore training state (counterpart of ``musev_tpu/utils/checkpoint.py``).

The JAX package snapshots param pytrees with orbax (``save_pytree`` :17,
``restore_pytree`` :26). Here the state is a nested tree of dicts, lists and
tuples whose leaves are tensors or plain values (an ``nn.Module``'s
``state_dict``, a ``torch.optim`` state dict with its step counts,
``exp_avg`` and ``exp_avg_sq``), written as one ``.safetensors`` file: the
tensors in the safetensors layout, the tree's structure (with every
non-tensor leaf and every dict key, ints included) as JSON in the header's
``__metadata__``. ``restore_state`` reads it back through the port's own
memory-mapped reader (``models.sd_weights.load_safetensors``); no
``safetensors`` package is needed on either side.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from ..models.sd_weights import load_safetensors

SAFETENSORS_DTYPES = {
    torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
    torch.int64: "I64", torch.int32: "I32", torch.uint8: "U8", torch.bool: "BOOL",
}
TREE_KEY = "musev_torch.tree"  # the __metadata__ entry holding the structure


def write_safetensors(path, state_dict: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """The safetensors format, written tensor by tensor: a little-endian u64
    header size, a JSON header of each tensor's dtype, shape and byte range
    (and ``__metadata__``, str to str, where given), padded with spaces to 8
    bytes, then each tensor's bytes in row-major order, whatever its device
    or memory format."""
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in state_dict.items():
        if t.dtype not in SAFETENSORS_DTYPES:
            raise TypeError(f"write_safetensors: tensor {name!r} has unsupported dtype {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = dict(dtype=SAFETENSORS_DTYPES[t.dtype], shape=list(t.shape),
                            data_offsets=[offset, offset + nbytes])
        offset += nbytes
    blob = json.dumps(header).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in state_dict.values():
            f.write(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy())


def safetensors_metadata(path) -> Dict[str, str]:
    """The ``__metadata__`` of a ``.safetensors`` file's header ({} if none)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n)).get("__metadata__", {})


def _flatten(node, path: str, tensors: Dict[str, torch.Tensor]):
    """The JSON structure of ``node``; its tensors go into ``tensors``."""
    if isinstance(node, torch.Tensor):
        if path in tensors:
            raise ValueError(f"save_state: two tensors at the path {path!r}")
        tensors[path] = node
        return {"tensor": path}
    if isinstance(node, dict):
        for key in node:
            if not isinstance(key, (str, int)) or isinstance(key, bool):
                raise TypeError(f"save_state: key {key!r} at {path!r} is not a str or int")
        return {"dict": [[k, _flatten(v, f"{path}.{k}" if path else str(k), tensors)]
                         for k, v in node.items()]}
    if isinstance(node, (list, tuple)):
        items = [_flatten(v, f"{path}.{i}" if path else str(i), tensors)
                 for i, v in enumerate(node)]
        return {"tuple" if isinstance(node, tuple) else "list": items}
    if node is None or isinstance(node, (bool, int, float, str)):
        return {"value": node}
    raise TypeError(f"save_state: leaf {type(node).__name__} at {path!r} is not a tensor, "
                    "number, string, bool or None")


def _unflatten(spec, tensors: Dict[str, torch.Tensor]):
    (kind, body), = spec.items()
    if kind == "tensor":
        return tensors[body]
    if kind == "dict":
        return {k: _unflatten(v, tensors) for k, v in body}
    if kind in ("list", "tuple"):
        items = [_unflatten(v, tensors) for v in body]
        return tuple(items) if kind == "tuple" else items
    return body


def save_state(path, tree) -> None:
    """Write ``tree`` (nested dicts with str or int keys, lists and tuples;
    tensors of the ``SAFETENSORS_DTYPES`` and numbers, strings, bools and
    None as leaves) to the ``.safetensors`` file ``path``."""
    tensors: Dict[str, torch.Tensor] = {}
    structure = _flatten(tree, "", tensors)
    write_safetensors(Path(path), tensors, {TREE_KEY: json.dumps(structure)})


def restore_state(path):
    """The tree ``save_state`` wrote to ``path``: its tensors are CPU views
    of the memory-mapped file (copy-on-write), bit for bit what was saved;
    ``load_state_dict`` of a module or optimizer copies them where they
    belong."""
    meta = safetensors_metadata(path)
    if TREE_KEY not in meta:
        raise ValueError(f"{path}: no {TREE_KEY!r} in the header's __metadata__: not written "
                         "by save_state")
    return _unflatten(json.loads(meta[TREE_KEY]), load_safetensors(str(path)))
