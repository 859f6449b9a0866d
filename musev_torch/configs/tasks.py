"""Task-spec loading: YAML (with ``${.key}`` interpolation) and CSV.

A copy of ``musev_tpu/configs/tasks.py``, except that ``yaml`` is imported
only when a YAML file is read: CSV tasks need only the standard library.
Only OmegaConf-style ``${.key}`` interpolation is resolved at load time;
bare ``{key}`` braces are left alone for the auto-prompt attribute registry
(``autoprompt``), which renders them later.
"""

from __future__ import annotations

import csv
import re
from typing import Any, Dict, List

_REF = re.compile(r"\$\{\.?([A-Za-z0-9_]+)\}")


def _resolve(task: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(task)
    for _ in range(4):  # few passes handle chained refs
        changed = False
        for k, v in out.items():
            if not isinstance(v, str):
                continue

            def sub_ref(m):
                key = m.group(1)
                return str(out.get(key, m.group(0)))

            nv = _REF.sub(sub_ref, v)
            if nv != v:
                out[k] = nv
                changed = True
        if not changed:
            break
    return out


def load_tasks_yaml(path: str) -> List[Dict[str, Any]]:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    if isinstance(data, dict):
        data = [data]
    return [_resolve(t) for t in data]


def load_tasks_csv(path: str) -> List[Dict[str, Any]]:
    with open(path, newline="") as f:
        return [_resolve(dict(row)) for row in csv.DictReader(f)]


def load_tasks(path: str) -> List[Dict[str, Any]]:
    if path.endswith((".yaml", ".yml")):
        return load_tasks_yaml(path)
    if path.endswith(".csv"):
        return load_tasks_csv(path)
    raise ValueError(f"unsupported task file {path!r} (yaml/csv)")
