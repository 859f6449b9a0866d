"""Attribute-to-prompt templating + task fan-out.

A copy of ``musev_tpu/autoprompt/templates.py`` (pure Python).

Redesigned from musev/auto_prompt/ (PortraitAttr2PromptTemplate human.py:10-40;
MultiAttr2PromptTemplate / KeywordMultiAttr2PromptTemplate attr2template.py;
task fan-out auto_prompt/util.py called at text2video.py:829). The attribute
zoo itself lives in ``attributes.py``; this module picks the template form
per task and expands '|' alternatives into separate tasks.

Template forms (attr2template.py module doc):
  * plain text (no braces)       -> the prompt verbatim
  * ``{key}`` braces             -> keys rendered via the attribute registry
  * a single bare ``{}``         -> preset portrait attribute ordering
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

from .attributes import (  # noqa: F401  (re-exported surface)
    PORTRAIT_ATTRS,
    REGISTRY,
    get_attr,
    has_key_brace,
    register_attr,
    render_template,
)


class PortraitTemplate:
    """``a portrait of {}`` with the reference's preset attribute order."""

    name = "portrait"
    template = "a portrait of {}"

    def __call__(self, task: Dict) -> List[str]:
        template = task.get("template") or self.template
        if task.get("prompt") and "{" in task["prompt"]:
            template = task["prompt"]
        return render_template(template, task)


_TEMPLATES = {"portrait": PortraitTemplate()}


def get_template(name: Optional[str]) -> PortraitTemplate:
    return _TEMPLATES.get(name or "portrait", _TEMPLATES["portrait"])


def generate_prompts(tasks: List[Dict]) -> List[Dict]:
    """Expand templated tasks into concrete-prompt tasks
    (auto_prompt/util.py semantics: plain non-empty prompts pass through)."""
    out = []
    for task in tasks:
        task = dict(task)
        task["origin_prompt"] = task.get("prompt", "")
        prompt = task.get("prompt", "")
        if prompt and "{" not in prompt:
            out.append(task)
            continue
        if not prompt:
            # empty prompt -> empty prompt (OnlySpacePromptTemplate,
            # load_template.py:25-26)
            task["prompt"] = ""
            out.append(task)
            continue
        template = get_template(task.get("template_name"))
        for p in template(task):
            t = copy.deepcopy(task)
            t["prompt"] = p
            out.append(t)
    return out
