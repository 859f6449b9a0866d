"""The auto-prompt attribute zoo: attribute value -> prompt text renderers.

A copy of ``musev_tpu/autoprompt/attributes.py`` (pure Python).

Functional redesign of musev/auto_prompt/attributes/ (attributes.py,
human.py, style.py, render.py): each attribute is a pure function
``value -> text`` in a name-keyed registry; preset combos and key-brace
templates build on top. Covers the reference's full attribute surface:
value-is-text attrs, "{value} {name}" attrs, the Age/-year-old form, the
Render preset map, the InsightFace detection-json renderer, and the
random-choice spring/festival attrs (seeded RNG injectable for tests).
"""

from __future__ import annotations

import json
import random
import re
from typing import Callable, Dict, List, Optional, Sequence

AttrFn = Callable[[str], str]

REGISTRY: Dict[str, AttrFn] = {}


def register_attr(name: str, fn: Optional[AttrFn] = None):
    if fn is not None:
        REGISTRY[name] = fn
        return fn

    def deco(f: AttrFn) -> AttrFn:
        REGISTRY[name] = f
        return f

    return deco


def get_attr(name: str) -> AttrFn:
    """Registered renderer, or value-is-text for unknown names (the
    reference falls back to AttriributeIsText, attr2template.py:105-110)."""
    return REGISTRY.get(name, value_is_text)


def value_is_text(value: str) -> str:
    """'a,b' -> 'a, b' (AttriributeIsText)."""
    if not value:
        return ""
    return ", ".join(v.strip() for v in str(value).split(",") if v.strip())


def value_and_name(name: str) -> AttrFn:
    """'black' w/ name 'hair' -> 'black hair' (AttributeIsTextAndName)."""

    def fn(value: str) -> str:
        if not value:
            return ""
        return ", ".join(
            f"{v.strip()} {name}" for v in str(value).split(",") if v.strip()
        )

    return fn


# -- the preset attribute set (human.py __all__) --------------------------------

_IS_TEXT = [
    "sex", "gender", "singing", "country", "headwear", "expression",
    "keywords", "clothes", "beard", "style", "caption", "race",
    "prompt_extra",
]
_IS_TEXT_AND_NAME = [
    "eyes", "hair", "background", "skin", "face", "smile", "nose",
    "mouth", "necklace", "irises", "lighting",
]
for _n in _IS_TEXT:
    register_attr(_n, value_is_text)
for _n in _IS_TEXT_AND_NAME:
    register_attr(_n, value_and_name(_n))


@register_attr("age")
def age(value: str) -> str:
    """'25' -> '25-year-old' (human.py Age)."""
    if value is None or value == "":
        return ""
    return ", ".join(
        f"{v.strip()}-year-old" for v in str(value).split(",") if v.strip()
    )


RENDER_MAP = {
    "Epic": "artstation, epic environment, highly detailed, 8k, HD",
    "HD": "8k, highly detailed",
    "EpicHD": (
        "hyper detailed, beautiful lighting, epic environment, octane "
        "render, cinematic, 8k"
    ),
    "Digital": (
        "detailed illustration, crisp lines, digital art, 8k, trending on "
        "artstation"
    ),
    "Unreal1": (
        "artstation, concept art, smooth, sharp focus, illustration, "
        "unreal engine 5, 8k"
    ),
    "Unreal2": (
        "concept art, octane render, artstation, epic environment, highly "
        "detailed, 8k"
    ),
}


@register_attr("render")
def render(value: str):
    """Named render-quality presets (render.py RenderMap).

    Multiple presets return a LIST: the reference's MultiAttr2Text fans a
    multi-text attribute into one prompt per text by outer product
    (attributes.py:100-116); render_template implements the same."""
    if not value:
        return ""
    parts = [RENDER_MAP[v.strip()] for v in str(value).split(",")
             if v.strip() in RENDER_MAP]
    if not parts:
        return ""
    if len(parts) == 1:
        return parts[0]
    return parts


def _random_choice_attr(name: str, choices: Sequence[str]) -> AttrFn:
    """Festival-style attrs: explicit value passes through, empty draws a
    random preset (human.py Env/Decoration/Festival/Spring*/Animal)."""

    def fn(value: str) -> str:
        if value not in ("", " ", None):
            return value
        return RNG.choice(list(choices))

    return register_attr(name, fn)


RNG = random.Random()  # seedable for deterministic tests

_random_choice_attr("env", [
    "east asian architecture", "fireworks", "snow, snowflakes",
    "snowing, snowflakes",
])
_random_choice_attr("decoration", [
    "chinese knot", "flowers", "food", "lanterns", "red envelop",
])
_random_choice_attr("festival", ["new year"])
_random_choice_attr("spring_headwear", ["rabbit ears", "rabbit ears, fur hat"])
_random_choice_attr("spring_clothes", [
    "mittens,chinese clothes", "mittens,fur trim", "mittens,red scarf",
    "mittens,winter clothes",
])
_random_choice_attr("animal", ["rabbit", "holding rabbits"])


@register_attr("insight_face")
def insight_face(value: str) -> str:
    """InsightFace detection json -> portrait prompt fragment
    (human.py InsightFace.__call__ semantics)."""
    data = json.loads(value)
    faces = data.get("info", [])
    if not faces:
        return ""
    if data.get("image_type") == "body":
        for f in faces:
            if f.get("black"):
                return "african,dark skin"
        return ""
    face_render = {"girl": "gorgeous,kawaii,colorful", "boy": "handsome,elegant"}
    counts = {"girl": 0, "boy": 0}
    renders: List[str] = []
    black = False
    for f in faces:
        if f.get("ratio", 1.0) < 0.02:
            continue
        kind = "girl" if f.get("gender") == 0 else "boy"
        counts[kind] += 1
        renders.append(face_render[kind])
        black = black or bool(f.get("black"))
    if not renders:
        return ""
    gender = ", ".join(
        f"{n}{g}" + ("s" if n > 1 else "")
        for g, n in counts.items()
        if n > 0
    )
    toks = ",".join(renders).split(",")
    dedup = sorted(set(toks), key=toks.index)
    face_txt = ",".join(dedup)
    if counts["girl"] == 0:
        face_txt = "male focus," + face_txt
    prompt = f"{gender},{face_txt},delicate face,beautiful eyes"
    if len(renders) == 1:
        prompt += ",solo"
    if black:
        prompt = "african,dark skin," + prompt
    return prompt


# The reference's preset portrait attribute order (human.py
# PresetPortraitAttributes); "a portrait of {}" joins these in order.
PORTRAIT_ATTRS = [
    "age", "sex", "gender", "race", "singing", "country", "lighting",
    "headwear", "eyes", "irises", "hair", "skin", "face", "smile",
    "expression", "clothes", "nose", "mouth", "beard", "necklace",
    "background", "style", "keywords", "prompt_extra", "render",
]

_KEY_BRACE = re.compile(r"\{([a-zA-Z_][a-zA-Z0-9_]*)\}")


def has_key_brace(template: str) -> bool:
    return bool(_KEY_BRACE.search(template))


def key_brace_words(template: str) -> List[str]:
    return _KEY_BRACE.findall(template)


def merge_near_same_char(text: str, char: str = ",") -> str:
    """', ,, x' -> ', x' (mmcm merge_near_same_char contract)."""
    out = re.sub(rf"(\s*{re.escape(char)}\s*)+", f"{char} ", text)
    return out.strip().strip(char).strip()


def expand_alternatives(task: Dict, keys: Sequence[str]) -> List[Dict]:
    """'|'-separated values fan one task into the cartesian product
    (MultiAttr2Text fan-out)."""
    variants: List[Dict] = [dict(task)]
    for key in keys:
        raw = task.get(key)
        if raw is None or "|" not in str(raw):
            continue
        options = [o.strip() for o in str(raw).split("|")]
        variants = [{**v, key: opt} for v in variants for opt in options]
    return variants


def render_template(template: str, task: Dict) -> List[str]:
    """The three reference template forms (attr2template.py module doc):
      1. no '{}' at all -> the template IS the prompt
      2. '{key}' braces -> each key rendered by its registered attribute
      3. a single bare '{}' -> PORTRAIT_ATTRS joined in preset order
    """
    if "{" not in template:
        return [template] if template.strip() else [""]
    if has_key_brace(template):
        keys = key_brace_words(template)
        out = []
        for variant in expand_alternatives(task, keys):
            vals = {
                k: get_attr(k)(str(variant.get(k, "") or "")) for k in keys
            }
            for combo in _expand_multi_text(vals):
                out.append(merge_near_same_char(template.format(**combo)))
        return out
    # bare {}: preset portrait ordering
    out = []
    for variant in expand_alternatives(task, PORTRAIT_ATTRS):
        vals = {
            k: get_attr(k)(str(variant[k]))
            for k in PORTRAIT_ATTRS
            if variant.get(k) not in (None, "")
        }
        for combo in _expand_multi_text(vals):
            body = ", ".join(
                combo[k] for k in PORTRAIT_ATTRS if combo.get(k)
            )
            out.append(merge_near_same_char(template.format(body)))
    return out


def _expand_multi_text(vals: Dict) -> List[Dict]:
    """Outer-product expansion when an attribute rendered a LIST of texts
    (reference MultiAttr2Text.__call__, attributes.py:100-116 — e.g. render
    'Epic,HD' yields one prompt per render preset)."""
    combos: List[Dict] = [{}]
    for k, v in vals.items():
        opts = v if isinstance(v, list) else [v]
        combos = [{**c, k: o} for c in combos for o in opts]
    return combos
