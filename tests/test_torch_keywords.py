"""The port's pipelines take every keyword of the JAX pipelines.

The JAX signatures are read from ``musev_tpu/pipelines/pipeline.py`` with
``ast`` (nothing of JAX is imported or compiled): each keyword that the
port's signature lacks must be in its table of not-ported options with the
JAX default, and pass at that default. A value that needs a branch not yet
ported raises ``NotImplementedError``; a value that the JAX pipeline ignores
because its branch is off passes.
"""

import ast
import inspect
from pathlib import Path

import numpy as np
import pytest

from musev_torch.pipelines.pipeline import (
    _NOT_PORTED,
    _NOT_PORTED_V2V,
    MusevPipeline,
    _reject_unported,
)

JAX_PIPELINE = Path(__file__).resolve().parents[1] / "musev_tpu" / "pipelines" / "pipeline.py"
TABLES = {"text2video": _NOT_PORTED, "video2video": _NOT_PORTED_V2V}


def _jax_defaults(method: str) -> dict:
    """Every keyword of the JAX ``MusevPipeline.<method>`` with a default."""
    tree = ast.parse(JAX_PIPELINE.read_text())
    cls = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "MusevPipeline")
    fn = next(n for n in cls.body if isinstance(n, ast.FunctionDef) and n.name == method)
    a = fn.args
    named = list(zip(a.args[len(a.args) - len(a.defaults):], a.defaults))
    named += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults) if d is not None]
    return {arg.arg: ast.literal_eval(d) for arg, d in named}


@pytest.mark.parametrize("method", sorted(TABLES))
def test_jax_keywords_pass_at_their_defaults(method):
    jax_kw = _jax_defaults(method)
    port = set(inspect.signature(getattr(MusevPipeline, method)).parameters)
    missing = {name: value for name, value in jax_kw.items() if name not in port}
    assert missing, "the JAX signature was not read"
    table = TABLES[method]
    for name, value in missing.items():
        assert name in table and table[name] == value, (name, value, table.get(name))
        _reject_unported(method, {name: value}, table)  # raises nothing
    _reject_unported(method, missing, table)


@pytest.mark.parametrize("kw,raises", [
    # read only under a branch that is off: any value passes
    (dict(redraw_strength=0.3), None),
    (dict(controlnet_conditioning_scale=0.5), None),
    (dict(ip_adapter_face_scale=0.2), None),
    (dict(video_overlap=3), None),
    # the branch itself, or a value under it, needs code not yet ported
    (dict(redraw_condition_image=True, redraw_strength=0.3), NotImplementedError),
    (dict(control_images=np.zeros((1, 13, 32, 32, 3)), controlnet_conditioning_scale=0.5),
     NotImplementedError),
    (dict(face_emb=np.zeros((1, 512)), ip_adapter_face_scale=0.2), NotImplementedError),
    (dict(record_mid_video=True, video_overlap=3), NotImplementedError),
    (dict(guidance_rescale=0.7), NotImplementedError),
    (dict(no_such_option=1), TypeError),
])
def test_text2video_keywords_under_their_branches(kw, raises):
    if raises is None:
        _reject_unported("text2video", kw, _NOT_PORTED)
    else:
        with pytest.raises(raises):
            _reject_unported("text2video", kw, _NOT_PORTED)
