"""The port's temporal-rows pivots (K5, K6, K7) against the JAX package.

The plain versions of ``pivot_rows`` / ``unpivot_rows`` are held against
``jnp.swapaxes`` and against the TPU kernel bodies of
``scripts/bench_fused_transpose.py`` (``_t_kernel``, ``_t_gn_kernel``,
``_inv_kernel``) run through ``pl.pallas_call(..., interpret=True)`` with the
script's grid and block specs, at an HW that is a multiple of the block. The
kernel bodies are read from the script's source: importing the script would
reset the JAX compilation cache of the whole test process. The port's
``TemporalTransformer``, which pivots through them, is held against JAX
``temporal_transformer``. Inputs come from a seeded numpy RNG; float32 on the
CPU. Tolerances: a relayout is exact; the GN-apply affine is one float32
multiply and add, which one side may fuse into one rounding, so it may differ
by one ulp of the output type (float32 or bf16) at the larger of |y| and
|x * scale| (the product's rounding shows in full where the add cancels); a
temporal transformer 1e-5 (float32 rounding in another summation order).
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from musev_tpu.models import unet_blocks as jblk
from musev_torch.models import sd_weights
from musev_torch.models.unet_blocks import TemporalTransformer
from musev_torch.ops.kernels.pivot import (
    pivot_rows,
    pivot_rows_plain,
    unpivot_rows,
    unpivot_rows_plain,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "bench_fused_transpose.py"
MODULE_TOL = dict(rtol=1e-5, atol=1e-5)
B, T, HW, C, BN = 2, 3, 16, 8, 8  # HW a multiple of the block BN


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _script_kernels():
    """The script's three kernel bodies, compiled from its source alone."""
    tree = ast.parse(SCRIPT.read_text())
    names = ("_t_kernel", "_t_gn_kernel", "_inv_kernel")
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return [ns[n] for n in names]


def _pallas(kind, x, scale=None, shift=None):
    """The script's pallas_call for ``kind``, in interpret mode."""
    t_kernel, t_gn_kernel, inv_kernel = _script_kernels()
    b = x.shape[0]
    if kind == "inv":
        _, hw, t, c = x.shape
        kernel, args = inv_kernel, (x,)
        in_specs = [pl.BlockSpec((1, BN, t, c), lambda i, j: (i, j, 0, 0))]
        out_spec = pl.BlockSpec((1, t, BN, c), lambda i, j: (i, 0, j, 0))
        out_shape = (b, t, hw, c)
    else:
        _, t, hw, c = x.shape
        in_specs = [pl.BlockSpec((1, t, BN, c), lambda i, j: (i, 0, j, 0))]
        kernel, args = t_kernel, (x,)
        if kind == "gn":
            kernel, args = t_gn_kernel, (x, scale, shift)
            in_specs += [pl.BlockSpec((1, t, c), lambda i, j: (i, 0, 0))] * 2
        out_spec = pl.BlockSpec((1, BN, t, c), lambda i, j: (i, j, 0, 0))
        out_shape = (b, hw, t, c)
    return np.asarray(pl.pallas_call(
        kernel, grid=(b, hw // BN), in_specs=in_specs, out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, x.dtype), interpret=True,
    )(*args))


def _inputs(dtype):
    x = torch.from_numpy(_rand(0, B, T, HW, C)).to(dtype)
    scale = torch.from_numpy(_rand(1, B, T, C))
    shift = torch.from_numpy(_rand(2, B, T, C))
    return x, scale, shift


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["pivot", "gn", "inv"])
def test_plain_pivots_match_swapaxes_and_the_tpu_kernels(kind, dtype):
    """The relayouts are exact; the GN apply is within one output ulp."""
    x, scale, shift = _inputs(dtype)
    if kind == "inv":
        x = x.reshape(B, HW, T, C)
        got = unpivot_rows(x)
        assert torch.equal(got, unpivot_rows_plain(x))
    else:
        args = (scale, shift) if kind == "gn" else ()
        got = pivot_rows(x, *args)
        assert torch.equal(got, pivot_rows_plain(x, *args))
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                else jnp.float32)
    if kind == "gn":
        want_swap = jnp.swapaxes(
            (xj.astype(jnp.float32) * scale.numpy()[:, :, None] + shift.numpy()[:, :, None])
            .astype(xj.dtype), 1, 2)
        want_kernel = _pallas(kind, xj, jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()))
    else:
        want_swap = jnp.swapaxes(xj, 1, 2)
        want_kernel = _pallas(kind, xj)
    got_np = got.float().numpy()
    for want in (np.asarray(want_swap, np.float32), want_kernel.astype(np.float32)):
        assert got_np.shape == want.shape
        if kind == "gn":
            mantissa = 7 if dtype == torch.bfloat16 else 23
            product = np.abs(x.float().numpy() * scale.numpy()[:, :, None]).swapaxes(1, 2)
            mag = np.maximum(np.maximum(np.abs(want), product), 1e-30)
            ulp = 2.0 ** (np.floor(np.log2(mag)) - mantissa)
            assert (np.abs(got_np - want) <= ulp).all()
        else:
            np.testing.assert_array_equal(got_np, want)


def test_pivots_check_their_arguments():
    x, scale, shift = _inputs(torch.float32)
    with pytest.raises(ValueError, match="together"):
        pivot_rows(x, scale)
    with pytest.raises(ValueError, match="float32"):
        pivot_rows(x, scale[:, :1], shift)
    with pytest.raises(ValueError):
        unpivot_rows(x[0])


def test_temporal_transformer_matches_jax():
    """GroupNorm over each video, the fused pivot to pixel-major rows, the
    temporal block, the inverse pivot and the residual (with a cond mask),
    on weights redrawn from the JAX init with temporal_weight 0.5, so the
    block's output shows."""
    c, heads, femb_dim, groups, frames = 16, 2, 24, 4, 5
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(np.shape(a), dtype=np.float32),
        jblk.init_temporal_transformer(jax.random.PRNGKey(0), c, heads, femb_dim),
    )
    jp["temporal_weight"] = np.asarray([0.5], np.float32)
    state = sd_weights.export_state_dict(sd_weights._temporal_attn_entries("tt", ()), jp)
    mod = TemporalTransformer(c, heads, femb_dim, groups)
    mod.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in state.items()}, strict=True)
    x, femb = _rand(4, 2 * frames, 3, 5, c), _rand(5, 2, frames, femb_dim)
    mask = np.asarray([0, 1, 1, 1, 1], np.float32)
    want = jblk.temporal_transformer(jp, jnp.asarray(x), jnp.asarray(femb), num_frames=frames,
                                     heads=heads, cond_mask=jnp.asarray(mask), groups=groups)
    with torch.no_grad():
        got = mod.eval()(torch.from_numpy(x), torch.from_numpy(femb), num_frames=frames,
                         cond_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODULE_TOL)
    assert np.abs(got.numpy() - x).max() > 100 * MODULE_TOL["atol"]
