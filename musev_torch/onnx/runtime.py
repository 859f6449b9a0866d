"""ONNX graph executor on PyTorch (counterpart of ``musev_tpu/onnx/runtime.py``).

The reference runs its host-stage networks (the dwpose detector and pose
model, the insightface detector and recognition nets, SAM) through
onnxruntime. Here each ONNX node becomes a PyTorch op on an explicit
device, run eagerly: ``OnnxModel(model, device=None)`` runs on CUDA unless
the caller names another device, and never falls back to the CPU.

The op set is the JAX executor's, lowering for lowering (about 90 ops:
convolutions, batch/instance/layer norm, activations, pooling, resize,
shape algebra, matmul/gemm, softmax, reductions, slicing/concat); an op
outside it raises ``NotImplementedError``. Static folding is kept exactly: a
value whose inputs are all numpy (initializers, constants, shapes) is
computed in numpy wherever the JAX executor computes it in numpy, so
Shape -> Gather -> Concat -> Reshape chains stay host constants; every
other value is a tensor on the model's device. Device values follow what
the JAX executor computes with 64-bit types off: float initializers and
feeds are float32 (a float16 one widens, where jnp keeps it); integer device
values stay int64 (the JAX executor's int32 gives the same results on the
index ranges a graph uses). Where jnp and torch differ, the JAX executor's
semantics are reproduced: ``Gather`` and ``GatherElements`` wrap negative
indices once and fill out-of-range ones (NaN for floats), integer ``Div``
floors only when both operands are static, and cubic ``Resize`` is
``jax.image.resize``'s bicubic (Keys a = -0.5, antialiased on downscale),
not ONNX's a = -0.75.

``run(feeds)`` takes and returns numpy arrays. Initializers are uploaded to
the device once, at first use, and kept.
"""

from __future__ import annotations

import functools
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .proto import TENSOR_DTYPES, Graph, Model, load_model

_STATIC = (np.ndarray, np.generic, int, float, bool)
_FLOAT = torch.float32  # every float device value: initializers, feeds, Python floats

# numpy -> torch dtypes of device values (float64 narrows as JAX's x64-off does)
_TORCH_DTYPES = {
    np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float32, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint16): torch.int32,
    np.dtype(np.uint32): torch.int64, np.dtype(np.uint64): torch.int64,
}


def _is_static(x) -> bool:
    return isinstance(x, _STATIC)


def _np(x):
    return np.asarray(x)


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _ndim(x) -> int:
    return len(_shape(x))


def _attr_str(attrs, name: str, default: str) -> str:
    v = attrs.get(name, default)
    return v.decode() if isinstance(v, bytes) else v


def _pair(v, rank: int):
    v = list(v)
    if len(v) == rank:
        return v
    return v * rank


def _conv_pads(attrs, spatial: int, x_shape, k_shape, strides, dilations):
    auto = _attr_str(attrs, "auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = attrs.get("pads", [0] * (2 * spatial))
        return [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if auto == "VALID":
        return [(0, 0)] * spatial
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial):
        in_dim = x_shape[2 + i]
        k = (k_shape[2 + i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        pad = max(0, (out_dim - 1) * strides[i] + k - in_dim)
        lo = pad // 2 if auto == "SAME_UPPER" else pad - pad // 2
        out.append((lo, pad - lo))
    return out


def _torch_pads(pads) -> List[int]:
    """[(lo, hi)] per leading-to-trailing axis -> F.pad's trailing-first list."""
    flat: List[int] = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return flat


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}
_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _op_conv(attrs, x, w, b=None):
    spatial = x.ndim - 2
    strides = [int(s) for s in _pair(attrs.get("strides", [1]), spatial)]
    dilations = [int(d) for d in _pair(attrs.get("dilations", [1]), spatial)]
    groups = int(attrs.get("group", 1))
    pads = _conv_pads(attrs, spatial, x.shape, w.shape, strides, dilations)
    if all(lo == hi for lo, hi in pads):
        padding = [lo for lo, _ in pads]
    else:
        x = F.pad(x, _torch_pads(pads))
        padding = [0] * spatial
    return _CONV[spatial](x, w, b, strides, padding, dilations, groups)


def _op_conv_transpose(attrs, x, w, b=None):
    spatial = x.ndim - 2
    strides = [int(s) for s in _pair(attrs.get("strides", [1]), spatial)]
    pads = attrs.get("pads", [0] * (2 * spatial))
    pads = [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if int(attrs.get("group", 1)) != 1:
        raise NotImplementedError("grouped ConvTranspose")
    # onnx W layout (C_in, C_out, k...): the full transposed convolution,
    # then each axis cropped by its (lo, hi) pads, as the JAX executor's
    # dilated convolution with kernel - 1 - pad padding computes
    y = _CONV_T[spatial](x, w, None, strides)
    crop = tuple([slice(None)] * 2 + [slice(lo, y.shape[2 + i] - hi)
                                      for i, (lo, hi) in enumerate(pads)])
    y = y[crop]
    if b is not None:
        y = y + b.reshape((1, -1) + (1,) * spatial)
    return y


def _pool(attrs, x, avg: bool):
    spatial = x.ndim - 2
    kshape = [int(k) for k in attrs["kernel_shape"]]
    strides = [int(s) for s in _pair(attrs.get("strides", [1] * spatial), spatial)]
    pads = attrs.get("pads", [0] * (2 * spatial))
    pads = [(int(pads[i]), int(pads[i + spatial])) for i in range(spatial)]
    if int(attrs.get("ceil_mode", 0)):
        new_pads = []
        for i in range(spatial):
            in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
            rem = (in_dim - kshape[i]) % strides[i]
            extra = (strides[i] - rem) % strides[i] if rem else 0
            new_pads.append((pads[i][0], pads[i][1] + extra))
        pads = new_pads
    # explicit padding with the reduction's identity, then a valid window
    flat = _torch_pads(pads)
    if not avg:
        xp = F.pad(x, flat, value=float("-inf")) if any(flat) else x
        return _MAX_POOL[spatial](xp, kshape, strides)
    pool = functools.partial(_AVG_POOL[spatial], kernel_size=kshape, stride=strides,
                             divisor_override=1) if spatial > 1 else None
    if pool is None:  # avg_pool1d has no divisor_override: sum = mean * k
        def pool(t):
            return F.avg_pool1d(t, kshape, strides) * kshape[0]
    y = pool(F.pad(x, flat) if any(flat) else x)
    if int(attrs.get("count_include_pad", 0)):
        return y / float(np.prod(kshape))
    ones = torch.ones((x.shape[0], 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
    counts = pool(F.pad(ones, flat) if any(flat) else ones)
    return y / counts


def _resize_coords(out_len, in_len, ctm, device):
    """ONNX output->input coordinate mapping per coordinate_transformation_mode."""
    xo = torch.arange(out_len, dtype=torch.float32, device=device)
    scale = out_len / in_len
    if ctm in ("half_pixel", "tf_half_pixel_for_nn"):
        return (xo + 0.5) / scale - 0.5
    if ctm == "pytorch_half_pixel":
        return (xo + 0.5) / scale - 0.5 if out_len > 1 else torch.zeros_like(xo)
    if ctm == "asymmetric":
        return xo / scale
    if ctm == "align_corners":
        if out_len == 1:
            return torch.zeros_like(xo)
        return xo * ((in_len - 1) / (out_len - 1))
    raise NotImplementedError(f"Resize coordinate_transformation_mode {ctm}")


def jax_bicubic_weights(in_len: int, out_len: int) -> np.ndarray:
    """(in_len, out_len) float32 weights of ``jax.image.resize(method=
    "bicubic")`` along one axis: Keys' cubic with a = -0.5 on half-pixel
    centres, the kernel widened by in/out on downscale (antialiasing),
    columns normalised, samples outside the input zeroed. ONNX's cubic
    (and ``F.interpolate``'s) use a = -0.75 without antialiasing; the JAX
    executor's ``Resize`` computes this one, so the port does too."""
    f32 = np.float32
    scale = f32(out_len / in_len)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_len, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) * inv_scale \
        - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_len, dtype=f32)[:, None]) / kernel_scale
    w = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    w = np.where(x >= 1.0, ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), w)
    w = np.where(x >= 2.0, f32(0.0), w).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_len - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _op_resize(attrs, x, *rest):
    # inputs (opset 11+): X, roi, scales, sizes ; (opset 10): X, scales
    roi = rest[0] if len(rest) > 0 else None
    scales = rest[1] if len(rest) > 1 else (rest[0] if rest else None)
    sizes = rest[2] if len(rest) > 2 else None
    del roi
    mode = _attr_str(attrs, "mode", "nearest")
    ctm = _attr_str(attrs, "coordinate_transformation_mode", "half_pixel")
    nearest_mode = _attr_str(attrs, "nearest_mode", "round_prefer_floor")
    if sizes is not None and np.size(sizes):
        out_shape = [int(s) for s in np.asarray(sizes)]
    else:
        sc = np.asarray(scales)
        out_shape = [int(np.floor(x.shape[i] * sc[i])) for i in range(x.ndim)]
    if mode == "cubic":
        if ctm not in ("half_pixel", "pytorch_half_pixel"):
            raise NotImplementedError(f"Resize cubic with ctm {ctm}")
        y = x if x.dtype.is_floating_point else x.float()
        for ax, out_len in enumerate(out_shape):
            if out_len == y.shape[ax]:
                continue
            w = torch.from_numpy(jax_bicubic_weights(y.shape[ax], out_len)).to(
                device=y.device, dtype=y.dtype)
            y = torch.tensordot(y, w, dims=([ax], [0])).movedim(-1, ax)
        return y
    if not (mode.startswith("nearest") or mode in ("linear", "bilinear")):
        raise NotImplementedError(f"Resize mode {mode}")
    # separable axis-by-axis gather honouring the exact onnx coordinate
    # conventions
    y = x
    for ax, out_len in enumerate(out_shape):
        in_len = y.shape[ax]
        if out_len == in_len:
            continue
        coords = _resize_coords(out_len, in_len, ctm, y.device)
        if mode.startswith("nearest"):
            if nearest_mode == "round_prefer_floor":
                idx = torch.ceil(coords - 0.5)
            elif nearest_mode == "round_prefer_ceil":
                idx = torch.floor(coords + 0.5)
            elif nearest_mode == "floor":
                idx = torch.floor(coords)
            elif nearest_mode == "ceil":
                idx = torch.ceil(coords)
            else:
                raise NotImplementedError(f"Resize nearest_mode {nearest_mode}")
            idx = idx.to(torch.int64).clamp(0, in_len - 1)
            y = y.index_select(ax, idx)
        else:
            lo = torch.floor(coords).to(torch.int64).clamp(0, in_len - 1)
            hi = (lo + 1).clamp(0, in_len - 1)
            w = (coords - lo.to(torch.float32)).clamp(0.0, 1.0)
            shape = [1] * y.ndim
            shape[ax] = out_len
            w = w.reshape(shape).to(y.dtype)
            y = y.index_select(ax, lo) * (1 - w) + y.index_select(ax, hi) * w
    return y


def _axes_tuple(axes, rank):
    return tuple(int(a) % rank for a in axes)


def _slice_bounds(starts, ends, axes, steps, shape):
    """The JAX executor's clamped (axis, start, end, step) per sliced axis."""
    out = []
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = ax % len(shape)
        # onnx clamps INT_MAX/MIN sentinels
        dim = shape[ax]
        if st > dim:
            st = dim
        if en > dim:
            en = dim
        if st < -dim:
            st = -dim
        if en < -(dim + 1):
            en = -(dim + 1) if sp < 0 else -dim
        out.append((ax, st, en, sp))
    return out


def _op_slice(node_attrs, data, starts=None, ends=None, axes=None, steps=None):
    if starts is None:  # opset 9 attribute form
        starts = node_attrs["starts"]
        ends = node_attrs["ends"]
        axes = node_attrs.get("axes")
    starts = [int(s) for s in np.asarray(starts).reshape(-1)]
    ends = [int(e) for e in np.asarray(ends).reshape(-1)]
    axes = (
        list(range(len(starts)))
        if axes is None
        else [int(a) for a in np.asarray(axes).reshape(-1)]
    )
    steps = (
        [1] * len(starts)
        if steps is None
        else [int(s) for s in np.asarray(steps).reshape(-1)]
    )
    bounds = _slice_bounds(starts, ends, axes, steps, _shape(data))
    if _is_static(data):
        slices = [slice(None)] * _ndim(data)
        for ax, st, en, sp in bounds:
            slices[ax] = slice(st, en, sp)
        return _np(data)[tuple(slices)]
    # torch slicing takes no negative step: those gather the indices
    # Python's slice semantics name
    for ax, st, en, sp in bounds:
        if sp > 0:
            data = data[(slice(None),) * ax + (slice(st, en, sp),)]
        else:
            idx = list(range(*slice(st, en, sp).indices(data.shape[ax])))
            data = data.index_select(ax, torch.tensor(idx, dtype=torch.int64,
                                                      device=data.device))
    return data


def _fill_value(dtype: torch.dtype):
    """jnp.take's fill for out-of-range indices."""
    if dtype.is_floating_point:
        return float("nan")
    if dtype == torch.bool:
        return True
    if dtype == torch.int64:  # the JAX executor's device integers are int32
        return torch.iinfo(torch.int32).min
    return torch.iinfo(dtype).min


def _take(x: torch.Tensor, idx: torch.Tensor, axis: int, along: bool) -> torch.Tensor:
    """``jnp.take`` (``along=False``) or ``jnp.take_along_axis`` with their
    default modes: negative indices wrap once, out-of-range ones fill."""
    dim = x.shape[axis]
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + dim, idx)
    valid = (idx >= 0) & (idx < dim)
    safe = idx.clamp(0, max(dim - 1, 0))
    if along:
        out = torch.gather(x, axis, safe)
        mask = valid
    else:
        out = x.index_select(axis, safe.reshape(-1))
        out = out.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])
        mask = valid.reshape((1,) * axis + idx.shape + (1,) * (x.ndim - axis - 1))
    if bool(valid.all()):
        return out
    return torch.where(mask, out, torch.full((), _fill_value(x.dtype), dtype=x.dtype,
                                             device=x.device))


def _pad_index(n: int, lo: int, hi: int, mode: str) -> np.ndarray:
    """Source indices of an axis of length n padded by (lo, hi) in
    jnp.pad's ``edge`` or ``reflect`` mode."""
    pos = np.arange(-lo, n + hi)
    if mode == "edge":
        return np.clip(pos, 0, n - 1)
    if n == 1:
        return np.zeros_like(pos)
    period = 2 * (n - 1)
    pos = np.mod(pos, period)
    return np.where(pos >= n, period - pos, pos)


class OnnxModel:
    """A parsed ONNX model run op by op in PyTorch on ``device`` (CUDA
    unless given; raises without it). ``run(feeds)`` takes and returns
    numpy arrays."""

    def __init__(self, model: Model, device=None):
        from ..pipelines.loader import resolve_device

        self.model = model
        self.graph: Graph = model.graph
        self.device = resolve_device(device)
        init_names = set(self.graph.initializers)
        self.input_names = [
            n for n, _ in self.graph.inputs if n not in init_names
        ]
        self.output_names = list(self.graph.outputs)
        # the graph's own arrays (initializers, Constant values): uploaded
        # once, at first use, by identity
        held = list(self.graph.initializers.values()) + [
            n.attrs["value"] for n in self.graph.nodes
            if n.op_type == "Constant" and isinstance(n.attrs.get("value"), np.ndarray)]
        self._held = {id(a) for a in held}
        self._uploaded: Dict[int, torch.Tensor] = {}

    @classmethod
    def from_file(cls, path: str, device=None) -> "OnnxModel":
        return cls(load_model(path), device=device)

    # -- values ------------------------------------------------------------------

    def _t(self, x):
        """A device tensor of ``x``; Python scalars stay scalars (weakly
        typed, as in jnp) and tensors pass through."""
        if isinstance(x, torch.Tensor) or isinstance(x, (bool, int, float)):
            return x
        key = id(x)
        if key in self._uploaded:
            return self._uploaded[key]
        a = np.asarray(x)
        dt = _FLOAT if a.dtype.kind == "f" else _TORCH_DTYPES[a.dtype]
        if a.dtype.kind == "u" and a.dtype != np.uint8:
            a = a.astype(np.int64)
        if not a.flags.writeable:  # parsed initializers view the file's bytes
            a = a.copy()
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device=self.device, dtype=dt)
        if key in self._held:
            self._uploaded[key] = t
        return t

    def _tt(self, x) -> torch.Tensor:
        """``_t`` that also makes Python scalars tensors."""
        x = self._t(x)
        if isinstance(x, torch.Tensor):
            return x
        dt = _FLOAT if isinstance(x, float) else (
            torch.bool if isinstance(x, bool) else torch.int64)
        return torch.tensor(x, dtype=dt, device=self.device)

    def _bin(self, fn, x, y):
        """``fn(x, y)`` in numpy when both are static (Python's operators
        on numpy, as the JAX executor's ``x + y`` on two numpy values), else
        on the device."""
        if _is_static(x) and _is_static(y):
            return fn(_np(x), _np(y))
        return fn(self._t(x), self._t(y))

    # -- execution -----------------------------------------------------------

    def _execute(self, feeds: Dict[str, object]) -> List[object]:
        env: Dict[str, object] = dict(self.graph.initializers)
        env[""] = None  # optional (omitted) inputs
        env.update(feeds)
        for node in self.graph.nodes:
            ins = [env[i] for i in node.inputs]
            outs = self._run_node(node.op_type, node.attrs, ins)
            if not isinstance(outs, (list, tuple)):
                outs = [outs]
            for name, val in zip(node.outputs, outs):
                if name:
                    env[name] = val
        return [env[o] for o in self.output_names]

    def run(self, feeds: Dict[str, np.ndarray]) -> List[np.ndarray]:
        with torch.inference_mode():
            out = self._execute({k: self._t(np.asarray(v)) for k, v in feeds.items()})
        return [o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o) for o in out]

    def __call__(self, **feeds):
        return self.run(feeds)

    # -- op lowering -----------------------------------------------------------

    def _run_node(self, op: str, attrs: Dict, ins: List):
        fn = getattr(self, f"_lower_{op}", None)
        if fn is None:
            raise NotImplementedError(
                f"ONNX op {op!r} not supported by musev_torch.onnx.runtime"
            )
        # constant folding of shape algebra happens inside each _lower_*
        # via _is_static checks (numpy in, numpy out)
        return fn(attrs, *ins)

    # elementwise ------------------------------------------------------------
    def _lower_Add(self, a, x, y):
        return self._bin(lambda p, q: p + q, x, y)

    def _lower_Sub(self, a, x, y):
        return self._bin(lambda p, q: p - q, x, y)

    def _lower_Mul(self, a, x, y):
        return self._bin(lambda p, q: p * q, x, y)

    def _lower_Div(self, a, x, y):
        if _is_static(x) and _is_static(y) and np.issubdtype(
            _np(x).dtype, np.integer
        ) and np.issubdtype(_np(y).dtype, np.integer):
            return _np(x) // _np(y)
        return self._bin(lambda p, q: p / q, x, y)

    def _lower_Pow(self, a, x, y):
        return self._bin(lambda p, q: p**q, x, y)

    def _lower_Neg(self, a, x):
        return -_np(x) if _is_static(x) else -x

    def _lower_Abs(self, a, x):
        return np.abs(x) if _is_static(x) else torch.abs(x)

    def _lower_Exp(self, a, x):
        return torch.exp(self._tt(x))

    def _lower_Log(self, a, x):
        return torch.log(self._tt(x))

    def _lower_Sqrt(self, a, x):
        return torch.sqrt(self._tt(x))

    def _lower_Erf(self, a, x):
        return torch.erf(self._tt(x))

    def _lower_Floor(self, a, x):
        return np.floor(_np(x)) if _is_static(x) else torch.floor(x)

    def _lower_Ceil(self, a, x):
        return np.ceil(_np(x)) if _is_static(x) else torch.ceil(x)

    def _lower_Relu(self, a, x):
        return torch.clamp_min(self._tt(x), 0)

    def _lower_LeakyRelu(self, a, x):
        x = self._tt(x)
        return torch.where(x >= 0, x, a.get("alpha", 0.01) * x)

    def _lower_PRelu(self, a, x, slope):
        x = self._tt(x)
        return torch.where(x >= 0, x, self._t(slope) * x)

    def _lower_Elu(self, a, x):
        x = self._tt(x)
        return torch.where(x >= 0, x, a.get("alpha", 1.0) * (torch.exp(x) - 1.0))

    def _lower_Sigmoid(self, a, x):
        return torch.sigmoid(self._tt(x))

    def _lower_HardSigmoid(self, a, x):
        return torch.clamp(a.get("alpha", 0.2) * self._tt(x) + a.get("beta", 0.5), 0.0, 1.0)

    def _lower_HardSwish(self, a, x):
        x = self._tt(x)
        return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)

    def _lower_Tanh(self, a, x):
        return torch.tanh(self._tt(x))

    def _lower_Softplus(self, a, x):
        x = self._tt(x)
        return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))

    def _lower_Clip(self, a, x, lo=None, hi=None):
        if lo is None:
            lo = a.get("min")
        if hi is None:
            hi = a.get("max")
        x = self._tt(x)
        if lo is not None:
            x = torch.maximum(x, self._tt(lo).to(x.dtype))
        if hi is not None:
            x = torch.minimum(x, self._tt(hi).to(x.dtype))
        return x

    def _lower_Min(self, a, *xs):
        return functools.reduce(torch.minimum, [self._tt(x) for x in xs])

    def _lower_Max(self, a, *xs):
        return functools.reduce(torch.maximum, [self._tt(x) for x in xs])

    def _lower_Where(self, a, c, x, y):
        return torch.where(self._tt(c).bool(), self._t(x), self._t(y))

    def _lower_Equal(self, a, x, y):
        return self._bin(lambda p, q: p == q, x, y)

    def _lower_Greater(self, a, x, y):
        return self._bin(lambda p, q: p > q, x, y)

    def _lower_Less(self, a, x, y):
        return self._bin(lambda p, q: p < q, x, y)

    def _lower_Not(self, a, x):
        return torch.logical_not(self._tt(x))

    def _lower_And(self, a, x, y):
        return torch.logical_and(self._tt(x), self._tt(y))

    def _lower_Or(self, a, x, y):
        return torch.logical_or(self._tt(x), self._tt(y))

    # matmul / norm -----------------------------------------------------------
    def _lower_MatMul(self, a, x, y):
        return torch.matmul(self._tt(x), self._tt(y))

    def _lower_Gemm(self, a, x, y, c=None):
        x, y = self._tt(x), self._tt(y)
        if int(a.get("transA", 0)):
            x = x.transpose(-1, -2)
        if int(a.get("transB", 0)):
            y = y.transpose(-1, -2)
        out = a.get("alpha", 1.0) * torch.matmul(x, y)
        if c is not None:
            out = out + a.get("beta", 1.0) * self._t(c)
        return out

    def _lower_BatchNormalization(self, a, x, scale, bias, mean, var):
        eps = a.get("epsilon", 1e-5)
        x = self._tt(x)
        scale, bias, mean, var = (self._tt(v) for v in (scale, bias, mean, var))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        inv = torch.rsqrt(var.float() + eps).to(x.dtype)
        return (x - mean.reshape(shape)) * (inv * scale).reshape(shape) + bias.reshape(shape)

    def _lower_InstanceNormalization(self, a, x, scale, bias):
        eps = a.get("epsilon", 1e-5)
        x = self._tt(x)
        axes = tuple(range(2, x.ndim))
        var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + eps) * self._tt(scale).reshape(
            shape) + self._tt(bias).reshape(shape)

    def _lower_LayerNormalization(self, a, x, scale, bias=None):
        x = self._tt(x)
        axis = int(a.get("axis", -1))
        eps = a.get("epsilon", 1e-5)
        axes = tuple(range(axis % x.ndim, x.ndim))
        var, mean = torch.var_mean(x, dim=axes, keepdim=True, correction=0)
        y = (x - mean) * torch.rsqrt(var + eps) * self._t(scale)
        if bias is not None:
            y = y + self._t(bias)
        return y

    def _lower_Softmax(self, a, x):
        return torch.softmax(self._tt(x), dim=int(a.get("axis", -1)))

    # conv / pool / resize ------------------------------------------------------
    def _lower_Conv(self, a, x, w, b=None):
        return _op_conv(a, self._tt(x), self._tt(w), None if b is None else self._tt(b))

    def _lower_ConvTranspose(self, a, x, w, b=None):
        return _op_conv_transpose(a, self._tt(x), self._tt(w),
                                  None if b is None else self._tt(b))

    def _lower_MaxPool(self, a, x):
        return _pool(a, self._tt(x), avg=False)

    def _lower_AveragePool(self, a, x):
        return _pool(a, self._tt(x), avg=True)

    def _lower_GlobalAveragePool(self, a, x):
        x = self._tt(x)
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)

    def _lower_GlobalMaxPool(self, a, x):
        x = self._tt(x)
        return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)

    def _lower_Resize(self, a, x, *rest):
        return _op_resize(a, self._tt(x), *rest)

    def _lower_Upsample(self, a, x, scales=None):
        if scales is None:
            scales = a["scales"]
        return _op_resize({"mode": a.get("mode", b"nearest")}, self._tt(x), None, scales)

    def _lower_Pad(self, a, x, pads=None, value=None, axes=None):
        x = self._tt(x)
        if pads is None:
            pads = a["pads"]
        pads = [int(p) for p in np.asarray(pads).reshape(-1)]
        rank = x.ndim
        if axes is not None:
            ax = [int(v) % rank for v in np.asarray(axes).reshape(-1)]
        else:
            ax = list(range(rank))
        width = [(0, 0)] * rank
        half = len(pads) // 2
        for j, axis in enumerate(ax):
            width[axis] = (pads[j], pads[j + half])
        mode = _attr_str(a, "mode", "constant")
        if mode == "constant":
            cval = 0.0 if value is None else float(np.asarray(value).reshape(()))
            return F.pad(x, _torch_pads(width), value=cval)
        if mode not in ("reflect", "edge"):
            raise KeyError(mode)
        for axis, (lo, hi) in enumerate(width):
            if lo or hi:
                idx = _pad_index(x.shape[axis], lo, hi, mode)
                x = x.index_select(axis, torch.from_numpy(idx).to(x.device))
        return x

    # shape algebra ---------------------------------------------------------------
    def _lower_Shape(self, a, x):
        shape = np.asarray(_shape(x), dtype=np.int64)
        start = int(a.get("start", 0))
        end = a.get("end")
        return shape[start : int(end) if end is not None else None]

    def _lower_Size(self, a, x):
        return np.asarray(int(np.prod(_shape(x))), dtype=np.int64)

    def _lower_Reshape(self, a, x, shape):
        shape = [int(s) for s in np.asarray(shape).reshape(-1)]
        if not int(a.get("allowzero", 0)):
            xs = _shape(x)
            shape = [xs[i] if s == 0 else s for i, s in enumerate(shape)]
        return _np(x).reshape(shape) if _is_static(x) else x.reshape(shape)

    def _lower_Transpose(self, a, x):
        x = self._tt(x)
        perm = a.get("perm")
        if perm is None:
            perm = list(range(x.ndim))[::-1]
        return x.permute([int(p) for p in perm])

    def _lower_Flatten(self, a, x):
        x = self._tt(x)
        axis = int(a.get("axis", 1)) % (x.ndim + 1)
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return x.reshape(lead, -1)

    def _lower_Squeeze(self, a, x, axes=None):
        if axes is None:
            axes = a.get("axes")
        if axes is None:
            axes = [i for i, s in enumerate(_shape(x)) if s == 1]
        axes = _axes_tuple(np.asarray(axes).reshape(-1), _ndim(x))
        if _is_static(x):
            return np.squeeze(_np(x), axis=axes)
        for ax in sorted(axes, reverse=True):
            x = x.squeeze(ax)
        return x

    def _lower_Unsqueeze(self, a, x, axes=None):
        if axes is None:
            axes = a["axes"]
        out_rank = _ndim(x) + len(np.asarray(axes).reshape(-1))
        axes = sorted(int(v) % out_rank for v in np.asarray(axes).reshape(-1))
        y = _np(x) if _is_static(x) else x
        for ax in axes:
            y = np.expand_dims(y, ax) if _is_static(y) else y.unsqueeze(ax)
        return y

    def _lower_Concat(self, a, *xs):
        axis = int(a["axis"])
        if all(_is_static(x) for x in xs):
            return np.concatenate([_np(x) for x in xs], axis=axis)
        return torch.cat([self._tt(x) for x in xs], dim=axis)

    def _lower_Split(self, a, x, split=None):
        x = self._tt(x)
        axis = int(a.get("axis", 0)) % x.ndim
        if split is None:
            split = a.get("split")
        if split is None:
            n = int(a.get("num_outputs", 2))
            sizes = [x.shape[axis] // n] * n
        else:
            sizes = [int(s) for s in np.asarray(split).reshape(-1)]
        return list(torch.split(x, sizes, dim=axis))

    def _lower_Gather(self, a, x, idx):
        axis = int(a.get("axis", 0))
        if _is_static(x) and _is_static(idx):
            return np.take(_np(x), _np(idx).astype(np.int64), axis=axis)
        x = self._tt(x)
        return _take(x, self._tt(idx), axis % x.ndim, along=False)

    def _lower_GatherElements(self, a, x, idx):
        x = self._tt(x)
        return _take(x, self._tt(idx), int(a.get("axis", 0)) % x.ndim, along=True)

    def _lower_Slice(self, a, *ins):
        return _op_slice(a, *ins)

    def _lower_Expand(self, a, x, shape):
        shape = [int(s) for s in np.asarray(shape).reshape(-1)]
        target = list(np.broadcast_shapes(tuple(_shape(x)), tuple(shape)))
        return torch.broadcast_to(self._tt(x), target)

    def _lower_Tile(self, a, x, reps):
        return torch.tile(self._tt(x), [int(r) for r in np.asarray(reps).reshape(-1)])

    def _lower_Cast(self, a, x):
        dt = TENSOR_DTYPES[int(a["to"])]
        if _is_static(x):
            return _np(x).astype(dt)
        return x.to(_TORCH_DTYPES[np.dtype(dt)])

    def _lower_Identity(self, a, x):
        return x

    def _lower_Constant(self, a):
        if "value" in a:
            return a["value"]
        if "value_float" in a:
            return np.float32(a["value_float"])
        if "value_int" in a:
            return np.int64(a["value_int"])
        if "value_floats" in a:
            return np.asarray(a["value_floats"], np.float32)
        if "value_ints" in a:
            return np.asarray(a["value_ints"], np.int64)
        raise NotImplementedError("Constant without tensor value")

    def _lower_ConstantOfShape(self, a, shape):
        val = a.get("value")
        fill = val.reshape(-1)[0] if isinstance(val, np.ndarray) else 0.0
        dt = val.dtype if isinstance(val, np.ndarray) else np.float32
        return np.full([int(s) for s in np.asarray(shape).reshape(-1)], fill, dt)

    def _lower_Range(self, a, start, limit, delta):
        if all(_is_static(v) for v in (start, limit, delta)):
            return np.arange(
                _np(start).item(), _np(limit).item(), _np(delta).item()
            )
        start, limit, delta = (self._tt(v) for v in (start, limit, delta))
        return torch.arange(start.item(), limit.item(), delta.item(), device=self.device,
                            dtype=torch.promote_types(torch.promote_types(
                                start.dtype, limit.dtype), delta.dtype))

    # reductions -------------------------------------------------------------------
    def _reduce(self, fn, a, x, axes=None):
        x = self._tt(x)
        if axes is None:
            axes = a.get("axes")
        keep = bool(int(a.get("keepdims", 1)))
        if axes is None:
            if int(a.get("noop_with_empty_axes", 0)):
                return x
            ax = tuple(range(x.ndim))
        else:
            ax = _axes_tuple(np.asarray(axes).reshape(-1), x.ndim)
        return fn(x, ax, keep)

    def _lower_ReduceMean(self, a, x, axes=None):
        return self._reduce(lambda t, d, k: t.mean(dim=d, keepdim=k), a, x, axes)

    def _lower_ReduceSum(self, a, x, axes=None):
        return self._reduce(lambda t, d, k: t.sum(dim=d, keepdim=k), a, x, axes)

    def _lower_ReduceMax(self, a, x, axes=None):
        return self._reduce(lambda t, d, k: t.amax(dim=d, keepdim=k), a, x, axes)

    def _lower_ReduceMin(self, a, x, axes=None):
        return self._reduce(lambda t, d, k: t.amin(dim=d, keepdim=k), a, x, axes)

    def _lower_ReduceProd(self, a, x, axes=None):
        def prod(t, dims, keep):
            for d in sorted(dims, reverse=True):
                t = t.prod(dim=d, keepdim=keep)
            return t

        return self._reduce(prod, a, x, axes)

    def _lower_ReduceL2(self, a, x, axes=None):
        x = self._tt(x)
        return torch.sqrt(self._reduce(lambda t, d, k: t.sum(dim=d, keepdim=k), a, x * x, axes))

    def _lower_ArgMax(self, a, x):
        return torch.argmax(self._tt(x), dim=int(a.get("axis", 0)),
                            keepdim=bool(int(a.get("keepdims", 1))))

    def _lower_ArgMin(self, a, x):
        return torch.argmin(self._tt(x), dim=int(a.get("axis", 0)),
                            keepdim=bool(int(a.get("keepdims", 1))))
