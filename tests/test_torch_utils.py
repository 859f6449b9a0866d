"""The port's utils against the JAX package's: checkpoints, DDIM inversion,
profiling, logging and seeding, and ``dynamic_crop_resize``.

The checkpoint writer has no JAX counterpart to match (the JAX package uses
orbax): its round trip must give back every tensor bit for bit, and the
``safetensors`` package must read what it writes. DDIM inversion runs the
same float32 noise prediction on both sides (relative 1e-6: float32 in
another order); the crop/resize is PIL's on both sides, bit for bit.
"""

import json
import logging
import random

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors
import safetensors.torch as stt
import torch

from musev_tpu.schedulers.ancestral import DDIMScheduler as JDDIM
from musev_tpu.schedulers.base import ScheduleConfig as JScheduleConfig
from musev_tpu.utils import image_util as j_image_util
from musev_tpu.utils import inversion as j_inversion
from musev_tpu.utils import logging_util as j_logging_util
from musev_tpu.utils import profiling as j_profiling
from musev_torch.schedulers.ancestral import DDIMScheduler
from musev_torch.schedulers.base import ScheduleConfig
from musev_torch.utils import checkpoint, image_util, inversion, logging_util, profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _assert_same_tree(got, want):
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.cpu(), want.cpu())
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_tree(a, b)
    else:
        assert got == want or (got != got and want != want)  # NaN leaves


def _trees():
    g = torch.Generator().manual_seed(0)
    return {
        "bf16": {"w": torch.randn(3, 5, generator=g).bfloat16()},
        "fp32": {"w": torch.randn(4, 2, 3, generator=g), "scalar": torch.tensor(1.5)},
        "int": {"i64": torch.arange(-3, 9), "i32": torch.arange(6, dtype=torch.int32).view(2, 3),
                "u8": torch.arange(250, 256, dtype=torch.uint8),
                "bool": torch.tensor([True, False, True]), "empty": torch.zeros(0, 4)},
        "nested": {"a": {"b": [torch.ones(2), (torch.zeros(1, dtype=torch.float16), 3)]},
                   7: {"x": None, "y": "text", "z": 2.5, "nan": float("nan"),
                       "flag": False},
                   "view": torch.arange(12.0).view(3, 4).t()},
    }


@pytest.mark.parametrize("name", list(_trees()))
def test_checkpoint_round_trip_is_bit_for_bit(tmp_path, name):
    tree = _trees()[name]
    path = tmp_path / "state.safetensors"
    checkpoint.save_state(path, tree)
    _assert_same_tree(checkpoint.restore_state(path), tree)
    # the safetensors package reads the file and its metadata
    flat = stt.load_file(str(path))
    with safetensors.safe_open(str(path), "pt") as f:
        assert checkpoint.TREE_KEY in f.metadata()
    assert sorted(t.numel() for t in flat.values()) == sorted(
        t.numel() for t in _tensor_leaves(tree))


def _tensor_leaves(node):
    if isinstance(node, torch.Tensor):
        return [node]
    items = node.values() if isinstance(node, dict) else \
        node if isinstance(node, (list, tuple)) else ()
    return [t for v in items for t in _tensor_leaves(v)]


def test_checkpoint_adamw_state_continues_bit_for_bit(tmp_path):
    """Save a module and its AdamW state after two steps, restore them into a
    fresh module and optimizer: the third step equals the uninterrupted one."""
    def make():
        torch.manual_seed(0)
        net = torch.nn.Sequential(torch.nn.Linear(6, 5), torch.nn.GELU(), torch.nn.Linear(5, 2))
        return net, torch.optim.AdamW(net.parameters(), lr=1e-2, weight_decay=1e-2)

    x = torch.from_numpy(_rand(1, 7, 6))

    def step(net, opt):
        opt.zero_grad()
        net(x).square().mean().backward()
        opt.step()

    net, opt = make()
    for _ in range(2):
        step(net, opt)
    path = tmp_path / "train.safetensors"
    checkpoint.save_state(path, {"model": net.state_dict(), "optimizer": opt.state_dict(),
                                 "step": 2})
    restored = checkpoint.restore_state(path)
    _assert_same_tree(restored["optimizer"], opt.state_dict())
    assert restored["step"] == 2
    net2, opt2 = make()
    net2.load_state_dict(restored["model"])
    opt2.load_state_dict(restored["optimizer"])
    step(net, opt)
    step(net2, opt2)
    _assert_same_tree(net2.state_dict(), net.state_dict())
    _assert_same_tree(opt2.state_dict(), opt.state_dict())


def test_checkpoint_refuses_what_it_cannot_write(tmp_path):
    with pytest.raises(TypeError, match="dtype"):
        checkpoint.save_state(tmp_path / "a.safetensors",
                              {"x": torch.zeros(2, dtype=torch.float64)})
    with pytest.raises(TypeError, match="leaf"):
        checkpoint.save_state(tmp_path / "b.safetensors", {"x": object()})
    plain = tmp_path / "plain.safetensors"
    stt.save_file({"x": torch.zeros(2)}, str(plain))
    with pytest.raises(ValueError, match="save_state"):
        checkpoint.restore_state(plain)


def test_write_safetensors_is_read_by_the_safetensors_package(tmp_path):
    tensors = {"a": torch.arange(6.0).view(2, 3).t(), "b": torch.ones(2, dtype=torch.bfloat16)}
    path = tmp_path / "w.safetensors"
    checkpoint.write_safetensors(path, tensors, {"k": "v"})
    got = stt.load_file(str(path))
    for k, v in tensors.items():
        assert torch.equal(got[k], v.contiguous())
    assert checkpoint.safetensors_metadata(path) == {"k": "v"}


@pytest.mark.parametrize("steps", [10, 4])
def test_ddim_inversion_matches_jax(steps):
    latents = _rand(0, 1, 3, 4, 4, 4)
    c = _rand(1, 1, 3, 4, 4, 4)

    def eps(x, t, xp):  # a float32 noise prediction both sides compute alike
        return 0.1 * x + (t / 1000.0) * xp.asarray(c)

    want = j_inversion.ddim_inversion(JDDIM.create(steps, JScheduleConfig()), jnp.asarray(latents),
                                      lambda x, t: eps(x, t, jnp))
    got = inversion.ddim_inversion(DDIMScheduler.create(steps, ScheduleConfig()),
                                   torch.from_numpy(latents),
                                   lambda x, t: eps(x, t, torch))
    assert len(got) == len(want) == steps + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_phase_timers_report_as_jax():
    timers, j_timers = profiling.PhaseTimers(), j_profiling.PhaseTimers()
    x = torch.zeros(3)
    for t in (timers, j_timers):
        with t.phase("decode", block_on=[x]):
            pass
        for _ in range(2):
            with t.phase("denoise"):
                pass
    assert timers.counts == j_timers.counts == {"decode": 1, "denoise": 2}
    timers.totals = j_timers.totals = {"decode": 0.25, "denoise": 1.5}
    assert timers.report() == j_timers.report()
    assert json.loads(timers.as_json()) == json.loads(j_timers.as_json())


def test_trace_and_device_status_on_the_cpu(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(4).sum()
    (written,) = (tmp_path / "trace").iterdir()
    assert json.loads(written.read_text())["traceEvents"]
    status = profiling.device_status()
    assert [set(e) for e in status] == [{"id", "platform", "device_kind"}]
    profiling.log_device_status("test: ")


def test_set_all_seed_and_logging_match_jax():
    seed, gen = logging_util.set_all_seed(123)
    port_draws = (random.random(), np.random.rand())
    assert seed == 123 and gen.initial_seed() == 123
    assert torch.equal(torch.randn(3, generator=gen),
                       torch.randn(3, generator=torch.Generator().manual_seed(123)))
    j_seed, _ = j_logging_util.set_all_seed(123)
    assert j_seed == 123 and (random.random(), np.random.rand()) == port_draws
    root = logging.getLogger()
    level = root.level
    try:
        logging_util.configure_logging(logging.WARNING)
        assert root.level == logging.WARNING
        assert logging.getLogger("musev_torch").level == logging.DEBUG
    finally:
        root.setLevel(level)


@pytest.mark.parametrize("shape,target", [
    ((40, 90, 3), (32, 48)),  # too wide: the width is cropped
    ((90, 40, 3), (48, 32)),  # too tall for a wider target: the height is cropped
    ((64, 64, 3), (40, 40)),  # the target's ratio: resize only
    ((33, 71, 3), (16, 16)),  # odd sizes, rounding of the crop
])
def test_dynamic_crop_resize_is_bit_for_bit(shape, target):
    image = np.random.default_rng(0).integers(0, 256, shape).astype(np.float32)
    got = image_util.dynamic_crop_resize(image, *target)
    want = j_image_util.dynamic_crop_resize(image, *target)
    assert got.shape == (*target, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
