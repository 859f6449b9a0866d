"""The reference against the program's float32 CPU path at narrow widths,
and the FLOP count against the analytic one."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port.harness import runner
from bench_port.harness import traffic as tr
from bench_port.harness.weights import draw
from bench_port.reference import pipeline as ref
from bench_port.reference.layers import Numerics
from bench_port.reference.unet import ResnetBlock, UNet3D, UNetSizes
from bench_port.tests import tiny

CPU = torch.device("cpu")
# float32 on both sides: only the order of sums differs, and the random
# network amplifies that by the Euler chain to about 1e-6 of the clip
FLOAT32_REL_L2 = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("preset,mix", [("musev", "t2v-576-24f"),
                                        ("musev_referencenet", "i2v-576-24f")])
def test_reference_matches_the_program_in_float32(preset, mix):
    from musev_torch.pipelines.pipeline import MusevPipeline

    cfg, traffic = tiny.config(preset), tiny.traffic(mix)
    seed = 2**31 + 12345
    models = runner.port_models(cfg, draw(cfg, seed, CPU, torch.float32), CPU, torch.float32,
                                tiny.port_preset(cfg))
    req = tr.request(traffic, seed, 0)
    latents, videos = runner.run_clip(MusevPipeline(models), req, traffic)
    want = runner.reference_clip(cfg, seed, req.args, CPU, torch.float32)
    assert want[0].shape == latents.shape and want[1].shape == videos.shape
    got = runner.compare(latents, videos, want)
    assert got["latents_rel_l2"] < FLOAT32_REL_L2 and got["frames_rel_l2"] < FLOAT32_REL_L2, got


def test_weights_repeat_from_the_seed_and_differ_across_seeds():
    cfg = tiny.config("musev")
    a, b, c = (draw(cfg, s, CPU, torch.bfloat16) for s in (7, 7, 8))
    key = "conv_in.weight"
    assert torch.equal(a["unet"][key], b["unet"][key])
    assert not torch.equal(a["unet"][key], c["unet"][key])
    assert float(a["unet"][key].float().std()) == pytest.approx(cfg["weights"]["std"], rel=0.2)
    assert torch.all(a["unet"]["conv_norm_out.weight"] == 1)


def test_flop_count_of_a_small_unet_is_the_analytic_one():
    """One resnet block: two 3x3 convolutions, the time projection and a 1x1
    shortcut, 2 * MACs each."""
    n, h, w, cin, cout, temb = 2, 8, 8, 16, 32, 64
    with torch.device("meta"):
        block = ResnetBlock(cin, cout, temb, 8)
        x, t = torch.empty(n, h, w, cin), torch.empty(n, temb)
    with FlopCounterMode(display=False) as fc:
        block(x, t)
    want = 2 * n * h * w * (9 * cin * cout + 9 * cout * cout + cin * cout) + 2 * n * temb * cout
    assert fc.get_total_flops() == want


def test_flop_count_of_a_unet_call_scales_with_its_rows():
    s = UNetSizes(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in tiny.config("musev")["modules"]["unet"].items()})
    with torch.device("meta"):
        unet = UNet3D(s)
    counts = []
    for rows in (2, 4):
        with torch.device("meta"):
            x, text = torch.empty(rows, 3, 8, 8, 4), torch.empty(rows, 77, 32)
        with FlopCounterMode(display=False) as fc:
            unet(x, 500.0, text, cond_index=(0,))
        counts.append(fc.get_total_flops())
    # the frame embedding runs once a call, every other product once a row
    assert 1.99 * counts[0] < counts[1] <= 2 * counts[0]


def test_control_precision_reads_above_bfloat16():
    """At narrow widths the float8 control departs from float32 far more
    than bfloat16 operands do (on the chip, at the cell's sizes, the readings
    that set the limits come from calibrate.py)."""
    cfg, traffic = tiny.config("musev_referencenet"), tiny.traffic("i2v-576-24f")
    req = tr.request(traffic, 99, 0)
    want = runner.reference_clip(cfg, 99, req.args, CPU, torch.bfloat16)
    readings = {p: runner.compare(*[t.numpy() for t in runner.reference_clip(
        cfg, 99, req.args, CPU, torch.bfloat16, Numerics(p))], want) for p in ("bf16", "fp8")}
    for key in ("latents_rel_l2", "frames_rel_l2"):
        assert readings["fp8"][key] > 3 * readings["bf16"][key], readings


def test_windows_match_the_program_plan():
    from musev_torch.ops.context import make_window_plan

    for t, size, overlap in ((24, 12, 4), (48, 12, 4), (8, 4, 2), (12, 12, 4)):
        np.testing.assert_array_equal(ref.windows(t, size, overlap),
                                      make_window_plan(t, size, overlap).windows)
