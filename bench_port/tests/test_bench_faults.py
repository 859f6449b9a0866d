"""A whole run at narrow widths on the CPU (the look for a card skipped),
with the timed path broken underneath: ``correct`` has to come out false
under the cell's own limits. The faults a clip can have: a step that
returns its state unchanged, half of the window batch left out with the
windows' mean taken over the rest, a frame altered where it is produced;
and the control, the float8 reference in the program's place."""

from __future__ import annotations

import time

import pytest
import torch

from bench_port.harness import runner, spec
from bench_port.reference.layers import Numerics
from bench_port.tests import tiny

CELLS = {"musev_referencenet.i2v-576-24f": ("musev_referencenet", "i2v-576-24f"),
         "musev.t2v-576-24f": ("musev", "t2v-576-24f")}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def narrow_run(cell_name: str, seed: int = 2**31 + 5):
    cell = spec.load_cell(cell_name)
    preset, mix = CELLS[cell_name]
    cell.config, cell.traffic = tiny.config(preset), tiny.traffic(mix)
    head, rec, checks = runner.run(cell, seed, 0.01, False, time.time(), device="cpu",
                                   preset=tiny.port_preset(cell.config), log=lambda m: None)
    return head, checks


def step_unchanged(monkeypatch):
    from musev_torch.schedulers.euler_discrete import EulerDiscreteScheduler

    monkeypatch.setattr(EulerDiscreteScheduler, "step",
                        lambda self, out, i, sample, **kw: (sample, sample))


def half_batch(monkeypatch):
    """Each CFG half runs its first windows only; the rest copy the last one."""
    from musev_torch.pipelines import denoiser

    inner = denoiser.unet3d_apply

    def apply(unet, sample, *a, **kw):
        out = inner(unet, sample, *a, **kw)
        halves = out.chunk(2)
        keep = (halves[0].shape[0] + 1) // 2
        fill = [torch.cat([h[:keep]] + [h[keep - 1:keep]] * (h.shape[0] - keep)) for h in halves]
        return torch.cat(fill)

    monkeypatch.setattr(denoiser, "unet3d_apply", apply)


def frame_altered(monkeypatch):
    from musev_torch.pipelines.pipeline import MusevPipeline

    inner = MusevPipeline.decode_latents

    def decode(self, latents, segment=16):
        videos = inner(self, latents, segment).copy()
        videos[:, 2] = 1.0 - videos[:, 2]
        return videos

    monkeypatch.setattr(MusevPipeline, "decode_latents", decode)


def control(monkeypatch, preset: str, seed: int):
    """The reference computed in float8 e4m3 in the program's place."""
    def clip(pipe, req, traffic):
        lat, vid = runner.reference_clip(tiny.config(preset), seed, req.args,
                                         torch.device("cpu"), torch.float32, Numerics("fp8"))
        return lat.numpy(), vid.numpy()

    monkeypatch.setattr(runner, "run_clip", clip)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_sound_program_is_correct(cell):
    head, checks = narrow_run(cell)
    assert head["correct"] and head["failed"] == 0, checks


@pytest.mark.parametrize("fault", [step_unchanged, half_batch, frame_altered])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    head, checks = narrow_run(cell)
    assert not head["correct"], checks


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_is_not_correct(cell, monkeypatch):
    seed = 2**31 + 5
    control(monkeypatch, CELLS[cell][0], seed)
    head, checks = narrow_run(cell, seed)
    assert not head["correct"], checks
