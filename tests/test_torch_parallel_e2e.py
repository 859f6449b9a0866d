"""The port's topologies end to end on 2 gloo ranks, against the port's own
one-process runs: ``MusevPipeline.text2video`` with ``fp_axis``, both CLIs
under ``--parallel fp`` and ``--parallel dp``, ``OnlineInference`` over an
fp pipeline, and training (``diffusion_loss`` with ``fp_axis``,
``train_step`` under ``dp_axis``).

The models are the CLIs' ``--tiny`` presets (drawn from the loader's seed,
so every rank builds the same weights) and, for training, the JAX package's
train-test config drawn from torch's seed with every leaf moved by
N(0, 0.05). float32 on the CPU (the dp training step in float64, see
``_dp_step``). Tolerances: the clip in [0, 1] within the fp tolerance of
the UNet (2e-4, about 0.05 of one grey level), uint8 frames within one
grey level, the grads per param within relative L2 1e-4.

The 2 ranks are spawned once for the module (``file://`` rendezvous, one
torch thread per rank); they run every case and save what they got; each
test asserts one case. The ranks import this module, so it imports torch,
numpy and ``musev_torch`` only (nothing of JAX).
"""

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import musev_torch.io.video as video_io
from musev_torch import train
from musev_torch.cli import text2video as t2v
from musev_torch.cli import video2video as v2v
from musev_torch.configs.model_registry import get_model_preset
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.parallel.mesh import make_mesh, set_mesh
from musev_torch.pipelines.loader import build_models
from musev_torch.pipelines.pipeline import MusevPipeline
from musev_torch.serve.app import OnlineInference

N = 2
CLIP_TOL = dict(atol=2e-4, rtol=0)
GRAD_REL_L2 = 1e-4
T2V_KW = dict(height=32, width=32, video_length=6, n_batch=1, video_num_inference_steps=2,
              num_inference_steps=2, context_frames=4, context_overlap=2, seed=3)
CLI_RUN = ["--tiny", "--device", "cpu", "--height", "32", "--width", "32", "--time_size", "4",
           "--context_frames", "4", "--context_overlap", "2", "--num_inference_steps", "2",
           "--video_num_inference_steps", "2", "--seed", "5", "--fps", "4"]
TRAIN_CFG = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, cross_attention_dim=16,
                 attention_heads=4, norm_num_groups=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class FramesReader:
    """``VideoReader``'s interface over frames saved with ``np.save``."""

    def __init__(self, path):
        self.frames = np.load(path)
        self.num_frames, self.height, self.width = self.frames.shape[:3]

    def windows(self, time_size: int, overlap: int = 0, sample_rate: int = 1):
        for lo in range(0, self.num_frames, time_size - overlap):
            yield self.frames[lo:lo + time_size:sample_rate]

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _tiny_models():
    return build_models(t2v._shrink_preset(get_model_preset("musev")), device="cpu")


def _condition_image():
    return np.random.default_rng(0).uniform(0, 255, (1, 1, 32, 32, 3)).astype(np.float32)


def _run_cli(cli, topology, files, out):
    """The CLI's run, its frames captured where it would write them."""
    frames = {}
    cli_mod = t2v  # both CLIs write through text2video's write_frames
    saved = cli_mod.native_available, cli_mod.write_video, video_io.VideoReader
    cli_mod.native_available = lambda: True
    cli_mod.write_video = lambda path, f, fps: frames.__setitem__(path, f)
    video_io.VideoReader = FramesReader
    try:
        extra = ["--video_is_middle", "--controlnet_name", "none"] if cli is v2v else []
        written = cli.main(["--test_data_path", str(files[cli.__name__]), "--output_dir",
                            str(out), "--parallel", topology, *extra, *CLI_RUN])
    finally:
        cli_mod.native_available, cli_mod.write_video, video_io.VideoReader = saved
    return dict(written=written, frames=[frames[w] for w in written],
                out_dir_exists=Path(out).exists())


def _train_unet(dtype=torch.float32):
    torch.manual_seed(0)
    unet = UNet3D(UNet3DConfig(**TRAIN_CFG))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in unet.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return unet.to(dtype)


def _train_batch(b, dtype=torch.float32):
    rng = np.random.default_rng(b)
    t = torch.from_numpy
    return dict(latents=t(rng.standard_normal((b, 5, 4, 4, 4), dtype=np.float32)).to(dtype),
                text=t(rng.standard_normal((b, 5, 16), dtype=np.float32)).to(dtype),
                timesteps=t(rng.integers(0, 1000, (b,))),
                noise=t(rng.standard_normal((b, 4, 4, 4, 4), dtype=np.float32)))


def _fp_grads(spec_kw):
    """``diffusion_loss`` and its grads (after ``sync_grads``), by param."""
    unet = _train_unet()
    spec = train.TrainSpec(unet_cfg=unet.cfg, **spec_kw)
    x = _train_batch(2)
    loss = train.diffusion_loss(unet, spec, x["latents"], x["text"], timesteps=x["timesteps"],
                                noise=x["noise"])
    loss.backward()
    train.sync_grads(list(unet.parameters()), spec)
    return loss.item(), {n: p.grad.clone() for n, p in unet.named_parameters()
                         if p.grad is not None}


def _dp_step(spec_kw):
    """One ``train_step`` in float64: the loss, the grads and the params
    after it. (In float32 a scalar param's grad, a temporal weight summed
    over the clip, moves by 5.5e-4 relative between a batch of 3 and shards
    of 2 + 1: float32 rounding of another summation order.)"""
    unet = _train_unet(torch.float64)
    spec = train.TrainSpec(unet_cfg=unet.cfg, learning_rate=0.5, **spec_kw)
    x = _train_batch(3, torch.float64)
    loss = train.train_step(unet, spec, x["latents"], x["text"], timesteps=x["timesteps"],
                            noise=x["noise"])
    return loss.item(), {n: p.grad.clone() for n, p in unet.named_parameters()
                         if p.grad is not None}, {n: p.detach().clone()
                                                  for n, p in unet.named_parameters()}


def _rank(rank, n, d, files):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/init", rank=rank, world_size=n)
    try:
        got = {}
        mesh = make_mesh((n,), ("fp",))
        pipe = MusevPipeline(_tiny_models(), fp_axis="fp", mesh=mesh)
        with set_mesh(mesh):
            got["pipeline fp"] = pipe.text2video("a cat", condition_images=_condition_image(),
                                                 **T2V_KW).videos
            got["serve fp"] = OnlineInference(pipe, time_size=4).online_t2v_inference(
                "a portrait", None, seed=3, w=32, h=32, video_length=4)
            got["train fp"] = _fp_grads(dict(fp_axis="fp"))
        dp_mesh = make_mesh((n,), ("dp",))
        with set_mesh(dp_mesh):
            got["train dp"] = _dp_step(dict(dp_axis="dp"))
        for cli in (t2v, v2v):
            for topology in ("fp", "dp"):
                got[f"{cli.__name__} {topology}"] = _run_cli(cli, topology, files,
                                                             Path(d) / f"out{rank}_{topology}")
        torch.save(got, f"{d}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tasks")
    np.save(d / "pose.npy", np.random.default_rng(1).integers(0, 256, (6, 32, 32, 3),
                                                              dtype=np.uint8))
    (d / "t2v.csv").write_text("name,prompt\ncat,a cat walking\n")
    (d / "v2v.csv").write_text(f"name,prompt,video_path\ndance,a dancer,{d / 'pose.npy'}\n")
    return {t2v.__name__: d / "t2v.csv", v2v.__name__: d / "v2v.csv"}


@pytest.fixture(scope="module")
def ranks(files):
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(N, d, files), nprocs=N, join=True)
        return [torch.load(Path(d) / f"rank{r}.pt", weights_only=False) for r in range(N)]


@pytest.fixture(scope="module")
def one_process(files, tmp_path_factory):
    """The same runs in this process, without a mesh."""
    pipe = MusevPipeline(_tiny_models())
    out = dict(pipeline=pipe.text2video("a cat", condition_images=_condition_image(),
                                        **T2V_KW).videos,
               serve=OnlineInference(pipe, time_size=4).online_t2v_inference(
                   "a portrait", None, seed=3, w=32, h=32, video_length=4),
               train_fp=_fp_grads({}), train_dp=_dp_step({}))
    for cli in (t2v, v2v):
        out[cli.__name__] = _run_cli(cli, "none", files, tmp_path_factory.mktemp("none"))
    return out


def _rel_l2(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def test_pipeline_text2video_fp_matches_one_process(ranks, one_process):
    """Every rank ends with the whole clip, within the fp tolerance of the
    one-process pipeline (the VAE decode frame-sharded over the mesh)."""
    for got in ranks:
        np.testing.assert_allclose(got["pipeline fp"], one_process["pipeline"], **CLIP_TOL)


def test_online_inference_over_an_fp_pipeline(ranks, one_process):
    """The serving callable on an fp pipeline: the frames of the
    one-process server within one grey level, of the same shape."""
    want = one_process["serve"]
    for got in ranks:
        assert got["serve fp"].dtype == np.uint8 and got["serve fp"].shape == want.shape
        assert np.abs(got["serve fp"].astype(int) - want).max() <= 1


@pytest.mark.parametrize("topology", ["fp", "dp"])
@pytest.mark.parametrize("cli", [t2v, v2v], ids=["text2video", "video2video"])
def test_cli_on_two_ranks_writes_the_frames_of_none(ranks, one_process, cli, topology):
    """Rank 0 writes the clip of ``--parallel none`` (within one grey level:
    the UNet's float32 rounding moves a pixel across a level at most);
    rank 1 writes nothing, not even the output directory."""
    want = one_process[cli.__name__]
    first, second = (r[f"{cli.__name__} {topology}"] for r in ranks)
    assert len(first["written"]) == 1 and Path(first["written"][0]).name == Path(
        want["written"][0]).name
    assert first["frames"][0].shape == want["frames"][0].shape
    assert np.abs(first["frames"][0].astype(int) - want["frames"][0]).max() <= 1
    assert second["written"] == [] and not second["out_dir_exists"]


def test_fp_training_grads_match_one_process(ranks, one_process):
    """``diffusion_loss`` through the frame-parallel program (grad
    checkpointing on, so the backward recomputes collectives), then
    ``sync_grads`` summing over the ranks: the loss and every param's grad
    of the one-process run."""
    want_loss, want = one_process["train_fp"]
    for got_loss, got in (r["train fp"] for r in ranks):
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        assert got.keys() == want.keys()
        worst = max((_rel_l2(got[k], want[k]), k) for k in want)
        assert worst[0] <= GRAD_REL_L2, worst


def test_dp_train_step_matches_one_process(ranks, one_process):
    """``train_step`` with a batch of 3 over 2 ranks (shards of 2 and 1),
    in float64: the loss, every grad (averaged over the ranks) and the
    stepped params of the one-process step."""
    want_loss, want, want_params = one_process["train_dp"]
    for got_loss, got, params in (r["train dp"] for r in ranks):
        assert got_loss == pytest.approx(want_loss, rel=1e-5)
        assert got.keys() == want.keys()
        worst = max((_rel_l2(got[k], want[k]), k) for k in want)
        assert worst[0] <= GRAD_REL_L2, worst
        for k in want_params:
            torch.testing.assert_close(params[k], want_params[k], atol=1e-6, rtol=1e-5)
