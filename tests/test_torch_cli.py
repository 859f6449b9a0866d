"""The port's CLIs, task files and prompt templates against the JAX package's.

Nothing of JAX runs: the JAX CLIs' ``parse_args`` and the pure-Python task
and prompt modules are compared directly. The CLIs run on the CPU at tiny
size (``--tiny --device cpu``), their frames captured where they would be
written and held against ``MusevPipeline`` called directly on the same
models; float32 on the CPU is deterministic, so they must agree bit for bit.
"""

import hashlib

import numpy as np
import pytest
import safetensors.torch as stt
import torch

from musev_tpu.autoprompt import generate_prompts as j_generate_prompts
from musev_tpu.cli import text2video as j_t2v
from musev_tpu.cli import video2video as j_v2v
from musev_tpu.configs.tasks import load_tasks as j_load_tasks
from musev_torch.autoprompt import generate_prompts
from musev_torch.cli import text2video as t2v
from musev_torch.cli import video2video as v2v
from musev_torch.configs.model_registry import get_model_preset, resolve_negative_prompt
from musev_torch.configs.tasks import load_tasks
from musev_torch.io.video import VideoReader, native_available, write_video
from musev_torch.pipelines import loader
from musev_torch.pipelines.loader import build_models, resolve_dtype
from musev_torch.pipelines.pipeline import MusevPipeline

EXAMPLE_YAML = "configs/tasks/example.yaml"
ONNX_ENV = ("MUSEV_DWPOSE_DET", "MUSEV_DWPOSE_POSE", "MUSEV_SAM_ENCODER", "MUSEV_SAM_DECODER",
            "MUSEV_FACE_DET")
TINY_RUN = ["--tiny", "--device", "cpu", "--time_size", "4", "--context_frames", "4",
            "--context_overlap", "0", "--num_inference_steps", "2",
            "--video_num_inference_steps", "2", "--seed", "5", "--fps", "4"]


@pytest.fixture(autouse=True)
def _no_onnx_env(monkeypatch):
    for name in ONNX_ENV:  # the JAX CLI's ONNX flags default to these
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("port,jax,added", [(t2v, j_t2v, {"device"}),
                                            (v2v, j_v2v, {"device", "tiny"})])
def test_parse_args_defaults_match_the_jax_cli(port, jax, added):
    """Every shared flag has the JAX default but ``--dtype``, whose default
    is the port's own choice (None: bf16 on CUDA, float32 on the CPU)."""
    got = vars(port.parse_args(["--test_data_path", "t.yaml"]))
    want = vars(jax.parse_args(["--test_data_path", "t.yaml"]))
    assert set(got) - set(want) == added and set(want) <= set(got)
    changed = {k for k in want if got[k] != want[k]}
    assert changed == {"dtype"} and got["dtype"] is None and want["dtype"] == "float32"


def test_dtype_default_and_refusal():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_dtype(cpu, None) == torch.float32
    assert resolve_dtype(cuda, None) == torch.bfloat16
    assert resolve_dtype(cpu, torch.bfloat16) == torch.bfloat16
    with pytest.raises(ValueError, match="bfloat16"):
        resolve_dtype(cuda, torch.float32)


def _csv(path):
    path.write_text(
        "name,prompt,hair,height,img_length_ratio,ipadapter_image,refer_image\n"
        "plain,a cat walking in a garden,,256,1.0,,\n"
        "braces,\"a girl, {hair}\",black|red,320,0.9,cond.png,${.ipadapter_image}\n"
        "portrait,{},blond,256,1.0,,\n"
    )
    return str(path)


@pytest.mark.parametrize("source", ["yaml", "csv"])
def test_tasks_and_prompts_match_jax(tmp_path, source):
    path = EXAMPLE_YAML if source == "yaml" else _csv(tmp_path / "tasks.csv")
    tasks = load_tasks(path)
    assert tasks == j_load_tasks(path) and len(tasks) >= 3
    assert generate_prompts(tasks) == j_generate_prompts(j_load_tasks(path))
    if source == "csv":
        assert tasks[1]["refer_image"] == "cond.png"
        assert [t["prompt"] for t in generate_prompts(tasks)[1:3]] == [
            "a girl, black hair", "a girl, red hair"]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny musev checkpoint set written from the port's own seeded modules."""
    d = tmp_path_factory.mktemp("ckpts")
    donor = build_models(t2v._shrink_preset(get_model_preset("musev")), device="cpu", seed=1)
    paths = {}
    for slot, module in (("unet", donor.unet), ("vae", donor.vae), ("text", donor.text_encoder)):
        paths[slot] = str(d / f"{slot}.safetensors")
        stt.save_file({k: v.contiguous() for k, v in module.state_dict().items()}, paths[slot])
    return paths


@pytest.fixture
def captured(monkeypatch):
    """Frames the CLIs hand to ``write_video``, by output path."""
    frames = {}
    monkeypatch.setattr(t2v, "native_available", lambda: True)
    monkeypatch.setattr(t2v, "write_video", lambda path, f, fps: frames.__setitem__(path, f))
    return frames


def test_text2video_cli_equals_the_pipeline(tmp_path, checkpoints, captured):
    (tmp_path / "tasks.csv").write_text("name,prompt\ncat,a cat walking\n")
    out = tmp_path / "out"
    written = t2v.main(["--test_data_path", str(tmp_path / "tasks.csv"), "--output_dir", str(out),
                        "--height", "64", "--width", "64", "--strict_checkpoints",
                        "--unet_checkpoint", checkpoints["unet"],
                        "--vae_checkpoint", checkpoints["vae"],
                        "--text_checkpoint", checkpoints["text"], *TINY_RUN])
    sig = hashlib.md5(b"a cat walking").hexdigest()[:4]
    name = f"musev_cat_w=64_h=64_t=4_nb=1_s=5_p={sig}_w=0.001_ms=8.0_g=3.5_wi=0.5.mp4"
    assert written == [str(out / name)] and list(captured) == written

    preset = t2v._shrink_preset(get_model_preset(
        "musev", unet_checkpoint=checkpoints["unet"], vae_checkpoint=checkpoints["vae"],
        text_checkpoint=checkpoints["text"]))
    res = MusevPipeline(build_models(preset, device="cpu", strict=True)).text2video(
        "a cat walking", resolve_negative_prompt("V2"), height=64, width=64, video_length=4,
        context_frames=4, context_overlap=0, num_inference_steps=2,
        video_num_inference_steps=2, seed=5)
    want = (res.videos[0] * 255).astype(np.uint8)
    assert captured[written[0]].shape == (5, 64, 64, 3)
    np.testing.assert_array_equal(captured[written[0]], want)


def test_video2video_cli_on_a_pose_video(tmp_path, captured):
    if not native_available():
        pytest.skip("native video library unavailable: the CLI reads the video through it")
    pose = np.random.default_rng(0).integers(0, 256, (6, 64, 64, 3), dtype=np.uint8)
    write_video(str(tmp_path / "pose.mp4"), pose, fps=12)
    with VideoReader(str(tmp_path / "pose.mp4")) as r:
        source = r.read(0, 6)
    (tmp_path / "tasks.csv").write_text(
        f"name,prompt,video_path\ndance,a dancer,{tmp_path / 'pose.mp4'}\nno_video,skipped,\n")
    written = v2v.main(["--test_data_path", str(tmp_path / "tasks.csv"),
                        "--output_dir", str(tmp_path / "out"), "--video_is_middle",
                        "--controlnet_name", "none", *TINY_RUN])
    assert written == [str(tmp_path / "out" / "musev_referencenet_pose_dance_w=64_h=64_t=4_s=5.mp4")]

    preset = t2v._shrink_preset(get_model_preset("musev_referencenet_pose"))
    res = MusevPipeline(build_models(preset, device="cpu")).video2video(
        "a dancer", source, resolve_negative_prompt("V2"), video_is_middle=True, time_size=4,
        context_frames=4, context_overlap=0, num_inference_steps=2,
        video_num_inference_steps=2, seed=5)
    got = captured[written[0]]
    assert got.shape == (7, 64, 64, 3)  # the condition frame and 6 source frames
    np.testing.assert_array_equal(got, (res.videos[0] * 255).astype(np.uint8))


# (the case's position in the list before the adapter flags and --scheduler
# were ported: the test ids keep it, cli, flags, what the error names)
_REFUSED = [
    (0, t2v, ["--parallel", "fp"], "item 15"),
    (5, t2v, ["--face_det_onnx", "det.onnx", "--face_rec_onnx", "rec.onnx"], "item 12"),
    (6, t2v, ["--face_rec_onnx", "rec.onnx"], "item 12"),
    (7, t2v, ["--ip_adapter_face_checkpoint", "face.bin"], "item 9"),
    (9, v2v, ["--processor_onnx", "depth=midas.onnx"], "item 12"),
    (10, v2v, ["--dwpose_det_onnx", "det.onnx", "--dwpose_pose_onnx", "pose.onnx"], "item 12"),
    (11, v2v, ["--sam_encoder_onnx", "enc.onnx", "--sam_decoder_onnx", "dec.onnx"], "item 12"),
    (12, v2v, ["--face_detector_onnx", "face.onnx"], "item 12"),
    (13, v2v, ["--controlnet_name", "dwpose_body_hand"], "item 12"),
    (14, v2v, ["--parallel", "dp"], "item 15"),
]


@pytest.mark.parametrize("cli,flags,match", [
    pytest.param(cli, flags, match, id=f"{cli.__name__}-flags{i}-{match}")
    for i, cli, flags, match in _REFUSED])
def test_refused_flags_raise_before_models_are_built(monkeypatch, tmp_path, cli, flags, match):
    def built(*a, **k):
        raise AssertionError("models were built")

    monkeypatch.setattr(loader, "build_models", built)
    (tmp_path / "tasks.csv").write_text("name,prompt\ncat,a cat\n")
    with pytest.raises(NotImplementedError, match=match):
        cli.main(["--test_data_path", str(tmp_path / "tasks.csv"), "--device", "cpu", *flags])


@pytest.fixture(scope="module")
def adapter_files(tmp_path_factory):
    """A kohya LoRA over two UNet attention projections and a CLIP MLP, an
    LCM-LoRA over the same UNet sites, and a 2-vector embedding, at the
    tiny preset's shapes."""
    d = tmp_path_factory.mktemp("adapters")
    preset = t2v._shrink_preset(get_model_preset("musev"))
    shapes = {
        "lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q": (16, 16),
        "lora_unet_mid_block_attentions_0_transformer_blocks_0_attn2_to_v": (32, 32),
        "lora_te_text_model_encoder_layers_0_mlp_fc1": (64, 32),
    }
    rng = np.random.default_rng(0)
    paths = {}
    for name, keys in (("style", shapes), ("lcm", list(shapes)[:2])):
        sd = {}
        for key in keys:
            out, inn = shapes[key]
            sd[f"{key}.lora_down.weight"] = torch.from_numpy(
                rng.standard_normal((4, inn), dtype=np.float32))
            sd[f"{key}.lora_up.weight"] = torch.from_numpy(
                rng.standard_normal((out, 4), dtype=np.float32) * 0.1)
        paths[name] = str(d / f"{name}.safetensors")
        stt.save_file(sd, paths[name])
    paths["emb"] = str(d / "badhandv4.safetensors")
    stt.save_file({"emb_params": torch.from_numpy(rng.standard_normal(
        (2, preset.text_cfg.hidden_size), dtype=np.float32))}, paths["emb"])
    return paths


# (cli, flags with {file} placeholders, the scheduler, the adapters as
# pipeline calls: ("lora", file, scale) / ("ti", file) / ("lcm", file))
_WORKING = [
    (t2v, ["--lora_path", "{style}:0.5"], "euler", [("lora", "style", 0.5)]),
    (t2v, ["--textual_inversion", "{emb}"], "euler", [("ti", "emb")]),
    (t2v, ["--lcm_lora_path", "{lcm}"], "lcm", [("lcm", "lcm")]),
    (t2v, ["--lcm"], "lcm", []),
    (t2v, ["--scheduler", "ddim"], "ddim", []),
    (v2v, ["--lora_path", "{style}"], "euler", [("lora", "style", 1.0)]),
    (v2v, ["--lcm"], "lcm", []),
]


@pytest.mark.parametrize("cli,flags,scheduler,adapters", _WORKING,
                         ids=[f"{c.__name__.split('.')[-1]}-{' '.join(f)}" for c, f, _, _ in _WORKING])
def test_adapter_and_scheduler_flags_reach_the_pipeline(monkeypatch, tmp_path, adapter_files,
                                                        captured, cli, flags, scheduler, adapters):
    """The CLI's pipeline has the scheduler and weights of ``MusevPipeline``
    given the same adapters by its own methods on the same seed's models;
    the text2video CLI's clip equals that pipeline's (the video2video CLI's
    task has no video, so it builds the models and writes nothing)."""
    made = []
    real_init = MusevPipeline.__init__

    def record(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(MusevPipeline, "__init__", record)
    (tmp_path / "tasks.csv").write_text("name,prompt\ncat,a cat walking\n")
    argv = ["--test_data_path", str(tmp_path / "tasks.csv"), "--output_dir", str(tmp_path / "out"),
            "--negative_prompt", "V3", "--height", "64", "--width", "64", *TINY_RUN,
            *[f.format(**adapter_files) for f in flags]]
    if cli is v2v:
        argv += ["--video_is_middle", "--controlnet_name", "none"]
    written = cli.main(argv)
    (pipe,) = made
    assert pipe.scheduler_name == scheduler

    model = "musev" if cli is t2v else "musev_referencenet_pose"
    want = MusevPipeline(build_models(t2v._shrink_preset(get_model_preset(model)), device="cpu"))
    for kind, name, *scale in adapters:
        if kind == "lora":
            want.load_lora(adapter_files[name], *scale)
        elif kind == "ti":
            want.load_textual_inversion(adapter_files[name])
        else:
            want.enable_lcm(adapter_files[name])
    want.scheduler_name = scheduler
    for module in ("unet", "text_encoder"):
        ref = getattr(want.m, module).state_dict()
        for k, v in getattr(pipe.m, module).state_dict().items():
            assert torch.equal(v, ref[k]), k
    negative = resolve_negative_prompt("V3")
    assert pipe.m.tokenizer.encode(negative) == want.m.tokenizer.encode(negative)
    if cli is v2v:
        assert written == []
        return
    res = want.text2video("a cat walking", negative, height=64, width=64, video_length=4,
                          context_frames=4, context_overlap=0, num_inference_steps=2,
                          video_num_inference_steps=2, seed=5)
    np.testing.assert_array_equal(captured[written[0]], (res.videos[0] * 255).astype(np.uint8))
