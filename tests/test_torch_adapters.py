"""The port's LoRA, textual inversion and LCM-LoRA against the JAX package's.

The same seeded numpy LoRA state dicts (kohya, peft and attn-procs
layouts) and embeddings go into the JAX package's param trees and into the
port's modules loaded from those trees by ``musev_torch.models.convert``.
Fused weights must agree within 1e-6 in float32 (numpy and torch may sum
the rank-r products in another order), the module counts and the unmatched
lists exactly. The loader is held against the JAX loader on one written
file set with a LoRA, an embedding and an LCM-LoRA. The whole slice:
a tiny ``musev`` denoise of three ``dpmpp_2m`` steps with a LoRA fused and
a textual-inversion trigger in the negative prompt, against the JAX
package at the tolerance of ``test_torch_pipeline.py`` (its only
``lax.scan`` compile; everything else here is eager or numpy).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as stn
import torch

from musev_tpu.cli.text2video import _shrink_preset as j_shrink
from musev_tpu.configs.model_registry import get_model_preset as j_preset
from musev_tpu.models import lora as jlora
from musev_tpu.models import sd_weights as jsw
from musev_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from musev_tpu.models.clip_text import init_clip_text
from musev_tpu.models.unet3d import UNet3DConfig as JUNetConfig
from musev_tpu.models.unet3d import init_unet3d
from musev_tpu.ops.context import make_window_plan as j_plan
from musev_tpu.pipelines import denoiser as jden
from musev_tpu.pipelines import loader as jloader
from musev_tpu.pipelines.pipeline import MusevModels as JModels
from musev_tpu.pipelines.pipeline import MusevPipeline as JPipeline
from musev_tpu.schedulers import create_scheduler as j_create
from musev_tpu.utils import text_emb as j_text_emb
from musev_tpu.utils import textual_inversion as jti
from musev_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from musev_torch.cli.text2video import _shrink_preset
from musev_torch.configs.model_registry import get_model_preset
from musev_torch.models import convert, lora
from musev_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from musev_torch.models.unet3d import UNet3D, UNet3DConfig
from musev_torch.ops.context import make_window_plan
from musev_torch.pipelines import denoiser, loader
from musev_torch.pipelines.loader import build_models
from musev_torch.pipelines.pipeline import MusevModels, MusevPipeline
from musev_torch.schedulers import create_scheduler
from musev_torch.utils import text_emb
from musev_torch.utils import textual_inversion as ti
from musev_torch.utils.tokenizer import HashTokenizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: torch's OpenMP pool spun
    against the suite's other xdist workers. Restored after, as the setting
    is the process's and JAX shares it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TINY_UNET = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                 cross_attention_dim=24, attention_heads=4, norm_num_groups=8)
TINY_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=2, num_heads=4,
                 intermediate_size=48)
LOOP_TOL = dict(rtol=1e-3, atol=1e-3)  # test_torch_pipeline.py's
FUSE_ATOL = 1e-6
RANK = 4
ATTN = "down_blocks.0.attentions.0.transformer_blocks.0"
# LoRA targets: spatial and temporal attention, a 1x1 and a 3x3 conv, a linear
UNET_SITES = (f"{ATTN}.attn1.to_q", f"{ATTN}.attn2.to_k", f"{ATTN}.attn1.to_out.0",
              "down_blocks.0.temp_attentions.0.transformer_blocks.0.attn1.to_v",
              "mid_block.attentions.0.proj_in", "up_blocks.1.resnets.0.conv1",
              "time_embedding.linear_1")
TEXT_SITES = ("text_model.encoder.layers.0.self_attn.q_proj", "text_model.encoder.layers.1.mlp.fc1")
LAYOUTS = ("kohya", "peft", "attn_procs")


def _factors(rng, weight_shape):
    """Seeded (down, up) for a weight of torch shape (out, in[, kh, kw])."""
    out, inn = weight_shape[:2]
    if len(weight_shape) == 4:
        down = rng.standard_normal((RANK, inn, *weight_shape[2:]), dtype=np.float32) * 0.1
        return down, rng.standard_normal((out, RANK, 1, 1), dtype=np.float32) * 0.1
    return (rng.standard_normal((RANK, inn), dtype=np.float32) * 0.1,
            rng.standard_normal((out, RANK), dtype=np.float32) * 0.1)


def make_lora(unet, text, layout, seed=0, unet_sites=UNET_SITES, text_sites=TEXT_SITES):
    """A LoRA state dict over the given sites of ``unet`` / ``text`` (port
    modules, for the shapes) in one of the three layouts, with the names
    each layout leaves unmatched."""
    rng = np.random.default_rng(seed)
    sd = {}
    shapes = {("unet", tk): tuple(unet.get_parameter(f"{tk}.weight").shape) for tk in unet_sites}
    shapes.update({("text", tk): tuple(text.get_parameter(f"{tk}.weight").shape)
                   for tk in text_sites})
    for (net, tk), shape in shapes.items():
        down, up = _factors(rng, shape)
        if layout == "kohya":
            key = ("lora_unet_" if net == "unet" else "lora_te_") + tk.replace(".", "_")
            sd.update({f"{key}.lora_down.weight": down, f"{key}.lora_up.weight": up,
                       f"{key}.alpha": np.array(RANK / 2, np.float32)})
        elif layout == "peft":
            key = ("unet." if net == "unet" else "text_encoder.") + tk
            sd.update({f"{key}.lora_A.default.weight": down, f"{key}.lora_B.default.weight": up})
        elif net == "unet" and ".attn" in tk:  # attn-procs: attention projections only
            attn, proj = tk.split(".to_")
            proj = proj.split(".")[0]
            key = f"unet.{attn}.processor.to_{proj}_lora"
            sd.update({f"{key}.down.weight": down, f"{key}.up.weight": up})
    if layout == "kohya":  # unknown module, and a module without its up factor
        sd["lora_unet_no_such_block.lora_down.weight"] = np.zeros((RANK, 16), np.float32)
        sd["lora_unet_no_such_block.lora_up.weight"] = np.zeros((16, RANK), np.float32)
        sd["lora_te_text_model_encoder_layers_0_mlp_fc2.lora_down.weight"] = \
            np.zeros((RANK, 48), np.float32)
    return sd


@pytest.fixture(scope="module")
def tiny():
    """JAX params of a tiny UNet and CLIP, and port modules loaded from them."""
    k = jax.random.PRNGKey(0)
    jp = dict(unet=init_unet3d(jax.random.fold_in(k, 0), JUNetConfig(**TINY_UNET)),
              text=init_clip_text(jax.random.fold_in(k, 2), JCLIPConfig(**TINY_CLIP)))
    unet, clip = UNet3D(UNet3DConfig(**TINY_UNET)), CLIPTextModel(CLIPTextConfig(**TINY_CLIP))
    unet.load_state_dict(convert.unet3d_from_jax(jp["unet"], unet.cfg), strict=True)
    clip.load_state_dict(convert.clip_text_from_jax(jp["text"], clip.cfg), strict=True)
    return jp, unet.eval(), clip.eval()


def _copy_tree(params):
    return jax.tree_util.tree_map(lambda x: x, params)


def _assert_modules_equal_jax(unet, clip, jp_unet, jp_text, atol=FUSE_ATOL):
    for module, want in ((unet, convert.unet3d_from_jax(jp_unet, unet.cfg)),
                         (clip, convert.clip_text_from_jax(jp_text, clip.cfg))):
        got = module.state_dict()
        assert set(got) == set(want)
        for key, v in want.items():
            torch.testing.assert_close(got[key], v, rtol=0, atol=atol, msg=key)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_parse_kohya_lora_matches_jax(tiny, layout):
    _, unet, clip = tiny
    sd = make_lora(unet, clip, layout)
    got, want = lora.parse_kohya_lora(sd), jlora.parse_kohya_lora(sd)
    assert list(got) == list(want)
    for mod, entry in want.items():
        assert sorted(got[mod]) == sorted(entry), mod
        for part, v in entry.items():
            np.testing.assert_array_equal(got[mod][part].numpy(), v)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_fuse_and_unfuse_match_jax(tiny, layout):
    """Counts, the unmatched list and every weight after the fuse at 0.8 and
    after the unfuse at -0.8, in float32."""
    jp, unet0, clip0 = tiny
    unet, clip = copy.deepcopy(unet0), copy.deepcopy(clip0)
    j_unet, j_text = _copy_tree(jp["unet"]), _copy_tree(jp["text"])
    sd = make_lora(unet, clip, layout)
    for scale in (0.8, -0.8):
        want = jlora.fuse_lora(j_unet, JUNetConfig(**TINY_UNET), sd, scale=scale,
                               text_params=j_text, text_cfg=JCLIPConfig(**TINY_CLIP))
        got = lora.fuse_lora(unet, sd, scale=scale, text_encoder=clip)
        assert got == want
        _assert_modules_equal_jax(unet, clip, j_unet, j_text)
    n, unmatched = got
    if layout == "kohya":
        assert n == len(UNET_SITES) + len(TEXT_SITES) and len(unmatched) == 2
    if layout == "attn_procs":  # the JAX parser's to_out name misses to_out.0
        assert n == 3 and unmatched == [f"unet.{ATTN}.attn1.to_out"]
    # the unfuse restores the weights within float32 rounding
    for a, b in zip(unet.parameters(), unet0.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=FUSE_ATOL)


def test_fuse_rounds_once_to_the_weight_dtype(tiny):
    """In bf16 a fused weight is bf16(float32(W) + s * delta), bit for bit on
    the CPU, and the unfuse comes back within its two roundings: half a bf16
    ulp of the fused weight and half of the restored one."""
    _, unet0, clip0 = tiny
    unet, clip = copy.deepcopy(unet0).to(torch.bfloat16), copy.deepcopy(clip0).to(torch.bfloat16)
    sd = make_lora(unet, clip, "kohya")
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    lora.fuse_lora(unet, sd, scale=0.8, text_encoder=clip)
    entries = lora.parse_kohya_lora(sd)
    for tk in UNET_SITES:
        w0 = before[f"{tk}.weight"]
        d = lora._delta(entries["lora_unet_" + tk.replace(".", "_")], "cpu").reshape(w0.shape)
        want = (w0.float() + 0.8 * d).to(torch.bfloat16)
        assert torch.equal(unet.get_parameter(f"{tk}.weight"), want), tk
    fused = {tk: unet.get_parameter(f"{tk}.weight").detach().float() for tk in UNET_SITES}
    lora.fuse_lora(unet, sd, scale=-0.8, text_encoder=clip)

    def ulp(x):
        return torch.finfo(torch.bfloat16).eps * torch.exp2(torch.floor(torch.log2(x.abs())))

    for tk in UNET_SITES:
        w0, w = before[f"{tk}.weight"].float(), unet.get_parameter(f"{tk}.weight").detach().float()
        assert ((w - w0).abs() <= 0.5 * (ulp(fused[tk]) + ulp(w))).all(), tk


def _inversion_pair(tiny, n_vectors=2):
    jp, _, clip0 = tiny
    emb = np.random.default_rng(5).standard_normal((n_vectors, 24), dtype=np.float32)
    j_text = _copy_tree(jp["text"])
    j_tok = jti.InversionTokenizer(JHashTokenizer(vocab_size=1000))
    jti.add_textual_inversion(j_text, j_tok, "badhandv4", emb)
    clip = copy.deepcopy(clip0)
    tok = ti.InversionTokenizer(HashTokenizer(vocab_size=1000))
    ti.add_textual_inversion(clip, tok, "badhandv4", emb)
    return emb, (j_text, j_tok), (clip, tok)


PROMPTS = ("a cat, badhandv4 walking", "(badhandv4:1.2), [blurry], (worst quality:2)",
           "badhandv4,bad hands", "no trigger here")


def test_inversion_tokenizer_and_encoding_match_jax(tiny):
    """Ids and weights of the weighted-prompt parser equal JAX's, a trigger
    inside a weighted span included; the table's new rows are the file's;
    the encoded prompts agree."""
    emb, (j_text, j_tok), (clip, tok) = _inversion_pair(tiny)
    table = clip.text_model.embeddings.token_embedding
    assert table.num_embeddings == 1002 == j_text["token_embedding"].shape[0]
    assert torch.equal(table.weight[1000:], torch.from_numpy(emb))
    for p in PROMPTS:
        assert tok.encode(p) == j_tok.encode(p)
        assert text_emb._tokens_with_weights(tok, p, 225) == \
            j_text_emb._tokens_with_weights(j_tok, p, 225)
    ids, weights = text_emb._tokens_with_weights(tok, PROMPTS[1], 225)
    assert ids[:2] == [1000, 1001] and weights[:2] == pytest.approx([1.2, 1.2])

    from musev_tpu.models.clip_text import clip_text_encode as j_encode
    from musev_torch.models.clip_text import clip_text_encode

    cfg = JCLIPConfig(**TINY_CLIP)
    want = j_text_emb.encode_weighted_prompt(j_tok, lambda i: j_encode(j_text, cfg, i), PROMPTS)
    with torch.no_grad():
        got = text_emb.encode_weighted_prompt(
            tok, lambda i: clip_text_encode(clip, torch.as_tensor(i)), PROMPTS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("layout", ["emb_params", "string_to_param", "single_tensor"])
def test_load_inversion_state_dict_layouts(layout):
    emb = np.random.default_rng(1).standard_normal((3, 8), dtype=np.float32)
    sd = {"emb_params": {"emb_params": emb},
          "string_to_param": {"string_to_param": {"*": emb}, "name": "badhandv4"},
          "single_tensor": {"v": emb[0]}}[layout]
    got, want = ti.load_inversion_state_dict(sd), jti.load_inversion_state_dict(sd)
    assert got.shape == want.shape == ((1, 8) if layout == "single_tensor" else (3, 8))
    np.testing.assert_array_equal(got.numpy(), want)


def test_split_path_arg_and_scale_match_jax(tmp_path):
    colon = tmp_path / "a:b.safetensors"
    colon.write_bytes(b"")
    for spec in ("lora.safetensors", "lora.safetensors:0.5", "lora.safetensors=0.5",
                 "/my:path/lora.safetensors=0.8", str(colon), "emb.pt:badhandv4"):
        assert loader._split_path_arg(spec) == jloader._split_path_arg(spec)
    assert loader._parse_scale(None, "x") == jloader._parse_scale(None, "x") == 1.0
    with pytest.raises(ValueError, match="'=' form"):
        loader._parse_scale("strong", "lora:strong")


# -- the loader from files --------------------------------------------------


def _write_adapter_set(d):
    """A tiny musev file set from a JAX donor, plus a kohya LoRA, an
    embedding and a peft LCM-LoRA over the tiny preset's shapes."""
    jp = j_shrink(j_preset("musev"))
    donor = jloader.build_models(jp, seed=7)
    tp = _shrink_preset(get_model_preset("musev"))
    unet, clip = UNet3D(tp.unet_cfg), CLIPTextModel(tp.text_cfg)

    def f32(sd):
        return {k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in sd.items()}

    p = {name: str(d / name) for name in ("unet.safetensors", "vae.safetensors",
                                          "text.safetensors", "style.safetensors",
                                          "badhandv4.safetensors", "lcm.safetensors")}
    stn.save_file(f32(jsw.export_unet3d(donor.unet_params, jp.unet_cfg)), p["unet.safetensors"])
    stn.save_file(f32(jsw.export_state_dict(jsw.vae_key_map(jp.vae_cfg), donor.vae_params)),
                  p["vae.safetensors"])
    stn.save_file(f32(jsw.export_state_dict(jsw.clip_text_key_map(jp.text_cfg),
                                            donor.text_params)), p["text.safetensors"])
    stn.save_file(make_lora(unet, clip, "kohya", seed=1), p["style.safetensors"])
    emb = np.random.default_rng(2).standard_normal((2, tp.text_cfg.hidden_size), dtype=np.float32)
    stn.save_file({"emb_params": emb}, p["badhandv4.safetensors"])
    stn.save_file(make_lora(unet, clip, "peft", seed=3, text_sites=()), p["lcm.safetensors"])
    return p


def _with_files(preset, p, **adapters):
    preset.unet_checkpoint = p["unet.safetensors"]
    preset.vae_checkpoint = p["vae.safetensors"]
    preset.text_checkpoint = p["text.safetensors"]
    for k, v in adapters.items():
        setattr(preset, k, v)
    return preset


@pytest.fixture(scope="module")
def adapter_files(tmp_path_factory):
    return _write_adapter_set(tmp_path_factory.mktemp("adapters"))


def test_loader_with_adapters_matches_jax_loader(adapter_files):
    """A LoRA at 0.8, an embedding and an LCM-LoRA at 0.5 through both
    loaders: the UNet and text encoder within 1e-6 of the JAX params, the
    grown table and the trigger's ids equal; the pipeline's adapter methods
    on the plain models give the same weights, and unload_lora undoes the
    LoRAs within float32 rounding."""
    p = adapter_files
    adapters = dict(lora_checkpoints=[p["style.safetensors"] + ":0.8"],
                    textual_inversion_checkpoints=[p["badhandv4.safetensors"]],
                    lcm_lora_checkpoint=p["lcm.safetensors"], lcm_lora_scale=0.5)
    jp = _with_files(j_shrink(j_preset("musev")), p, **adapters)
    jm = jloader.build_models(jp, seed=3, strict=True)
    tm = build_models(_with_files(_shrink_preset(get_model_preset("musev")), p, **adapters),
                      device="cpu", seed=5, strict=True)
    _assert_modules_equal_jax(tm.unet, tm.text_encoder, jm.unet_params, jm.text_params)
    assert tm.text_encoder.text_model.embeddings.token_embedding.num_embeddings == 1002
    for prompt in PROMPTS:
        assert tm.tokenizer.encode(prompt) == jm.tokenizer.encode(prompt)

    plain = build_models(_with_files(_shrink_preset(get_model_preset("musev")), p),
                         device="cpu", strict=True)
    before = {k: v.clone() for k, v in plain.unet.state_dict().items()}
    pipe = MusevPipeline(plain)
    pipe.load_textual_inversion(p["badhandv4.safetensors"])
    assert pipe.load_lora(p["style.safetensors"], 0.8) == len(UNET_SITES) + len(TEXT_SITES)
    pipe.enable_lcm(p["lcm.safetensors"], scale=0.5)
    assert pipe.scheduler_name == "lcm"
    for module in ("unet", "text_encoder"):
        want = getattr(tm, module).state_dict()
        for k, v in getattr(plain, module).state_dict().items():
            assert torch.equal(v, want[k]), k
    assert plain.tokenizer.encode(PROMPTS[1]) == tm.tokenizer.encode(PROMPTS[1])
    pipe.unload_lora()
    for k, v in plain.unet.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=FUSE_ATOL, msg=k)


@pytest.mark.parametrize("field", ["lora_checkpoints", "textual_inversion_checkpoints",
                                   "lcm_lora_checkpoint"])
def test_missing_adapter_file_raises_before_weights_are_drawn(monkeypatch, tmp_path, field):
    """The JAX loader logs a missing adapter file and goes on without it;
    the port refuses, before any weight is drawn."""
    def drawn(*a, **k):
        raise AssertionError("weights were drawn")

    monkeypatch.setattr(loader, "init_random_", drawn)
    absent = str(tmp_path / "absent.safetensors")
    value = absent if field == "lcm_lora_checkpoint" else [absent + ":0.5"]
    preset = _shrink_preset(get_model_preset("musev", **{field: value}))
    with pytest.raises(FileNotFoundError, match="absent.safetensors"):
        build_models(preset, device="cpu")


# -- the whole slice --------------------------------------------------------


def test_dpmpp_2m_denoise_with_lora_and_inversion_matches_jax(tiny):
    """Prompt pair through the weighted encoder with a trigger in the
    negative prompt, then three dpmpp_2m steps over 6 frames in 2 windows
    of 4 overlapping by 2, one condition frame, CFG; LoRA fused into the
    UNet and the text encoder."""
    jp, unet0, clip0 = tiny
    emb, (j_text, j_tok), (clip, tok) = _inversion_pair(tiny)
    unet = copy.deepcopy(unet0)
    j_unet = _copy_tree(jp["unet"])
    sd = make_lora(unet, clip, "kohya", seed=4)
    jcfg = JUNetConfig(**TINY_UNET)
    assert jlora.fuse_lora(j_unet, jcfg, sd, scale=0.7, text_params=j_text,
                           text_cfg=JCLIPConfig(**TINY_CLIP)) == \
        lora.fuse_lora(unet, sd, scale=0.7, text_encoder=clip)

    prompt, negative = ["a cat walking"], ["(badhandv4:1.2), bad quality"]
    jmodels = JModels(unet_params=j_unet, unet_cfg=jcfg, vae_params=None, vae_cfg=None,
                      text_params=j_text, text_cfg=JCLIPConfig(**TINY_CLIP), tokenizer=j_tok)
    j_c, j_uc = JPipeline(jmodels).encode_prompt_pair(prompt, negative)
    port = MusevModels(unet=unet, vae=None, text_encoder=clip, tokenizer=tok)
    with torch.no_grad():
        t_c, t_uc = MusevPipeline(port).encode_prompt_pair(prompt, negative)
    np.testing.assert_allclose(t_uc.numpy(), np.asarray(j_uc), rtol=1e-5, atol=1e-5)

    rng = np.random.default_rng(0)
    latents = rng.standard_normal((1, 6, 4, 4, 4), dtype=np.float32) * 14.6
    cond = rng.standard_normal((1, 1, 4, 4, 4), dtype=np.float32)
    guidance = np.full((3,), 3.5, np.float32)
    jspec = jden.DenoiseSpec(unet_cfg=jcfg, scheduler=j_create("dpmpp_2m", 3),
                             plan=j_plan(6, 4, 2), guidance=guidance, n_vision_cond=1)
    want = jden.denoise_loop(j_unet, jspec, jnp.asarray(latents), j_uc, j_c,
                             jax.random.PRNGKey(0), condition_latents=jnp.asarray(cond))
    spec = denoiser.DenoiseSpec(unet_cfg=unet.cfg, scheduler=create_scheduler("dpmpp_2m", 3),
                                plan=make_window_plan(6, 4, 2), guidance=guidance,
                                n_vision_cond=1)
    with torch.no_grad():
        got = denoiser.denoise_loop(unet, spec, torch.from_numpy(latents), t_uc, t_c,
                                    condition_latents=torch.from_numpy(cond))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOOP_TOL)
