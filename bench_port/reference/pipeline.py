"""MuseV text- and image-to-video as plain equations (predictor.py:356-750,
pipeline_controlnet.py).

One clip: the prompt pair through CLIP's text encoder; the condition frame,
either the VAE mean of a given image or a text-to-image run (the UNet at one
frame with its temporal layers skipped, Euler, CFG 7.5); for image-to-video
also the IP-Adapter tokens of that image and the ReferenceNet's features of
its latents; then Euler steps over the video latents, each step one UNet
call over every context window and both CFG halves, the windows' overlaps
averaged and the halves combined; last the VAE decode. Noise comes from the
run's CPU ``torch.Generator`` in MuseV's VideoFusion form, drawn in the
order MuseV draws it, so the same seed gives the same noise as the measured
program's. The hash tokenizer stands in for CLIP's BPE files, which the
repository does not hold.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .encoders import CLIPText, CLIPVision, ClipSizes, ImageProj, VAE, VAESizes
from .layers import GroupNorm, LayerNorm, Numerics, attach
from .unet import ReferenceNet, UNet3D, UNetSizes


def build(cfg: dict, numerics: Numerics, device="meta") -> Dict[str, torch.nn.Module]:
    """The modules of a configuration file's ``modules`` (their widths by
    name) on ``device`` (``meta``: shapes only), float32."""
    kinds = dict(unet=lambda s: UNet3D(UNetSizes(**s)), vae=lambda s: VAE(VAESizes(**s)),
                 text_encoder=lambda s: CLIPText(ClipSizes(**s)),
                 referencenet=lambda s: ReferenceNet(UNetSizes(**s)),
                 clip_vision=lambda s: CLIPVision(ClipSizes(**s)),
                 ip_proj=lambda s: ImageProj(**s))
    mods = {}
    with torch.device(device):
        for name, sizes in cfg["modules"].items():
            if name not in kinds:
                raise ValueError(f"the reference has no module {name!r}; it has {sorted(kinds)}")
            sizes = {k: tuple(v) if isinstance(v, list) else v for k, v in sizes.items()}
            mods[name] = kinds[name](sizes)
    for m in mods.values():
        attach(m.eval().requires_grad_(False), numerics)
    return mods


# -- tokens -----------------------------------------------------------------

def prompt_ids(prompts: Sequence[str], vocab: int = 49408, length: int = 77) -> np.ndarray:
    """One token per whitespace word, sha1-hashed into [1, vocab - 3], between
    the begin (vocab - 2) and end (vocab - 1) tokens, padded with the end
    token. Weighted prompts (brackets, colons) are refused."""
    bos, eos = vocab - 2, vocab - 1
    rows = []
    for p in prompts:
        if any(ch in p for ch in "()[]:\\"):
            raise ValueError(f"the reference takes unweighted prompts only: {p!r}")
        ids = [int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little") % (vocab - 3) + 1
               for w in p.lower().split()]
        if len(ids) > length - 2:
            raise ValueError(f"prompt of {len(ids)} words: at most {length - 2}")
        rows.append([bos] + ids + [eos] * (length - 1 - len(ids)))
    return np.asarray(rows, dtype=np.int64)


# -- noise, sigmas, windows -------------------------------------------------

def video_fusion_noise(gen: torch.Generator, shape: Sequence[int], w_ind: float = 0.5):
    """sqrt(1 - w) * (one draw shared over time) + sqrt(w) * (one per frame)."""
    common = torch.randn((shape[0], 1, *shape[2:]), generator=gen)
    ind = torch.randn(tuple(shape), generator=gen)
    return (1.0 - w_ind) ** 0.5 * common + w_ind ** 0.5 * ind


@dataclasses.dataclass(frozen=True)
class Euler:
    """Euler discrete over SD's scaled-linear betas (0.00085 .. 0.012, 1000
    steps), linspace timesteps, sigmas interpolated linearly, then 0."""

    steps: int

    def tables(self) -> Tuple[np.ndarray, np.ndarray]:
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        full = np.sqrt((1.0 - ac) / ac)
        ts = np.linspace(0, 999, self.steps, dtype=np.float64)[::-1].copy()
        sig = np.concatenate([np.interp(ts, np.arange(1000), full), [0.0]]).astype(np.float32)
        return ts.astype(np.float32), sig

    @property
    def init_sigma(self) -> float:
        return float(np.sqrt(self.tables()[1].max() ** 2 + 1))

    def scale(self, x: torch.Tensor, i: int) -> torch.Tensor:
        sigma = float(self.tables()[1][i])
        return x / float(np.float32(np.sqrt(sigma ** 2 + 1.0)))

    def step(self, eps: torch.Tensor, i: int, x: torch.Tensor) -> torch.Tensor:
        sig = self.tables()[1]
        sigma = float(sig[i])
        pred = x - sigma * eps
        return x + (x - pred) / sigma * (float(sig[i + 1]) - sigma)


def windows(num_frames: int, size: int, overlap: int) -> np.ndarray:
    """MuseV's ``uniform_v2`` context windows: a sliding window of ``size``
    frames with stride size - overlap, the last snapped to end at the last
    frame, a last window that ends where the one before it does dropped."""
    if num_frames <= size:
        return np.arange(num_frames)[None]
    wins = []
    for start in range(0, num_frames, size - overlap):
        if start + size > num_frames:
            wins.append(list(range(num_frames - size, num_frames)))
            break
        wins.append(list(range(start, start + size)))
    if len(wins) >= 2 and wins[-1][-1] == wins[-2][-1]:
        wins = wins[:-1]
    return np.asarray(wins)


# -- the clip ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClipArgs:
    """One clip's request, as the benchmark hands it to both sides."""

    prompt: str
    negative_prompt: str
    seed: int
    height: int = 576
    width: int = 576
    video_length: int = 24
    context_frames: int = 12
    context_overlap: int = 4
    video_steps: int = 10
    t2i_steps: int = 30
    video_guidance: float = 3.5
    t2i_guidance: float = 7.5
    w_ind_noise: float = 0.5
    img_weight: float = 1e-3
    motion_speed: float = 8.0
    condition_image: Optional[np.ndarray] = None  # (H, W, 3) uint8: image-to-video


def _cfg_denoise(unet: UNet3D, sched: Euler, lat: torch.Tensor, text_uc, text_c, guidance,
                 wins: np.ndarray, cond: Optional[torch.Tensor], unet_kw: dict,
                 use_temporal: bool) -> torch.Tensor:
    """Every step: one UNet call over [uncond windows; cond windows] (the
    condition frames spliced in front of each), the windows' overlaps
    averaged, the halves combined by ``guidance``, an Euler step."""
    b, t = lat.shape[:2]
    n_win, wlen = wins.shape
    flat = torch.as_tensor(wins.reshape(-1), device=lat.device)
    counts = torch.as_tensor(np.bincount(wins.reshape(-1), minlength=t), dtype=torch.float32,
                             device=lat.device)
    text = torch.cat([text_uc.repeat_interleave(n_win, 0), text_c.repeat_interleave(n_win, 0)])
    ts = sched.tables()[0]
    for i in range(sched.steps):
        win = sched.scale(lat, i)[:, flat].reshape(b * n_win, wlen, *lat.shape[2:])
        sample = torch.cat([win, win])
        n_vc = 0
        if cond is not None:
            n_vc = cond.shape[1]
            sample = torch.cat([torch.cat([cond.repeat_interleave(n_win, 0)] * 2), sample], 1)
        out = unet(sample, float(ts[i]), text, cond_index=tuple(range(n_vc)) if n_vc else None,
                   use_temporal=use_temporal, **unet_kw)[:, n_vc:]
        out = out.reshape(2, b, n_win * wlen, *lat.shape[2:])
        buf = out.new_zeros(2, b, t, *lat.shape[2:]).index_add_(2, flat, out)
        eps = buf / counts[None, None, :, None, None, None]
        lat = sched.step(eps[0] + guidance * (eps[1] - eps[0]), i, lat)
    return lat


def _halves(e: torch.Tensor, n_win: int) -> torch.Tensor:
    """(B, ...) repeated to both CFG halves' window rows."""
    return torch.cat([e.repeat_interleave(n_win, 0)] * 2)


@torch.no_grad()
def text2video(mods: Dict[str, torch.nn.Module], a: ClipArgs, device,
               decode_segment: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """One clip: (latents (1, 1 + T, h, w, 4), videos (1, 1 + T, H, W, 3) in
    [0, 1]), both float32 on ``device``; the condition frame first."""
    unet, vae = mods["unet"], mods["vae"]
    gen = torch.Generator().manual_seed(a.seed)
    vocab = mods["text_encoder"].text_model.embeddings.token_embedding.num_embeddings
    ids = torch.as_tensor(prompt_ids([a.prompt, a.negative_prompt], vocab), device=device)
    emb = mods["text_encoder"](ids)
    text_c, text_uc = emb[:1], emb[1:]
    h, w = a.height // 8, a.width // 8
    unet_kw: dict = dict(motion_speed=a.motion_speed)
    if a.condition_image is None:
        t2i = Euler(a.t2i_steps)
        lat = video_fusion_noise(gen, (1, 1, h, w, 4), a.w_ind_noise).to(device) * t2i.init_sigma
        cond = _cfg_denoise(unet, t2i, lat, text_uc, text_c, a.t2i_guidance, np.zeros((1, 1), int),
                            None, unet_kw, use_temporal=False)
    else:
        image = torch.as_tensor(a.condition_image, device=device)[None]  # (1, H, W, 3)
        cond = vae.encode(image.float() / 127.5 - 1.0)[:, None]  # (1, 1, h, w, 4)
        if "clip_vision" in mods:
            pooled = mods["clip_vision"](image)
            ip_c = mods["ip_proj"](pooled)
            ip_uc = mods["ip_proj"](torch.zeros_like(pooled))
            embs, mid = mods["referencenet"](cond[:, 0], ip_c)
            unet_kw.update(ip_tokens=torch.cat([ip_uc, ip_c]), refer_embs=embs,
                           mid_refer_emb=mid)
    wins = windows(a.video_length, a.context_frames, a.context_overlap)
    n_win = wins.shape[0]
    if "ip_tokens" in unet_kw:
        ip = unet_kw["ip_tokens"]
        unet_kw["ip_tokens"] = ip.reshape(2, 1, *ip.shape[1:]).repeat_interleave(n_win, 1) \
            .reshape(2 * n_win, *ip.shape[1:])
        unet_kw["refer_embs"] = [_halves(e, n_win) for e in unet_kw["refer_embs"]]
        unet_kw["mid_refer_emb"] = _halves(unet_kw["mid_refer_emb"], n_win)
    video = Euler(a.video_steps)
    noise = video_fusion_noise(gen, (1, a.video_length, h, w, 4), a.w_ind_noise).to(device)
    noise = a.img_weight ** 0.5 * cond.mean(dim=1, keepdim=True) + (1 - a.img_weight) ** 0.5 * noise
    lat = _cfg_denoise(unet, video, noise * video.init_sigma, text_uc, text_c, a.video_guidance,
                       wins, cond, unet_kw, use_temporal=True)
    latents = torch.cat([cond, lat], dim=1)
    frames = latents[0]
    pixels = torch.cat([vae.decode(frames[s:s + decode_segment])
                        for s in range(0, frames.shape[0], decode_segment)])
    videos = (pixels.clamp(-1, 1) + 1.0) / 2.0
    return latents, videos[None]


def load(mods: Dict[str, torch.nn.Module], weights: Dict[str, Dict[str, torch.Tensor]],
         device) -> None:
    """Give the meta-built modules the benchmark's weights, as float32 on
    ``device``."""
    for name, m in mods.items():
        sd = {k: v.to(device=device, dtype=torch.float32) for k, v in weights[name].items()}
        m.load_state_dict(sd, strict=True, assign=True)


def layout(cfg: dict) -> Dict[str, Dict[str, Tuple[Tuple[int, ...], bool]]]:
    """Every module's parameters: name -> (shape, whether it is a norm scale)."""
    out: Dict[str, Dict[str, Tuple[Tuple[int, ...], bool]]] = {}
    for name, m in build(cfg, Numerics()).items():
        scales = {f"{p}.weight" if p else "weight" for p, sub in m.named_modules()
                  if isinstance(sub, (GroupNorm, LayerNorm))}
        out[name] = {k: (tuple(v.shape), k in scales) for k, v in m.state_dict().items()}
    return out
