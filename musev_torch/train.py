"""Diffusion training for the 3D UNet (counterpart of ``musev_tpu/train.py``).

Epsilon-prediction MSE with the video-fusion noise decomposition: the first
``n_vision_cond`` frames of a clip are the clean vision condition, the rest
are noised at a random timestep and predicted. ``train_step`` takes one SGD
step; ``make_optimizer`` and ``train_step_opt`` give the AdamW (with
global-norm clipping) or SGD trainer; ``super_train_step`` takes one SGD
step over the conditioned bundle (UNet, ReferenceNet, IP-Adapter image
projection, ControlNet).

The JAX package's functions return new param trees; here the modules and
the optimizer are updated in place and the steps return the loss. Draws come
from an explicit ``torch.Generator`` (on the CPU; they do not reproduce
``jax.random``'s numbers), or the caller passes ``timesteps=`` and
``noise=`` (the tests pass the JAX package's draws). Precision is the
caller's: float32 master weights with the loss under
``torch.autocast("cuda", torch.bfloat16)`` put the kernels' bf16 inputs on
the card. Under autograd every kernel wrapper wraps its launch in an
``autograd.Function`` (``ops.kernels.records``): the flash kernel with its
softmax stats under the memory-efficient attention, the packed temporal
attention with a float32 recompute for its backward, the pivots with each
other's kernels for theirs. The JAX package's ``training_ctx`` routes
around its Pallas kernels instead, which have no VJP.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .models.controlnet import ControlNet, controlnet_apply
from .models.referencenet import ReferenceNet2D, referencenet_apply
from .models.unet3d import UNet3D, UNet3DConfig, unet3d_apply
from .ops.noise import video_fusion_noise
from .parallel.frame_parallel import unet3d_apply_fp
from .parallel.mesh import all_reduce_sum, axis_group, axis_rank, axis_size
from .schedulers.base import ScheduleConfig


@dataclasses.dataclass(frozen=True)
class TrainSpec:
    unet_cfg: UNet3DConfig
    schedule: ScheduleConfig = ScheduleConfig()
    learning_rate: float = 1e-5
    w_ind_noise: float = 0.5
    n_vision_cond: int = 1
    grad_checkpoint: bool = True
    # frame-parallel training: the UNet's (batch, frame) rows sharded over
    # this axis of the ambient mesh (parallel.frame_parallel); the grads
    # flow back through its collectives, and sync_grads sums the replicated
    # params' grads over the ranks
    fp_axis: Optional[str] = None
    # data-parallel training: each rank takes its share of the batch (the
    # JAX package shards the batch by its sharding instead); sync_grads
    # averages the grads over the ranks
    dp_axis: Optional[str] = None
    # make_optimizer / train_step_opt: "sgd" or "adamw"
    optimizer: str = "adamw"
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0


@dataclasses.dataclass(frozen=True)
class SuperTrainSpec:
    """Training spec for the conditioned bundle (the reference's
    SuperUNet3DConditionModel scaffold, super_model.py:22-253). The configs
    are the bundle's modules' own; where given they must equal them."""

    unet_cfg: UNet3DConfig
    referencenet_cfg: object = None
    controlnet_cfg: object = None
    schedule: ScheduleConfig = ScheduleConfig()
    learning_rate: float = 1e-5
    w_ind_noise: float = 0.5
    n_vision_cond: int = 1
    controlnet_scale: float = 1.0


def _check_cfg(module: nn.Module, cfg, name: str) -> None:
    if cfg is not None and module.cfg != cfg:
        raise ValueError(f"the spec's {name} differs from the module's config")


def _noised(latents: torch.Tensor, schedule: ScheduleConfig, w_ind_noise: float, n_vc: int,
            generator: Optional[torch.Generator], timesteps, noise):
    """(cond, noisy, noise, timesteps): the clean condition frames, the
    noised rest in the latents' dtype, the float32 noise and the int64
    timesteps (B,) on the latents' device. ``timesteps`` and ``noise`` are
    drawn from ``generator`` (timesteps first) where not given."""
    b = latents.shape[0]
    cond, gen = latents[:, :n_vc], latents[:, n_vc:]
    if timesteps is None or noise is None:
        if generator is None:
            raise ValueError("the loss draws timesteps and noise: pass a torch.Generator, or "
                             "timesteps= and noise=")
        if timesteps is None:
            timesteps = torch.randint(0, schedule.num_train_timesteps, (b,),
                                      generator=generator)
        if noise is None:
            noise = video_fusion_noise(generator, gen.shape, w_ind_noise=w_ind_noise)
    dev = latents.device
    timesteps = torch.as_tensor(timesteps, dtype=torch.int64).to(dev)
    noise = torch.as_tensor(noise).to(device=dev, dtype=torch.float32)
    ac = torch.from_numpy(schedule.alphas_cumprod().astype(np.float32)).to(dev)
    a = ac[timesteps][:, None, None, None, None]
    noisy = (a.sqrt() * gen.float() + (1.0 - a).sqrt() * noise).to(latents.dtype)
    return cond, noisy, noise, timesteps


def _mse(pred: torch.Tensor, noise: torch.Tensor, n_vc: int) -> torch.Tensor:
    pred_gen = pred[:, n_vc:] if n_vc > 0 else pred
    err = pred_gen.float() - noise
    return (err * err).mean()


def _cond_kw(n_vc: int, t: int, cond: torch.Tensor) -> dict:
    if n_vc == 0:
        return {}
    return dict(condition_latents=cond, cond_index=tuple(range(n_vc)),
                gen_index=tuple(range(n_vc, t)))


def diffusion_loss(
    unet: UNet3D,
    spec: TrainSpec,
    latents: torch.Tensor,
    text_emb: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Noise-prediction MSE (float32 scalar) of ``unet`` on clean video
    latents (B, T, h, w, C) and text embeddings (B, S, D). The first
    ``n_vision_cond`` frames act as the clean vision condition; the rest are
    noised at ``timesteps`` (B,) with ``noise`` (B, T - n_vc, h, w, C), drawn
    from ``generator`` where not given. ``spec.grad_checkpoint`` recomputes
    each UNet block layer in the backward (``unet3d_core``).

    On a mesh every rank passes the whole batch and draws the same global
    timesteps and noise. Under ``spec.fp_axis`` the UNet call is the
    frame-parallel program and the loss is the whole batch's on every rank,
    its backward reaching each rank's share of the grads. Under
    ``spec.dp_axis`` each rank takes its contiguous share of the batch; the
    value returned is the whole batch's loss and the backward gives this
    rank's share, weighted so that the mean over the ranks is the whole
    batch's grad. ``sync_grads`` completes either after the backward."""
    if spec.fp_axis is not None and spec.dp_axis is not None:
        raise ValueError("fp_axis excludes dp_axis")
    _check_cfg(unet, spec.unet_cfg, "unet_cfg")
    n_vc = spec.n_vision_cond
    cond, noisy, noise, timesteps = _noised(latents, spec.schedule, spec.w_ind_noise, n_vc,
                                            generator, timesteps, noise)
    t = latents.shape[1]
    if spec.dp_axis is not None:
        n, rank = axis_size(spec.dp_axis), axis_rank(spec.dp_axis)
        b = latents.shape[0]
        if b < n:
            raise ValueError(f"dp training: a batch of {b} over {n} ranks leaves a rank none")
        cond, noisy, noise, timesteps, text_emb = (
            torch.tensor_split(x, n)[rank] for x in (cond, noisy, noise, timesteps, text_emb))
        pred = unet3d_apply(unet, noisy, timesteps.float(), text_emb,
                            grad_checkpoint=spec.grad_checkpoint, **_cond_kw(n_vc, t, cond))
        local = _mse(pred, noise, n_vc) * (n * noisy.shape[0] / b)
        total = all_reduce_sum(local.detach(), axis_group(spec.dp_axis)) / n
        return local + (total - local).detach()
    unet_fn = unet3d_apply
    if spec.fp_axis is not None:
        unet_fn = functools.partial(unet3d_apply_fp, axis=spec.fp_axis)
    pred = unet_fn(unet, noisy, timesteps.float(), text_emb,
                   grad_checkpoint=spec.grad_checkpoint, **_cond_kw(n_vc, t, cond))
    return _mse(pred, noise, n_vc)


def sync_grads(params: Sequence[torch.Tensor], spec: TrainSpec) -> None:
    """After the backward of ``diffusion_loss`` on a mesh: the grads summed
    over the ranks of ``spec.fp_axis`` (each rank holds the part its rows
    gave), averaged over those of ``spec.dp_axis``; nothing without either."""
    for axis, mean in ((spec.fp_axis, False), (spec.dp_axis, True)):
        if axis is None:
            continue
        group = axis_group(axis)
        n = dist.get_world_size(group)
        for p in params:
            if p.grad is not None:
                dist.all_reduce(p.grad, group=group)
                if mean:
                    p.grad.div_(n)


def _sgd(params: Sequence[torch.Tensor], lr: float) -> None:
    """``p - lr * g`` in the params' dtype; a param with no grad stays."""
    with torch.no_grad():
        for p in params:
            if p.grad is not None:
                p.sub_(p.grad.to(p.dtype) * lr)


def train_step(unet: UNet3D, spec: TrainSpec, latents: torch.Tensor, text_emb: torch.Tensor,
               generator: Optional[torch.Generator] = None, *,
               timesteps: Optional[torch.Tensor] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step on ``unet`` in place; returns the loss (detached). The
    grads stay in each param's ``.grad``."""
    params = list(unet.parameters())
    for p in params:
        p.grad = None
    loss = diffusion_loss(unet, spec, latents, text_emb, generator,
                          timesteps=timesteps, noise=noise)
    loss.backward()
    sync_grads(params, spec)
    _sgd(params, spec.learning_rate)
    return loss.detach()


def make_optimizer(spec: TrainSpec, params) -> torch.optim.Optimizer:
    """The optimizer of ``spec.optimizer`` over ``params``: ``torch.optim.SGD``
    at the learning rate, or ``torch.optim.AdamW`` (betas 0.9/0.999, eps 1e-8,
    optax's defaults) with ``spec.weight_decay``; ``train_step_opt`` clips
    AdamW's grads to ``spec.max_grad_norm`` first, as the JAX package's optax
    chain does."""
    params = list(params)
    if spec.optimizer == "sgd":
        return torch.optim.SGD(params, lr=spec.learning_rate)
    if spec.optimizer == "adamw":
        return torch.optim.AdamW(params, lr=spec.learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=spec.weight_decay)
    raise ValueError(f"unknown optimizer {spec.optimizer!r}")


def train_step_opt(unet: UNet3D, optimizer: torch.optim.Optimizer, spec: TrainSpec,
                   latents: torch.Tensor, text_emb: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   timesteps: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of ``optimizer`` (from ``make_optimizer(spec, ...)``) on
    ``unet`` in place; returns the loss (detached). A param the loss does not
    reach gets a zero grad, as the JAX package's ``train_step_opt`` gives it
    (train.py:270-273), so AdamW still decays it and its moments."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    optimizer.zero_grad(set_to_none=True)
    loss = diffusion_loss(unet, spec, latents, text_emb, generator,
                          timesteps=timesteps, noise=noise)
    loss.backward()
    sync_grads(params, spec)
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if spec.optimizer == "adamw":
        torch.nn.utils.clip_grad_norm_(params, spec.max_grad_norm)
    optimizer.step()
    return loss.detach()


def super_diffusion_loss(
    bundle: Dict[str, nn.Module],
    spec: SuperTrainSpec,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    timesteps: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Joint loss of the bundle's modules, in ``_super_diffusion_loss``'s
    order (train.py:145-205): the IP projection of the pooled CLIP embedding,
    the ReferenceNet on the reference latents at the noised timesteps, the
    ControlNet on every frame with its control image, then the UNet.

    bundle: ``unet`` (UNet3D), and ``referencenet`` (ReferenceNet2D),
    ``ip_proj`` (ImageProjModel), ``controlnet`` (ControlNet) where given.
    batch: ``latents`` (B, T, h, w, C), ``text_emb`` (B, S, D), and
    ``refer_latents`` (B, h, w, C), ``clip_pooled`` (B, clip_dim),
    ``control_images`` (B, T, H, W, 3) where given."""
    unet: UNet3D = bundle["unet"]
    _check_cfg(unet, spec.unet_cfg, "unet_cfg")
    latents, text_emb = batch["latents"], batch["text_emb"]
    b, t, h, w, c = latents.shape
    n_vc = spec.n_vision_cond
    cond, noisy, noise, timesteps = _noised(latents, spec.schedule, spec.w_ind_noise, n_vc,
                                            generator, timesteps, noise)
    ts = timesteps.float()

    clip_tokens = None
    if "ip_proj" in bundle and "clip_pooled" in batch:
        clip_tokens = bundle["ip_proj"](batch["clip_pooled"])
    refer_embs = mid_emb = None
    if "referencenet" in bundle and "refer_latents" in batch:
        net: ReferenceNet2D = bundle["referencenet"]
        _check_cfg(net, spec.referencenet_cfg, "referencenet_cfg")
        ctx = clip_tokens if clip_tokens is not None else text_emb
        refer_embs, mid_emb = referencenet_apply(net, batch["refer_latents"], ts, ctx)
    cn_down = cn_mid = None
    if "controlnet" in bundle and "control_images" in batch:
        net: ControlNet = bundle["controlnet"]
        _check_cfg(net, spec.controlnet_cfg, "controlnet_cfg")
        frames = torch.cat([cond.to(noisy.dtype), noisy], dim=1).reshape(-1, h, w, c)
        ctrl = batch["control_images"].reshape(-1, *batch["control_images"].shape[2:])
        cn_down, cn_mid = controlnet_apply(
            net, frames, ts.repeat_interleave(t), text_emb.repeat_interleave(t, dim=0), ctrl,
            conditioning_scale=spec.controlnet_scale)

    pred = unet3d_apply(
        unet, noisy, ts, text_emb, **_cond_kw(n_vc, t, cond),
        down_block_refer_embs=refer_embs, mid_block_refer_emb=mid_emb,
        vision_clip_emb=clip_tokens, controlnet_down_residuals=cn_down,
        controlnet_mid_residual=cn_mid,
    )
    return _mse(pred, noise, n_vc)


def super_train_step(bundle: Dict[str, nn.Module], spec: SuperTrainSpec,
                     batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None, *,
                     timesteps: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One SGD step over every param of the bundle, in place; returns the
    loss (detached)."""
    params = [p for module in bundle.values() for p in module.parameters()]
    for p in params:
        p.grad = None
    loss = super_diffusion_loss(bundle, spec, batch, generator, timesteps=timesteps,
                                noise=noise)
    loss.backward()
    _sgd(params, spec.learning_rate)
    return loss.detach()
