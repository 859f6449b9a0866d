#!/usr/bin/env python3
"""Where the frame-parallel program at one rank parts from the unsharded
UNet call on one GPU, and how far each is from the same call in float32.

    python3 chip_fp_parity.py

Run from the root of a checkout on a machine with a CUDA device (as
``chip_smoke.py``, whose helpers it uses). At full width (the ``musev`` UNet
at 576x576, the default plan's 3 windows of 12 + 1 frames under CFG: 78
frame rows, bf16 weights drawn as ``chip_smoke.py``'s phase parallel draws
them), at the reference's temporal weights (1e-5) and with the temporal
layers weighted 1, it prints and writes to ``chiprun_out/fp_parity.json``:

* the unsharded bf16 call against itself (is the call deterministic);
* ``unet3d_apply_fp`` at one rank (``StubComm(1)``, whose collectives are
  then exact) against the unsharded call, relative L2 of the output and of
  every UNetOps site's output in call order, with the first site that
  differs, for three forms of the frame-parallel GroupNorm: the port's
  (one all-reduce of the first two moments, var = E[x^2] - E[x]^2), the
  same with the apply as one fused multiply-add, and a two-pass form (the
  mean all-reduced first, then the centred second moment);
* the same two calls with the model in float32 and every kernel replaced
  by a float32 reference (``chip_smoke.float32_references``: SDPA for flash
  attention, the plain versions of the short-attention kernel and of the
  pivots; TF32 off), against each other, and each bf16 output against the
  float32 unsharded one;
* whether NCCL accepts a ``batch_isend_irecv`` from a rank to itself in a
  group of one.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def two_pass_video(fp, torch):
    """``_fp_group_norm_video`` with the mean all-reduced first and the
    centred second moment after it (two all-reduces)."""
    def gn(norm, v, comm, slot_onehot, slot_ids, count):
        vf = v.float()
        c, g = vf.shape[-1], norm.num_groups
        oh = fp._group_onehot(c, g, vf.device)
        mean_g = (comm.psum(slot_onehot.t() @ vf.sum(dim=(1, 2))) @ oh) / count
        d = vf - (mean_g @ oh.t())[slot_ids][:, None, None, :]
        var_g = (comm.psum(slot_onehot.t() @ d.square().sum(dim=(1, 2))) @ oh) / count
        scale = (torch.rsqrt(var_g + norm.eps) @ oh.t()) * norm.weight.float()[None, :]
        shift = norm.bias.float()[None, :] - (mean_g @ oh.t()) * scale
        return torch.addcmul(shift[slot_ids][:, None, None, :], vf,
                             scale[slot_ids][:, None, None, :]).to(v.dtype)
    return gn


def two_pass_pixel(fp, torch):
    def ss(norm, y, comm, count):
        yf = y.float()
        c, g = yf.shape[-1], norm.num_groups
        oh = fp._group_onehot(c, g, yf.device)
        mean_g = (comm.psum(yf.sum(dim=(1, 2))) @ oh) / count
        d = yf - (mean_g @ oh.t())[:, None, None, :]
        var_g = (comm.psum(d.square().sum(dim=(1, 2))) @ oh) / count
        scale = (torch.rsqrt(var_g + norm.eps) @ oh.t()) * norm.weight.float()[None, :]
        shift = norm.bias.float()[None, :] - (mean_g @ oh.t()) * scale
        return scale, shift
    return ss


def fused_apply_video(fp, torch):
    def gn(norm, v, comm, slot_onehot, slot_ids, count):
        vf = v.float()
        stats = torch.cat([vf.sum(dim=(1, 2)), vf.square().sum(dim=(1, 2))], dim=-1)
        stats = comm.psum(slot_onehot.t() @ stats)
        scale, shift = fp._group_scale_shift(norm, *stats.chunk(2, dim=-1), count)
        return torch.addcmul(shift[slot_ids][:, None, None, :], vf,
                             scale[slot_ids][:, None, None, :]).to(v.dtype)
    return gn


def main() -> None:
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from musev_torch.models import unet3d as u3
    from musev_torch.models.unet3d import UNet3D, musev_config, unet3d_apply
    from musev_torch.models.unet_blocks import TemporalConvLayer, TemporalTransformer
    from musev_torch.ops.kernels import _build
    from musev_torch.parallel import frame_parallel as fp
    from musev_torch.pipelines.loader import init_random_

    t0 = time.time()
    _build.build(_build.SOURCES)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(12)
    unet = UNet3D(musev_config()).to("cuda", torch.bfloat16).eval()
    init_random_(unet, gen, scale=0.02)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=gen, dtype=torch.bfloat16)

    rows, frames = 2 * cs.FP_WINDOWS, 12
    sample, cond, text = rand(rows, frames, 72, 72, 4), rand(rows, 1, 72, 72, 4), \
        rand(rows, 77, 768)
    kw = dict(condition_latents=cond, gen_index=tuple(range(1, frames + 1)), cond_index=(0,),
              do_cfg=True)
    init_random_(unet, gen, scale=cs.SPLIT_WEIGHT_SCALE)

    # the UNetOps sites' outputs of one call, in call order
    sites = {"on": None}
    real_core = u3.unet3d_core

    def core(unet_, x, temb, ops, **k):
        if sites["on"] is not None:
            rec = sites["on"]
            for kind in ("spatial", "temporal_conv", "temporal_attn"):
                f = getattr(ops, kind)

                def wrapped(mod, *a, f=f, kind=kind):
                    y = f(mod, *a)
                    rec.append((kind, y.detach().clone()))
                    return y
                setattr(ops, kind, wrapped)
        return real_core(unet_, x, temb, ops, **k)

    u3.unet3d_core = core
    fp.unet3d_core = core

    def run(call, record=None):
        sites["on"] = record
        try:
            with torch.inference_mode():
                out = call()
            torch.cuda.synchronize()
        finally:
            sites["on"] = None
        return out

    def unsharded(model, sample_, cond_, text_):
        return lambda: unet3d_apply(model, sample_, 500.0, text_,
                                    **dict(kw, condition_latents=cond_))

    def one_rank(model, sample_, cond_, text_):
        return lambda: fp.unet3d_apply_fp(model, sample_, 500.0, text_, comm=fp.StubComm(1),
                                          **dict(kw, condition_latents=cond_))

    forms = {"port": {},
             "fused apply": {"_fp_group_norm_video": fused_apply_video(fp, torch)},
             "two-pass": {"_fp_group_norm_video": two_pass_video(fp, torch),
                          "_fp_gn_pixel_scale_shift": two_pass_pixel(fp, torch)}}
    real_fp = {name: getattr(fp, name) for name in ("_fp_group_norm_video",
                                                      "_fp_gn_pixel_scale_shift")}
    record = {}
    for weighting in ("reference", "temporal 1"):
        if weighting == "temporal 1":
            for m in unet.modules():
                if isinstance(m, (TemporalTransformer, TemporalConvLayer)):
                    m.temporal_weight.data.fill_(1.0)
        r = record[weighting] = {}
        base_sites = []
        want = run(unsharded(unet, sample, cond, text), base_sites).float()
        again = run(unsharded(unet, sample, cond, text)).float()
        r["unsharded_self"] = cs.rel_l2(torch, again, want)
        del again
        outs = {}
        for form, patch in forms.items():
            for name, fn in patch.items():
                setattr(fp, name, fn)
            got_sites = []
            try:
                got = run(one_rank(unet, sample, cond, text), got_sites).float()
            finally:
                for name, fn in real_fp.items():
                    setattr(fp, name, fn)
            per_site = [(k, cs.rel_l2(torch, a, b),
                         float((a != b).float().mean()))
                        for (k, a), (_, b) in zip(got_sites, base_sites)]
            first = next((i for i, s in enumerate(per_site) if s[1] > 0), None)
            r[form] = dict(rel_l2=cs.rel_l2(torch, got, want), first_site=first,
                           first_kind=None if first is None else per_site[first][0],
                           sites=per_site)
            outs[form] = got.cpu()
            del got_sites, got
            print(f"{weighting}, {form}: one rank against unsharded relative L2 "
                  f"{r[form]['rel_l2']:.4e}; first differing site {first} "
                  f"({r[form]['first_kind']}) of {len(per_site)}", flush=True)
        del base_sites
        torch.cuda.empty_cache()

        # float32 with float32 references for the kernels
        with cs.float32_references(torch):
            unet32 = copy.deepcopy(unet).float()
            s32, c32, t32 = sample.float(), cond.float(), text.float()
            ref32 = run(unsharded(unet32, s32, c32, t32)).float().cpu()
            fp32 = run(one_rank(unet32, s32, c32, t32)).float().cpu()
            del unet32
        torch.cuda.empty_cache()
        r["float32_one_rank_vs_unsharded"] = cs.rel_l2(torch, fp32, ref32)
        r["bf16_unsharded_vs_float32"] = cs.rel_l2(torch, want, ref32)
        for form, got in outs.items():
            r[f"bf16_one_rank_{form}_vs_float32"] = cs.rel_l2(torch, got, ref32)
        print(f"{weighting}: unsharded against itself {r['unsharded_self']:.4e}; float32 one "
              f"rank against float32 unsharded {r['float32_one_rank_vs_unsharded']:.4e}; "
              f"against float32 unsharded: bf16 unsharded "
              f"{r['bf16_unsharded_vs_float32']:.4e}, bf16 one rank "
              + ", ".join(f"{f} {r[f'bf16_one_rank_{f}_vs_float32']:.4e}" for f in outs),
              flush=True)
        del want, outs, ref32, fp32

    with tempfile.TemporaryDirectory(prefix="_fp_parity_", dir=ROOT) as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0, world_size=1)
        try:
            x = torch.arange(1 << 16, device="cuda", dtype=torch.float32)
            out = torch.empty_like(x)
            try:
                for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 0),
                                                   dist.P2POp(dist.irecv, out, 0)]):
                    req.wait()
                torch.cuda.synchronize()
                record["nccl_self_p2p"] = "equal" if torch.equal(out, x) else "differs"
            except Exception as e:  # the question this script asks
                record["nccl_self_p2p"] = f"refused: {type(e).__name__}: {e}"
        finally:
            dist.destroy_process_group()
    print(f"NCCL batch_isend_irecv to self in a group of one: {record['nccl_self_p2p']}")
    record["card"] = card.strip()
    record["s"] = time.time() - t0
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "fp_parity.json").write_text(json.dumps(record, indent=1))
    print(f"chip_fp_parity: {record['s']:.1f} s")


if __name__ == "__main__":
    main()
