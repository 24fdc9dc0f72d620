"""The reference followed step by step from the served request's own
state.

A diffusion trajectory of 50 steps under CFG amplifies rounding: with
random weights the system's bf16 image and the fp32 reference's image,
each run freely from the same seed, part by about 1-2% of the image, about
as far as the system's own int8 path does, so the two cannot be told
apart. The check therefore judges every stage on the system's own inputs
to it, which the benchmark records for the sampled requests while they
are served (harness/capture.py):

  start  the first UNet input against the reference's own initial latents
         from the request's seed (the same draw; exact);
  parse  the face parser's label map against the reference's own parse of
         the photo: the share of pixels whose label differs;
  embed  the face embedder's embedding (SCRFD detect and align, iresnet50)
         against the reference's own: relative L2;
  cond   every UNet call's conditioning (both CFG rows of the context, and
         SDXL's pooled embeddings) against the reference's own, made from
         the prompt and the photo with the system's label map and
         embedding (markers and tokens, masks, CLIP pixels, the text
         encodes, ViT-H, ProjPlus and the FacialEncoder), switched at the
         merge step: relative L2 over all the steps together; and its
         parts (PARTS): the null row, the ID tokens of the conditioned
         row, its prompt tokens before the merge step (the text-only
         encode), after it outside the facial slots (the marked encode)
         and in the fused facial slots (the FacialEncoder's output);
  unet   every UNet call's output (both CFG rows) against the reference
         UNet's on the system's input and conditioning, at the reference's
         timestep: relative L2 over all the steps together; and, at the
         probe steps, the output of each probed block of the UNet
         (`unet.<block>`, the reference's block in the reference's UNet
         on the same input);
  step   every sampler update (CFG combination and DDIM step, fp32) from
         the system's latents and noise prediction against the system's
         next UNet input (the last against its decoder input);
  image  the served uint8 image against the reference's decode of the
         system's final latents, in uint8, through the safety checker.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import numpy as np
import torch

from .image import to_uint8
from .sampler import CondBranch
from .schedulers import make_plan


NUMBERS = ("start", "parse", "embed", "cond", "unet", "step", "image")
# the context's parts (read in every run, compared where a cell names
# them): the null row, the conditioned row's ID tokens, its prompt tokens
# before the merge step, after it outside the facial slots, and in them
PARTS = ("cond.null", "cond.id", "cond.text", "cond.marked", "cond.face")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp_min(1e-300))


def _add(acc, got: torch.Tensor, want: torch.Tensor) -> None:
    """Accumulate squared distance and squared norm, for a relative L2
    over several tensors together."""
    got, want = got.double(), want.double()
    acc[0] += float(((got - want) ** 2).sum())
    acc[1] += float((want ** 2).sum())


def _ctx(branch: CondBranch):
    return torch.cat([branch.null, branch.context], dim=0)


def facial_slots(cond) -> torch.Tensor:
    """The prompt positions the FacialEncoder writes (valid slots)."""
    idx = cond["facial_idx"][0].long()
    return idx[cond["facial_idx_mask"][0].bool()].unique()


def add_cond_parts(joint, ctx, want, merged: bool, slots) -> None:
    """Accumulate one step's context (2, 77 + ids, D), null row first,
    into the PARTS of `joint`."""
    _add(joint["cond.null"], ctx[0], want[0])
    _add(joint["cond.id"], ctx[1, 77:], want[1, 77:])
    if not merged:
        _add(joint["cond.text"], ctx[1, :77], want[1, :77])
        return
    keep = torch.ones(77, dtype=torch.bool, device=ctx.device)
    keep[slots] = False
    _add(joint["cond.marked"], ctx[1, :77][keep], want[1, :77][keep])
    _add(joint["cond.face"], ctx[1, slots], want[1, slots])


@contextmanager
def outputs_of(module: torch.nn.Module, names):
    """While inside, {name: last output} of each named submodule."""
    seen, hooks = {}, []
    for name in names:
        def keep(mod, args, out, name=name):
            seen[name] = out
        hooks.append(getattr(module, name).register_forward_hook(keep))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


@torch.no_grad()
def follow(ref, prompt: str, face: np.ndarray, seed: int, got: Dict,
           served: np.ndarray, step_dtype: torch.dtype = torch.float32,
           unet: bool = True) -> Dict[str, float]:
    """Gaps of one request. `got`: the system's "x" (list of (1, h, w, C)
    UNet inputs, one a step), "ctx" and "added" (each step's conditioning
    rows), "eps" (list of (2, h, w, C) outputs), "probe" ({block: {step:
    (2, C, h, w) output}}) and "final" ((1, h, w, C) decoder input).
    step_dtype: the precision the reference's sampler update runs in (the
    control's is lower); unet False skips the UNet calls (the unet gaps
    are then not read)."""
    s = ref.spec
    dev = ref.device
    out = {"parse": 1.0, "embed": float("inf")}
    if got.get("labels") is not None and got.get("faceid") is not None:
        labels = ref.parser(face)
        out["parse"] = float(np.mean(np.asarray(got["labels"]) != labels))
        out["embed"] = rel_l2(torch.from_numpy(np.asarray(got["faceid"])),
                              torch.from_numpy(ref.embedder(face)))
        cond = ref.prepare(prompt, face, labels=got["labels"],
                           faceid=got["faceid"])
    else:
        cond = ref.prepare(prompt, face)
    text_b, facial_b, time_ids = ref.branches(cond)
    slots = facial_slots(cond)
    plan = make_plan(ref.schedule, s.scheduler, s.steps)
    sf = 2 ** (len(ref.m.vae.config.block_out_channels) - 1)
    shape = (s.height // sf, s.width // sf, ref.m.unet.config.sample_channels)
    gen = torch.Generator(dev).manual_seed(int(seed))
    x0 = torch.randn(shape, generator=gen, device=dev,
                     dtype=torch.float32)[None] * plan.init_scale
    xs = [x.to(dev, torch.float32) for x in got["x"]]
    out.update(start=rel_l2(xs[0], x0 * float(plan.c_in[0])) if xs
               else float("inf"), step=0.0)
    probes = got.get("probe") or {}
    keys = (("cond", "unet") + PARTS
            + tuple(f"unet.{b}" for b in probes))
    joint = {k: [0.0, 0.0] for k in keys}                 # d^2, r^2
    if not (len(xs) == len(got["eps"]) == len(got["ctx"]) == s.steps):
        out["step"] = float("inf")
        joint = {k: [1.0, 0.0] for k in joint}
        xs = []
    pooled = None
    if text_b.pooled is not None:
        pooled = {b: torch.cat([br.pooled_null, br.pooled])
                  for b, br in ((0, text_b), (1, facial_b))}
    for i, xin in enumerate(xs):
        branch = 0 if i <= s.start_merge_step else 1
        ctx = got["ctx"][i].to(dev, torch.float32)
        want = _ctx((text_b, facial_b)[branch])
        _add(joint["cond"], ctx, want)
        add_cond_parts(joint, ctx, want, bool(branch), slots)
        added = got["added"][i]
        if pooled is not None:
            added = {k: v.to(dev, torch.float32) for k, v in added.items()}
            _add(joint["cond"], added["text_embeds"], pooled[branch])
            _add(joint["cond"], added["time_ids"],
                 torch.cat([time_ids, time_ids]))
        t = torch.full((2,), float(plan.timesteps[i]), device=dev)
        eps = got["eps"][i].to(dev, torch.float32)
        if unet:
            here = [b for b, by_step in probes.items() if i in by_step]
            with outputs_of(ref.m.unet, here) as seen:
                _add(joint["unet"], eps, ref.m.unet(
                    torch.cat([xin, xin]), t, ctx, added_cond=added))
            for b in here:
                _add(joint[f"unet.{b}"], probes[b][i].to(dev, torch.float32),
                     seen[b])
        u, c = eps.to(step_dtype).chunk(2)
        e = u + s.guidance_scale * (c - u)
        x = (xin / float(plan.c_in[i])).to(step_dtype)
        x_next = float(plan.coef_x[i]) * x + float(plan.coef_e[i]) * e
        nxt = (xs[i + 1] / float(plan.c_in[i + 1]) if i + 1 < len(xs)
               else got["final"].to(dev, torch.float32))
        out["step"] = max(out["step"], rel_l2(nxt, x_next.float()))
    for k, (d2, r2) in joint.items():
        out[k] = ((d2 / r2) ** 0.5 if r2 > 0
                  else 0.0 if d2 == 0 else float("inf"))
    for b, by_step in probes.items():              # a probe never recorded
        if unet and not by_step:
            out[f"unet.{b}"] = float("inf")
    if not unet:
        out.update({k: 0.0 for k in keys if k.startswith("unet")})
    final = got["final"].to(dev, torch.float32)
    image = to_uint8(ref.m.vae.decode(final)).cpu().numpy()
    if ref.checker is not None:
        image, _ = ref.checker(image)
    out["image"] = rel_l2(torch.from_numpy(served.astype(np.float64)),
                          torch.from_numpy(image[0].astype(np.float64)))
    return out


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x through `dtype` and back; fp8 with a per-tensor scale that maps
    the largest magnitude to the format's largest value."""
    if dtype.itemsize >= 2:
        return x.to(dtype).to(x.dtype)
    scale = x.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(x.dtype) * scale


@contextmanager
def lower_precision(modules, dtype: torch.dtype):
    """While inside, every convolution and linear layer of `modules` takes
    its input and weight rounded through `dtype` (the control of a stage:
    fp8 e4m3 below a bf16 stage, bf16 below an fp32 one)."""
    from torch import nn
    saved, hooks = [], []
    for module in modules:
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                saved.append((m, m.weight.data))
                m.weight.data = _round(m.weight.data, dtype)
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, args: (_round(args[0], dtype),
                                       *args[1:])))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        for m, w in saved:
            m.weight.data = w


def worst(gaps: Dict[str, Optional[float]], new: Dict[str, float]) -> None:
    for k, v in new.items():
        gaps[k] = v if gaps.get(k) is None else max(gaps[k], v)
