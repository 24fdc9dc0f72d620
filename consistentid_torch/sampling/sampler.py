"""CFG denoise loop with delayed ("merge-step") conditioning: a Python loop
over the sampler plan (the JAX package runs the same steps as a lax.scan,
sampling/sampler.py).

While i <= start_merge_step the text-only branch conditions the UNet, the
facial-augmented branch afterwards; each branch carries its own positive and
negative context and, for SDXL, pooled embeddings, all switched together
(reference SDXL :619-628). CFG batches [negative, positive] into one UNet
call; eps = eps_uncond + g * (eps_cond - eps_uncond). The step
that follows is the plan's: affine (DDIM, Euler, DDPM with its ancestral
noise), DPM-Solver++(2M) with the previous x0, or PNDM (PLMS) with the eps
history and the held warm-up sample.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .schedulers import SamplerPlan


@dataclass
class CondBranch:
    """One conditioning branch: positive and negative embeddings
    (B, L, D), and for SDXL the pooled positive and negative (B, Dp)."""

    context: torch.Tensor
    null: torch.Tensor
    pooled: Optional[torch.Tensor] = None
    pooled_null: Optional[torch.Tensor] = None


def denoise(unet_fn: Callable, latents: torch.Tensor,
            text_branch: CondBranch, facial_branch: CondBranch,
            plan: SamplerPlan, guidance_scale: float,
            start_merge_step: int,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None,
            time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """unet_fn(latents, t, context) -> eps, NHWC; with pooled branches
    (SDXL) unet_fn(latents, t, context, added), added = {"text_embeds":
    [pooled_null; pooled] of the step's branch, "time_ids": (2B, 6)
    `time_ids` twice}. Returns the final (scaled-space) latents in fp32.

    An ancestral plan (DDPM: coef_n != 0) adds coef_n[i] z_i at step i:
    z_i drawn from `generator` on the latents' device, or taken from
    `noise` (T, B, h, w, C) when given (tests inject the JAX package's
    draws)."""
    x = latents.float() * plan.init_scale
    contexts = {
        branch_id: torch.cat([b.null, b.context], dim=0)
        for branch_id, b in ((0, text_branch), (1, facial_branch))}
    pooled = None
    if text_branch.pooled is not None:
        pooled = {branch_id: torch.cat([b.pooled_null, b.pooled], dim=0)
                  for branch_id, b in ((0, text_branch), (1, facial_branch))}
        time_ids2 = torch.cat([time_ids, time_ids], dim=0)
    needs_noise = bool((plan.coef_n != 0).any())
    if needs_noise and noise is None and generator is None:
        raise ValueError("an ancestral sampler needs a generator or noise")
    prev_x0 = cur_sample = None  # DPM-Solver++(2M), PNDM history
    if plan.kind == "pndm":
        e_hist = [torch.zeros_like(x)] * 3
    for i in range(plan.num_steps):
        branch = 0 if i <= start_merge_step else 1
        latent_in = torch.cat([x, x], dim=0) * float(plan.c_in[i])
        t = torch.full((latent_in.shape[0],), float(plan.timesteps[i]),
                       device=x.device, dtype=torch.float32)
        if pooled is None:
            eps = unet_fn(latent_in, t, contexts[branch])
        else:
            eps = unet_fn(latent_in, t, contexts[branch], {
                "text_embeds": pooled[branch], "time_ids": time_ids2})
        eps_uncond, eps_cond = eps.float().chunk(2)
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        if plan.kind == "dpmpp_2m":
            x0 = (x - float(plan.c_sigma[i]) * eps) / float(plan.c_alpha[i])
            rr = float(plan.rr[i])
            d = x0 if i == 0 else (1.0 + rr) * x0 - rr * prev_x0
            x = float(plan.ratio[i]) * x - float(plan.gamma[i]) * d
            prev_x0 = x0
        elif plan.kind == "pndm":
            # Adams-Bashforth over the eps history; the counter-1 eval
            # re-applies the warm-up transfer from the held sample and
            # leaves the history as it is (diffusers step_plms)
            w = [float(c) for c in plan.plms_w[i]]
            eps_used = (w[0] * eps + w[1] * e_hist[0] + w[2] * e_hist[1]
                        + w[3] * e_hist[2])
            use_cur = plan.use_cur[i] > 0.5
            base = cur_sample if use_cur else x
            if i == 0:
                cur_sample = x
            x = float(plan.coef_x[i]) * base + float(plan.coef_e[i]) * eps_used
            if not use_cur:
                e_hist = [eps, e_hist[0], e_hist[1]]
        else:
            x_next = float(plan.coef_x[i]) * x + float(plan.coef_e[i]) * eps
            if needs_noise:
                z = noise[i].to(x) if noise is not None else torch.randn(
                    x.shape, generator=generator, device=x.device,
                    dtype=x.dtype)
                x_next = x_next + float(plan.coef_n[i]) * z
            x = x_next
    return x
