"""CFG denoise loop with delayed ("merge-step") conditioning: a Python loop
over the sampler plan (the JAX package runs the same steps as a lax.scan).

While i <= start_merge_step the text-only branch conditions the UNet, the
facial-augmented branch afterwards. CFG batches [negative, positive] into
one UNet call; eps = eps_uncond + g * (eps_cond - eps_uncond).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from .schedulers import SamplerPlan


@dataclass
class CondBranch:
    """One conditioning branch: positive and negative embeddings
    (B, L, D)."""

    context: torch.Tensor
    null: torch.Tensor


def denoise(unet_fn: Callable, latents: torch.Tensor,
            text_branch: CondBranch, facial_branch: CondBranch,
            plan: SamplerPlan, guidance_scale: float,
            start_merge_step: int) -> torch.Tensor:
    """unet_fn(latents, t, context) -> eps, NHWC. Returns the final
    (scaled-space) latents in fp32."""
    x = latents.float() * plan.init_scale
    contexts = {
        branch_id: torch.cat([b.null, b.context], dim=0)
        for branch_id, b in ((0, text_branch), (1, facial_branch))}
    for i in range(plan.num_steps):
        context = contexts[0 if i <= start_merge_step else 1]
        latent_in = torch.cat([x, x], dim=0) * float(plan.c_in[i])
        t = torch.full((latent_in.shape[0],), float(plan.timesteps[i]),
                       device=x.device, dtype=torch.float32)
        eps_uncond, eps_cond = unet_fn(latent_in, t, context).float().chunk(2)
        eps = eps_uncond + guidance_scale * (eps_cond - eps_uncond)
        x = float(plan.coef_x[i]) * x + float(plan.coef_e[i]) * eps
    return x
