"""ConsistentID image-to-image pipeline on PyTorch.

Counterpart of the JAX package's pipelines/img2img.py: the diffusers
StableDiffusionImg2ImgPipeline contract composed with ConsistentID's
conditioning (the reference's Base mixin, pipelines/BaseConsistentID.py),
through the inpaint pipeline's strength -> timestep truncation (reference
StableDIffusionInpaint_ConsistentID.py:246-248):
  - keep the last int(T * strength) steps of the plan;
  - strength < 1: the init image's VAE latents noised to the first kept
    step, the plan's init scale set to 1;
  - strength >= 1: no VAE encode, the latents are the noise and the plan's
    init scale is kept, so the result is text-to-image's from the same
    latents (for the deterministic samplers);
  - the full ConsistentID conditioning, no mask, no recomposition.

Randomness as in pipelines/inpaint.py: one generator seeded `seed` on the
bundle's device draws the noise, then the posterior noise (strength < 1
only), then any ancestral noise. The bundle's quant mode reaches the UNet
through `infer_unet` (JAX `img2img.py:64`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..sampling import denoise, make_plan
from ..sampling.schedulers import plan_tail
from .consistentid_sd15 import _StageClock
from .inpaint import _InitImagePipeline, _noised_init_latents


class ConsistentIDImg2ImgPipeline(_InitImagePipeline):
    """generate(prompt, face_image, init_image, strength=0.8, ...)."""

    _batch_refusal = "batched img2img is not supported"

    @torch.no_grad()
    def _img2img_core(self, cond: Dict[str, torch.Tensor],
                      noise: torch.Tensor, guidance_scale: float,
                      start_merge_step: int, num_steps: int, scheduler: str,
                      ip_scale: float, lora_scale: float, strength: float,
                      generator: Optional[torch.Generator] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      sampler_noise: Optional[torch.Tensor] = None,
                      sync_stages: bool = True) -> torch.Tensor:
        """Encode (+ VAE-encode below strength 1) + denoise + decode from
        the initial `noise` (1, h, w, C); the posterior and ancestral noise
        injected or drawn from `generator` in that order. Returns the
        decoded NHWC images in [-1, 1]."""
        clock = _StageClock(noise.device, sync_stages)
        text_b, facial_b, time_ids = self._branches(cond)
        plan = plan_tail(make_plan(self.schedule, scheduler, num_steps),
                         strength)
        if strength >= 1.0:
            latents = noise
        else:
            image_latents, _ = self._encode_init(cond["init_image"],
                                                 posterior_noise, generator)
            latents = _noised_init_latents(plan, image_latents, noise)
            plan = dataclasses.replace(plan, init_scale=1.0)
        clock.mark("encode")
        unet = self.bundle.infer_unet(lora_scale)
        clock.mark("fold")
        unet_fn, _ = self._unet_fns(unet, ip_scale, 1)
        final = denoise(unet_fn, latents, text_b, facial_b, plan,
                        guidance_scale, start_merge_step,
                        generator=generator, noise=sampler_noise,
                        time_ids=time_ids)
        clock.mark("denoise")
        images = self._decode(final)
        clock.mark("decode")
        self.last_stage_ms = clock.stages
        return images

    def _images(self, prompt: str, face_image: np.ndarray,
                init_image: np.ndarray, strength: float = 0.8,
                negative_prompt: str = "", seed: int = 0,
                height: Optional[int] = None, width: Optional[int] = None,
                num_inference_steps: Optional[int] = None,
                guidance_scale: Optional[float] = None,
                start_merge_step: Optional[int] = None,
                scheduler: Optional[str] = None, ip_scale: float = 1.0,
                lora_scale: float = 1.0,
                parsing_labels: Optional[np.ndarray] = None,
                faceid_embeds: Optional[np.ndarray] = None,
                sync_stages: bool = True, **extra) -> torch.Tensor:
        """init_image (H, W, 3) uint8, strength in (0, 1]: the share of the
        plan that runs. Returns the decoded images on the device."""
        if extra:
            raise TypeError(f"unknown generate() arguments: {sorted(extra)}")
        cond, height, width, t0 = self._prepare(
            prompt, face_image, init_image, negative_prompt, height, width,
            parsing_labels, faceid_embeds)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        gen, noise = self._noise(seed, height, width)
        images = self._img2img_core(
            self.device_cond(cond), noise,
            *self._core_args(guidance_scale, start_merge_step,
                             num_inference_steps, scheduler),
            ip_scale, lora_scale, float(strength), generator=gen,
            sync_stages=sync_stages)
        self.last_stage_ms = {"prepare": prepare_ms, **self.last_stage_ms}
        return images
