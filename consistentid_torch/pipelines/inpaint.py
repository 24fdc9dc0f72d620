"""ConsistentID inpainting and ControlNet-inpainting pipelines on PyTorch.

Counterparts of the JAX package's pipelines/inpaint.py, the reference's
pipelines/StableDIffusionInpaint_ConsistentID.py (:94-389) and
StableDIffusionControlNetInpaint_ConsistentID.py (:94-486):
  - strength -> timestep truncation (:246-248): only the last
    int(T * strength) steps run, from the image latents noised to the first
    of them (pure noise at strength 1);
  - masked image = init * (mask < 0.5) (:241);
  - a 4-channel UNet recomposes after each step, (1 - mask) * the init
    latents re-noised to the next step + mask * latents (:340-352); a
    9-channel inpainting UNet takes [latents, mask, masked-image latents]
    concatenated instead (:320-321);
  - ControlNet residuals each step, under a keep schedule over the
    truncated plan's progress (:363-370, :405-425).

Randomness: one torch.Generator seeded `seed` on the bundle's device draws
the initial noise, then the VAE posterior noise (one draw, shared by the
init image's and the masked image's encodes, as the JAX package encodes
both with one key), then any ancestral sampler noise. JAX draws them from
PRNGKey(seed), fold_in(., 1) and fold_in(., 2), so the parity tests inject
all three.

`generate` serves one image per call; `generate_async` runs the same path
and returns a callable, so its bits are `generate`'s. The batch variants
raise, as the inherited text-to-image ones would ignore the init image.
The bundle's quant mode reaches the UNet through `infer_unet` (JAX
`inpaint.py:101,247`); the ControlNet stays float, as in JAX.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.controlnet import ControlNet, make_controlnet
from ..sampling import denoise, make_plan
from ..sampling.schedulers import SamplerPlan, plan_tail
from ..utils.image import (resize_nearest_uint8, sd_image_preprocess,
                           to_grey_uint8, to_uint8)
from .consistentid_sd15 import ConsistentIDPipeline, _StageClock


def _noised_init_latents(plan: SamplerPlan, image_latents: torch.Tensor,
                         noise: torch.Tensor) -> torch.Tensor:
    """Image latents noised to the plan's first step, in the plan's own
    latent space (VP for ddim/ddpm/dpmpp_2m/pndm, sigma space for euler),
    fp32."""
    return (float(plan.noise_x[0]) * image_latents.float()
            + float(plan.noise_e[0]) * noise.float())


def _inpaint_target_table(plan: SamplerPlan, image_latents: torch.Tensor,
                          noise: torch.Tensor) -> torch.Tensor:
    """(T, B, h, w, C) fp32 blend targets of 4-channel inpainting: the init
    latents re-noised to the NEXT step's level; the last step blends the
    clean image latents (1.0 x0 + 0.0 noise; reference :344-352)."""
    dev = image_latents.device
    nx = torch.from_numpy(np.concatenate(
        [plan.noise_x[1:], [1.0]]).astype(np.float32)).to(dev)
    ne = torch.from_numpy(np.concatenate(
        [plan.noise_e[1:], [0.0]]).astype(np.float32)).to(dev)
    return (nx[:, None, None, None, None] * image_latents.float()[None]
            + ne[:, None, None, None, None] * noise.float()[None])


def preprocess_mask(mask_image: np.ndarray, height: int, width: int,
                    latent_h: int, latent_w: int):
    """Binary inpaint mask (uint8 grey, grey + alpha, RGB or RGBA; white
    regenerates) -> (pixel mask (1, H, W, 1), latent mask (1, h, w, 1)),
    fp32 in {0, 1}: PIL's convert("L"), NEAREST to the pixel grid,
    thresholded at 0.5, NEAREST again to the latent grid, as the JAX
    package does with PIL."""
    m = resize_nearest_uint8(to_grey_uint8(mask_image), height, width)
    m = (m.astype(np.float32) / 255.0 >= 0.5).astype(np.float32)
    latent = resize_nearest_uint8((m * 255).astype(np.uint8), latent_h,
                                  latent_w).astype(np.float32) / 255.0
    return m[None, :, :, None], latent[None, :, :, None]


class _InitImagePipeline(ConsistentIDPipeline):
    """What img2img and inpainting share: one image a call through
    `_images` (each subclass's signature), `generate` and `generate_async`
    over it, no batch variants."""

    _batch_refusal = "batched generation from an init image is not supported"

    def generate(self, *args, return_float: bool = False, **kwargs):
        """uint8 (1, H, W, 3) numpy images through the safety checker, or
        with return_float the decoded [-1, 1] images on the device; the
        arguments are `_images`'."""
        images = self._images(*args, **kwargs)
        if return_float:
            return images
        return self._check(to_uint8(images).cpu().numpy())

    def generate_async(self, *args, **kwargs) -> Callable[[], np.ndarray]:
        """`generate` through the same path, returning a zero-argument
        callable that yields the uint8 images (`_async`)."""
        return self._async(to_uint8(self._images(*args, sync_stages=False,
                                                 **kwargs)))

    def generate_batch(self, *args, **kwargs):
        raise NotImplementedError(
            f"{self._batch_refusal}; the inherited text-to-image batch path "
            "would silently ignore the init image: call generate() per "
            "image (generate_async overlaps them)")

    generate_batch_async = generate_batch

    def _prepare(self, prompt, face_image, init_image, negative_prompt,
                 height, width, parsing_labels, faceid_embeds):
        """(host cond with "init_image", height, width, the start time of
        the prepare stage)."""
        t0 = time.perf_counter()
        height = height or self.config.height
        width = width or self.config.width
        cond = self.prepare_conditioning(
            prompt, face_image, parsing_labels=parsing_labels,
            faceid_embeds=faceid_embeds, negative_prompt=negative_prompt)
        cond["init_image"] = sd_image_preprocess(init_image, height, width)
        return cond, height, width, t0

    def _noise(self, seed: int, height: int, width: int):
        """(generator seeded `seed` on the bundle's device, the initial
        noise (1, h, w, C) drawn from it first, C the VAE's latent
        channels: a 9-channel UNet denoises 4-channel latents too)."""
        device = self.bundle.device
        gen = torch.Generator(device).manual_seed(seed)
        noise = torch.randn(
            (1, *self._latent_shape(height, width,
                                    self.bundle.vae_config.latent_channels)),
            generator=gen, device=device, dtype=torch.float32)
        return gen, noise

    def _core_args(self, guidance_scale, start_merge_step,
                   num_inference_steps, scheduler):
        cfg = self.config
        return (guidance_scale if guidance_scale is not None
                else cfg.guidance_scale,
                start_merge_step if start_merge_step is not None
                else cfg.start_merge_step,
                num_inference_steps or cfg.num_inference_steps,
                scheduler or cfg.scheduler)

    def _encode_init(self, image: torch.Tensor,
                     posterior_noise: Optional[torch.Tensor],
                     generator: Optional[torch.Generator]):
        """(scaled image latents, the posterior noise used): the VAE
        posterior sampled with `posterior_noise`, else with a draw from
        `generator` in the VAE's dtype (as JAX draws it in the mean's),
        else its mean."""
        vae = self.bundle.vae
        if posterior_noise is None and generator is not None:
            b, h, w, _ = image.shape
            sf = self.bundle.vae_scale_factor
            posterior_noise = torch.randn(
                (b, h // sf, w // sf, self.bundle.vae_config.latent_channels),
                generator=generator, device=image.device,
                dtype=vae.post_quant_conv.weight.dtype)
        return vae.encode(image, noise=posterior_noise), posterior_noise


class ConsistentIDInpaintPipeline(_InitImagePipeline):
    """generate(prompt, face_image, init_image, mask_image, strength=1.0,
    ...): regenerate the mask's white region of init_image."""

    _batch_refusal = "batched inpainting is not supported"

    def _unet_fn(self, unet, ip_scale: float, cond: Dict[str, torch.Tensor],
                 masked_latents: Optional[torch.Tensor], plan: SamplerPlan):
        """unet_fn for `denoise`: the 9-channel UNet gets the latent mask
        and the masked image's latents beside the latents."""
        latent_mask = cond["latent_mask"]

        def unet_fn(x, t, context, added, i):
            if masked_latents is not None:
                n = x.shape[0] // latent_mask.shape[0]
                x = torch.cat([x, latent_mask.repeat(n, 1, 1, 1).to(x),
                               masked_latents.repeat(n, 1, 1, 1).to(x)],
                              dim=-1)
            return unet(x, t, context, ip_scale=ip_scale, added_cond=added)

        return unet_fn

    @torch.no_grad()
    def _inpaint_core(self, cond: Dict[str, torch.Tensor],
                      noise: torch.Tensor, guidance_scale: float,
                      start_merge_step: int, num_steps: int, scheduler: str,
                      ip_scale: float, lora_scale: float, strength: float,
                      generator: Optional[torch.Generator] = None,
                      posterior_noise: Optional[torch.Tensor] = None,
                      sampler_noise: Optional[torch.Tensor] = None,
                      sync_stages: bool = True) -> torch.Tensor:
        """Encode + VAE-encode + denoise + decode from the initial `noise`
        (1, h, w, 4); the posterior noise and the ancestral noise injected
        or drawn from `generator` in that order. Returns the decoded NHWC
        images in [-1, 1]."""
        bundle = self.bundle
        clock = _StageClock(noise.device, sync_stages)
        text_b, facial_b, time_ids = self._branches(cond)
        plan = plan_tail(make_plan(self.schedule, scheduler, num_steps),
                         strength)
        image_latents, posterior_noise = self._encode_init(
            cond["init_image"], posterior_noise, generator)
        nine_channel = bundle.unet_config.sample_channels == 9
        masked_latents = None
        if nine_channel:
            masked = cond["init_image"] * (cond["pixel_mask"] < 0.5).to(
                cond["init_image"])
            masked_latents = bundle.vae.encode(masked, noise=posterior_noise)
        clock.mark("encode")

        if strength >= 1.0:
            latents = noise
        else:
            latents = _noised_init_latents(plan, image_latents, noise)
            # init_scale only applies to a start from pure noise
            plan = dataclasses.replace(plan, init_scale=1.0)
        mask = targets = None
        if not nine_channel:
            mask = cond["latent_mask"]
            targets = _inpaint_target_table(plan, image_latents, noise)
        unet = bundle.infer_unet(lora_scale)
        clock.mark("fold")
        unet_fn = self._unet_fn(unet, ip_scale, cond, masked_latents, plan)
        final = denoise(unet_fn, latents, text_b, facial_b, plan,
                        guidance_scale, start_merge_step,
                        generator=generator, noise=sampler_noise,
                        time_ids=time_ids, inpaint_mask=mask,
                        inpaint_targets=targets)
        clock.mark("denoise")
        images = self._decode(final)
        clock.mark("decode")
        self.last_stage_ms = clock.stages
        return images

    def _extra_cond(self, height: int, width: int, **extra):
        """Host cond entries of the subclass's extra generate() arguments;
        none here."""
        if extra:
            raise TypeError(f"unknown generate() arguments: {sorted(extra)}")
        return {}

    def _images(self, prompt: str, face_image: np.ndarray,
                init_image: np.ndarray, mask_image: np.ndarray,
                strength: float = 1.0, negative_prompt: str = "",
                seed: int = 0, height: Optional[int] = None,
                width: Optional[int] = None,
                num_inference_steps: Optional[int] = None,
                guidance_scale: Optional[float] = None,
                start_merge_step: Optional[int] = None,
                scheduler: Optional[str] = None, ip_scale: float = 1.0,
                lora_scale: float = 1.0,
                parsing_labels: Optional[np.ndarray] = None,
                faceid_embeds: Optional[np.ndarray] = None,
                sync_stages: bool = True, **extra) -> torch.Tensor:
        """init_image (H, W, 3) uint8, mask_image uint8 (grey, RGB or RGBA;
        white regenerates), strength in (0, 1]: the share of the plan that
        runs. Returns the decoded images on the device."""
        cond, height, width, t0 = self._prepare(
            prompt, face_image, init_image, negative_prompt, height, width,
            parsing_labels, faceid_embeds)
        sf = self.bundle.vae_scale_factor
        cond["pixel_mask"], cond["latent_mask"] = preprocess_mask(
            mask_image, height, width, height // sf, width // sf)
        cond.update(self._extra_cond(height, width, **extra))
        prepare_ms = (time.perf_counter() - t0) * 1e3
        gen, noise = self._noise(seed, height, width)
        images = self._inpaint_core(
            self.device_cond(cond), noise,
            *self._core_args(guidance_scale, start_merge_step,
                             num_inference_steps, scheduler),
            ip_scale, lora_scale, float(strength), generator=gen,
            sync_stages=sync_stages)
        self.last_stage_ms = {"prepare": prepare_ms, **self.last_stage_ms}
        return images


class ConsistentIDControlNetInpaintPipeline(ConsistentIDInpaintPipeline):
    """Inpainting with per-step ControlNet residuals: generate(...,
    control_image=(H, W, 3) uint8).

    controlnet: a ControlNet over the bundle's UNet config (by default a
    fresh one, zero output convolutions, on the bundle's device and dtype).
    controlnet_scale scales the residuals at the steps whose progress
    (i + 0.5) / T over the truncated plan lies in [control_guidance_start,
    control_guidance_end], 0 elsewhere; guess_mode conditions the text
    branch only by zeroing the uncond half's residuals (reference
    :389-392). The ControlNet runs every step, as in the JAX package. A
    9-channel UNet is refused: the ControlNet path feeds 4-channel latents
    and blends them (the JAX package would fail on a shape there)."""

    def __init__(self, *args, controlnet: Optional[ControlNet] = None,
                 controlnet_scale: float = 1.0,
                 control_guidance_start: float = 0.0,
                 control_guidance_end: float = 1.0,
                 guess_mode: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bundle.unet_config.sample_channels != 4:
            raise ValueError(
                "ControlNet inpainting runs a 4-channel UNet (latents "
                "blended after each step); this bundle's UNet takes "
                f"{self.bundle.unet_config.sample_channels} channels")
        self.controlnet = controlnet or make_controlnet(
            self.bundle.unet_config, in_channels=4, dtype=self.bundle.dtype,
            device=self.bundle.device)
        self.controlnet_scale = controlnet_scale
        self.control_guidance_start = control_guidance_start
        self.control_guidance_end = control_guidance_end
        self.guess_mode = guess_mode

    def _extra_cond(self, height: int, width: int, control_image=None,
                    **extra):
        if extra:
            raise TypeError(f"unknown generate() arguments: {sorted(extra)}")
        if control_image is None:
            raise TypeError("ControlNet inpainting needs control_image "
                            "((H, W, 3) uint8)")
        # control images stay in [0, 1]
        return {"control_image":
                sd_image_preprocess(control_image, height, width) * 0.5
                + 0.5}

    def scale_table(self, num_steps: int) -> np.ndarray:
        """(T,) residual scale per step of a T-step (truncated) plan."""
        progress = (np.arange(num_steps) + 0.5) / num_steps
        keep = ((progress >= self.control_guidance_start)
                & (progress <= self.control_guidance_end))
        return keep.astype(np.float32) * np.float32(self.controlnet_scale)

    def _unet_fn(self, unet, ip_scale, cond, masked_latents, plan):
        scales = self.scale_table(plan.num_steps)
        control = cond["control_image"]
        b = control.shape[0]
        control2 = control.repeat(2, 1, 1, 1)        # the CFG pair's
        # guess mode: the uncond half's residuals zeroed
        gate = torch.cat([torch.zeros(b), torch.ones(b)]).to(
            control.device).reshape(-1, 1, 1, 1)
        net = self.controlnet

        def unet_fn(x, t, context, added, i):
            down, mid = net(x, t, context, control2,
                            conditioning_scale=float(scales[i]),
                            added_cond=added)
            if self.guess_mode:
                down = tuple(r * gate.to(r.dtype) for r in down)
                mid = mid * gate.to(mid.dtype)
            return unet(x, t, context, ip_scale=ip_scale, added_cond=added,
                        down_block_residuals=down, mid_residual=mid)

        return unet_fn
