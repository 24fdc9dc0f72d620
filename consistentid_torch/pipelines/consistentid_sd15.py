"""ConsistentID SD1.5 text-to-image pipeline on PyTorch.

Counterpart of the JAX package's pipelines/consistentid_sd15.py:
  host prepare (strings, masks, numpy images -> fixed-shape numpy)
    -> encode (three CLIP-L text encodes, one batched ViT-H pass over
       face + zero + 5 regions, ProjPlusModel and FacialEncoder fusion)
    -> LoRA fold -> DDIM CFG denoise with the merge-step switch
    -> VAE decode -> uint8.

Face parsing labels and the ArcFace embedding are injected inputs (as the
JAX pipeline allows); a missing face embedding falls back to zeros like the
reference. Parameters live in the bundle's modules.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Union

import numpy as np
import torch
from torch import nn

from ..adapter import FacialEncoder, ProjPlusModel
from ..conditioning import (fetch_mask_raw_image, masks_for_unique_values,
                            prepare_trigger_token_idx,
                            process_text_with_markers,
                            tokenize_and_mask_trigger_ends)
from ..core.config import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                           PipelineConfig, SchedulerConfig, UNetConfig,
                           VAEConfig)
from ..core.dtypes import resolve_device, resolve_dtype
from ..models import (AutoencoderKL, CLIPTextEncoder, CLIPVisionEncoder, UNet,
                      fold_lora_params)
from ..sampling import CondBranch, NoiseSchedule, denoise, make_plan
from ..utils.image import (center_crop_mask, clip_preprocess,
                           postprocess_to_uint8)

FACE_CAPTION_TEMPLATE = (
    "The person has one face, one nose, two eyes, two ears, and one mouth.")
KEY_REGIONS = ("Face", "Left_Ear", "Right_Ear", "Left_Eye", "Right_Eye",
               "Nose", "Upper_Lip", "Lower_Lip")
MAX_CAPTION_CHARS = 330


def select_key_regions(parsing_mask_list: Dict) -> Dict:
    """Keep Face/Nose plus the first of each Ear/Eye/Lip pair (<=5 regions),
    reproducing reference get_prepare_facemask (:294-309)."""
    out, seen = {}, set()
    for key, mask in parsing_mask_list.items():
        if key not in KEY_REGIONS:
            continue
        if "_" in key:
            suffix = key.split("_")[1]
            if suffix in seen:
                continue
            seen.add(suffix)
        out[key] = mask
    return out


class SD15Bundle(nn.Module):
    """Every model of one SD1.5 ConsistentID pipeline, with its parameters.

    Submodule names match the JAX bundle's parameter tree (unet, vae,
    text_encoder, image_encoder, proj, facial_encoder), so
    `load_state_dict(params_from_jax(tree))` carries JAX weights across.
    Modules are built on the meta device and materialised once on `device`
    in `dtype`, then initialised by `init_params`. Training keeps the
    trainable subset as fp32 masters (`training.create_train_state`);
    `call` runs a submodule in `dtype` either way.
    """

    def __init__(self, unet_config: UNetConfig,
                 adapter_config: AdapterConfig = AdapterConfig(),
                 vae_config: VAEConfig = VAEConfig(),
                 text_config: CLIPTextConfig = CLIPTextConfig(),
                 vision_config: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Union[str, torch.device] = "cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.unet_config = unet_config
        self.adapter_config = a = adapter_config
        self.vae_config = vae_config
        self.text_config = text_config
        self.vision_config = vision_config
        with torch.device("meta"):
            self.unet = UNet(unet_config)
            self.vae = AutoencoderKL(vae_config)
            self.text_encoder = CLIPTextEncoder(text_config)
            self.image_encoder = CLIPVisionEncoder(vision_config)
            self.proj = ProjPlusModel(
                cross_attention_dim=a.cross_attention_dim,
                id_embeddings_dim=a.id_embeddings_dim,
                clip_embeddings_dim=a.clip_embeddings_dim,
                num_tokens=a.num_id_tokens)
            self.facial_encoder = FacialEncoder(
                embedding_dim=a.clip_embeddings_dim,
                output_dim=a.facial_output_dim,
                embed_dim=a.cross_attention_dim,
                facial_dim=a.facial_dim, facial_depth=a.facial_depth,
                facial_heads=a.facial_heads,
                facial_dim_head=a.facial_dim_head)
        self.to_empty(device=device)
        self.to(resolve_dtype(dtype))
        self.requires_grad_(False)
        self.init_params(torch.Generator(device).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.unet.conv_in.weight.dtype

    @property
    def vae_scale_factor(self) -> int:
        return 2 ** (len(self.vae_config.block_out_channels) - 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Semantic initialisation (training from scratch, tests): fan-in
        normal weights, zero biases, unit norms, zero LoRA up-projections,
        N(0, 1/rank) LoRA down-projections, zero position/class embeddings,
        N(0, 1/dim) perceiver latents."""
        for name, p in self.named_parameters():
            owner, leaf = name.split(".")[-2:]
            if name.endswith("_lora.up.weight"):
                p.zero_()
            elif name.endswith("_lora.down.weight"):
                p.normal_(0.0, 1.0 / p.shape[0], generator=generator)
            elif leaf == "latents":
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=generator)
            elif leaf in ("position_embedding", "class_embedding", "bias"):
                p.zero_()
            elif p.dim() == 1:      # norm scales
                p.fill_(1.0)
            elif owner == "token_embedding":
                p.normal_(0.0, 1.0, generator=generator)
            else:                   # Linear (out, in) / Conv (out, in, kh, kw)
                fan_in = p[0].numel()
                p.normal_(0.0, fan_in ** -0.5, generator=generator)

    @torch.no_grad()
    def random_params(self, generator: torch.Generator,
                      std: float = 0.02) -> None:
        """Fill every parameter with N(0, std) on its device: weights for
        benchmarks and smoke runs only (no semantic initialisers)."""
        for p in self.parameters():
            p.normal_(0.0, std, generator=generator)

    def call(self, module: nn.Module, *args, **kwargs):
        """Run a submodule in the bundle's compute dtype. Parameters stored
        in another dtype (the fp32 masters of the trainable subset, see
        training/train_step.py) are cast at use, and their gradients flow
        back to the masters in fp32, as flax casts fp32 weights at use."""
        cast = {name: p.to(self.dtype) for name, p in
                module.named_parameters() if p.dtype != self.dtype}
        if not cast:
            return module(*args, **kwargs)
        return torch.func.functional_call(module, cast, args, kwargs)

    def infer_unet(self, lora_scale: float) -> UNet:
        """The UNet the denoise loop runs: LoRA folded into the base
        projections once per call, so every step is LoRA-free, and every
        weight in the bundle's dtype. Unfolded tensors of that dtype are
        shared with `self.unet`, not copied."""
        if self.unet_config.lora_rank == 0 and all(
                p.dtype == self.dtype for p in self.unet.parameters()):
            return self.unet
        folded = {k: v.to(self.dtype) for k, v in fold_lora_params(
            self.unet.state_dict(), lora_scale).items()}
        with torch.device("meta"):
            unet = UNet(dataclasses.replace(self.unet_config, lora_rank=0))
        unet.load_state_dict(folded, assign=True)
        return unet


class ConsistentIDPipeline:
    """generate(prompt, face_image, ...) -> uint8 (B, H, W, 3) images."""

    def __init__(self, bundle: SD15Bundle, tokenizer,
                 pipeline_config: Optional[PipelineConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None):
        self.bundle = bundle
        self.tokenizer = tokenizer
        # register the trigger tokens (reference :148-150); idempotent
        tokenizer.add_tokens(["<|image|>", "<|facial|>"])
        self.config = pipeline_config or PipelineConfig()
        self.schedule = NoiseSchedule.create(
            scheduler_config or SchedulerConfig())
        self._facial_token_id = tokenizer.convert_tokens_to_ids("<|facial|>")
        # per-stage times of the last _generate_core call, in ms
        self.last_stage_ms: Dict[str, float] = {}

    # ---------------- host-side prepare ----------------

    def _tokenize_padded(self, text: str) -> np.ndarray:
        ids = list(self.tokenizer.encode(text))[
            :self.tokenizer.model_max_length]
        ids += [self.tokenizer.pad_token_id] * (
            self.tokenizer.model_max_length - len(ids))
        return np.asarray(ids, np.int64)[None]

    def prepare_conditioning(
        self,
        prompt: str,
        face_image: np.ndarray,
        parsing_labels: Optional[np.ndarray] = None,
        faceid_embeds: Optional[np.ndarray] = None,
        face_caption: Optional[str] = None,
        negative_prompt: str = "",
        max_num_facials: int = 5,
    ) -> Dict[str, np.ndarray]:
        """Strings, masks and pixels -> fixed-shape numpy arrays.
        face_image: (H, W, 3) uint8; parsing_labels: (H, W) label map of
        the same size (face parsing is not ported yet, so it is required)."""
        if parsing_labels is None:
            raise ValueError("pass parsing_labels: the face parser is not "
                             "part of the port yet")
        if faceid_embeds is None:  # no detector: zero fallback (ref :220-221)
            faceid_embeds = np.zeros(
                (1, self.bundle.adapter_config.id_embeddings_dim), np.float32)
        face_caption = face_caption or FACE_CAPTION_TEMPLATE

        region_masks = select_key_regions(
            masks_for_unique_values(parsing_labels))
        caption_aligned, region_masks = process_text_with_markers(
            face_caption, region_masks)

        prompt_face = prompt + "Detail:" + caption_aligned
        if len(self.tokenizer.encode(prompt_face)) > \
                self.tokenizer.model_max_length:
            prompt_face = "Detail:" + caption_aligned + " Caption:" + prompt
        if len(face_caption) > MAX_CAPTION_CHARS:
            prompt_face = prompt
        prompt_text_only = prompt_face.replace("<|facial|>", "").replace(
            "<|image|>", "")

        clean_ids, img_mask, fac_mask = tokenize_and_mask_trigger_ends(
            prompt_face, None, self._facial_token_id, self.tokenizer)
        _, _, facial_idx, facial_idx_mask = prepare_trigger_token_idx(
            img_mask, fac_mask, 1, max_num_facials)

        size = self.bundle.vision_config.image_size
        regions = np.zeros((max_num_facials, size, size, 3), np.float32)
        region_mask_maps = np.zeros((max_num_facials, 512, 512), np.float32)
        for i, mask in enumerate(region_masks.values()):
            if i >= max_num_facials:
                break
            masked = fetch_mask_raw_image(face_image, mask)
            regions[i] = clip_preprocess(masked, size)[0]
            region_mask_maps[i] = center_crop_mask(mask, 512)

        return {
            "clean_ids": clean_ids.astype(np.int32),
            "text_only_ids":
                self._tokenize_padded(prompt_text_only).astype(np.int32),
            "negative_ids":
                self._tokenize_padded(negative_prompt).astype(np.int32),
            "facial_idx": facial_idx.astype(np.int32),
            "facial_idx_mask": facial_idx_mask,
            "face_pixels": clip_preprocess(face_image, size),
            "region_pixels": regions[None],          # (1, 5, S, S, 3)
            "region_masks": region_mask_maps[None],  # (1, 5, 512, 512)
            "faceid_embeds": np.asarray(faceid_embeds, np.float32),
        }

    def device_cond(self, cond: Dict[str, np.ndarray]) -> Dict:
        """Host cond -> tensors on the bundle's device (region_masks stay on
        the host: no inference graph reads them)."""
        dev = self.bundle.device
        out = {}
        for key, val in cond.items():
            if key == "region_masks":
                continue
            t = torch.from_numpy(np.ascontiguousarray(val))
            if t.dtype == torch.int32:
                t = t.long()
            out[key] = t.to(dev)
        return out

    # ---------------- device stages ----------------

    @torch.no_grad()
    def encode_embeddings(self, cond: Dict[str, torch.Tensor]):
        """(null, augmented, text_only) context embeddings,
        (B, 77 + num_id_tokens, D) each."""
        b = self.bundle
        a = b.adapter_config
        dtype = b.dtype
        enc_marked, _ = b.text_encoder(cond["clean_ids"])
        enc_text_only, _ = b.text_encoder(cond["text_only_ids"])
        enc_negative, _ = b.text_encoder(cond["negative_ids"])

        # one batched ViT pass: [face x B, zeros, regions x B*5]
        size = b.vision_config.image_size
        bs, n_regions = cond["region_pixels"].shape[:2]
        face = cond["face_pixels"].to(dtype)
        vit_in = torch.cat([
            face, torch.zeros((1, size, size, 3), dtype=dtype,
                              device=face.device),
            cond["region_pixels"].reshape(-1, size, size, 3).to(dtype)])
        _, penult = b.image_encoder(vit_in)
        face_emb, zero_emb = penult[:bs], penult[bs:bs + 1]
        region_embs = penult[bs + 1:].reshape(bs, n_regions,
                                              *penult.shape[1:])
        zero_regions = zero_emb[:, None].expand_as(region_embs)

        faceid = cond["faceid_embeds"].to(dtype)
        faceid_tokens = b.call(b.proj, faceid, face_emb, shortcut=a.shortcut,
                               scale=a.shortcut_scale)
        uncond_faceid_tokens = b.call(
            b.proj, torch.zeros_like(faceid), zero_emb.expand(bs, -1, -1),
            shortcut=a.shortcut, scale=a.shortcut_scale)

        fused = b.call(b.facial_encoder, enc_marked, region_embs,
                       cond["facial_idx"], cond["facial_idx_mask"])
        uncond_fused = b.call(b.facial_encoder, enc_negative, zero_regions,
                              cond["facial_idx"], cond["facial_idx_mask"])

        augmented = torch.cat([fused, faceid_tokens], dim=1)
        null = torch.cat([uncond_fused, uncond_faceid_tokens], dim=1)
        text_only = torch.cat([enc_text_only, faceid_tokens], dim=1)
        return null, augmented, text_only

    @torch.no_grad()
    def _generate_core(self, cond: Dict[str, torch.Tensor],
                       latents: torch.Tensor, guidance_scale: float,
                       start_merge_step: int, num_steps: int, scheduler: str,
                       ip_scale: float, lora_scale: float) -> torch.Tensor:
        """Encode + denoise + decode from injected NHWC latents; returns the
        decoded NHWC images in [-1, 1] (bundle dtype). Stage times land in
        `last_stage_ms` (synchronising at stage boundaries on the card)."""
        clock = _StageClock(latents.device)
        null_e, aug_e, text_e = self.encode_embeddings(cond)
        n = latents.shape[0]
        if null_e.shape[0] != n:
            null_e, aug_e, text_e = (
                e.repeat_interleave(n // e.shape[0], dim=0)
                for e in (null_e, aug_e, text_e))
        clock.mark("encode")
        plan = make_plan(self.schedule, scheduler, num_steps)
        unet = self.bundle.infer_unet(lora_scale)

        def unet_fn(x, t, context):
            return unet(x, t, context, ip_scale=ip_scale)

        final = denoise(unet_fn, latents,
                        CondBranch(context=text_e, null=null_e),
                        CondBranch(context=aug_e, null=null_e),
                        plan, guidance_scale, start_merge_step)
        clock.mark("denoise")
        images = self.bundle.vae.decode(final)
        clock.mark("decode")
        self.last_stage_ms = clock.stages
        return images

    def generate(
        self,
        prompt: str,
        face_image: np.ndarray,
        negative_prompt: str = "",
        seed: int = 0,
        height: Optional[int] = None,
        width: Optional[int] = None,
        num_inference_steps: Optional[int] = None,
        guidance_scale: Optional[float] = None,
        start_merge_step: Optional[int] = None,
        scheduler: Optional[str] = None,
        ip_scale: float = 1.0,
        lora_scale: float = 1.0,
        parsing_labels: Optional[np.ndarray] = None,
        faceid_embeds: Optional[np.ndarray] = None,
        num_images_per_prompt: int = 1,
        return_float: bool = False,
    ):
        """uint8 (N, H, W, 3) numpy images; with return_float the decoded
        [-1, 1] images as a tensor on the device instead."""
        cfg = self.config
        height = height or cfg.height
        width = width or cfg.width
        cond = self.device_cond(self.prepare_conditioning(
            prompt, face_image, parsing_labels=parsing_labels,
            faceid_embeds=faceid_embeds, negative_prompt=negative_prompt))
        sf = self.bundle.vae_scale_factor
        device = self.bundle.device
        gen = torch.Generator(device).manual_seed(seed)
        latents = torch.randn(
            (num_images_per_prompt, height // sf, width // sf,
             self.bundle.unet_config.sample_channels),
            generator=gen, device=device, dtype=torch.float32)
        images = self._generate_core(
            cond, latents,
            guidance_scale if guidance_scale is not None
            else cfg.guidance_scale,
            start_merge_step if start_merge_step is not None
            else cfg.start_merge_step,
            num_inference_steps or cfg.num_inference_steps,
            scheduler or cfg.scheduler, ip_scale, lora_scale)
        if return_float:
            return images
        return postprocess_to_uint8(images)


class _StageClock:
    """Wall time per stage, in ms. On the card each mark synchronises, so a
    stage's time is its device time plus its host launch overhead."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stages: Dict[str, float] = {}
        self._sync()
        self._last = time.perf_counter()

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def mark(self, name: str) -> None:
        self._sync()
        now = time.perf_counter()
        self.stages[name] = (now - self._last) * 1e3
        self._last = now
