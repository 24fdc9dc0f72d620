"""ConsistentID SD1.5 text-to-image pipeline on PyTorch.

Counterpart of the JAX package's pipelines/consistentid_sd15.py:
  host prepare (strings, masks, numpy images -> fixed-shape numpy)
    -> encode (three CLIP-L text encodes, one batched ViT-H pass over
       face + zero + 5 regions, ProjPlusModel and FacialEncoder fusion)
    -> LoRA fold -> CFG denoise with the merge-step switch (any of the five
       samplers) -> VAE decode -> uint8 on the device.
`generate` serves one prompt, `generate_batch` distinct requests as one
batch (the serving path), and their `_async` variants return a callable
that collects the images later. Each takes `cache_interval` (the config's
by default): above 1 the UNet runs DeepCache's split (`_unet_fns`). The
img2img and inpainting pipelines (pipelines/img2img.py, inpaint.py) build
on this one.

Face parsing labels and the ArcFace embedding are either injected or made
from the photo by the `face_parser` and `face_embedder` hooks
(models/bisenet.py, models/arcface.py with models/scrfd.py), as in the JAX
pipeline; with neither an embedding nor an embedder the embedding is zeros,
like the reference's no-face fallback. A `safety_checker` hook
(models/safety_checker.py) runs on the uint8 images. Parameters live in the
bundle's modules.

`mesh` (parallel/mesh.py; JAX :299-328, 731-739, 834-844): with a model
axis, every request's UNet (LoRA folded first) is split over the model
group (parallel/tensor_parallel.py); with a data axis that divides the
batch, every rank draws the global latents from the same generator, keeps
its rows (in `generate_batch` whole requests, every conditioning row of a
request together), denoises and decodes them, and an all-gather returns
the full batch on every rank, as the JAX call returns the full array. So
for one seed the images are the single-device ones. A batch the data axis
does not divide runs whole on every rank (JAX's rule).
"""
from __future__ import annotations

import copy
import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Union

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
from ..models.layers import calibration
from ..ops.quant import (act_scales_from_calib, act_scales_to_numpy,
                         merge_act_scales, quantize_state_like)
from ..parallel.mesh import (all_gather_cat, data_axis_size, model_axis_size,
                             shard_rows)
from ..parallel.tensor_parallel import tensor_parallel_unet
from ..sampling import CondBranch, NoiseSchedule, denoise, make_plan
from ..utils.image import (center_crop_mask, clip_preprocess,
                           resize_bicubic_uint8, to_uint8)
from ..utils.png import as_rgb

FACE_CAPTION_TEMPLATE = (
    "The person has one face, one nose, two eyes, two ears, and one mouth.")
KEY_REGIONS = ("Face", "Left_Ear", "Right_Ear", "Left_Eye", "Right_Eye",
               "Nose", "Upper_Lip", "Lower_Lip")
MAX_CAPTION_CHARS = 330
# the bundle's quant modes -> the UNet's `quant` (JAX SD15Bundle)
QUANT_MODES = {"none": False, "int8": True, "int8_static": "static"}
# nn.Module's own containers (submodules, parameters, buffers, hooks):
# what a shallow copy of a module must not share with its original
_MODULE_REGISTRIES = tuple(k for k, v in vars(nn.Module()).items()
                           if isinstance(v, (dict, set)))


def check_quant(quant: str, act_scales) -> None:
    """JAX SD15Bundle.__post_init__'s checks: a known mode, and calibrated
    act_scales for int8_static."""
    if quant not in QUANT_MODES:
        raise ValueError(f"quant must be one of {sorted(QUANT_MODES)}: "
                         f"{quant}")
    if quant == "int8_static" and act_scales is None:
        raise ValueError(
            "quant='int8_static' needs calibrated act_scales: run "
            "pipeline.calibrate_int8() or load a saved artifact "
            "(io.quant_scales.load_act_scales)")


def check_tensor_parallel(config: UNetConfig, tp: int) -> None:
    """ValueError unless `tp` divides every transformer level's heads (JAX's
    GSPMD pads such a split; the port keeps whole heads per rank)."""
    for level, heads in enumerate(config.num_attention_heads):
        has_attn = (config.down_block_has_attn[level]
                    or level == len(config.num_attention_heads) - 1)
        if has_attn and heads % tp:
            raise ValueError(f"UNet level {level}: {heads} attention heads "
                             f"do not split over a tensor-parallel degree "
                             f"of {tp}")


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

    `quant` (JAX `SD15Bundle.quant`): "none", "int8" (the W8A8 UNet with
    dynamic activation scales) or "int8_static" (calibrated per-tensor
    scales, `act_scales`, a {module: {"act_scale": scale}} tree). It
    changes only the UNet the inference paths run (`infer_unet`); the
    parameters stay float. `quantized` gives a twin at another mode that
    shares them.
    """

    def __init__(self, unet_config: UNetConfig,
                 adapter_config: AdapterConfig = AdapterConfig(),
                 vae_config: VAEConfig = VAEConfig(),
                 text_config: CLIPTextConfig = CLIPTextConfig(),
                 vision_config: CLIPVisionConfig = CLIPVisionConfig(),
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 quant: str = "none", act_scales: Optional[Dict] = None):
        check_quant(quant, act_scales)
        super().__init__()
        self.quant = quant
        self.act_scales = act_scales
        device = resolve_device(device)
        self.unet_config = unet_config
        self.adapter_config = adapter_config
        self.vae_config = vae_config
        self.text_config = text_config
        self.vision_config = vision_config
        with torch.device("meta"):
            self._make_modules()
        self.to_empty(device=device)
        self.to(resolve_dtype(dtype))
        self.requires_grad_(False)
        self.init_params(torch.Generator(device).manual_seed(seed))

    # rematerialise the training UNet's blocks (models/unet.py), as the JAX
    # bundle's fields do; off until set
    @property
    def remat(self) -> bool:
        return self.unet.remat

    @remat.setter
    def remat(self, value: bool) -> None:
        self.unet.remat = bool(value)

    @property
    def remat_policy(self) -> str:
        return self.unet.remat_policy

    @remat_policy.setter
    def remat_policy(self, value: str) -> None:
        self.unet.remat_policy = value

    def _make_modules(self) -> None:
        """Build the submodules (on the meta device, from the configs)."""
        a = self.adapter_config
        self.unet = UNet(self.unet_config)
        self.vae = AutoencoderKL(self.vae_config)
        self.text_encoder = CLIPTextEncoder(self.text_config)
        self.image_encoder = CLIPVisionEncoder(self.vision_config)
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

    def quantized(self, quant: str,
                  act_scales: Optional[Dict] = None) -> "SD15Bundle":
        """A twin of this bundle serving its UNet at `quant` (act_scales:
        by default this bundle's). The submodules and tensors are shared;
        the registries that hold them are the twin's own, so assigning a
        submodule, parameter or buffer on either bundle leaves the other's
        as it was."""
        act_scales = act_scales if act_scales is not None \
            else self.act_scales
        check_quant(quant, act_scales)
        twin = copy.copy(self)
        for name in _MODULE_REGISTRIES:
            twin.__dict__[name] = copy.copy(self.__dict__[name])
        twin.quant = quant
        twin.act_scales = act_scales
        return twin

    def infer_unet(self, lora_scale: float) -> UNet:
        """The UNet the denoise loop runs: LoRA folded into the base
        projections once per call, so every step is LoRA-free, and every
        weight in the bundle's dtype. Unfolded tensors of that dtype are
        shared with `self.unet`, not copied. Under int8 the folded weights
        are then quantized (JAX infer_unet), still once per call."""
        if self.quant == "none" and self.unet_config.lora_rank == 0 and all(
                p.dtype == self.dtype for p in self.unet.parameters()):
            return self.unet
        return self._folded_unet(lora_scale, QUANT_MODES[self.quant])

    def calibration_unet(self, lora_scale: float = 1.0) -> UNet:
        """The dynamic int8 twin calibration runs (JAX calibration_unet):
        the serving graph of quant="int8", its layers recording their
        activation amax under `models.layers.calibration`."""
        return self._folded_unet(lora_scale, True)

    def _folded_unet(self, lora_scale: float, quant) -> UNet:
        folded = {k: v.to(self.dtype) for k, v in fold_lora_params(
            self.unet.state_dict(), lora_scale).items()}
        with torch.device("meta"):
            unet = UNet(dataclasses.replace(self.unet_config, lora_rank=0),
                        quant=quant)
        if quant:
            folded = quantize_state_like(
                unet.state_dict(), folded,
                self.act_scales if quant == "static" else None)
        unet.load_state_dict(folded, assign=True)
        return unet


class ConsistentIDPipeline:
    """generate(prompt, face_image, ...) -> uint8 (B, H, W, 3) images."""

    def __init__(self, bundle: SD15Bundle, tokenizer,
                 pipeline_config: Optional[PipelineConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 face_parser: Optional[Callable] = None,
                 face_embedder: Optional[Callable] = None,
                 safety_checker: Optional[Callable] = None, mesh=None):
        """face_parser: (H, W, 3) uint8 -> (H, W) label map; face_embedder:
        (H, W, 3) uint8 -> (1, D) embedding; safety_checker: uint8
        (B, H, W, 3) -> (images, (B,) bool flags); mesh: a
        parallel.Mesh (module docstring)."""
        check_tensor_parallel(bundle.unet_config, model_axis_size(mesh))
        self.mesh = mesh
        self.bundle = bundle
        self.tokenizer = tokenizer
        # register the trigger tokens (reference :148-150); idempotent
        tokenizer.add_tokens(["<|image|>", "<|facial|>"])
        self.config = pipeline_config or PipelineConfig()
        self.schedule = NoiseSchedule.create(
            scheduler_config or SchedulerConfig())
        self._facial_token_id = tokenizer.convert_tokens_to_ids("<|facial|>")
        self.face_parser = face_parser
        self.face_embedder = face_embedder
        self.safety_checker = safety_checker
        self.last_nsfw_flags = None  # set per call when a checker is active
        # per-stage times of the last generate call, in ms: prepare (host
        # work and the perception hooks), encode, fold (the LoRA fold and,
        # under int8, the weight quantization), denoise, decode (those four
        # of _generate_core) and safety
        self.last_stage_ms: Dict[str, float] = {}

    # ---------------- int8 ----------------

    def with_quant(self, quant: str,
                   act_scales: Optional[Dict] = None
                   ) -> "ConsistentIDPipeline":
        """The same pipeline serving its UNet at `quant` ("none", "int8",
        "int8_static"; JAX with_quant): parameters, tokenizers and hooks
        shared, the bundle a twin (`SD15Bundle.quantized`). "int8_static"
        needs `act_scales` or a bundle calibrated before
        (`calibrate_int8`). Works for every subclass."""
        p = copy.copy(self)
        p.bundle = self.bundle.quantized(quant, act_scales)
        return p

    def _calibration_batch(self, cond: Dict[str, torch.Tensor]):
        """(contexts, added_cond) of every context the serving loop feeds
        the UNet: the CFG null, the facial-augmented and the text-only
        ones, concatenated (JAX `_calibration_batch`)."""
        null_e, aug_e, text_e = self.encode_embeddings(cond)
        return torch.cat([null_e, aug_e, text_e]), None

    @torch.no_grad()
    def calibrate_int8(self, prompt: Optional[str] = None,
                       face_image: Optional[np.ndarray] = None,
                       num_calib_steps: int = 8, seed: int = 0,
                       margin: float = 1.1, negative_prompt: str = "",
                       parsing_labels: Optional[np.ndarray] = None,
                       faceid_embeds: Optional[np.ndarray] = None,
                       height: Optional[int] = None,
                       width: Optional[int] = None, lora_scale: float = 1.0,
                       samples: Optional[Sequence] = None,
                       noise: Optional[Sequence] = None
                       ) -> "ConsistentIDPipeline":
        """Max calibration (the JAX package's calibrate_int8) -> a pipeline
        serving quant="int8_static" with the scales found.

        The dynamic int8 twin (`calibration_unet`, LoRA folded at
        `lora_scale`: calibrate at the scale generation will fold) runs
        once per step on q-sample latents sqrt(a_t) x0 + sqrt(1 - a_t) eps
        at `num_calib_steps` timesteps spread over the schedule
        (linspace(0, T - 1, n), rounded), x0 the VAE encoding of the face
        resized to the generation size (PIL's BICUBIC, bit for bit), with
        the real contexts (`_calibration_batch`). Every int8 layer records
        its activation amax; per step the records become scales (times
        `margin`) and steps and samples are max-merged.

        samples: (prompt, face) pairs or dicts with prompt, face_image and
        optionally negative_prompt, parsing_labels, faceid_embeds, instead
        of one (prompt, face_image). Every sample sees the same noise
        sequence, from a generator seeded `seed` on the bundle's device, so
        the merged tree is the elementwise max of the per-sample trees;
        `noise` injects that sequence (num_calib_steps arrays of the
        latents' shape (1, h, w, C)). Save the result with
        io.quant_scales.save_act_scales(path, pipe.bundle.act_scales)."""
        cfg = self.config
        height = height or cfg.height
        width = width or cfg.width
        if samples is None:
            if prompt is None or face_image is None:
                raise ValueError(
                    "calibrate_int8 needs (prompt, face_image) or samples=")
            samples = [{"prompt": prompt, "face_image": face_image,
                        "negative_prompt": negative_prompt,
                        "parsing_labels": parsing_labels,
                        "faceid_embeds": faceid_embeds}]
        else:
            samples = [s if isinstance(s, dict)
                       else {"prompt": s[0], "face_image": s[1]}
                       for s in samples]
        if noise is not None and len(noise) != num_calib_steps:
            raise ValueError(f"{len(noise)} noise arrays for "
                             f"{num_calib_steps} calibration steps")
        b = self.bundle
        device = b.device
        unet = b.calibration_unet(lora_scale)
        n_train = len(self.schedule.alphas_cumprod)
        ts = np.linspace(0, n_train - 1,
                         num_calib_steps).round().astype(np.int64)
        scales = None
        for sample in samples:
            gen = torch.Generator(device).manual_seed(seed)
            cond = self.device_cond(self.prepare_conditioning(
                sample["prompt"], sample["face_image"],
                parsing_labels=sample.get("parsing_labels"),
                faceid_embeds=sample.get("faceid_embeds"),
                negative_prompt=sample.get("negative_prompt", "")))
            ctx, added = self._calibration_batch(cond)
            img = resize_bicubic_uint8(as_rgb(sample["face_image"]), height,
                                       width)
            pixels = torch.from_numpy(
                img.astype(np.float32) / 127.5 - 1.0)[None].to(device)
            x0 = b.vae.encode(pixels).float()
            for i, t in enumerate(ts):
                eps = (torch.randn(x0.shape, generator=gen, device=device)
                       if noise is None else torch.from_numpy(
                           np.array(noise[i], np.float32)).to(device))
                tt = torch.full((ctx.shape[0],), int(t), device=device)
                xt = self.schedule.add_noise(x0, eps, tt[:1])
                with calibration(unet) as records:
                    unet(xt.expand(ctx.shape[0], *xt.shape[1:]), tt, ctx,
                         added_cond=added)
                step = act_scales_from_calib(records, margin)
                scales = (step if scales is None
                          else merge_act_scales([scales, step]))
        return self.with_quant("int8_static",
                               act_scales=act_scales_to_numpy(scales))

    # ---------------- host-side prepare ----------------

    def _tokenize_padded(self, text: str, tokenizer=None) -> np.ndarray:
        """(1, model_max_length) ids of `text`, truncated or padded with the
        tokenizer's pad id (by default the pipeline's tokenizer)."""
        tok = tokenizer or self.tokenizer
        ids = list(tok.encode(text))[:tok.model_max_length]
        ids += [tok.pad_token_id] * (tok.model_max_length - len(ids))
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
        the same size, else made by the face parser; faceid_embeds: else
        made by the face embedder, else zeros."""
        if parsing_labels is None:
            if self.face_parser is None:
                raise ValueError("pass parsing_labels or configure "
                                 "face_parser")
            parsing_labels = self.face_parser(face_image)
        if faceid_embeds is None:
            if self.face_embedder is not None:
                faceid_embeds = self.face_embedder(face_image)
            else:  # no detector: zero fallback (reference :220-221)
                faceid_embeds = np.zeros(
                    (1, self.bundle.adapter_config.id_embeddings_dim),
                    np.float32)
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
        # recorded for the dual-tokenizer SDXL pipeline, which re-tokenizes
        # them with its second tokenizer
        self._last_prompt_face = prompt_face
        self._last_prompt_text_only = prompt_text_only

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
        enc_marked, _ = b.text_encoder(cond["clean_ids"])
        enc_text_only, _ = b.text_encoder(cond["text_only_ids"])
        enc_negative, _ = b.text_encoder(cond["negative_ids"])
        fused, uncond_fused, faceid_tokens, uncond_faceid_tokens = \
            self._adapter_tokens(cond, enc_marked, enc_negative)
        augmented = torch.cat([fused, faceid_tokens], dim=1)
        null = torch.cat([uncond_fused, uncond_faceid_tokens], dim=1)
        text_only = torch.cat([enc_text_only, faceid_tokens], dim=1)
        return null, augmented, text_only

    def _adapter_tokens(self, cond: Dict[str, torch.Tensor],
                        enc_marked: torch.Tensor, enc_negative: torch.Tensor):
        """The adapters' outputs: the FacialEncoder's fused prompt states
        for the marked and the negative prompt, and the ID tokens of the
        face and of the zero image. One batched ViT-H pass over [face x B,
        zeros, regions x B*5] feeds both."""
        b = self.bundle
        a = b.adapter_config
        dtype = b.dtype
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
        return fused, uncond_fused, faceid_tokens, uncond_faceid_tokens

    def _branches(self, cond: Dict[str, torch.Tensor]):
        """(text-only branch, facial branch, time_ids) of the denoise loop;
        SD1.5: one null for both, no pooled embeddings or time ids."""
        null_e, aug_e, text_e = self.encode_embeddings(cond)
        return (CondBranch(context=text_e, null=null_e),
                CondBranch(context=aug_e, null=null_e), None)

    def _decode(self, final: torch.Tensor) -> torch.Tensor:
        return self.bundle.vae.decode(final)

    @torch.no_grad()
    def _generate_core(self, cond: Dict[str, torch.Tensor],
                       latents: torch.Tensor, guidance_scale: float,
                       start_merge_step: int, num_steps: int, scheduler: str,
                       ip_scale: float, lora_scale: float,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None,
                       sync_stages: bool = True,
                       cache_interval: int = 1) -> torch.Tensor:
        """Encode + denoise + decode from injected NHWC latents; returns the
        decoded NHWC images in [-1, 1] (the decoder's dtype). `generator`
        or `noise` feed an ancestral sampler (`denoise`). With
        `sync_stages` the stage times land in `last_stage_ms`
        (synchronising at stage boundaries on the card); without, nothing
        waits for the card. cache_interval > 1: DeepCache (`_unet_fns`)."""
        clock = _StageClock(latents.device, sync_stages)
        text_b, facial_b, time_ids = self._branches(cond)
        n = latents.shape[0]
        if text_b.context.shape[0] != n:
            # num_images_per_prompt: each request's conditioning repeated
            def rep(e):
                return (None if e is None
                        else e.repeat_interleave(n // e.shape[0], dim=0))
            text_b, facial_b = (
                CondBranch(*(rep(getattr(b, f.name))
                             for f in dataclasses.fields(b)))
                for b in (text_b, facial_b))
            time_ids = rep(time_ids)
        clock.mark("encode")
        plan = make_plan(self.schedule, scheduler, num_steps)
        unet = tensor_parallel_unet(self.bundle.infer_unet(lora_scale),
                                    self.mesh)
        clock.mark("fold")
        unet_fn, unet_cached_fn = self._unet_fns(unet, ip_scale,
                                                 cache_interval)
        final = denoise(unet_fn, latents, text_b, facial_b, plan,
                        guidance_scale, start_merge_step,
                        generator=generator, noise=noise, time_ids=time_ids,
                        cache_interval=cache_interval,
                        unet_cached_fn=unet_cached_fn)
        clock.mark("denoise")
        images = self._decode(final)
        clock.mark("decode")
        self.last_stage_ms = clock.stages
        return images

    @staticmethod
    def _unet_fns(unet, ip_scale: float, cache_interval: int):
        """(unet_fn, unet_cached_fn) for `denoise`. With cache_interval > 1
        (DeepCache) the full fn also returns the deep feature and the
        cached fn runs the shallow path on it (models/unet.py)."""
        if cache_interval > 1:
            def unet_fn(x, t, context, added, i):
                return unet(x, t, context, ip_scale=ip_scale,
                            added_cond=added, return_deep=True)

            def unet_cached_fn(x, t, context, added, i, deep):
                return unet(x, t, context, ip_scale=ip_scale,
                            added_cond=added, deep_feature=deep)

            return unet_fn, unet_cached_fn

        def unet_fn(x, t, context, added, i):
            return unet(x, t, context, ip_scale=ip_scale, added_cond=added)

        return unet_fn, None

    def _latent_shape(self, height: Optional[int], width: Optional[int],
                      channels: Optional[int] = None):
        """(h, w, C) of the latents at a request's size; C the UNet's
        sample channels unless given."""
        sf = self.bundle.vae_scale_factor
        return ((height or self.config.height) // sf,
                (width or self.config.width) // sf,
                channels or self.bundle.unet_config.sample_channels)

    def _run(self, host_cond: Dict[str, np.ndarray], latents: torch.Tensor,
             generator: torch.Generator, prepare_ms: float,
             guidance_scale: Optional[float] = None,
             start_merge_step: Optional[int] = None,
             num_inference_steps: Optional[int] = None,
             scheduler: Optional[str] = None, ip_scale: float = 1.0,
             lora_scale: float = 1.0, sync_stages: bool = True,
             cache_interval: Optional[int] = None) -> torch.Tensor:
        cfg = self.config
        num_steps = num_inference_steps or cfg.num_inference_steps
        scheduler = scheduler or cfg.scheduler
        host_cond, latents, noise, split = self._data_shard(
            host_cond, latents, generator, scheduler, num_steps)
        images = self._generate_core(
            self.device_cond(host_cond), latents,
            guidance_scale if guidance_scale is not None
            else cfg.guidance_scale,
            start_merge_step if start_merge_step is not None
            else cfg.start_merge_step,
            num_steps, scheduler, ip_scale, lora_scale,
            generator=None if noise is not None else generator,
            noise=noise, sync_stages=sync_stages,
            cache_interval=(cache_interval if cache_interval is not None
                            else cfg.cache_interval))
        if split:
            images = all_gather_cat(images, self.mesh.data_group)
        self.last_stage_ms = {"prepare": prepare_ms, **self.last_stage_ms}
        return images

    def _data_shard(self, host_cond: Dict[str, np.ndarray],
                    latents: torch.Tensor, generator: torch.Generator,
                    scheduler: str, num_steps: int):
        """(cond, latents, noise, split): this rank's share of a batch
        under a data axis that divides it, else everything as given. The
        cond of one request (generate) stays whole; a batch of requests
        (generate_batch) is split per request, each key's rows of a
        request kept together. An ancestral sampler's noise is drawn for
        the global batch from `generator`, in the single-device order, and
        sliced."""
        n = latents.shape[0]
        if data_axis_size(self.mesh) == 1 or n % self.mesh.data:
            return host_cond, latents, None, False
        rows = shard_rows(n, self.mesh)
        if host_cond["clean_ids"].shape[0] == n:
            host_cond = {
                k: v[rows.start * (v.shape[0] // n):
                     rows.stop * (v.shape[0] // n)]
                for k, v in host_cond.items()}
        noise = None
        plan = make_plan(self.schedule, scheduler, num_steps)
        if bool((plan.coef_n != 0).any()):
            noise = torch.stack([
                torch.randn(latents.shape, generator=generator,
                            device=latents.device, dtype=latents.dtype)
                for _ in range(num_steps)])[:, rows]
        return host_cond, latents[rows], noise, True

    def _check(self, out: np.ndarray) -> np.ndarray:
        """uint8 images through the safety checker when one is configured
        (flags in `last_nsfw_flags`)."""
        if self.safety_checker is not None:
            t0 = time.perf_counter()
            out, self.last_nsfw_flags = self.safety_checker(out)
            self.last_stage_ms["safety"] = (time.perf_counter() - t0) * 1e3
        return out

    def generate(
        self,
        prompt: str,
        face_image: np.ndarray,
        negative_prompt: str = "",
        seed: int = 0,
        height: Optional[int] = None,
        width: Optional[int] = None,
        parsing_labels: Optional[np.ndarray] = None,
        faceid_embeds: Optional[np.ndarray] = None,
        num_images_per_prompt: int = 1,
        return_float: bool = False,
        **kwargs,
    ):
        """uint8 (N, H, W, 3) numpy images, through the safety checker when
        one is configured; with return_float the decoded [-1, 1] images as
        a tensor on the device instead, before any checker. kwargs:
        num_inference_steps, guidance_scale, start_merge_step, scheduler,
        ip_scale, lora_scale, cache_interval (the config's values by
        default). The latents
        and then any ancestral noise come from one generator seeded `seed`
        on the bundle's device."""
        return self._finish(self._generate_u8(
            prompt, face_image, negative_prompt, seed, height, width,
            parsing_labels, faceid_embeds, num_images_per_prompt,
            return_float, kwargs), return_float)

    def _generate_u8(self, prompt, face_image, negative_prompt, seed, height,
                     width, parsing_labels, faceid_embeds,
                     num_images_per_prompt, return_float, kwargs,
                     sync_stages: bool = True) -> torch.Tensor:
        t0 = time.perf_counter()
        cond = self.prepare_conditioning(
            prompt, face_image, parsing_labels=parsing_labels,
            faceid_embeds=faceid_embeds, negative_prompt=negative_prompt)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        device = self.bundle.device
        gen = torch.Generator(device).manual_seed(seed)
        latents = torch.randn(
            (num_images_per_prompt, *self._latent_shape(height, width)),
            generator=gen, device=device, dtype=torch.float32)
        images = self._run(cond, latents, gen, prepare_ms,
                           sync_stages=sync_stages, **kwargs)
        return images if return_float else to_uint8(images)

    def _finish(self, images: torch.Tensor, return_float: bool):
        if return_float:
            return images
        return self._check(images.cpu().numpy())

    def generate_batch(
        self,
        prompts: Sequence[str],
        face_images: Sequence[np.ndarray],
        negative_prompts: Optional[Sequence[str]] = None,
        seed: int = 0,
        seeds: Optional[Sequence[int]] = None,
        parsing_labels_list: Optional[Sequence[np.ndarray]] = None,
        faceid_embeds_list: Optional[Sequence[np.ndarray]] = None,
        height: Optional[int] = None,
        width: Optional[int] = None,
        return_float: bool = False,
        **kwargs,
    ):
        """Distinct requests as one batch (JAX generate_batch): each
        request's conditioning is prepared on the host, the rows are
        concatenated and encode + denoise + decode run once at batch
        len(prompts). The serving path.

        seeds: per-request seeds; request i's latents come from its own
        generator seeded seeds[i], so under the ODE samplers (ddim, euler,
        dpmpp_2m, pndm) a request's output does not depend on its batch
        position or neighbours (up to the batch-dependent rounding of the
        card's products). An ancestral sampler (ddpm) draws its noise for
        the whole batch from request 0's generator, after its latents, as
        the JAX package keys it off seeds[0]. Without seeds one generator
        seeded `seed` draws all latents. kwargs as `generate`."""
        return self._finish(self._batch_u8(
            prompts, face_images, negative_prompts, seed, seeds,
            parsing_labels_list, faceid_embeds_list, height, width,
            return_float, kwargs), return_float)

    def prepare_batch(
        self, prompts: Sequence[str], face_images: Sequence[np.ndarray],
        negative_prompts: Optional[Sequence[str]] = None,
        parsing_labels_list: Optional[Sequence[np.ndarray]] = None,
        faceid_embeds_list: Optional[Sequence[np.ndarray]] = None,
    ) -> Dict[str, np.ndarray]:
        """Each request's `prepare_conditioning`, the rows concatenated on
        axis 0 (the JAX package's generate_batch)."""
        n = len(prompts)
        negative_prompts = negative_prompts or [""] * n
        conds = [self.prepare_conditioning(
            prompts[i], face_images[i],
            parsing_labels=(parsing_labels_list[i]
                            if parsing_labels_list is not None else None),
            faceid_embeds=(faceid_embeds_list[i]
                           if faceid_embeds_list is not None else None),
            negative_prompt=negative_prompts[i]) for i in range(n)]
        return {k: np.concatenate([c[k] for c in conds]) for k in conds[0]}

    def _batch_u8(self, prompts, face_images, negative_prompts, seed, seeds,
                  parsing_labels_list, faceid_embeds_list, height, width,
                  return_float, kwargs,
                  sync_stages: bool = True) -> torch.Tensor:
        n = len(prompts)
        t0 = time.perf_counter()
        cond = self.prepare_batch(prompts, face_images, negative_prompts,
                                  parsing_labels_list, faceid_embeds_list)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        device = self.bundle.device
        shape = self._latent_shape(height, width)
        if seeds is not None:
            if len(seeds) != n:
                raise ValueError(f"{len(seeds)} seeds for {n} requests")
            gens = [torch.Generator(device).manual_seed(int(s))
                    for s in seeds]
            latents = torch.stack([
                torch.randn(shape, generator=g, device=device,
                            dtype=torch.float32) for g in gens])
            gen = gens[0]
        else:
            gen = torch.Generator(device).manual_seed(seed)
            latents = torch.randn((n, *shape), generator=gen, device=device,
                                  dtype=torch.float32)
        images = self._run(cond, latents, gen, prepare_ms,
                           sync_stages=sync_stages, **kwargs)
        return images if return_float else to_uint8(images)

    def _async(self, u8: torch.Tensor) -> Callable[[], np.ndarray]:
        """A zero-argument callable yielding the uint8 images through the
        safety checker. On the card the copy into pinned host memory starts
        now, behind an event, and overlaps whatever is queued after it
        (the JAX package's copy_to_host_async): submit request i + 1, then
        collect request i."""
        if u8.device.type == "cuda":
            host = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(u8, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host, done = u8, None

        def finish() -> np.ndarray:
            if done is not None:
                done.synchronize()
            return self._check(host.numpy())

        return finish

    def generate_async(self, prompt: str, face_image: np.ndarray,
                       negative_prompt: str = "", seed: int = 0,
                       height: Optional[int] = None,
                       width: Optional[int] = None,
                       parsing_labels: Optional[np.ndarray] = None,
                       faceid_embeds: Optional[np.ndarray] = None,
                       num_images_per_prompt: int = 1, **kwargs):
        """`generate`, returning a zero-argument callable that yields the
        uint8 images (see `_async`); nothing waits for the card until it is
        called, so `last_stage_ms` holds no device split."""
        return self._async(self._generate_u8(
            prompt, face_image, negative_prompt, seed, height, width,
            parsing_labels, faceid_embeds, num_images_per_prompt, False,
            kwargs, sync_stages=False))

    def generate_batch_async(
            self, prompts: Sequence[str], face_images: Sequence[np.ndarray],
            negative_prompts: Optional[Sequence[str]] = None, seed: int = 0,
            seeds: Optional[Sequence[int]] = None,
            parsing_labels_list: Optional[Sequence[np.ndarray]] = None,
            faceid_embeds_list: Optional[Sequence[np.ndarray]] = None,
            height: Optional[int] = None, width: Optional[int] = None,
            **kwargs):
        """`generate_batch`, returning a zero-argument callable that yields
        the uint8 batch (see `generate_async`)."""
        return self._async(self._batch_u8(
            prompts, face_images, negative_prompts, seed, seeds,
            parsing_labels_list, faceid_embeds_list, height, width, False,
            kwargs, sync_stages=False))


class _StageClock:
    """Wall time per stage, in ms. On the card each mark synchronises, so a
    stage's time is its device time plus its host launch overhead; with
    `sync` False nothing is timed (the stages are left empty)."""

    def __init__(self, device: torch.device, sync: bool = True):
        self.cuda = device.type == "cuda"
        self.on = sync
        self.stages: Dict[str, float] = {}
        self._sync()
        self._last = time.perf_counter()

    def _sync(self):
        if self.cuda and self.on:
            torch.cuda.synchronize()

    def mark(self, name: str) -> None:
        if not self.on:
            return
        self._sync()
        now = time.perf_counter()
        self.stages[name] = (now - self._last) * 1e3
        self._last = now
