"""ConsistentID SDXL text-to-image pipeline on PyTorch.

Counterpart of the JAX package's pipelines/consistentid_sdxl.py (the
reference's ConsistentIDStableDiffusionXLPipeline,
pipline_StableDiffusionXL_ConsistentID.py:44-692):
  - two tokenizers and text towers, CLIP-L and OpenCLIP bigG, whose
    penultimate hidden states are concatenated to 2048 wide (:514-524); the
    pooled embedding is bigG's final-layer-normed EOS state;
  - `text_time` micro-conditioning: the pooled embedding and six time ids
    (original size, crop corner, target size) added to the UNet's time
    embedding (:527-539, :631);
  - the 2048-wide FacialEncoder and the ID projection with shortcut=True
    (:568);
  - the negative AND pooled embeddings switched per branch at the merge
    step (:619-628);
  - the VAE decoded in fp32 when its config says force_upcast (:670-672).

The host prepare, `generate`, `generate_batch` and their async variants come
from the SD1.5 pipeline, DeepCache's `cache_interval` with them (SDXL's level
0 has no attention, so its cached steps launch no flash kernel); the encode
and the decode are SDXL's. As in the JAX
package there is no safety checker.
"""
from __future__ import annotations

import copy
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from ..conditioning import tokenize_and_mask_trigger_ends
from ..core.config import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                           PipelineConfig, SchedulerConfig, UNetConfig,
                           VAEConfig, clip_text_bigg_config)
from ..models import AutoencoderKL, CLIPTextEncoder
from ..sampling import CondBranch
from .consistentid_sd15 import ConsistentIDPipeline, SD15Bundle


def sdxl_adapter_config(**overrides) -> AdapterConfig:
    """The SDXL adapter: 2048-wide context and facial output, ID tokens
    with the shortcut (reference SDXL :568)."""
    base = dict(cross_attention_dim=2048, facial_output_dim=2048,
                shortcut=True)
    base.update(overrides)
    return AdapterConfig(**base)


class SDXLBundle(SD15Bundle):
    """The SDXL model set: the SD1.5 bundle's modules at SDXL's configs plus
    the bigG second text encoder (`text_encoder_2`), whose width sets the
    pooled embedding's."""

    def __init__(self, unet_config: UNetConfig,
                 adapter_config: AdapterConfig = AdapterConfig(),
                 vae_config: VAEConfig = VAEConfig(),
                 text_config: CLIPTextConfig = CLIPTextConfig(),
                 vision_config: CLIPVisionConfig = CLIPVisionConfig(),
                 text_config_2: Optional[CLIPTextConfig] = None,
                 dtype: Union[str, torch.dtype] = torch.float32,
                 device: Union[str, torch.device] = "cuda", seed: int = 0,
                 quant: str = "none", act_scales: Optional[Dict] = None):
        # read by _make_modules, inside SD15Bundle.__init__
        self.text_config_2 = text_config_2 or clip_text_bigg_config()
        super().__init__(unet_config, adapter_config, vae_config,
                         text_config, vision_config, dtype=dtype,
                         device=device, seed=seed, quant=quant,
                         act_scales=act_scales)

    def _make_modules(self) -> None:
        super()._make_modules()
        self.text_encoder_2 = CLIPTextEncoder(self.text_config_2)


class ConsistentIDXLPipeline(ConsistentIDPipeline):
    """SDXL generate(); the bundle's UNet has addition_embed_type
    "text_time". Without `tokenizer_2` the first tokenizer serves both
    towers."""

    def __init__(self, bundle: SDXLBundle, tokenizer, tokenizer_2=None,
                 pipeline_config: Optional[PipelineConfig] = None,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 face_parser: Optional[Callable] = None,
                 face_embedder: Optional[Callable] = None, mesh=None):
        if pipeline_config is None:
            pipeline_config = PipelineConfig(
                height=1024, width=1024, guidance_scale=7.5,
                num_inference_steps=50, start_merge_step=30)
        super().__init__(bundle, tokenizer, pipeline_config=pipeline_config,
                         scheduler_config=scheduler_config,
                         face_parser=face_parser,
                         face_embedder=face_embedder, mesh=mesh)
        self.tokenizer_2 = tokenizer_2 or tokenizer
        self.tokenizer_2.add_tokens(["<|image|>", "<|facial|>"])
        # the reference sets its region-mask resolution to 1280 (:570) and
        # never reads it; kept for parity
        self.region_mask_size = 1280
        self._fp32_vae: Optional[AutoencoderKL] = None
        self._fp32_vae_key: Optional[tuple] = None

    # ---------------- host-side prepare ----------------

    def prepare_conditioning(self, prompt, face_image, parsing_labels=None,
                             faceid_embeds=None, face_caption=None,
                             negative_prompt="", max_num_facials=5,
                             original_size=None, target_size=None,
                             crops_coords_top_left=(0, 0)):
        """The SD1.5 cond plus the second tokenizer's ids (`clean_ids2`
        with the trigger ends masked as tokenize_and_mask_trigger_ends does,
        `text_only_ids2` and `negative_ids2` plainly padded) and
        `time_ids` (1, 6):
        original size, crop corner, target size, the target the config's
        height and width unless given (reference :378-385, :527-539)."""
        cond = super().prepare_conditioning(
            prompt, face_image, parsing_labels=parsing_labels,
            faceid_embeds=faceid_embeds, face_caption=face_caption,
            negative_prompt=negative_prompt, max_num_facials=max_num_facials)
        tok2 = self.tokenizer_2
        cond["clean_ids2"] = tokenize_and_mask_trigger_ends(
            self._last_prompt_face, None,
            tok2.convert_tokens_to_ids("<|facial|>"), tok2)[0].astype(np.int32)
        cond["text_only_ids2"] = self._tokenize_padded(
            self._last_prompt_text_only, tok2).astype(np.int32)
        cond["negative_ids2"] = self._tokenize_padded(
            negative_prompt, tok2).astype(np.int32)
        target = target_size or (self.config.height, self.config.width)
        orig = original_size or target
        cond["time_ids"] = np.asarray(
            [[orig[0], orig[1], crops_coords_top_left[0],
              crops_coords_top_left[1], target[0], target[1]]], np.float32)
        return cond

    # ---------------- device stages ----------------

    def _encode_dual(self, ids1: torch.Tensor, ids2: torch.Tensor):
        """Both towers' penultimate hidden states concatenated (B, 77,
        768 + 1280), and the bigG tower's pooled embedding (B, 1280)."""
        b = self.bundle
        h1, _ = b.text_encoder(ids1, output_hidden_state_index=-2)
        h2, pooled2 = b.text_encoder_2(ids2, output_hidden_state_index=-2)
        return torch.cat([h1, h2], dim=-1), pooled2

    @torch.no_grad()
    def encode_embeddings_xl(self, cond: Dict[str, torch.Tensor]):
        """(text-only branch, facial branch): contexts (B, 77 +
        num_id_tokens, 2048) with their pooled embeddings; the negative
        context and pooled embedding are shared."""
        enc_marked, pooled_marked = self._encode_dual(
            cond["clean_ids"], cond["clean_ids2"])
        enc_text_only, pooled_text_only = self._encode_dual(
            cond["text_only_ids"], cond["text_only_ids2"])
        enc_negative, pooled_negative = self._encode_dual(
            cond["negative_ids"], cond["negative_ids2"])
        fused, uncond_fused, faceid_tokens, uncond_faceid_tokens = \
            self._adapter_tokens(cond, enc_marked, enc_negative)
        facial = CondBranch(
            context=torch.cat([fused, faceid_tokens], dim=1),
            null=torch.cat([uncond_fused, uncond_faceid_tokens], dim=1),
            pooled=pooled_marked, pooled_null=pooled_negative)
        text = CondBranch(
            context=torch.cat([enc_text_only, faceid_tokens], dim=1),
            null=torch.cat([enc_negative, uncond_faceid_tokens], dim=1),
            pooled=pooled_text_only, pooled_null=pooled_negative)
        return text, facial

    def _branches(self, cond: Dict[str, torch.Tensor]):
        text, facial = self.encode_embeddings_xl(cond)
        return text, facial, cond["time_ids"]

    def _calibration_batch(self, cond: Dict[str, torch.Tensor]):
        """SDXL's calibration batch (JAX `:152-162`): the facial null,
        facial and text-only contexts with their pooled embeddings and the
        time ids, the added conditioning every serving call feeds."""
        text_b, facial_b = self.encode_embeddings_xl(cond)
        ctx = torch.cat([facial_b.null, facial_b.context, text_b.context])
        pooled = torch.cat([facial_b.pooled_null, facial_b.pooled,
                            text_b.pooled])
        time_ids = torch.cat([cond["time_ids"]] * 3)
        return ctx, {"text_embeds": pooled, "time_ids": time_ids}

    def fp32_vae(self) -> AutoencoderKL:
        """The VAE in fp32: the bundle's own when it is fp32, else an fp32
        copy of it. The copy is kept while the VAE's parameters stay the
        same tensors, unchanged in place (their storage and version
        counters), and made anew after a reload or an edit, so it always
        holds what the JAX package's per-call cast computes."""
        vae = self.bundle.vae
        if vae.post_quant_conv.weight.dtype == torch.float32:
            return vae
        key = tuple((p.data_ptr(), p._version) for p in vae.parameters())
        if self._fp32_vae is None or key != self._fp32_vae_key:
            self._fp32_vae = None           # free the stale copy first
            self._fp32_vae = copy.deepcopy(vae).float()
            self._fp32_vae_key = key
        return self._fp32_vae

    def _decode(self, final: torch.Tensor) -> torch.Tensor:
        if self.bundle.vae_config.force_upcast:
            # fp32 decode, gated on the VAE config as in the reference
            return self.fp32_vae().decode(final.float())
        return self.bundle.vae.decode(final)
