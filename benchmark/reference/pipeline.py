"""The plain reference of one ConsistentID request from the photo, SD1.5 or
SDXL: perception (BiSeNet parse, SCRFD detect and align, iresnet embed),
the host prepare (markers, masks, tokens, CLIP pixels), the three (SDXL:
six) text encodes, one ViT-H pass, ProjPlus and the FacialEncoder; the
models whose calls stepwise.py follows (the UNet, the DDIM plan, the VAE
decode, uint8 and, for SD1.5, the safety checker).

Everything in fp32 with TF32 off, one request at a time (CFG batch 2),
attention as matmuls and a softmax, and the LoRA deltas applied at every
projection instead of folded. Module and parameter names are the
published layouts' (the same as the system under test takes), so one
state dict of raw weights feeds both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .adapter import FacialEncoder, ProjPlusModel
from .clip import CLIPTextEncoder, CLIPVisionEncoder
from .config import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                     SchedulerConfig, UNetConfig, VAEConfig)
from .image import clip_preprocess
from .markers import process_text_with_markers
from .masks import fetch_mask_raw_image, masks_for_unique_values
from .sampler import CondBranch
from .schedulers import NoiseSchedule
from .tokenize import prepare_trigger_token_idx, tokenize_and_mask_trigger_ends
from .unet import UNet
from .vae import AutoencoderKL

FACE_CAPTION_TEMPLATE = (
    "The person has one face, one nose, two eyes, two ears, and one mouth.")
KEY_REGIONS = ("Face", "Left_Ear", "Right_Ear", "Left_Eye", "Right_Eye",
               "Nose", "Upper_Lip", "Lower_Lip")
MAX_CAPTION_CHARS = 330


def tf32_off() -> None:
    """fp32 products in fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Models(nn.Module):
    """The diffusion-side models of one configuration, with the submodule
    names of the published layout (unet, vae, text_encoder, image_encoder,
    proj, facial_encoder, and SDXL's text_encoder_2)."""

    def __init__(self, unet: UNetConfig, adapter: AdapterConfig,
                 vae: VAEConfig, text: CLIPTextConfig,
                 vision: CLIPVisionConfig,
                 text_2: Optional[CLIPTextConfig] = None):
        super().__init__()
        self.unet = UNet(unet)
        self.vae = AutoencoderKL(vae)
        self.text_encoder = CLIPTextEncoder(text)
        self.image_encoder = CLIPVisionEncoder(vision)
        self.proj = ProjPlusModel(
            cross_attention_dim=adapter.cross_attention_dim,
            id_embeddings_dim=adapter.id_embeddings_dim,
            clip_embeddings_dim=adapter.clip_embeddings_dim,
            num_tokens=adapter.num_id_tokens)
        self.facial_encoder = FacialEncoder(
            embedding_dim=adapter.clip_embeddings_dim,
            output_dim=adapter.facial_output_dim,
            embed_dim=adapter.cross_attention_dim,
            facial_dim=adapter.facial_dim, facial_depth=adapter.facial_depth,
            facial_heads=adapter.facial_heads,
            facial_dim_head=adapter.facial_dim_head)
        if text_2 is not None:
            self.text_encoder_2 = CLIPTextEncoder(text_2)
        self.adapter_config = adapter
        self.vision_config = vision
        self.sdxl = text_2 is not None


@dataclass
class RequestSpec:
    """What the serving configuration fixes for every request."""

    height: int
    width: int
    steps: int
    guidance_scale: float
    start_merge_step: int
    scheduler: str = "ddim"


def _select_key_regions(parsing_mask_list: Dict) -> Dict:
    """Face and Nose, and the first of each Ear, Eye and Lip pair: at most
    five regions (ConsistentID's get_prepare_facemask)."""
    out, seen = {}, set()
    for key, mask in parsing_mask_list.items():
        if key not in KEY_REGIONS:
            continue
        if "_" in key:
            part = key.split("_")[1]
            if part in seen:
                continue
            seen.add(part)
        out[key] = mask
    return out


def _padded(tok, text: str) -> np.ndarray:
    ids = list(tok.encode(text))[:tok.model_max_length]
    ids += [tok.pad_token_id] * (tok.model_max_length - len(ids))
    return np.asarray(ids, np.int64)[None]


class Reference:
    """The reference's conditioning of one request (prepare, branches) and
    its models, for stepwise.follow."""

    def __init__(self, models: Models, tokenizer, spec: RequestSpec,
                 face_parser, face_embedder, tokenizer_2=None,
                 safety_checker=None):
        self.m = models
        self.tok = tokenizer
        self.tok2 = tokenizer_2 or tokenizer
        for t in (self.tok, self.tok2):
            t.add_tokens(["<|image|>", "<|facial|>"])
        self.spec = spec
        self.parser = face_parser
        self.embedder = face_embedder
        self.checker = safety_checker
        self.schedule = NoiseSchedule.create(SchedulerConfig())
        self.device = models.unet.conv_in.weight.device

    # ---------------- host prepare ----------------

    def prepare(self, prompt: str, face: np.ndarray, labels=None,
                faceid=None, negative_prompt: str = "",
                max_num_facials: int = 5):
        """The request's conditioning tensors; `labels` and `faceid`, when
        given, in place of the reference's own perception."""
        labels = self.parser(face) if labels is None else labels
        faceid = self.embedder(face) if faceid is None else faceid
        caption = FACE_CAPTION_TEMPLATE
        region_masks = _select_key_regions(masks_for_unique_values(labels))
        caption_aligned, region_masks = process_text_with_markers(
            caption, region_masks)
        prompt_face = prompt + "Detail:" + caption_aligned
        if len(self.tok.encode(prompt_face)) > self.tok.model_max_length:
            prompt_face = "Detail:" + caption_aligned + " Caption:" + prompt
        if len(caption) > MAX_CAPTION_CHARS:
            prompt_face = prompt
        text_only = prompt_face.replace("<|facial|>", "").replace(
            "<|image|>", "")
        facial_id = self.tok.convert_tokens_to_ids("<|facial|>")
        clean_ids, img_mask, fac_mask = tokenize_and_mask_trigger_ends(
            prompt_face, None, facial_id, self.tok)
        _, _, facial_idx, facial_idx_mask = prepare_trigger_token_idx(
            img_mask, fac_mask, 1, max_num_facials)
        size = self.m.vision_config.image_size
        regions = np.zeros((max_num_facials, size, size, 3), np.float32)
        for i, mask in enumerate(region_masks.values()):
            if i >= max_num_facials:
                break
            regions[i] = clip_preprocess(fetch_mask_raw_image(face, mask),
                                         size)[0]
        cond = {
            "clean_ids": clean_ids, "text_only_ids": _padded(self.tok,
                                                             text_only),
            "negative_ids": _padded(self.tok, negative_prompt),
            "facial_idx": facial_idx, "facial_idx_mask": facial_idx_mask,
            "face_pixels": clip_preprocess(face, size),
            "region_pixels": regions[None],
            "faceid_embeds": np.asarray(faceid, np.float32),
        }
        if self.m.sdxl:
            id2 = self.tok2.convert_tokens_to_ids("<|facial|>")
            cond["clean_ids2"] = tokenize_and_mask_trigger_ends(
                prompt_face, None, id2, self.tok2)[0]
            cond["text_only_ids2"] = _padded(self.tok2, text_only)
            cond["negative_ids2"] = _padded(self.tok2, negative_prompt)
            s = self.spec
            cond["time_ids"] = np.asarray(
                [[s.height, s.width, 0, 0, s.height, s.width]], np.float32)
        out = {}
        for k, v in cond.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if t.dtype in (torch.int32, torch.int64):
                t = t.long()
            elif t.is_floating_point():
                t = t.float()
            out[k] = t.to(self.device)
        return out

    # ---------------- encode ----------------

    def _adapter_tokens(self, cond, enc_marked, enc_negative):
        m, a = self.m, self.m.adapter_config
        size = m.vision_config.image_size
        n_regions = cond["region_pixels"].shape[1]
        vit_in = torch.cat([
            cond["face_pixels"],
            torch.zeros((1, size, size, 3), device=self.device),
            cond["region_pixels"].reshape(-1, size, size, 3)])
        _, penult = m.image_encoder(vit_in)
        face_emb, zero_emb = penult[:1], penult[1:2]
        region_embs = penult[2:].reshape(1, n_regions, *penult.shape[1:])
        zero_regions = zero_emb[:, None].expand_as(region_embs)
        faceid = cond["faceid_embeds"]
        tokens = m.proj(faceid, face_emb, shortcut=a.shortcut,
                        scale=a.shortcut_scale)
        uncond_tokens = m.proj(torch.zeros_like(faceid), zero_emb,
                               shortcut=a.shortcut, scale=a.shortcut_scale)
        fused = m.facial_encoder(enc_marked, region_embs, cond["facial_idx"],
                                 cond["facial_idx_mask"])
        uncond_fused = m.facial_encoder(enc_negative, zero_regions,
                                        cond["facial_idx"],
                                        cond["facial_idx_mask"])
        return fused, uncond_fused, tokens, uncond_tokens

    def branches(self, cond):
        m = self.m
        if not m.sdxl:
            enc_marked, _ = m.text_encoder(cond["clean_ids"])
            enc_text, _ = m.text_encoder(cond["text_only_ids"])
            enc_neg, _ = m.text_encoder(cond["negative_ids"])
            fused, ufused, tok, utok = self._adapter_tokens(
                cond, enc_marked, enc_neg)
            null = torch.cat([ufused, utok], dim=1)
            return (CondBranch(torch.cat([enc_text, tok], dim=1), null),
                    CondBranch(torch.cat([fused, tok], dim=1), null), None)

        def dual(i1, i2):
            h1, _ = m.text_encoder(cond[i1], output_hidden_state_index=-2)
            h2, pooled = m.text_encoder_2(cond[i2],
                                          output_hidden_state_index=-2)
            return torch.cat([h1, h2], dim=-1), pooled

        enc_marked, p_marked = dual("clean_ids", "clean_ids2")
        enc_text, p_text = dual("text_only_ids", "text_only_ids2")
        enc_neg, p_neg = dual("negative_ids", "negative_ids2")
        fused, ufused, tok, utok = self._adapter_tokens(cond, enc_marked,
                                                        enc_neg)
        facial = CondBranch(torch.cat([fused, tok], dim=1),
                            torch.cat([ufused, utok], dim=1),
                            pooled=p_marked, pooled_null=p_neg)
        text = CondBranch(torch.cat([enc_text, tok], dim=1),
                          torch.cat([enc_neg, utok], dim=1),
                          pooled=p_text, pooled_null=p_neg)
        return text, facial, cond["time_ids"]


def build_models(configs: Dict, state: Dict[str, torch.Tensor],
                 device) -> Models:
    """fp32 reference models on `device` from the configs and the raw
    state dict (any float dtype; cast to fp32)."""
    with torch.device("meta"):
        models = Models(**configs)
    missing = set(models.state_dict()) - set(state)
    if missing:
        raise KeyError(f"raw weights lack {sorted(missing)[:5]}")
    models.load_state_dict({k: v.to(device=device, dtype=torch.float32)
                            for k, v in state.items()}, assign=True)
    return models.eval()

