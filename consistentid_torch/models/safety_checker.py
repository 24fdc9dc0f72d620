"""CLIP-based NSFW safety checker, counterpart of the JAX package's
models/safety_checker.py (diffusers' StableDiffusionSafetyChecker, which the
reference SD1.5 pipeline runs on every decoded image): a CLIP vision tower
and visual projection give image embeddings whose cosine similarities to
fixed concept and special-care banks are thresholded; a special-care hit
lowers every concept threshold by 0.01; flagged images become black.
"""
from __future__ import annotations

from typing import Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..core.config import CLIPVisionConfig
from ..core.dtypes import resolve_device
from ..utils.image import CLIP_MEAN, CLIP_STD, resize_bicubic_uint8
from .clip import CLIPVisionEncoder

# ViT-L/14 at 224, the checker's vision tower
SAFETY_VISION_CONFIG = CLIPVisionConfig(
    image_size=224, patch_size=14, hidden_size=1024, intermediate_size=4096,
    num_layers=24, num_heads=16)


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B, D) x (N, D) -> (B, N) cosine similarity."""
    a = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    b = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return a @ b.T


class SafetyChecker(nn.Module):
    """(B, S, S, 3) CLIP-preprocessed pixels -> (B,) bool nsfw flags."""

    def __init__(self, vision_config: CLIPVisionConfig = SAFETY_VISION_CONFIG,
                 projection_dim: int = 768, num_concepts: int = 17,
                 num_special: int = 3):
        super().__init__()
        self.vision_config = vision_config
        self.vision_model = CLIPVisionEncoder(vision_config)
        self.visual_projection = nn.Linear(vision_config.hidden_size,
                                           projection_dim, bias=False)
        self.concept_embeds = nn.Parameter(
            torch.randn(num_concepts, projection_dim))
        self.special_care_embeds = nn.Parameter(
            torch.randn(num_special, projection_dim))
        self.concept_embeds_weights = nn.Parameter(torch.ones(num_concepts))
        self.special_care_embeds_weights = nn.Parameter(
            torch.ones(num_special))

    def forward(self, clip_pixels: torch.Tensor) -> torch.Tensor:
        post, _ = self.vision_model(clip_pixels)
        emb = self.visual_projection(post[:, 0]).float()  # CLS token
        special = (_cosine(emb, self.special_care_embeds.float())
                   - self.special_care_embeds_weights.float())
        adjustment = torch.where((special > 0).any(dim=-1, keepdim=True),
                                 0.01, 0.0)
        concept = (_cosine(emb, self.concept_embeds.float())
                   - self.concept_embeds_weights.float() + adjustment)
        return (concept > 0).any(dim=-1)


def make_safety_checker(state: Mapping[str, torch.Tensor],
                        vision_config: Optional[CLIPVisionConfig] = None,
                        device: Union[str, torch.device] = "cuda"):
    """uint8 (B, H, W, 3) images -> (the images with flagged ones set to 0,
    (B,) bool flags): the pipeline's `safety_checker` hook. `state`: a
    SafetyChecker state dict; the model runs in fp32 on `device`."""
    device = resolve_device(device)
    vision_config = vision_config or SAFETY_VISION_CONFIG
    with torch.device("meta"):
        model = SafetyChecker(
            vision_config,
            projection_dim=state["visual_projection.weight"].shape[0],
            num_concepts=state["concept_embeds"].shape[0],
            num_special=state["special_care_embeds"].shape[0])
    model.load_state_dict(state, assign=True)
    model = model.to(device=device, dtype=torch.float32).eval()
    size = vision_config.image_size
    mean, std = (torch.from_numpy(a).to(device) for a in (CLIP_MEAN, CLIP_STD))

    @torch.no_grad()
    def check(images: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        # resized on the model's device: PIL's integer arithmetic, its bits
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        batch = torch.stack([resize_bicubic_uint8(img, size, size)
                             for img in x])
        flags = model((batch.float() / 255.0 - mean) / std).cpu().numpy()
        out = images.copy()
        out[flags] = 0
        return out, flags

    check.model = model
    return check
