"""Baseline ID encoders for benchmark comparisons (the JAX package's
eval/baselines.py).

The reference's evaluation bundles a PhotoMakerIDEncoder for side-by-side
comparison (evaluation/eval_function.py:662-683): the CLIP-L vision CLS
embedding through two projections (1024 -> 768 and 1024 -> 1280,
concatenated to 2048), fused into the prompt embeds at the trigger
positions. Submodule names follow the JAX module's parameter tree, so
`io.from_jax.params_from_jax` carries its weights across.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..adapter.modules import FuseModule
from ..core.config import CLIPVisionConfig
from ..models.clip import CLIPVisionEncoder


def photomaker_vision_config() -> CLIPVisionConfig:
    """CLIP-L/14 vision tower (PhotoMaker's backbone)."""
    return CLIPVisionConfig(image_size=224, patch_size=14, hidden_size=1024,
                            intermediate_size=4096, num_layers=24,
                            num_heads=16, hidden_act="quick_gelu")


class PhotoMakerIDEncoder(nn.Module):
    """id_pixel_values (B, N, H, W, 3) + prompt embeds (B, L, D) ->
    fused embeds; D is projection_dim + projection_dim_2."""

    def __init__(self, vision_config: Optional[CLIPVisionConfig] = None,
                 projection_dim: int = 768, projection_dim_2: int = 1280):
        super().__init__()
        cfg = vision_config or photomaker_vision_config()
        width = projection_dim + projection_dim_2
        self.vision_model = CLIPVisionEncoder(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size, projection_dim,
                                           bias=False)
        self.visual_projection_2 = nn.Linear(cfg.hidden_size,
                                             projection_dim_2, bias=False)
        self.fuse_module = FuseModule(width, width)

    def forward(self, id_pixel_values: torch.Tensor,
                prompt_embeds: torch.Tensor, token_idx: torch.Tensor,
                token_mask: torch.Tensor) -> torch.Tensor:
        b, n = id_pixel_values.shape[:2]
        post, _ = self.vision_model(id_pixel_values.flatten(0, 1))
        pooled = post[:, 0]   # cls token, post-layernorm
        id_embeds = torch.cat([self.visual_projection(pooled),
                               self.visual_projection_2(pooled)], dim=-1)
        return self.fuse_module(prompt_embeds, id_embeds.reshape(b, n, -1),
                                token_idx, token_mask)
