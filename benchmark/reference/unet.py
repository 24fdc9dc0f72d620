"""SD UNet (UNet2DConditionModel layout, SD1.5 and SDXL) with the
ConsistentID adapter hooks: LoRA on every attention projection and
decoupled-IP cross-attention.

Counterpart of the JAX package's models/unet.py. The SDXL layout
(`addition_embed_type="text_time"`) adds the pooled-text and time-ids
embedding to the time embedding and takes linear transformer projections.
The public forward takes and returns NHWC latents and runs NCHW inside.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .config import UNetConfig
from .layers import (GN_EPS, Downsample, ResnetBlock,
                     TimestepEmbedding, Transformer2D, Upsample,
                     timestep_embedding)


class UNet(nn.Module):
    def __init__(self, config: UNetConfig):
        super().__init__()
        cfg = self.config = config
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim
        groups = cfg.norm_num_groups

        def transformer(level: int, depth: int) -> Transformer2D:
            return Transformer2D(
                boc[level], cfg.num_attention_heads[level],
                cfg.cross_attention_dim, depth=depth, groups=groups,
                lora_rank=cfg.lora_rank, ip_num_tokens=cfg.ip_num_tokens,
                use_linear_projection=cfg.is_sdxl)

        self.conv_in = nn.Conv2d(cfg.sample_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)
        if cfg.is_sdxl:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)

        skip_ch = [boc[0]]
        ch = boc[0]
        for level in range(n):
            out_ch = boc[level]
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{j}",
                                ResnetBlock(ch, out_ch, temb, groups))
                ch = out_ch
                if cfg.down_block_has_attn[level]:
                    self.add_module(f"down_{level}_attn_{j}", transformer(
                        level, cfg.transformer_layers_per_block[level]))
                skip_ch.append(ch)
            if level < n - 1:
                self.add_module(f"down_{level}_downsample",
                                Downsample(ch))
                skip_ch.append(ch)

        self.mid_resnet_0 = ResnetBlock(ch, boc[-1], temb, groups)
        self.mid_attn = transformer(n - 1, cfg.mid_transformer_depth)
        self.mid_resnet_1 = ResnetBlock(boc[-1], boc[-1], temb, groups)
        ch = boc[-1]

        for i in range(n):
            level = n - 1 - i
            out_ch = boc[level]
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", ResnetBlock(
                    ch + skip_ch.pop(), out_ch, temb, groups))
                ch = out_ch
                if cfg.down_block_has_attn[level]:
                    self.add_module(f"up_{i}_attn_{j}", transformer(
                        level, cfg.transformer_layers_per_block[level]))
            if i < n - 1:
                self.add_module(f"up_{i}_upsample", Upsample(ch))

        self.conv_norm_out = nn.GroupNorm(groups, boc[0], eps=GN_EPS)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor, lora_scale: float = 1.0,
                ip_scale: float = 1.0,
                added_cond: Optional[Dict[str, torch.Tensor]] = None):
        """sample (B, H, W, C) latents, timesteps (B,) or scalar, context
        (B, L + ip_num_tokens, cross_attention_dim) -> (B, H, W, C_out).
        The SDXL layout needs added_cond {"text_embeds": (B, Dp) pooled
        text, "time_ids": (B, 6)}."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        n = len(cfg.block_out_channels)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        if cfg.is_sdxl:
            if added_cond is None:
                raise ValueError("the SDXL UNet needs added_cond "
                                 "(text_embeds, time_ids)")
            time_ids = added_cond["time_ids"]
            t_emb = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift)
            add = torch.cat([added_cond["text_embeds"].float(),
                             t_emb.reshape(time_ids.shape[0], -1)], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        def attn(name, h):
            return getattr(self, name)(h, ctx, lora_scale, ip_scale)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for level in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{j}")(h, temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"down_{level}_attn_{j}", h)
                skips.append(h)
            if level < n - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)

        h = self.mid_resnet_0(h, temb)
        h = attn("mid_attn", h)
        h = self.mid_resnet_1(h, temb)
        for i in range(n):
            level = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_resnet_{j}")(h, temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"up_{i}_attn_{j}", h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)
