"""SD1.5 UNet (UNet2DConditionModel layout) with the ConsistentID adapter
hooks: LoRA on every attention projection and decoupled-IP cross-attention.

Counterpart of the JAX package's models/unet.py at the SD1.5 layout, without
the DeepCache split, ControlNet residuals or SDXL text_time embeddings. The
public forward takes and returns NHWC latents and runs NCHW inside.

Attention-probability capture for the facial localization loss follows the
JAX package: `capture_layers` names blocks of UNET_LAYER_NAMES (`up_i` counts
from the deepest up block, so `up_2` is level 1), and every attn2 in them
returns its softmax, column-gathered at `capture_cols`. The forward then
returns `(out, {module path: probs})`, keyed as the JAX package's sown
tensors are; training.losses.collect_attn_probs orders them as it does.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import UNetConfig
from .layers import (GN_EPS, Downsample, ResnetBlock, TimestepEmbedding,
                     Transformer2D, Upsample, timestep_embedding)

UNET_LAYER_NAMES = ("down_0", "down_1", "down_2", "mid", "up_1", "up_2",
                    "up_3")


def localization_layer_names(num_layers: int) -> Tuple[str, ...]:
    """The centred window of `num_layers` capture blocks (reference
    functions.py:266-278): 5 -> down_1, down_2, mid, up_1, up_2."""
    start = (len(UNET_LAYER_NAMES) - num_layers) // 2
    return UNET_LAYER_NAMES[start:start + num_layers]


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
                lora_rank=cfg.lora_rank, ip_num_tokens=cfg.ip_num_tokens)

        self.conv_in = nn.Conv2d(cfg.sample_channels, boc[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(boc[0], temb)

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
                self.add_module(f"down_{level}_downsample", Downsample(ch))
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
                ip_scale: float = 1.0, capture_layers: Sequence[str] = (),
                capture_cols: Optional[torch.Tensor] = None):
        """sample (B, H, W, C) latents, timesteps (B,) or scalar, context
        (B, L + ip_num_tokens, cross_attention_dim) -> (B, H, W, C_out);
        with capture_layers, (out, {module path: probs (B, H, Sq, N or K)
        fp32})."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        n = len(cfg.block_out_channels)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(sample.shape[0])
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        captured = {}

        def attn(name, block, h):
            if block not in capture_layers:
                return getattr(self, name)(h, ctx, lora_scale, ip_scale)
            h, probs = getattr(self, name)(h, ctx, lora_scale, ip_scale,
                                           True, capture_cols)
            for sub, p in probs.items():
                # keyed by the path the JAX package sows the tensor under
                captured[f"['{name}']['{sub}']['attn2']"] = p
            return h

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for level in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{j}")(h, temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"down_{level}_attn_{j}", f"down_{level}", h)
                skips.append(h)
            if level < n - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)

        h = self.mid_resnet_0(h, temb)
        h = attn("mid_attn", "mid", h)
        h = self.mid_resnet_1(h, temb)

        for i in range(n):
            level = n - 1 - i
            for j in range(cfg.layers_per_block + 1):
                h = torch.cat([h, skips.pop()], dim=1)
                h = getattr(self, f"up_{i}_resnet_{j}")(h, temb)
                if cfg.down_block_has_attn[level]:
                    h = attn(f"up_{i}_attn_{j}", f"up_{i}", h)
            if i < n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        out = self.conv_out(F.silu(self.conv_norm_out(h))).permute(0, 2, 3, 1)
        return (out, captured) if capture_layers else out
