"""ControlNet (diffusers ControlNetModel layout), config-shared with
models/unet.py.

Counterpart of the JAX package's models/controlnet.py, the ControlNet the
reference composes with its inpaint pipeline
(pipelines/StableDIffusionControlNetInpaint_ConsistentID.py:94-486, per-step
residuals fed to the UNet at :405-425): a conditioning-embedding conv stem
on the control image, a copy of the UNet's down and mid stack without the
adapter hooks, and zero-initialised 1x1 projections giving one residual per
UNet skip plus one for the mid block.

Submodules carry the JAX module names (`controlnet_cond_embedding.blocks_k`,
`down_{l}_resnet_{j}`, `controlnet_down_blocks_{i}`, `controlnet_mid_block`,
...), so `io.from_jax.params_from_jax` carries a JAX ControlNet's parameters
unchanged. The residuals come out in the UNet's inner NCHW layout, the
layout `UNet.forward` adds them in.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import UNetConfig
from ..core.dtypes import resolve_device, resolve_dtype
from .layers import (Downsample, ResnetBlock, TimestepEmbedding,
                     Transformer2D, timestep_embedding)

# the zero-initialised output convolutions (diffusers' zero_module)
_ZERO_INIT = ("controlnet_down_blocks_", "controlnet_mid_block",
              "controlnet_cond_embedding.conv_out")


class ControlNetConditioningEmbedding(nn.Module):
    """Control image (B, 3, 8h, 8w) -> conv_in-resolution features: a
    stride-2 conv pyramid (`blocks_{2i}` keeps the width, `blocks_{2i+1}`
    halves the size) and a zero-initialised output conv."""

    def __init__(self, out_channels: int,
                 block_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        bc = tuple(block_channels)
        self.n_stages = len(bc) - 1
        self.conv_in = nn.Conv2d(3, bc[0], 3, padding=1)
        for i in range(self.n_stages):
            self.add_module(f"blocks_{2 * i}",
                            nn.Conv2d(bc[i], bc[i], 3, padding=1))
            self.add_module(f"blocks_{2 * i + 1}",
                            nn.Conv2d(bc[i], bc[i + 1], 3, stride=2,
                                      padding=1))
        self.conv_out = nn.Conv2d(bc[-1], out_channels, 3, padding=1)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(self.conv_in(cond))
        for k in range(2 * self.n_stages):
            h = F.silu(getattr(self, f"blocks_{k}")(h))
        return self.conv_out(h)


class ControlNet(nn.Module):
    """ControlNet over `config`'s down and mid stack.

    cond_embed_channels: the control pyramid; its length less one is the
    number of stride-2 convs, log2 of the pixel-to-latent ratio (3 for the
    SD VAE). in_channels: the latent channels conv_in takes (flax infers
    them from the input; the ControlNet-inpaint path feeds the 4 latent
    channels), by default config.sample_channels."""

    def __init__(self, config: UNetConfig,
                 cond_embed_channels: Sequence[int] = (16, 32, 96, 256),
                 in_channels: Optional[int] = None):
        super().__init__()
        cfg = self.config = config
        self.cond_embed_channels = tuple(cond_embed_channels)
        boc = cfg.block_out_channels
        n = len(boc)
        temb = cfg.time_embed_dim
        groups = cfg.norm_num_groups
        self.in_channels = in_channels or cfg.sample_channels

        def transformer(level: int, depth: int) -> Transformer2D:
            return Transformer2D(boc[level], cfg.num_attention_heads[level],
                                 cfg.cross_attention_dim, depth=depth,
                                 groups=groups,
                                 use_linear_projection=cfg.is_sdxl)

        self.time_embedding = TimestepEmbedding(boc[0], temb)
        if cfg.is_sdxl:
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, temb)
        self.conv_in = nn.Conv2d(self.in_channels, boc[0], 3, padding=1)
        self.controlnet_cond_embedding = ControlNetConditioningEmbedding(
            boc[0], self.cond_embed_channels)

        skip_ch = [boc[0]]
        ch = boc[0]
        for level in range(n):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{j}",
                                ResnetBlock(ch, boc[level], temb, groups))
                ch = boc[level]
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
        for i, c in enumerate(skip_ch):
            self.add_module(f"controlnet_down_blocks_{i}", nn.Conv2d(c, c, 1))
        self.controlnet_mid_block = nn.Conv2d(boc[-1], boc[-1], 1)

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX module's initialisation in kind: fan-in normal weights,
        zero biases, unit norm scales, zero output convolutions (so a fresh
        ControlNet adds nothing to the UNet)."""
        for name, p in self.named_parameters():
            if name.startswith(_ZERO_INIT) or name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)

    @torch.no_grad()
    def random_params(self, generator: torch.Generator,
                      std: float = 0.02) -> None:
        """Every parameter N(0, std) on its device, the output convolutions
        too: weights for smoke runs and benchmarks, whose residuals are
        nonzero (no semantic initialisers)."""
        for p in self.parameters():
            p.normal_(0.0, std, generator=generator)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                controlnet_cond: torch.Tensor,
                conditioning_scale: float = 1.0,
                added_cond: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
        """sample (B, h, w, C) latents, timesteps (B,) or scalar, context
        (B, L, cross_attention_dim), controlnet_cond (B, 8h, 8w, 3) control
        image -> (down_block_residuals, mid_residual), NCHW, scaled by
        conditioning_scale."""
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
                raise ValueError("the SDXL ControlNet needs added_cond "
                                 "(text_embeds, time_ids)")
            time_ids = added_cond["time_ids"]
            t_emb = timestep_embedding(
                time_ids.reshape(-1), cfg.addition_time_embed_dim,
                cfg.flip_sin_to_cos, cfg.freq_shift)
            add = torch.cat([added_cond["text_embeds"].float(),
                             t_emb.reshape(time_ids.shape[0], -1)], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        ctx = encoder_hidden_states.to(dtype)

        h = self.conv_in(sample.to(dtype).permute(0, 3, 1, 2))
        h = h + self.controlnet_cond_embedding(
            controlnet_cond.to(dtype).permute(0, 3, 1, 2))
        skips = [h]
        for level in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{j}")(h, temb)
                if cfg.down_block_has_attn[level]:
                    h = getattr(self, f"down_{level}_attn_{j}")(h, ctx)
                skips.append(h)
            if level < n - 1:
                h = getattr(self, f"down_{level}_downsample")(h)
                skips.append(h)
        h = self.mid_resnet_0(h, temb)
        h = self.mid_attn(h, ctx)
        h = self.mid_resnet_1(h, temb)

        down = tuple(getattr(self, f"controlnet_down_blocks_{i}")(s)
                     * conditioning_scale for i, s in enumerate(skips))
        return down, self.controlnet_mid_block(h) * conditioning_scale


def make_controlnet(config: UNetConfig,
                    cond_embed_channels: Sequence[int] = (16, 32, 96, 256),
                    in_channels: Optional[int] = None,
                    dtype: Union[str, torch.dtype] = torch.float32,
                    device: Union[str, torch.device] = "cuda",
                    seed: int = 0) -> ControlNet:
    """A ControlNet built on the meta device and materialised once on
    `device` in `dtype`, initialised by `init_params` from a generator
    seeded `seed` there; frozen (inference)."""
    device = resolve_device(device)
    with torch.device("meta"):
        net = ControlNet(config, cond_embed_channels, in_channels)
    net.to_empty(device=device)
    net.to(resolve_dtype(dtype))
    net.requires_grad_(False)
    net.init_params(torch.Generator(device).manual_seed(seed))
    return net
