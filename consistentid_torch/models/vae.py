"""AutoencoderKL (the SD VAE), counterpart of the JAX package's
models/vae.py. `decode` and `encode` take and return NHWC tensors; the
mid-block attention is plain torch (it never reaches the flash kernel in the
JAX package either)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import VAEConfig

VAE_GN_EPS = 1e-6


class VAEResnet(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=VAE_GN_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=VAE_GN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (SD VAE mid-block)."""

    def __init__(self, channels: int, groups: int = 32):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, channels, eps=VAE_GN_EPS)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.Linear(channels, channels)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        s = torch.matmul(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        h = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        h = self.to_out(h).reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return x + h


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.n = len(boc)
        self.layers_per_block = cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.in_channels, boc[0], 3, padding=1)
        ch = boc[0]
        for level, out_ch in enumerate(boc):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{level}_resnet_{j}",
                                VAEResnet(ch, out_ch, g))
                ch = out_ch
            if level < self.n - 1:
                # diffusers pads (0, 1) before the stride-2 VALID conv
                self.add_module(f"down_{level}_downsample",
                                nn.Conv2d(ch, ch, 3, stride=2))
        self.mid_resnet_0 = VAEResnet(ch, boc[-1], g)
        self.mid_attn = VAEAttention(boc[-1], g)
        self.mid_resnet_1 = VAEResnet(boc[-1], boc[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, boc[-1], eps=VAE_GN_EPS)
        self.conv_out = nn.Conv2d(boc[-1], 2 * cfg.latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for level in range(self.n):
            for j in range(self.layers_per_block):
                h = getattr(self, f"down_{level}_resnet_{j}")(h)
            if level < self.n - 1:
                h = getattr(self, f"down_{level}_downsample")(
                    F.pad(h, (0, 1, 0, 1)))
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        cfg = config
        boc = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.n = len(boc)
        self.layers_per_block = cfg.layers_per_block
        self.conv_in = nn.Conv2d(cfg.latent_channels, boc[-1], 3, padding=1)
        self.mid_resnet_0 = VAEResnet(boc[-1], boc[-1], g)
        self.mid_attn = VAEAttention(boc[-1], g)
        self.mid_resnet_1 = VAEResnet(boc[-1], boc[-1], g)
        ch = boc[-1]
        for i, out_ch in enumerate(reversed(boc)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_resnet_{j}", VAEResnet(ch, out_ch, g))
                ch = out_ch
            if i < self.n - 1:
                self.add_module(f"up_{i}_upsample",
                                nn.Conv2d(ch, ch, 3, padding=1))
        self.conv_norm_out = nn.GroupNorm(g, boc[0], eps=VAE_GN_EPS)
        self.conv_out = nn.Conv2d(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z)
        h = self.mid_resnet_1(self.mid_attn(self.mid_resnet_0(h)))
        for i in range(self.n):
            for j in range(self.layers_per_block + 1):
                h = getattr(self, f"up_{i}_resnet_{j}")(h)
            if i < self.n - 1:
                h = F.interpolate(h, scale_factor=2.0, mode="nearest")
                h = getattr(self, f"up_{i}_upsample")(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                    2 * config.latent_channels, 1)
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)

    def _dtype(self):
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x: torch.Tensor):
        """image (B, H, W, 3) in [-1, 1] -> (mean, logvar), each NHWC."""
        h = self.encoder(x.to(self._dtype()).permute(0, 3, 1, 2))
        mean, logvar = self.quant_conv(h).permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Scaled latents: the mean, or a posterior sample when a generator
        or the standard-normal `noise` itself (NHWC, the latents' shape) is
        given."""
        mean, logvar = self.encode_moments(x)
        if noise is None and generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
        if noise is not None:
            mean = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return mean * self.config.scaling_factor

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Scaled NHWC latents -> NHWC image in [-1, 1]."""
        z = (z / self.config.scaling_factor).to(self._dtype())
        h = self.decoder(self.post_quant_conv(z.permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)
