"""Shared layers of the SD1.5 and SDXL UNets.

Counterparts of the JAX package's models/layers.py. Submodules carry the
flax parameter names (`conv1`, `attn1.to_q`, `to_q_lora.down`, ...), so a
flax tree maps onto a state dict by a walk plus transposes (io/from_jax.py).
Convolution modules take NCHW tensors, token modules (B, S, C).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .attention import dot_product_attention, merge_heads, split_heads
GN_EPS = 1e-5              # resnet / conv-out group norms
GN_EPS_TRANSFORMER = 1e-6  # transformer input group norm
LN_EPS = 1e-5


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features, (B,) -> (B, dim). fp32 throughout."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting sinusoidal features to the time-embed dim."""

    def __init__(self, in_dim: int, embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim)
        self.linear_2 = nn.Linear(embed_dim, embed_dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_dim: Optional[int], groups: int = 32):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=GN_EPS)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels)
                              if temb_dim else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=GN_EPS)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x, temb: Optional[torch.Tensor] = None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None and temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class LoRADelta(nn.Module):
    """Rank-decomposed delta (diffusers LoRALinearLayer): up(down(x)),
    applied additively with an external scale."""

    def __init__(self, in_features: int, out_features: int, rank: int):
        super().__init__()
        self.down = nn.Linear(in_features, rank, bias=False)
        self.up = nn.Linear(rank, out_features, bias=False)

    def forward(self, x):
        return self.up(self.down(x))


class Attention(nn.Module):
    """UNet attention with optional LoRA on all four projections and the
    decoupled IP-adapter branch over the last `ip_num_tokens` context
    tokens (reference attention.py:90-294)."""

    def __init__(self, query_dim: int, heads: int,
                 context_dim: Optional[int] = None, lora_rank: int = 0,
                 ip_num_tokens: int = 0):
        super().__init__()
        inner = query_dim
        ctx_dim = context_dim if context_dim is not None else query_dim
        self.heads = heads
        self.ip_num_tokens = ip_num_tokens if context_dim is not None else 0
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.Linear(inner, inner)
        self.lora_rank = lora_rank
        if lora_rank > 0:
            self.to_q_lora = LoRADelta(query_dim, inner, lora_rank)
            self.to_k_lora = LoRADelta(ctx_dim, inner, lora_rank)
            self.to_v_lora = LoRADelta(ctx_dim, inner, lora_rank)
            self.to_out_lora = LoRADelta(inner, inner, lora_rank)
        if self.ip_num_tokens > 0:
            self.to_k_ip = nn.Linear(ctx_dim, inner, bias=False)
            self.to_v_ip = nn.Linear(ctx_dim, inner, bias=False)

    def _proj(self, name: str, x, lora_scale: float):
        y = getattr(self, name)(x)
        if self.lora_rank > 0:
            y = y + lora_scale * getattr(self, f"{name}_lora")(x)
        return y

    def forward(self, x, context=None, lora_scale: float = 1.0,
                ip_scale: float = 1.0):
        ctx = x if context is None else context
        ip_ctx = None
        if self.ip_num_tokens > 0:
            end = ctx.shape[1] - self.ip_num_tokens
            ctx, ip_ctx = ctx[:, :end], ctx[:, end:]
        q = self._proj("to_q", x, lora_scale)
        k = self._proj("to_k", ctx, lora_scale)
        v = self._proj("to_v", ctx, lora_scale)
        qh, kh, vh = (split_heads(t, self.heads) for t in (q, k, v))
        out = merge_heads(dot_product_attention(qh, kh, vh))
        if ip_ctx is not None:
            ip_out = dot_product_attention(
                qh, split_heads(self.to_k_ip(ip_ctx), self.heads),
                split_heads(self.to_v_ip(ip_ctx), self.heads))
            out = out + ip_scale * merge_heads(ip_out)
        return self._proj("to_out", out, lora_scale)


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.proj = nn.Linear(dim, inner * 2)
        self.out = nn.Linear(inner, dim)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int,
                 lora_rank: int = 0, ip_num_tokens: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = Attention(dim, heads, lora_rank=lora_rank)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = Attention(dim, heads, context_dim=context_dim,
                               lora_rank=lora_rank,
                               ip_num_tokens=ip_num_tokens)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = GEGLUFeedForward(dim)

    def forward(self, x, context, lora_scale=1.0, ip_scale=1.0):
        x = x + self.attn1(self.norm1(x), lora_scale=lora_scale)
        x = x + self.attn2(self.norm2(x), context, lora_scale=lora_scale,
                           ip_scale=ip_scale)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """Spatial transformer around `depth` BasicTransformerBlocks, registered
    as blocks_0, blocks_1, ...; its in/out projections are 1x1 convolutions
    (SD1.5) or, with use_linear_projection, linears over the flattened
    tokens (SDXL)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1, groups: int = 32, lora_rank: int = 0,
                 ip_num_tokens: int = 0, use_linear_projection: bool = False):
        super().__init__()
        self.depth = depth
        self.use_linear = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=GN_EPS_TRANSFORMER)
        proj = ((lambda: nn.Linear(channels, channels))
                if use_linear_projection
                else (lambda: nn.Conv2d(channels, channels, 1)))
        self.proj_in = proj()
        for i in range(depth):
            self.add_module(f"blocks_{i}", BasicTransformerBlock(
                channels, heads, context_dim, lora_rank=lora_rank,
                ip_num_tokens=ip_num_tokens))
        self.proj_out = proj()

    def forward(self, x, context, lora_scale=1.0, ip_scale=1.0):
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if not self.use_linear:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if self.use_linear:
            h = self.proj_in(h)
        for i in range(self.depth):
            h = getattr(self, f"blocks_{i}")(h, context, lora_scale, ip_scale)
        if self.use_linear:
            h = self.proj_out(h)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return (h if self.use_linear else self.proj_out(h)) + x
