"""Shared layers of the SD1.5 and SDXL UNets.

Counterparts of the JAX package's models/layers.py. Submodules carry the
flax parameter names (`conv1`, `attn1.to_q`, `to_q_lora.down`, ...), so a
flax tree maps onto a state dict by a walk plus transposes (io/from_jax.py).
Convolution modules take NCHW tensors, token modules (B, S, C).

`quant` (False, True or "static") selects the W8A8 twins `Int8Conv` and
`Int8Dense` (ops/quant.py) for the layers the JAX package quantizes: the
resnet blocks' conv1, conv2 and conv_shortcut, the down- and upsampling
convolutions, the attention projections to_q, to_k, to_v and to_out, the
feed-forward's proj and out, and the transformers' proj_in and proj_out.
The IP projections (to_k_ip, to_v_ip), time_emb_proj, the norms and the
LoRA deltas stay float, as in JAX.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import dot_product_attention, merge_heads, split_heads
from ..ops.quant import (QMAX, int8_conv_quantized, int8_matmul_quantized,
                         quantize_symmetric, quantize_with_scale)

GN_EPS = 1e-5              # resnet / conv-out group norms
GN_EPS_TRANSFORMER = 1e-6  # transformer input group norm
LN_EPS = 1e-5


class _Int8Layer(nn.Module):
    """Buffers of a W8A8 layer (JAX `Int8Conv`/`Int8Dense` params):
    `kernel_q` int8 in the float layer's weight layout, `kernel_scale` fp32
    per output channel, `bias` (or None), and with `static` a calibrated
    fp32 scalar `act_scale`. `path` is the layer's module path in the UNet
    (models/unet.py sets it), under which `calibration` records it."""

    def __init__(self, kernel_shape, bias: bool, static: bool):
        super().__init__()
        self.static = static
        self.path = ""
        self.records: Optional[Dict[str, List[torch.Tensor]]] = None
        self.register_buffer("kernel_q",
                             torch.zeros(kernel_shape, dtype=torch.int8))
        self.register_buffer("kernel_scale", torch.ones(kernel_shape[0]))
        self.register_buffer("bias", torch.zeros(kernel_shape[0])
                             if bias else None)
        if static:
            self.register_buffer("act_scale", torch.ones(()))

    def _quantize(self, x: torch.Tensor, dims):
        """(codes, scale): the static act_scale, or per `dims` (recorded
        as max(scale) * 127 while calibrating, JAX's sown act_amax)."""
        if self.static:
            return quantize_with_scale(x, self.act_scale), self.act_scale
        xq, xscale = quantize_symmetric(x, dims, keepdim=True)
        if self.records is not None:
            self.records.setdefault(self.path, []).append(
                xscale.max() * QMAX)
        return xq, xscale

    def _finish(self, y: torch.Tensor, dtype: torch.dtype,
                channel_dim: int = -1,
                memory_format=torch.preserve_format) -> torch.Tensor:
        """The fp32 product plus the bias (along `channel_dim`) in fp32,
        cast to `dtype`."""
        if self.bias is not None:
            shape = [1] * y.dim()
            shape[channel_dim] = -1
            y = y + self.bias.float().reshape(shape)
        return y.to(dtype, memory_format=memory_format)


class Int8Conv(_Int8Layer):
    """W8A8 convolution (JAX `Int8Conv`): activations quantized per
    example (the amax over C, H, W; recorded under calibration) or with
    the static `act_scale`, the product on int_mm over im2col. Returns
    NCHW in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0,
                 bias: bool = True, static: bool = False):
        super().__init__((out_channels, in_channels, kernel_size,
                          kernel_size), bias, static)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xscale = self._quantize(x, (1, 2, 3))
        y = int8_conv_quantized(xq, xscale, self.kernel_q, self.kernel_scale,
                                self.stride, self.padding, self.path)
        return self._finish(y, x.dtype, 1, torch.contiguous_format)


class Int8Dense(_Int8Layer):
    """W8A8 linear layer (JAX `Int8Dense`): activations quantized per token
    (the amax over the last axis; recorded under calibration) or with the
    static `act_scale`."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, static: bool = False):
        super().__init__((out_features, in_features), bias, static)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq, xscale = self._quantize(x, (x.dim() - 1,))
        y = int8_matmul_quantized(xq, xscale, self.kernel_q,
                                  self.kernel_scale, self.path)
        return self._finish(y, x.dtype)


@contextmanager
def calibration(model: nn.Module) -> Iterator[Dict[str, List[torch.Tensor]]]:
    """While inside, every dynamic int8 layer of `model` records its
    activation amax: yields {module path: [max(xscale) * 127 per apply]}
    (0-dim fp32 tensors on the layers' device), the JAX package's "calib"
    collection, for ops.quant.act_scales_from_calib."""
    records: Dict[str, List[torch.Tensor]] = {}
    layers = [m for m in model.modules() if isinstance(m, _Int8Layer)]
    for layer in layers:
        layer.records = records
    try:
        yield records
    finally:
        for layer in layers:
            layer.records = None


def conv2d(in_channels: int, out_channels: int, kernel_size: int,
           stride: int = 1, padding: int = 0, bias: bool = True,
           quant=False) -> nn.Module:
    """nn.Conv2d, or with `quant` (True: dynamic, "static": calibrated) its
    W8A8 twin."""
    if quant:
        return Int8Conv(in_channels, out_channels, kernel_size, stride,
                        padding, bias, static=quant == "static")
    return nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                     padding=padding, bias=bias)


def linear(in_features: int, out_features: int, bias: bool = True,
           quant=False) -> nn.Module:
    """nn.Linear, or with `quant` its W8A8 twin (as `conv2d`)."""
    if quant:
        return Int8Dense(in_features, out_features, bias,
                         static=quant == "static")
    return nn.Linear(in_features, out_features, bias=bias)


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
                 temb_dim: Optional[int], groups: int = 32, quant=False):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_channels, eps=GN_EPS)
        self.conv1 = conv2d(in_channels, out_channels, 3, padding=1,
                            quant=quant)
        self.time_emb_proj = (nn.Linear(temb_dim, out_channels)
                              if temb_dim else None)
        self.norm2 = nn.GroupNorm(groups, out_channels, eps=GN_EPS)
        self.conv2 = conv2d(out_channels, out_channels, 3, padding=1,
                            quant=quant)
        self.conv_shortcut = (conv2d(in_channels, out_channels, 1,
                                     quant=quant)
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
    def __init__(self, channels: int, quant=False):
        super().__init__()
        self.conv = conv2d(channels, channels, 3, stride=2, padding=1,
                           quant=quant)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, quant=False):
        super().__init__()
        self.conv = conv2d(channels, channels, 3, padding=1, quant=quant)

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
    tokens (reference attention.py:90-294).

    With `capture_probs=True` the call returns `(out, probs)`: the fp32
    softmax of the base attention (plain torch, never the flash kernels),
    and with `capture_idx` (B, N) only those N context columns of it,
    gathered here so the full map never leaves the layer (JAX `:306-314`:
    the localization loss normalises after gathering, so it is exact)."""

    def __init__(self, query_dim: int, heads: int,
                 context_dim: Optional[int] = None, lora_rank: int = 0,
                 ip_num_tokens: int = 0, quant=False):
        super().__init__()
        inner = query_dim
        ctx_dim = context_dim if context_dim is not None else query_dim
        self.heads = heads
        self.ip_num_tokens = ip_num_tokens if context_dim is not None else 0
        self.to_q = linear(query_dim, inner, bias=False, quant=quant)
        self.to_k = linear(ctx_dim, inner, bias=False, quant=quant)
        self.to_v = linear(ctx_dim, inner, bias=False, quant=quant)
        self.to_out = linear(inner, inner, quant=quant)
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
                ip_scale: float = 1.0, capture_probs: bool = False,
                capture_idx: Optional[torch.Tensor] = None):
        ctx = x if context is None else context
        ip_ctx = None
        if self.ip_num_tokens > 0:
            end = ctx.shape[1] - self.ip_num_tokens
            ctx, ip_ctx = ctx[:, :end], ctx[:, end:]
        q = self._proj("to_q", x, lora_scale)
        k = self._proj("to_k", ctx, lora_scale)
        v = self._proj("to_v", ctx, lora_scale)
        qh, kh, vh = (split_heads(t, self.heads) for t in (q, k, v))
        probs = None
        if capture_probs:
            out, probs = dot_product_attention(qh, kh, vh, return_probs=True)
            if capture_idx is not None:
                b, h, sq, _ = probs.shape
                idx = capture_idx.long()[:, None, None, :].expand(
                    b, h, sq, capture_idx.shape[-1])
                probs = probs.gather(3, idx)
        else:
            out = dot_product_attention(qh, kh, vh)
        out = merge_heads(out)
        if ip_ctx is not None:
            ip_out = dot_product_attention(
                qh, split_heads(self.to_k_ip(ip_ctx), self.heads),
                split_heads(self.to_v_ip(ip_ctx), self.heads), use_flash=False)
            out = out + ip_scale * merge_heads(ip_out)
        y = self._proj("to_out", out, lora_scale)
        return (y, probs) if capture_probs else y


class GEGLUFeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4, quant=False):
        super().__init__()
        inner = dim * mult
        self.proj = linear(dim, inner * 2, quant=quant)
        self.out = linear(inner, dim, quant=quant)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return self.out(h * F.gelu(gate))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, context_dim: int,
                 lora_rank: int = 0, ip_num_tokens: int = 0, quant=False):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn1 = Attention(dim, heads, lora_rank=lora_rank, quant=quant)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn2 = Attention(dim, heads, context_dim=context_dim,
                               lora_rank=lora_rank,
                               ip_num_tokens=ip_num_tokens, quant=quant)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff = GEGLUFeedForward(dim, quant=quant)

    def forward(self, x, context, lora_scale=1.0, ip_scale=1.0,
                capture_probs=False, capture_idx=None):
        """With capture_probs, returns (x, attn2's captured probs)."""
        x = x + self.attn1(self.norm1(x), lora_scale=lora_scale)
        h = self.attn2(self.norm2(x), context, lora_scale=lora_scale,
                       ip_scale=ip_scale, capture_probs=capture_probs,
                       capture_idx=capture_idx)
        probs = None
        if capture_probs:
            h, probs = h
        x = x + h
        x = x + self.ff(self.norm3(x))
        return (x, probs) if capture_probs else x


class Transformer2D(nn.Module):
    """Spatial transformer around `depth` BasicTransformerBlocks, registered
    as blocks_0, blocks_1, ...; its in/out projections are 1x1 convolutions
    (SD1.5) or, with use_linear_projection, linears over the flattened
    tokens (SDXL)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 depth: int = 1, groups: int = 32, lora_rank: int = 0,
                 ip_num_tokens: int = 0, use_linear_projection: bool = False,
                 quant=False):
        super().__init__()
        self.depth = depth
        self.use_linear = use_linear_projection
        self.norm = nn.GroupNorm(groups, channels, eps=GN_EPS_TRANSFORMER)
        proj = ((lambda: linear(channels, channels, quant=quant))
                if use_linear_projection
                else (lambda: conv2d(channels, channels, 1, quant=quant)))
        self.proj_in = proj()
        for i in range(depth):
            self.add_module(f"blocks_{i}", BasicTransformerBlock(
                channels, heads, context_dim, lora_rank=lora_rank,
                ip_num_tokens=ip_num_tokens, quant=quant))
        self.proj_out = proj()

    def forward(self, x, context, lora_scale=1.0, ip_scale=1.0,
                capture_probs=False, capture_idx=None):
        """With capture_probs, returns (out, {"blocks_i": probs})."""
        b, c, hh, ww = x.shape
        h = self.norm(x)
        if not self.use_linear:
            h = self.proj_in(h)
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        if self.use_linear:
            h = self.proj_in(h)
        captured = {}
        for i in range(self.depth):
            h = getattr(self, f"blocks_{i}")(h, context, lora_scale, ip_scale,
                                             capture_probs, capture_idx)
            if capture_probs:
                h, captured[f"blocks_{i}"] = h
        if self.use_linear:
            h = self.proj_out(h)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        out = (h if self.use_linear else self.proj_out(h)) + x
        return (out, captured) if capture_probs else out
