"""Attention dispatch: flash attention for large attention maps, plain
torch elsewhere and whenever the softmax probabilities must be returned.

Counterpart of the JAX package's ops/attention.py, with the same cutover:
attention goes to `flash_attention` when Sq * Sk >= 1024 * 1024 per head,
which at 512 px is exactly the UNet self-attention at levels 0 and 1. There
it runs K1 without autograd and K2 forward / K3, K4 backward under it. On a
CPU tensor `flash_attention` runs the plain versions, so the dispatch and the
gradient are the same on both devices.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import flash_attention as _flash

FLASH_MIN_ELEMS = 1024 * 1024


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None,
                        return_probs: bool = False):
    """Plain attention, (B, H, S, D): fp32 scores and softmax, P cast to
    q's dtype for the P V product, output in q's dtype."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p.to(q.dtype), v)
    if return_probs:
        return o, p
    return o


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None,
                          return_probs: bool = False,
                          use_flash: Optional[bool] = None):
    """Attention over (B, H, S, D) tensors. use_flash=None selects the flash
    kernel for Sq * Sk >= FLASH_MIN_ELEMS; return_probs forces plain torch."""
    if return_probs:
        return reference_attention(q, k, v, sm_scale, return_probs=True)
    if use_flash is None:
        use_flash = q.shape[2] * k.shape[2] >= FLASH_MIN_ELEMS
    if use_flash:
        return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), sm_scale)
    return reference_attention(q, k, v, sm_scale)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
