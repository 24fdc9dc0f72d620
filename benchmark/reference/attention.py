"""Plain attention for the reference: softmax(Q K^T / sqrt(d)) V as two
matmuls and a softmax, in the inputs' dtype (fp32 in the reference). No
flash kernel."""
from __future__ import annotations

import math
from typing import Optional

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: Optional[float] = None):
    """(B, H, S, D) attention: fp32 scores and softmax, P cast to q's dtype
    for the P V product."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p.to(q.dtype), v)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          sm_scale: Optional[float] = None):
    return reference_attention(q, k, v, sm_scale)


def split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, H*D) -> (B, H, S, D)."""
    b, s, hd = x.shape
    return x.reshape(b, s, heads, hd // heads).transpose(1, 2)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, S, D) -> (B, S, H*D)."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
