"""Perceiver blocks of the ConsistentID adapter (counterparts of the JAX
package's adapter/perceiver.py; reference functions.py:390-488): LayerNorm
eps 1e-5, exact-erf GELU, and the q/k scaling by dim_head**-0.25 each with
an fp32 softmax."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LN_EPS = 1e-5


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = int(dim * mult)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, inner, bias=False)
        self.fc2 = nn.Linear(inner, dim, bias=False)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(self.norm(x))))


class PerceiverAttention(nn.Module):
    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8):
        super().__init__()
        inner = dim_head * heads
        self.dim_head = dim_head
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x, latents):
        """latents attend to concat(x, latents); (B, n1, D), (B, n2, D)."""
        x = self.norm1(x)
        latents = self.norm2(latents)
        b, n2, _ = latents.shape

        def heads_first(t):
            return t.reshape(b, t.shape[1], self.heads,
                             self.dim_head).transpose(1, 2)

        q = heads_first(self.to_q(latents))
        k, v = self.to_kv(torch.cat([x, latents], dim=1)).chunk(2, dim=-1)
        k, v = heads_first(k), heads_first(v)
        scale = 1.0 / (self.dim_head ** 0.25)
        logits = torch.matmul((q * scale).float(),
                              (k * scale).float().transpose(-1, -2))
        out = torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)
        out = out.transpose(1, 2).reshape(b, n2, self.heads * self.dim_head)
        return self.to_out(out)


class FacePerceiverResampler(nn.Module):
    """Depth-`depth` perceiver stack refining ID tokens against CLIP
    features."""

    def __init__(self, dim: int = 768, depth: int = 4, dim_head: int = 64,
                 heads: int = 16, embedding_dim: int = 1280,
                 output_dim: int = 768, ff_mult: int = 4):
        super().__init__()
        self.depth = depth
        self.proj_in = nn.Linear(embedding_dim, dim)
        for i in range(depth):
            self.add_module(f"layers_{i}_attn",
                            PerceiverAttention(dim, dim_head, heads))
            self.add_module(f"layers_{i}_ff", FeedForward(dim, ff_mult))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, latents, x):
        x = self.proj_in(x)
        for i in range(self.depth):
            latents = getattr(self, f"layers_{i}_attn")(x, latents) + latents
            latents = getattr(self, f"layers_{i}_ff")(latents) + latents
        return self.norm_out(self.proj_out(latents))
