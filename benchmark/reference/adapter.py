"""ConsistentID adapter heads (counterparts of the JAX package's
adapter/modules.py; reference functions.py:490-592, attention.py:10-88):
the overall-ID projector, the per-region compressor and the prompt fuse."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .perceiver import LN_EPS, FacePerceiverResampler, FeedForward, \
    PerceiverAttention


class ProjPlusModel(nn.Module):
    """ArcFace embedding -> num_tokens ID tokens, perceiver-refined against
    CLIP penultimate hidden states."""

    def __init__(self, cross_attention_dim: int = 768,
                 id_embeddings_dim: int = 512, clip_embeddings_dim: int = 1280,
                 num_tokens: int = 4):
        super().__init__()
        self.cross_attention_dim = cross_attention_dim
        self.num_tokens = num_tokens
        self.proj_0 = nn.Linear(id_embeddings_dim, id_embeddings_dim * 2)
        self.proj_2 = nn.Linear(id_embeddings_dim * 2,
                                cross_attention_dim * num_tokens)
        self.norm = nn.LayerNorm(cross_attention_dim, eps=LN_EPS)
        self.perceiver_resampler = FacePerceiverResampler(
            dim=cross_attention_dim, depth=4, dim_head=64,
            heads=cross_attention_dim // 64,
            embedding_dim=clip_embeddings_dim,
            output_dim=cross_attention_dim, ff_mult=4)

    def forward(self, id_embeds, clip_embeds, shortcut: bool = False,
                scale: float = 1.0):
        x = self.proj_2(F.gelu(self.proj_0(id_embeds)))
        x = self.norm(x.reshape(-1, self.num_tokens, self.cross_attention_dim))
        out = self.perceiver_resampler(x, clip_embeds)
        if shortcut:
            out = x + scale * out
        return out


class AttentionMLP(nn.Module):
    """Compresses one facial-region CLIP feature map into
    `single_num_tokens` tokens via a learned-latent perceiver."""

    def __init__(self, dim: int = 1024, depth: int = 8, dim_head: int = 64,
                 heads: int = 16, single_num_tokens: int = 1,
                 embedding_dim: int = 1280, output_dim: int = 768,
                 ff_mult: int = 4):
        super().__init__()
        self.depth = depth
        self.latents = nn.Parameter(torch.zeros(1, single_num_tokens, dim))
        self.proj_in = nn.Linear(embedding_dim, dim)
        for i in range(depth):
            self.add_module(f"layers_{i}_attn",
                            PerceiverAttention(dim, dim_head, heads))
            self.add_module(f"layers_{i}_ff", FeedForward(dim, ff_mult))
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=LN_EPS)

    def forward(self, x):
        latents = self.latents.expand(x.shape[0], -1, -1)
        x = self.proj_in(x)
        for i in range(self.depth):
            latents = getattr(self, f"layers_{i}_attn")(x, latents) + latents
            latents = getattr(self, f"layers_{i}_ff")(latents) + latents
        return self.norm_out(self.proj_out(latents))


class MLP(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int,
                 use_residual: bool = True):
        super().__init__()
        self.use_residual = use_residual
        self.layernorm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(in_dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, out_dim)

    def forward(self, x):
        y = self.fc2(F.gelu(self.fc1(self.layernorm(x))))
        return y + x if self.use_residual else y


class FuseModule(nn.Module):
    """Splice per-region ID tokens into the prompt embeddings at the
    `<|facial|>` marker positions.

    prompt_embeds (B, L, D), id_embeds (B, N, D_id), facial_token_idx (B, N)
    int, facial_token_mask (B, N) bool. Only valid slots are written, so a
    padded slot whose index collides with a valid one cannot overwrite it
    (the JAX package writes padded slots back with their own gathered value,
    which is the same result unless indices collide).
    """

    def __init__(self, embed_dim: int, id_dim: int):
        super().__init__()
        self.mlp1 = MLP(embed_dim + id_dim, embed_dim, embed_dim,
                        use_residual=False)
        self.mlp2 = MLP(embed_dim, embed_dim, embed_dim, use_residual=True)
        self.layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, prompt_embeds, id_embeds, facial_token_idx,
                facial_token_mask):
        idx = facial_token_idx.long()
        d = prompt_embeds.shape[-1]
        gathered = prompt_embeds.gather(
            1, idx[..., None].expand(-1, -1, d))                # (B, N, D)
        stacked = torch.cat([gathered, id_embeds.to(prompt_embeds.dtype)],
                            dim=-1)
        fused = self.mlp1(stacked) + gathered
        fused = self.layer_norm(self.mlp2(fused))
        b_idx, n_idx = facial_token_mask.bool().nonzero(as_tuple=True)
        out = prompt_embeds.clone()
        out[b_idx, idx[b_idx, n_idx]] = fused[b_idx, n_idx].to(out.dtype)
        return out


class FacialEncoder(nn.Module):
    """Fine-grained ID encoder: one token per facial region (AttentionMLP
    over each region's CLIP feature map), fused into the prompt embeds."""

    def __init__(self, embedding_dim: int = 1280, output_dim: int = 768,
                 embed_dim: int = 768, facial_dim: int = 1024,
                 facial_depth: int = 8, facial_heads: int = 16,
                 facial_dim_head: int = 64):
        super().__init__()
        self.output_dim = output_dim
        self.visual_projection = AttentionMLP(
            dim=facial_dim, depth=facial_depth, heads=facial_heads,
            dim_head=facial_dim_head, embedding_dim=embedding_dim,
            output_dim=output_dim)
        self.fuse_module = FuseModule(embed_dim, output_dim)

    def forward(self, prompt_embeds, multi_image_embeds, facial_token_idx,
                facial_token_mask):
        """multi_image_embeds: (B, N, T, C) per-region CLIP hidden states."""
        b, n, t, c = multi_image_embeds.shape
        id_tokens = self.visual_projection(
            multi_image_embeds.reshape(b * n, t, c))
        id_tokens = id_tokens.reshape(b, n, self.output_dim)
        return self.fuse_module(prompt_embeds, id_tokens, facial_token_idx,
                                facial_token_mask)
