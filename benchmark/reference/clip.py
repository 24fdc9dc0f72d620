"""CLIP text (CLIP-L, quick_gelu) and vision (ViT-H, penultimate states)
encoders, counterparts of the JAX package's models/clip.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import CLIPTextConfig, CLIPVisionConfig
from .attention import dot_product_attention, merge_heads, split_heads

CLIP_LN_EPS = 1e-5


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == "gelu":
        return F.gelu
    raise ValueError(name)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, causal: bool):
        super().__init__()
        self.num_heads = num_heads
        self.causal = causal
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x):
        qh, kh, vh = (split_heads(p(x), self.num_heads)
                      for p in (self.q_proj, self.k_proj, self.v_proj))
        if self.causal:
            s = qh.shape[2]
            logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
            logits = logits * qh.shape[-1] ** -0.5
            mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            logits = logits.masked_fill(~mask, -1e30)
            out = torch.matmul(torch.softmax(logits, dim=-1).to(vh.dtype), vh)
        else:
            out = dot_product_attention(qh, kh, vh)
        return self.out_proj(merge_heads(out))


class CLIPLayer(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 num_heads: int, causal: bool, hidden_act: str):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=CLIP_LN_EPS)
        self.self_attn = CLIPAttention(hidden_size, num_heads, causal)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=CLIP_LN_EPS)
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)
        self.act = _act(hidden_act)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.fc2(self.act(self.fc1(self.layer_norm2(x))))


class CLIPTextEncoder(nn.Module):
    """input_ids (B, S) -> (hidden state, pooled EOS embedding). Index -1
    returns the final layer-normed output, -2 the penultimate raw state."""

    def __init__(self, config: CLIPTextConfig):
        super().__init__()
        cfg = self.config = config
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.max_position_embeddings, cfg.hidden_size))
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                causal=True, hidden_act=cfg.hidden_act))
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=CLIP_LN_EPS)

    def forward(self, input_ids: torch.Tensor,
                output_hidden_state_index: int = -1,
                eos_token_id: int = 49407):
        s = input_ids.shape[1]
        x = self.token_embedding(input_ids) + self.position_embedding[:s]
        hidden_states = [x]
        for i in range(self.config.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            hidden_states.append(x)
        final = self.final_layer_norm(x)
        out = (final if output_hidden_state_index == -1
               else hidden_states[output_hidden_state_index])
        eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(final.shape[0], device=final.device),
                       eos_pos]
        return out, pooled


class CLIPVisionEncoder(nn.Module):
    """pixel_values (B, S, S, 3) -> (post-layernormed last state,
    penultimate hidden states)."""

    def __init__(self, config: CLIPVisionConfig):
        super().__init__()
        cfg = self.config = config
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.hidden_size))
        self.position_embedding = nn.Parameter(
            torch.zeros(cfg.num_tokens, cfg.hidden_size))
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=CLIP_LN_EPS)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}", CLIPLayer(
                cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                causal=False, hidden_act=cfg.hidden_act))
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=CLIP_LN_EPS)

    def forward(self, pixel_values: torch.Tensor):
        cfg = self.config
        x = pixel_values.to(self.patch_embedding.weight.dtype)
        patches = self.patch_embedding(x.permute(0, 3, 1, 2))
        patches = patches.flatten(2).transpose(1, 2)
        cls = self.class_embedding.expand(patches.shape[0], 1, -1)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding
        x = self.pre_layrnorm(x)
        penultimate = x
        for i in range(cfg.num_layers):
            penultimate = x
            x = getattr(self, f"layers_{i}")(x)
        return self.post_layernorm(x), penultimate
