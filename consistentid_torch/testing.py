"""Tiny random-weight bundles and a synthetic tokenizer for tests and smoke
runs. `tiny_bundle` has the sizes of the JAX package's tiny SD1.5 bundle, so
the same parameters load into both."""
from __future__ import annotations

from typing import Union

import torch

from .core import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                   UNetConfig, VAEConfig)


def tiny_bundle(device: Union[str, torch.device] = "cuda",
                dtype: torch.dtype = torch.float32, seed: int = 0):
    """A complete SD1.5 ConsistentID bundle at toy scale (random weights)."""
    from .pipelines import SD15Bundle

    return SD15Bundle(
        unet_config=UNetConfig(
            block_out_channels=(32, 32, 64, 64),
            layers_per_block=1,
            num_attention_heads=(2, 2, 2, 2),
            cross_attention_dim=64,
            norm_num_groups=8,
            lora_rank=4,
            ip_num_tokens=4,
        ),
        adapter_config=AdapterConfig(
            cross_attention_dim=64,
            id_embeddings_dim=16,
            clip_embeddings_dim=32,
            num_id_tokens=4,
            facial_dim=64,
            facial_depth=2,
            facial_heads=2,
            facial_output_dim=64,
        ),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        text_config=CLIPTextConfig(hidden_size=64, intermediate_size=128,
                                   num_layers=2, num_heads=2),
        vision_config=CLIPVisionConfig(image_size=28, patch_size=14,
                                       hidden_size=32, intermediate_size=64,
                                       num_layers=2, num_heads=2),
        dtype=dtype, device=device, seed=seed)


def synthetic_clip_tokenizer():
    """CLIPBPETokenizer over a universal byte-level vocab (full byte
    alphabet + </w> word-end forms, no merges): encodes any text through the
    production BPE code path where no real vocab.json exists. Token ids do
    not match the real CLIP vocab."""
    from .conditioning import CLIPBPETokenizer
    from .conditioning.clip_tokenizer import bytes_to_unicode

    syms = list(bytes_to_unicode().values())
    tokens = (syms + [s + "</w>" for s in syms]
              + ["<|startoftext|>", "<|endoftext|>"])
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    return CLIPBPETokenizer(vocab, [])
