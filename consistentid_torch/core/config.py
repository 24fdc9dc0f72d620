"""Configuration dataclasses of the port.

Copies of the JAX package's core/config.py entries that the SD1.5 path
reads, with the same field names and defaults, so a config carries across
field by field. Fields the port does not read yet (SDXL text_time, DeepCache,
prediction types and timestep spacings other than epsilon/leading, the
adapter's duplicated LoRA and scale defaults) are left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class UNetConfig:
    """SD UNet layout (diffusers UNet2DConditionModel) plus the ConsistentID
    adapter hooks: LoRA on every attention projection and the decoupled-IP
    tokens at the tail of the context."""

    sample_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    down_block_has_attn: Tuple[bool, ...] = (True, True, True, False)
    transformer_layers_per_block: Tuple[int, ...] = (1, 1, 1, 0)
    mid_transformer_depth: int = 1
    num_attention_heads: Tuple[int, ...] = (8, 8, 8, 8)
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    time_embed_dim_mult: int = 4
    freq_shift: float = 0.0
    flip_sin_to_cos: bool = True
    lora_rank: int = 0
    ip_num_tokens: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    def head_dim(self, level: int) -> int:
        return self.block_out_channels[level] // self.num_attention_heads[level]


def sd15_unet_config(**overrides) -> UNetConfig:
    """SD1.5 UNet2DConditionModel layout (runwayml/stable-diffusion-v1-5)."""
    return UNetConfig(**overrides)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (the SD1.5 VAE)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text encoder. Defaults = CLIP-L/14 (the SD1.5 text encoder)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"


@dataclass(frozen=True)
class CLIPVisionConfig:
    """CLIP vision tower. Defaults = ViT-H/14, whose penultimate hidden
    states (257 x 1280) feed the adapters."""

    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1280
    intermediate_size: int = 5120
    num_layers: int = 32
    num_heads: int = 16
    hidden_act: str = "gelu"

    @property
    def num_tokens(self) -> int:  # cls + patches
        return 1 + (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class AdapterConfig:
    """ConsistentID adapter hyperparameters (reference defaults:
    ProjPlusModel functions.py:490-512, AttentionMLP functions.py:524-570,
    FacialEncoder attention.py:72-76, 4 ID tokens). The UNet's LoRA rank is
    UNetConfig.lora_rank."""

    cross_attention_dim: int = 768
    id_embeddings_dim: int = 512
    clip_embeddings_dim: int = 1280
    num_id_tokens: int = 4
    facial_dim: int = 1024
    facial_depth: int = 8
    facial_heads: int = 16
    facial_dim_head: int = 64
    facial_output_dim: int = 768
    shortcut: bool = False
    shortcut_scale: float = 1.0


@dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    set_alpha_to_one: bool = False
    steps_offset: int = 1


@dataclass(frozen=True)
class PipelineConfig:
    height: int = 512
    width: int = 512
    num_inference_steps: int = 50
    guidance_scale: float = 5.0
    start_merge_step: int = 30          # reference infer.py:48-49
    scheduler: str = "ddim"
