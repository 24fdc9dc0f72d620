"""Configuration dataclasses of the port.

Copies of the JAX package's core/config.py entries that the SD1.5 and SDXL
text-to-image and training paths read, with the same field names and
defaults, so a config carries across field by field. Fields the port
does not read yet (DeepCache, prediction types and timestep spacings other
than epsilon/leading, the adapter's duplicated LoRA and scale defaults) are
left out.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


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
    # SDXL micro-conditioning ("text_time" added embedding); the SDXL layout
    # also takes linear transformer projections
    addition_embed_type: Optional[str] = None      # None | "text_time"
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    lora_rank: int = 0
    ip_num_tokens: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * self.time_embed_dim_mult

    def head_dim(self, level: int) -> int:
        return self.block_out_channels[level] // self.num_attention_heads[level]

    @property
    def is_sdxl(self) -> bool:
        """The SDXL layout: the text_time added embedding, linear
        transformer projections, and an adapter checkpoint whose projection
        is named `image_proj_model`."""
        return self.addition_embed_type == "text_time"


def sd15_unet_config(**overrides) -> UNetConfig:
    """SD1.5 UNet2DConditionModel layout (runwayml/stable-diffusion-v1-5)."""
    return UNetConfig(**overrides)


def sdxl_unet_config(**overrides) -> UNetConfig:
    """SDXL base UNet layout (stabilityai/stable-diffusion-xl-base-1.0):
    a plain level 0, then 2 and 10 transformer layers at levels 1 and 2,
    10 in the mid block; 10 and 20 heads of dim 64; text_time
    micro-conditioning (reference pipline_StableDiffusionXL_ConsistentID.py
    :527-539)."""
    base = dict(
        block_out_channels=(320, 640, 1280),
        down_block_has_attn=(False, True, True),
        transformer_layers_per_block=(0, 2, 10),
        mid_transformer_depth=10,
        num_attention_heads=(5, 10, 20),
        cross_attention_dim=2048,
        addition_embed_type="text_time",
        addition_time_embed_dim=256,
        projection_class_embeddings_input_dim=2816,
    )
    base.update(overrides)
    return UNetConfig(**base)


@dataclass(frozen=True)
class VAEConfig:
    """AutoencoderKL (SD1.5 and SDXL share this layout)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215     # 0.13025 for SDXL
    force_upcast: bool = False          # SDXL decodes in fp32 (reference
    #                                     :670-672)


@dataclass(frozen=True)
class CLIPTextConfig:
    """CLIP text encoder. Defaults = CLIP-L/14 (the SD1.5 text encoder)."""

    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"      # CLIP-L quick_gelu; bigG gelu


def clip_text_bigg_config(**kw) -> CLIPTextConfig:
    """OpenCLIP bigG (SDXL's text_encoder_2)."""
    base = dict(hidden_size=1280, intermediate_size=5120, num_layers=32,
                num_heads=20, hidden_act="gelu")
    base.update(kw)
    return CLIPTextConfig(**base)


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
    # DeepCache cadence (sampling/sampler.py): 1 runs the full UNet every
    # step; N > 1 refreshes the deep blocks every N-th step and runs only
    # the level-0 blocks in between
    cache_interval: int = 1


REMAT_POLICIES = ("full", "dots")


@dataclass(frozen=True)
class TrainConfig:
    """SD1.5 adapter training (the JAX package's TrainConfig, same fields and
    defaults)."""

    learning_rate: float = 1e-4
    weight_decay: float = 1e-2
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    batch_per_device: int = 2
    grad_accum_steps: int = 1
    facial_weight: float = 0.01         # reference train.py:34
    mask_loss_prob: float = 0.5         # reference train.py:35
    localization_layers: int = 5        # 3 for SDXL (train_SDXL.py:47)
    resolution: int = 512
    max_steps: int = 100000
    save_steps: int = 1000
    seed: int = 42
    # UNet rematerialisation under autograd (models/unet.py): "full"
    # recomputes each block in the backward, "dots" keeps the outputs of its
    # 2-D products (the linear layers) and recomputes the rest
    remat_unet: bool = False
    remat_policy: str = "full"  # "full" | "dots"
    # AdamW first-moment storage dtype ("float32" | "bfloat16"); second
    # moments stay fp32
    mu_dtype: str = "float32"

    def __post_init__(self):
        if self.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {self.remat_policy!r}: one of "
                             f"{REMAT_POLICIES}")
        if self.mu_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"mu_dtype {self.mu_dtype!r}: float32 or "
                             "bfloat16")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1")
