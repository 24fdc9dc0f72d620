from .config import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                     PipelineConfig, SchedulerConfig, TrainConfig, UNetConfig,
                     VAEConfig, clip_text_bigg_config, sd15_unet_config,
                     sdxl_unet_config)
from .dtypes import resolve_device, resolve_dtype
