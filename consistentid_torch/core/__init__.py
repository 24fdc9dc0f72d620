from .config import (AdapterConfig, CLIPTextConfig, CLIPVisionConfig,
                     PipelineConfig, SchedulerConfig, UNetConfig, VAEConfig,
                     sd15_unet_config)
from .dtypes import resolve_device, resolve_dtype
