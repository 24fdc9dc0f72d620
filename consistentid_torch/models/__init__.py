from .clip import CLIPTextEncoder, CLIPVisionEncoder
from .lora import fold_lora_params
from .unet import UNet
from .vae import AutoencoderKL
