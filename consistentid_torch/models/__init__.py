from .clip import CLIPTextEncoder, CLIPVisionEncoder
from .controlnet import ControlNet, make_controlnet
from .lora import fold_lora_params
from .unet import UNET_LAYER_NAMES, UNet, localization_layer_names
from .vae import AutoencoderKL
