"""LLaVA-1.5 captioner model: CLIP vision tower -> MLP projector -> Llama,
counterpart of the JAX package's models/llava.py.

The vision tower is the port's `CLIPVisionEncoder`: its penultimate hidden
states (HF `vision_feature_layer=-2`) with CLS dropped
(`vision_feature_select_strategy="default"`) go through the 2-layer GELU
projector, and the spliced [pre-text, image, post-text] embeddings are
decoded greedily by `LlamaForCausalLM`. The FGID protocol has exactly one
image at a known place in the template, so the features are concatenated
between the pre and post embeddings instead of scattered into placeholder
ids (HF's masked scatter gives the same sequence).

`Llava` holds both halves as `mm` and `llama`, the two keys of the JAX
package's parameter bundle, so `io.from_jax.params_from_jax` loads that
bundle into it directly. The CLIP constants are utils/image.py's.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import LlavaConfig
from ..utils.image import CLIP_MEAN, CLIP_STD, _resize_pil
from ..utils.png import as_rgb
from .clip import CLIPVisionEncoder
from .llama import LlamaForCausalLM, greedy_generate

class LlavaProjector(nn.Module):
    """HF `multi_modal_projector`: linear_1 -> exact-erf GELU -> linear_2."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, out_features)
        self.linear_2 = nn.Linear(out_features, out_features)

    def forward(self, x):
        return self.linear_2(F.gelu(self.linear_1(x)))


class LlavaModel(nn.Module):
    """Image features for the splice: pixel_values (B, S, S, 3) normalized
    -> (B, patches, text hidden size)."""

    def __init__(self, config: LlavaConfig):
        super().__init__()
        self.config = config
        self.vision_tower = CLIPVisionEncoder(config.vision)
        self.multi_modal_projector = LlavaProjector(
            config.vision.hidden_size, config.text.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        _, penultimate = self.vision_tower(pixel_values)
        return self.multi_modal_projector(penultimate[:, 1:])  # drop CLS


class Llava(nn.Module):
    """The captioner's two halves: `mm` (vision tower + projector) and
    `llama` (the decoder), float unless given; either may be given, to
    share it with another `Llava` (an int8 decoder beside the float one's
    tower, say)."""

    def __init__(self, config: LlavaConfig, mm: Optional[LlavaModel] = None,
                 llama: Optional[LlamaForCausalLM] = None):
        super().__init__()
        self.config = config
        self.mm = mm if mm is not None else LlavaModel(config)
        self.llama = llama if llama is not None else LlamaForCausalLM(
            config.text)


def preprocess_image(image, image_size: int) -> np.ndarray:
    """Reference preprocessing (LLaVA-1.5 `image_aspect_ratio="pad"`): pad
    to square with the CLIP mean colour, PIL's bicubic resize to the tower
    size, normalize. A uint8 (H, W[, C]) image in, (1, S, S, 3) float32
    out, the JAX function's PIL arithmetic bit for bit."""
    image = as_rgb(image)
    h, w = image.shape[:2]
    if w != h:
        side = max(w, h)
        bg = np.array([int(round(255 * m)) for m in CLIP_MEAN],
                      np.uint8)
        sq = np.empty((side, side, 3), np.uint8)
        sq[:] = bg
        top, left = (side - h) // 2, (side - w) // 2
        sq[top:top + h, left:left + w] = image
        image = sq
    image = _resize_pil(image, image_size, image_size, "bicubic")
    arr = np.asarray(image, np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr[None]


def make_caption_fn(model: Llava, max_new_tokens: int, eos_token_id: int,
                    pad_token_id: int = 0,
                    kv_quant: Optional[bool] = None) -> Callable:
    """(pixel_values (B, S, S, 3), pre_ids, post_ids) -> (B, max_new_tokens)
    ids: the image features spliced between the pre and post token
    embeddings (shared by the batch), then `greedy_generate`. The tower and
    projector run in the decoder's dtype; `kv_quant` (default the model's
    flag) selects the int8 cache."""
    llama = model.llama

    @torch.no_grad()
    def fn(pixel_values, pre_ids, post_ids) -> torch.Tensor:
        device = llama.embed_tokens.weight.device
        pixels = torch.as_tensor(pixel_values).to(device)
        feats = model.mm(pixels).to(llama.dtype)
        b = feats.shape[0]

        def embed(ids):
            ids = torch.as_tensor(np.asarray(ids), dtype=torch.long,
                                  device=device)
            return llama.embed_tokens(ids)[None].expand(b, -1, -1)

        prompt_embeds = torch.cat([embed(pre_ids), feats, embed(post_ids)],
                                  dim=1)
        return greedy_generate(llama, None, max_new_tokens=max_new_tokens,
                               eos_token_id=eos_token_id,
                               pad_token_id=pad_token_id,
                               prompt_embeds=prompt_embeds,
                               kv_quant=kv_quant)

    return fn


@torch.no_grad()
def random_llava(config: LlavaConfig, seed: int = 0,
                 dtype: torch.dtype = torch.float32, device="cpu") -> Llava:
    """A float `Llava` with random weights from a seeded generator on
    `device`: linear, convolution and embedding weights N(0, 1/fan_in),
    norm weights 1, biases 0, the tower's class and position embeddings
    N(0, 0.02^2). Built on the meta device and filled in place, so a 7B
    model never passes through host memory when `device` is a card."""
    with torch.device("meta"):
        model = Llava(config)
    model = model.to_empty(device=device).to(dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "bias":
            p.zero_()
        elif leaf == "weight" and p.dim() == 1:
            p.fill_(1.0)
        elif leaf == "weight":
            p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model
