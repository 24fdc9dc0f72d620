"""Host-side image preprocessing on numpy arrays and CPU tensors.

The JAX package does this with PIL (its utils/image.py). Here an image is an
(H, W, 3) uint8 array and the resize is torch's antialiased bicubic, which
uses PIL's cubic coefficient (a = -0.5) and support scaling; like PIL it
resizes one axis at a time and rounds to uint8 after each, so the two agree
to about one grey level.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _as_rgb_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError("expected an (H, W, 3) uint8 image, got "
                         f"{arr.shape} {arr.dtype}")
    return arr


def resize_bicubic_uint8(image: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, PIL BICUBIC semantics:
    a horizontal then a vertical pass, each rounded to uint8 (a bicubic
    pass at scale 1 is the identity, so each call resizes one axis)."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    x = x.float()
    for size in ((x.shape[2], width), (height, width)):
        x = F.interpolate(x, size=size, mode="bicubic", align_corners=False,
                          antialias=True).round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def clip_preprocess(image, size: int = 224) -> np.ndarray:
    """CLIPImageProcessor defaults: shortest-side resize (bicubic), center
    crop, rescale, normalize. Returns (1, size, size, 3) fp32 NHWC."""
    image = _as_rgb_uint8(image)
    h, w = image.shape[:2]
    short = min(w, h)
    new_w, new_h = round(w * size / short), round(h * size / short)
    if (new_h, new_w) != (h, w):
        image = resize_bicubic_uint8(image, new_h, new_w)
    left, top = (new_w - size) // 2, (new_h - size) // 2
    image = image[top:top + size, left:left + size]
    arr = image.astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr[None]


def center_crop_mask(mask: np.ndarray, size: int = 512) -> np.ndarray:
    """CenterCrop + ToTensor for a binary (H, W) uint8 region mask
    (reference :354, transform_mask): zero-padded where the crop box leaves
    the mask. Returns (size, size) fp32 in [0, 1]."""
    h, w = mask.shape
    left, top = (w - size) // 2, (h - size) // 2
    out = np.zeros((size, size), np.float32)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + size, h), min(left + size, w)
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = mask[y0:y1, x0:x1]
    return out / 255.0


def postprocess_to_uint8(images: torch.Tensor) -> np.ndarray:
    """[-1,1] NHWC float tensor -> uint8 numpy (clip, *255, round half to
    even, as the JAX package's postprocess does)."""
    x = (images.float() / 2 + 0.5).clamp(0.0, 1.0)
    return torch.round(x * 255).to(torch.uint8).cpu().numpy()
