"""Host-side image preprocessing on numpy arrays and CPU tensors.

The JAX package does this with PIL (its utils/image.py and the perception
models' makers). Here an image is an (H, W, 3) uint8 array and the resize is
torch's antialiased bicubic or bilinear, which use PIL's filters (cubic
coefficient a = -0.5) and support scaling; like PIL they resize one axis at
a time and round to uint8 after each, so the two agree to one grey level
but for rare values (two: one per pass; PIL's filters are fixed-point).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _as_rgb_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] != 3 or arr.dtype != np.uint8:
        raise ValueError("expected an (H, W, 3) uint8 image, got "
                         f"{arr.shape} {arr.dtype}")
    return arr


def resize_uint8(image: np.ndarray, height: int, width: int,
                 mode: str = "bicubic") -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8 with PIL's BICUBIC or
    BILINEAR semantics: a horizontal then a vertical pass, each rounded to
    uint8 (a pass at scale 1 is the identity, so each call resizes one
    axis)."""
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    x = x.float()
    for size in ((x.shape[2], width), (height, width)):
        x = F.interpolate(x, size=size, mode=mode, align_corners=False,
                          antialias=True).round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


def resize_bicubic_uint8(image: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """PIL BICUBIC resize of an (H, W, C) uint8 image (`resize_uint8`)."""
    return resize_uint8(image, height, width, "bicubic")


def resize_bilinear_uint8(image: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """PIL BILINEAR resize of an (H, W, C) uint8 image (`resize_uint8`);
    the identity at the image's own size, as PIL's resize is."""
    if image.shape[:2] == (height, width):
        return np.array(image)
    return resize_uint8(image, height, width, "bilinear")


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


def imagenet_preprocess(image, size: int = 512) -> np.ndarray:
    """BiSeNet input: bilinear resize to (size, size), rescale, ImageNet
    normalize. Returns (1, size, size, 3) fp32 NHWC."""
    arr = resize_bilinear_uint8(_as_rgb_uint8(image), size, size)
    arr = arr.astype(np.float32) / 255.0
    return ((arr - IMAGENET_MEAN) / IMAGENET_STD)[None]


def detector_letterbox(image, input_size: int = 640):
    """SCRFD input: bilinear resize to fit (input_size, input_size), keeping
    the aspect, padded with zeros at the bottom and right, then the
    insightface normalization (x - 127.5) / 128. Returns ((1, S, S, 3) fp32
    NHWC, the resize scale)."""
    image = _as_rgb_uint8(image)
    h, w = image.shape[:2]
    scale = input_size / max(w, h)
    nw, nh = int(round(w * scale)), int(round(h * scale))
    canvas = np.zeros((input_size, input_size, 3), np.float32)
    canvas[:nh, :nw] = resize_bilinear_uint8(image, nh, nw)
    return ((canvas - 127.5) / 128.0)[None], scale


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


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[-1,1] NHWC float tensor -> uint8 tensor on the same device (clip,
    *255, round half to even, as the JAX package's postprocess does)."""
    x = (images.float() / 2 + 0.5).clamp(0.0, 1.0)
    return torch.round(x * 255).to(torch.uint8)


def postprocess_to_uint8(images: torch.Tensor) -> np.ndarray:
    """[-1,1] NHWC float tensor -> uint8 numpy, converted on its device."""
    return to_uint8(images).cpu().numpy()
