"""Image preprocessing on numpy arrays and tensors, on the host but for a
resize of a tensor on the card.

The JAX package does this with PIL (its utils/image.py and the perception
models' makers). Here an image is an (H, W, 3) uint8 array. The BICUBIC
and LANCZOS resizes are PIL's fixed-point resample in torch integer ops,
bit for bit on the CPU and on the card; NEAREST is PIL's in numpy. The
BILINEAR one is torch's antialiased bilinear, which uses PIL's filter and
supports scaling; like PIL it resizes one axis at a time and rounds to
uint8 after each, so the two agree to one grey level but for rare values
(two: one per pass; PIL's filters are fixed-point).
"""
from __future__ import annotations

import math
from typing import Tuple

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


def resize_bilinear_uint8(image: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """PIL BILINEAR resize of an (H, W, C) uint8 image: a horizontal then
    a vertical pass of torch's antialiased bilinear, each rounded to uint8
    (a pass at scale 1 is the identity, so each call resizes one axis); the
    identity at the image's own size, as PIL's resize is."""
    if image.shape[:2] == (height, width):
        return np.array(image)
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    x = x.float()
    for size in ((x.shape[2], width), (height, width)):
        x = F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                          antialias=True).round().clamp(0, 255)
    return x[0].permute(1, 2, 0).to(torch.uint8).numpy()


# PIL's 8-bit resampling: coefficients in fixed point with 22 fraction bits
_PRECISION_BITS = 22


def _lanczos(x: np.ndarray) -> np.ndarray:
    """PIL's LANCZOS filter: sinc(x) sinc(x / 3) on [-3, 3)."""
    return np.where((x >= -3.0) & (x < 3.0), np.sinc(x) * np.sinc(x / 3.0),
                    0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's BICUBIC filter (a = -0.5) on [-2, 2]."""
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


# PIL's 8-bit filters with their support
_PIL_FILTERS = {"lanczos": (_lanczos, 3.0), "bicubic": (_bicubic, 2.0)}


def _pil_coeffs(in_size: int, out_size: int,
                kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's precompute_coeffs and normalize_coeffs_8bpc for one axis with
    its LANCZOS or BICUBIC filter: per output pixel the filter widened by
    the scale when downsampling, its weights summed in order and normalised
    to sum 1, then rounded to fixed point. Returns the (out_size, ksize)
    source indices (clamped where the window is shorter; their weights are
    0) and int32 weights."""
    filt, filter_support = _PIL_FILTERS[kind]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filter_support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    n = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = np.where(x < n[:, None], filt((x + xmin[:, None] - center[:, None]
                                       + 0.5) * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for k in range(ksize):
        total = total + w[:, k]
    w = np.divide(w, total[:, None], out=w, where=total[:, None] != 0.0)
    w = w * (1 << _PRECISION_BITS)
    fixed = np.where(w < 0, np.trunc(w - 0.5), np.trunc(w + 0.5))
    return np.minimum(x + xmin[:, None], in_size - 1), fixed.astype(np.int32)


def _pil_pass(x: torch.Tensor, out_size: int, dim: int,
              kind: str) -> torch.Tensor:
    """One PIL resampling pass of a uint8 tensor along `dim`, on its
    device (`_pil_coeffs`): int32 sums, as PIL's, from half a unit,
    shifted down and clipped to uint8; integer arithmetic, so every device
    gives PIL's bits."""
    idx, fixed = (torch.from_numpy(a).to(x.device)
                  for a in _pil_coeffs(x.shape[dim], out_size, kind))
    moved = x.movedim(dim, 0)
    src = moved.reshape(len(moved), -1).to(torch.int32)
    acc = torch.full((out_size, src.shape[1]), 1 << (_PRECISION_BITS - 1),
                     dtype=torch.int32, device=x.device)
    term = torch.empty_like(acc)
    for k in range(idx.shape[1]):
        torch.index_select(src, 0, idx[:, k], out=term)
        acc += term.mul_(fixed[:, k, None])
    out = (acc >> _PRECISION_BITS).clamp_(0, 255).to(torch.uint8)
    return out.reshape((out_size,) + moved.shape[1:]).movedim(0, dim)


def _resize_pil(image, height: int, width: int, kind: str):
    """A horizontal `_pil_pass` then a vertical one, each only where that
    axis changes size and each rounded to uint8, as PIL's resample does.
    A numpy image is resized on the CPU and returned as numpy; a tensor on
    its device."""
    host = not isinstance(image, torch.Tensor)
    out = (torch.from_numpy(np.ascontiguousarray(image, np.uint8)) if host
           else image)
    if out.shape[1] != width:
        out = _pil_pass(out, width, dim=1, kind=kind)
    if out.shape[0] != height:
        out = _pil_pass(out, height, dim=0, kind=kind)
    return out.numpy().copy() if host else out.clone()


def resize_lanczos_uint8(image: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """PIL LANCZOS resize of an (H, W[, C]) uint8 image, bit for bit."""
    return _resize_pil(image, height, width, "lanczos")


def resize_bicubic_uint8(image, height: int, width: int):
    """PIL BICUBIC resize of an (H, W[, C]) uint8 image, bit for bit: a
    numpy array on the CPU, or a tensor on its device."""
    return _resize_pil(image, height, width, "bicubic")


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """PIL's NEAREST source index per output pixel (ImagingScaleAffine): a
    position starting at half a step, advanced by repeated addition of the
    step in double precision, truncated."""
    step = in_size / out_size
    pos = np.full(out_size, step, np.float64)
    pos[0] = step * 0.5
    return np.add.accumulate(pos).astype(np.int64)


def resize_nearest_uint8(image: np.ndarray, height: int,
                         width: int) -> np.ndarray:
    """PIL NEAREST resize of an (H, W[, C]) uint8 image, bit for bit."""
    out = np.asarray(image, np.uint8)
    h, w = out.shape[:2]
    return np.array(out[_nearest_index(h, height)][:, _nearest_index(w,
                                                                     width)])


def to_grey_uint8(image) -> np.ndarray:
    """PIL's convert("L") of an (H, W) grey, (H, W, 1), (H, W, 2) grey and
    alpha, (H, W, 3) RGB or (H, W, 4) RGBA uint8 image: grey kept, alpha
    dropped, RGB to ITU-R 601 luma in PIL's fixed point ((19595 R + 38470 G
    + 7471 B + 2^15) >> 16)."""
    arr = np.asarray(image, np.uint8)
    if arr.ndim == 2:
        return np.array(arr)
    if arr.ndim != 3 or arr.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"expected an (H, W[, 1-4]) uint8 image, got "
                         f"{arr.shape}")
    if arr.shape[2] <= 2:
        return np.array(arr[:, :, 0])
    rgb = arr[:, :, :3].astype(np.uint32)
    luma = (rgb[:, :, 0] * 19595 + rgb[:, :, 1] * 38470
            + rgb[:, :, 2] * 7471 + 0x8000) >> 16
    return luma.astype(np.uint8)


def sd_image_preprocess(image, height: int, width: int) -> np.ndarray:
    """Diffusion image input: (H, W, 3) uint8 resized with PIL's LANCZOS
    (`resize_lanczos_uint8`) and scaled to [-1, 1], (1, height, width, 3)
    fp32."""
    arr = resize_lanczos_uint8(_as_rgb_uint8(image), height, width)
    arr = arr.astype(np.float32) / 255.0
    return (arr * 2.0 - 1.0)[None]


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
