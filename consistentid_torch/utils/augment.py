"""Object-image augmentations (the JAX package's utils/augment.py; the
reference's evaluation/eval_function.py:76-187, the FastComposer-style
get_object_transforms set): pad-to-square, random horizontal flip, random
zoom-in and zoom-out with re-padding, on numpy (H, W, C) uint8 arrays.
Draws come from the caller's RandomState in the JAX package's order, and
the resizes are PIL's BILINEAR (`utils.image.resize_bilinear_uint8`), so
the outputs are the JAX package's bit for bit.
"""
from __future__ import annotations

import numpy as np

from .image import resize_bilinear_uint8


def pad_to_square(image: np.ndarray, fill: int = 0) -> np.ndarray:
    """(H, W, C) -> (S, S, C), centered."""
    h, w = image.shape[:2]
    s = max(h, w)
    out = np.full((s, s) + image.shape[2:], fill, image.dtype)
    top, left = (s - h) // 2, (s - w) // 2
    out[top:top + h, left:left + w] = image
    return out


def random_flip(image: np.ndarray, rng: np.random.RandomState,
                p: float = 0.5) -> np.ndarray:
    return image[:, ::-1] if rng.rand() < p else image


def random_zoom_in(image: np.ndarray, rng: np.random.RandomState,
                   min_scale: float = 1.0, max_scale: float = 1.25
                   ) -> np.ndarray:
    """Crop a random sub-window of 1/scale size (zoom-in), resized back to
    the input's size."""
    h, w = image.shape[:2]
    scale = rng.uniform(min_scale, max_scale)
    ch, cw = int(h / scale), int(w / scale)
    top = rng.randint(0, h - ch + 1)
    left = rng.randint(0, w - cw + 1)
    return resize_bilinear_uint8(image[top:top + ch, left:left + cw], h, w)


def random_zoom_out(image: np.ndarray, rng: np.random.RandomState,
                    min_scale: float = 0.75, max_scale: float = 1.0,
                    fill: int = 0) -> np.ndarray:
    """Shrink the content and re-pad to the original size at a random
    position (zoom-out)."""
    h, w = image.shape[:2]
    scale = rng.uniform(min_scale, max_scale)
    nh, nw = max(int(h * scale), 1), max(int(w * scale), 1)
    small = resize_bilinear_uint8(image, nh, nw)
    out = np.full_like(image, fill)
    top = rng.randint(0, h - nh + 1)
    left = rng.randint(0, w - nw + 1)
    out[top:top + nh, left:left + nw] = small
    return out


def object_transforms(image: np.ndarray, rng: np.random.RandomState,
                      size: int = 224, augment: bool = True) -> np.ndarray:
    """The composed pipeline: pad-to-square (+ random flip/zoom when
    augmenting) -> resize to `size`."""
    out = pad_to_square(image)
    if augment:
        out = random_flip(out, rng)
        if rng.rand() < 0.5:
            out = random_zoom_in(out, rng)
        else:
            out = random_zoom_out(out, rng)
    return resize_bilinear_uint8(out, size, size)
