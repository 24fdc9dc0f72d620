"""Face-parsing region masks (host-side numpy/scipy).

The JAX package builds these with cv2 contours and PIL compositing
(its conditioning/masks.py, after reference functions.py:326-387). Neither
library is needed here: filled external contours are the binary map with its
holes filled, and masks are (H, W) uint8 arrays in {0, 255}.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy import ndimage

# BiSeNet 19-class face-parsing label -> body part + overlay color
# (reference functions.py:333-359)
MASK_VALUE_TABLE = {
    0: ("Background", (0, 0, 0)),
    1: ("Face", (255, 0, 0)),
    2: ("Left_Eyebrow", (255, 85, 0)),
    3: ("Right_Eyebrow", (255, 170, 0)),
    4: ("Left_Eye", (255, 0, 85)),
    5: ("Right_Eye", (255, 0, 170)),
    6: ("Hair", (0, 0, 255)),
    7: ("Left_Ear", (85, 0, 255)),
    8: ("Right_Ear", (170, 0, 255)),
    9: ("Mouth_External Contour", (0, 255, 85)),
    10: ("Nose", (0, 255, 0)),
    11: ("Mouth_Inner_Contour", (0, 255, 170)),
    12: ("Upper_Lip", (85, 255, 0)),
    13: ("Lower_Lip", (170, 255, 0)),
    14: ("Neck", (0, 85, 255)),
    15: ("Neck_Inner Contour", (0, 170, 255)),
    16: ("Cloth", (255, 255, 0)),
    17: ("Hat", (255, 0, 255)),
    18: ("Earring", (255, 85, 255)),
    19: ("Necklace", (255, 255, 85)),
    20: ("Glasses", (255, 170, 255)),
    21: ("Hand", (255, 0, 255)),
    22: ("Wristband", (0, 255, 255)),
    23: ("Clothes_Upper", (85, 255, 255)),
    24: ("Clothes_Lower", (170, 255, 255)),
}


def filled_contour_mask(binary: np.ndarray) -> np.ndarray:
    """255-filled external contours of a boolean map.

    Filling every external contour (8-connected foreground) covers exactly
    the foreground plus the background pockets it encloses, which is what
    binary_fill_holes returns (its 4-connected background is the dual of the
    8-connected foreground), so one call covers every component at once."""
    return ndimage.binary_fill_holes(binary).astype(np.uint8) * 255


def masks_for_unique_values(parsing_map: np.ndarray) -> Dict[str, np.ndarray]:
    """(H, W) integer parsing map -> {body_part: (H, W) uint8 mask in {0,255}}.

    Value 0 becomes the inverted 'WithoutBackground' mask as well as the
    plain 'Background' one; unknown label values are skipped (reference
    functions.py:361-387).
    """
    arr = np.asarray(parsing_map)
    out: Dict[str, np.ndarray] = {}
    for value in np.unique(arr):
        filled = filled_contour_mask(arr == value)
        if value == 0:
            out["WithoutBackground"] = 255 - filled
        entry = MASK_VALUE_TABLE.get(int(value))
        if entry is None:
            continue
        out[entry[0]] = filled
    return out


def fetch_mask_raw_image(raw_image: np.ndarray,
                         mask: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 image x mask composite on black (reference
    functions.py:326-331, PIL's Image.composite): the mask is first resized
    to the image (bicubic, as PIL's default) when the parsing map has
    another size, then each pixel is image * mask / 255, rounded as PIL
    does."""
    from ..utils.image import resize_bicubic_uint8

    if mask.shape != raw_image.shape[:2]:
        mask = resize_bicubic_uint8(np.asarray(mask, np.uint8),
                                    *raw_image.shape[:2])
    t = raw_image.astype(np.uint32) * np.asarray(mask, np.uint32)[..., None]
    t += 128
    return ((t + (t >> 8)) >> 8).astype(np.uint8)
