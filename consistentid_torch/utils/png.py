"""PNG encoding and decoding with zlib, struct and numpy: the port's image
codec for the CLI and the server (the JAX package's apps use PIL).

`encode_png` writes 8-bit grey, RGB or RGBA with no filter. `decode_png`
reads 8-bit grey, grey + alpha, RGB and RGBA, non-interlaced, with all five
row filters; anything else (palette, 16-bit, interlaced, or another format
such as JPEG, for which the port has no decoder) raises a ValueError that
names it. `png_size` reads the size from the IHDR header without inflating
the data, so a server can refuse an oversized image first.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit): grey, RGB, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_NAMES = {3: "palette"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
    """uint8 (H, W), (H, W, 1), (H, W, 3) or (H, W, 4) -> PNG bytes."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4):
        raise ValueError(f"encode_png takes (H, W[, 1|3|4]), not "
                         f"{tuple(image.shape)}")
    h, w, c = img.shape
    colour = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * c)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def _not_png(data: bytes) -> ValueError:
    if data[:3] == b"\xff\xd8\xff":
        return ValueError("JPEG image: only PNG (and .npy) can be decoded "
                          "here; no JPEG decoder is available")
    return ValueError("not a PNG image (bad signature)")


def _header(data: bytes) -> Tuple[int, int, int, int, int]:
    if data[:8] != SIGNATURE:
        raise _not_png(data)
    if len(data) < 33 or data[12:16] != b"IHDR":
        raise ValueError("PNG without an IHDR header")
    w, h, depth, colour, _, _, interlace = struct.unpack(">IIBBBBB",
                                                         data[16:29])
    return w, h, depth, colour, interlace


def png_size(data: bytes) -> Tuple[int, int]:
    """(width, height) from the IHDR header, nothing inflated."""
    w, h, _, _, _ = _header(data)
    return w, h


def _unfilter(raw: bytes, h: int, w: int, c: int) -> np.ndarray:
    stride = w * c
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected "
                         f"{h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:      # None
            cur = line.copy()
        elif ftype == 1:    # Sub: a running sum per channel
            cur = (np.cumsum(line.reshape(w, c).astype(np.int64), axis=0)
                   % 256).astype(np.uint8).reshape(stride)
        elif ftype == 2:    # Up
            cur = line + prior
        elif ftype in (3, 4):
            cur = _unfilter_sequential(ftype, line, prior, c)
        else:
            raise ValueError(f"PNG row filter {ftype} is not one of 0-4")
        out[y] = cur
        prior = cur
    return out.reshape(h, w, c)


def _unfilter_sequential(ftype: int, line: np.ndarray, prior: np.ndarray,
                         c: int) -> np.ndarray:
    """Average (3) and Paeth (4), which depend on the byte to the left."""
    filt = line.tolist()
    up = prior.tolist()
    cur = bytearray(len(filt))
    for i, f in enumerate(filt):
        a = cur[i - c] if i >= c else 0
        b = up[i]
        if ftype == 3:
            cur[i] = (f + ((a + b) >> 1)) & 0xFF
        else:
            cc = up[i - c] if i >= c else 0
            p = a + b - cc
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - cc)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            cur[i] = (f + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 (H, W, C), C the file's channels (1 grey, 2 grey +
    alpha, 3 RGB, 4 RGBA)."""
    w, h, depth, colour, interlace = _header(data)
    if colour not in _CHANNELS:
        raise ValueError(f"PNG colour type {colour} "
                         f"({_COLOUR_NAMES.get(colour, 'unknown')}) is not "
                         "supported: grey, grey + alpha, RGB or RGBA only")
    if depth != 8:
        raise ValueError(f"PNG bit depth {depth} is not supported: 8 only")
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    pos, idat = 8, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        if kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        elif kind == b"IEND":
            break
        pos += 12 + n
    c = _CHANNELS[colour]
    expected = h * (w * c + 1)
    try:  # inflate no more than the header's size allows, and one byte
        raw = zlib.decompressobj().decompress(b"".join(idat), expected + 1)
    except zlib.error as e:
        raise ValueError(f"PNG data does not inflate: {e}") from None
    return _unfilter(raw, h, w, c)


def as_rgb(image: np.ndarray) -> np.ndarray:
    """uint8 (H, W[, C]) -> (H, W, 3): grey repeated, alpha dropped (as
    PIL's convert("RGB"))."""
    img = np.asarray(image, np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_array(path: str) -> np.ndarray:
    """An image file as uint8 (H, W[, C]) with the file's own channels (an
    inpaint mask's grey, say): a PNG, or a .npy array."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.uint8)
    with open(path, "rb") as f:
        return decode_png(f.read())


def read_image(path: str) -> np.ndarray:
    """An image file as uint8 (H, W, 3): a PNG, or a .npy array."""
    return as_rgb(read_array(path))
