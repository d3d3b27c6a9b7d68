"""Image grids and PNG encoding with the standard library only.

Counterpart of vitgan_tpu/utils/images.py's ``make_grid`` and
``to_png_bytes``.  The PNG encoder is zlib + struct (8-bit RGB, no filter),
so serving needs no imaging package.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import Optional

import numpy as np


def denormalize(batch: np.ndarray) -> np.ndarray:
    """[-1, 1] -> uint8."""
    return np.clip(np.rint((np.asarray(batch, np.float32) + 1.0) * 127.5), 0, 255).astype(np.uint8)


def make_grid(images: np.ndarray, nrow: Optional[int] = None, pad: int = 2,
              pad_value: int = 0) -> np.ndarray:
    """(N, H, W, C) float [-1, 1] or uint8 -> one (GH, GW, C) uint8 grid."""
    imgs = np.asarray(images)
    if imgs.dtype != np.uint8:
        imgs = denormalize(imgs)
    n, h, w, c = imgs.shape
    nrow = nrow or int(math.ceil(math.sqrt(n)))
    ncol = int(math.ceil(n / nrow))
    grid = np.full((ncol * (h + pad) + pad, nrow * (w + pad) + pad, c), pad_value, np.uint8)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = pad + r * (h + pad), pad + col * (w + pad)
        grid[y:y + h, x:x + w] = imgs[i]
    return grid


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def to_png_bytes(image_hwc: np.ndarray) -> bytes:
    """Encode one (H, W, C) uint8 image (C = 1 is repeated to RGB) as PNG."""
    arr = np.asarray(image_hwc, np.uint8)
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    h, w, c = arr.shape
    if c not in (3, 4):
        raise ValueError(f"PNG encoder takes 1, 3 or 4 channels, got {c}")
    # Each scanline is prefixed with filter type 0 (none).
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def save_png(path: str, image_hwc: np.ndarray) -> None:
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(to_png_bytes(image_hwc))
