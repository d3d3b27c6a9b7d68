"""Host image transforms: Resize (shorter side) -> CenterCrop.

Counterpart of vitgan_tpu/data/transforms.py, the reference's chain
``Resize(image_size) -> CenterCrop(image_size)`` (ref:src/v1/utils.py:124-131):
torchvision's ``Resize(int)`` scales the shorter side to ``size`` with PIL's
antialiased triangle (bilinear) filter, the long side truncated;
``CenterCrop`` takes the centred window, zero-padding an image smaller than
the crop.

The resize runs once, when a dataset is loaded.  It takes the C++ loader
(data/native.py) when it builds, as the JAX package's does, and otherwise
numpy.  The numpy version takes the loader's taps in the loader's order
(horizontal pass, then vertical, each output a running sum in float64 over
its taps), so the two are bit-equal; ``RESIZES`` counts the resizes each
path made.
"""

from __future__ import annotations

import logging
import subprocess
from typing import Tuple

import numpy as np

log = logging.getLogger(__name__)

# Resizes made by each path, added to where each runs.
RESIZES = {"native": 0, "numpy": 0}
_CHUNK = 256  # images a numpy pass holds in float64 at once


def _triangle_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's antialiased linear-filter taps, as the loader's make_taps: for
    each output pixel its first input pixel (lo, (out,)) and the weights of
    its taps ((out, L), zero past each pixel's own count).  The centre is
    (i + 0.5) * scale; the support widens by the scale when downscaling;
    weights over the in-bounds taps are normalised by their running sum."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale  # bilinear kernel support 1.0, scaled
    lo = np.zeros(out_size, np.int64)
    rows = []
    for i in range(out_size):
        center = (i + 0.5) * scale
        a = max(int(center - support + 0.5), 0)
        b = min(int(center + support + 0.5), in_size)
        ws = np.clip(1.0 - np.abs((np.arange(a, b, dtype=np.float64) + 0.5 - center)
                                  / filterscale), 0.0, None)
        total = np.cumsum(ws)[-1] if len(ws) else 0.0  # the loader's sequential sum
        if total > 0:
            lo[i], row = a, ws / total
        else:  # degenerate window: nearest
            lo[i], row = min(int(center), in_size - 1), np.ones(1)
        rows.append(row)
    weights = np.zeros((out_size, max(len(r) for r in rows)), np.float64)
    for i, row in enumerate(rows):
        weights[i, :len(row)] = row
    return lo, weights


def _filter(x: np.ndarray, axis: int, lo: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One pass along ``axis`` of float64 or uint8 ``x``: output pixel i is
    sum_j weights[i, j] * x[lo[i] + j], added in order of j from 0.0."""
    in_size = x.shape[axis]
    shape = [1] * x.ndim
    shape[axis] = len(lo)
    acc = None
    for j in range(weights.shape[1]):
        # past a pixel's own count its weight is 0: any in-bounds tap will do
        taps = np.take(x, np.minimum(lo + j, in_size - 1), axis=axis)
        term = weights[:, j].reshape(shape) * taps
        acc = term if acc is None else acc + term
    return acc


def _resize_numpy(images_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    n, h, w, c = images_u8.shape
    lo_h, wt_h = _triangle_taps(h, out_h)
    lo_w, wt_w = _triangle_taps(w, out_w)
    out = np.empty((n, out_h, out_w, c), np.uint8)
    for s in range(0, n, _CHUNK):
        tmp = _filter(images_u8[s:s + _CHUNK], 2, lo_w, wt_w)  # (n, h, out_w, c) float64
        acc = _filter(tmp, 1, lo_h, wt_h)
        out[s:s + _CHUNK] = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out


def resize_bilinear(images_u8: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, out_h, out_w, C) uint8, PIL-BILINEAR
    semantics: the C++ loader where it builds, else numpy (bit-equal)."""
    _, h, w, _ = images_u8.shape
    if (h, w) == (out_h, out_w):
        return images_u8
    from vitgan_tpu_torch.data import native

    try:
        out = native.native_resize_bilinear(images_u8, out_h, out_w)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        log.warning("the C++ resize is unavailable (%s: %s); resizing with numpy",
                    type(e).__name__, e)
    else:
        RESIZES["native"] += 1
        return out
    RESIZES["numpy"] += 1
    return _resize_numpy(images_u8, out_h, out_w)


def resize_shorter_side(images_u8: np.ndarray, size: int) -> np.ndarray:
    """torchvision Resize(int): the shorter side to ``size``, the aspect
    kept; the long side truncates like torchvision's
    _compute_resized_output_size (``int(size * long / short)``): 7x11 at 3
    gives 3x4."""
    _, h, w, _ = images_u8.shape
    if h <= w:
        out_h, out_w = size, max(1, int(size * w / h))
    else:
        out_h, out_w = max(1, int(size * h / w)), size
    return resize_bilinear(images_u8, out_h, out_w)


def center_crop(images_u8: np.ndarray, size: int) -> np.ndarray:
    """torchvision CenterCrop(int), zero-padding an image smaller than it."""
    _, h, w, _ = images_u8.shape
    if h < size or w < size:
        ph, pw = max(size - h, 0), max(size - w, 0)
        images_u8 = np.pad(images_u8, ((0, 0), (ph // 2, ph - ph // 2),
                                       (pw // 2, pw - pw // 2), (0, 0)))
        _, h, w, _ = images_u8.shape
    top = int(round((h - size) / 2.0))
    left = int(round((w - size) / 2.0))
    return np.ascontiguousarray(images_u8[:, top:top + size, left:left + size, :])


def reference_transforms(images_u8: np.ndarray, image_size: int) -> np.ndarray:
    """Resize (shorter side) -> CenterCrop, the reference's chain before
    Normalize; the images themselves at their own size."""
    _, h, w, _ = images_u8.shape
    if h == w == image_size:
        return images_u8
    return center_crop(resize_shorter_side(images_u8, image_size), image_size)
