"""ctypes binding of the port's C++ batch assembler (data/csrc/loader.cpp).

Counterpart of vitgan_tpu/data/native.py.  ``load_library`` builds the
port's own copy of the loader with the host's g++ on first use, into
``vitgan_tpu_torch/ops/_build/`` (listed in .gitignore) under a name that
hashes the source and the flags, so an edited source is built anew.  The
build writes a temporary file and renames it into place, so processes that
build at once never load a half-written library.  No nvcc and no card: this
is host code.

``-ffp-contract=off`` keeps every multiply and add apart, so the library's
values are the numpy versions' bit for bit (data/pipeline.normalize_to_unit,
data/transforms._resize_numpy).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops",
                         "_build")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", "-ffp-contract=off"]
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_U8P, _I64P, _F32P = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
                      ctypes.POINTER(ctypes.c_float))
_I64 = ctypes.c_int64


def library_path() -> str:
    """Where the library of this source and these flags is built."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libvitgan_torch_loader-{digest}.so")


def _build(path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp], check=True, capture_output=True,
                       timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_library() -> ctypes.CDLL:
    """The loader library, built on first use (raises where g++ fails)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.gather_normalize.restype = ctypes.c_int
            lib.gather_normalize.argtypes = [_U8P, _I64P, _I64, _I64, _I64, _I64,
                                             ctypes.c_void_p, _F32P, ctypes.c_int]
            lib.resize_bilinear_u8.restype = ctypes.c_int
            lib.resize_bilinear_u8.argtypes = [_U8P, _I64, _I64, _I64, _I64, _I64, _I64, _U8P,
                                               ctypes.c_int]
            _LIB = lib
    return _LIB


def _threads(num_threads: Optional[int]) -> int:
    return num_threads or max(1, os.cpu_count() or 1)


def native_resize_bilinear(images_u8: np.ndarray, out_h: int, out_w: int,
                           num_threads: Optional[int] = None) -> np.ndarray:
    """(N, H, W, C) uint8 -> (N, out_h, out_w, C) uint8, PIL-BILINEAR
    semantics, threaded over images."""
    lib = load_library()
    images_u8 = np.ascontiguousarray(images_u8, np.uint8)
    n, h, w, c = images_u8.shape
    out = np.empty((n, out_h, out_w, c), np.uint8)
    rc = lib.resize_bilinear_u8(images_u8.ctypes.data_as(_U8P), n, h, w, c, out_h, out_w,
                                out.ctypes.data_as(_U8P), _threads(num_threads))
    if rc != 0:
        raise RuntimeError(f"resize_bilinear_u8 failed with code {rc}")
    return out


class NativeBatcher:
    """Fused gather + normalize + flip over all host cores."""

    def __init__(self, num_threads: Optional[int] = None):
        self.lib = load_library()
        self.num_threads = _threads(num_threads)

    def gather_normalize(self, images_u8: np.ndarray, indices: np.ndarray,
                         flip: Optional[np.ndarray] = None,
                         out: Optional[np.ndarray] = None) -> np.ndarray:
        """images_u8[indices] as float32 in [-1, 1], sample i flipped along W
        where flip[i]; written into ``out`` (float32, C-contiguous, (B, H, W,
        C)) when given."""
        if images_u8.dtype != np.uint8 or images_u8.ndim != 4:
            raise ValueError(f"expect (N, H, W, C) uint8 images, got {images_u8.dtype} "
                             f"{images_u8.shape}")
        images_u8 = np.ascontiguousarray(images_u8)
        indices = np.ascontiguousarray(indices, np.int64)
        # The C side reads images + index * stride unchecked (it never sees
        # N): raise as numpy's fancy indexing does instead.
        if len(indices) and (indices.min() < 0 or indices.max() >= len(images_u8)):
            raise IndexError(f"gather indices out of range [0, {len(images_u8)}): "
                             f"min {indices.min()}, max {indices.max()}")
        b = len(indices)
        _, h, w, c = images_u8.shape
        if out is None:
            out = np.empty((b, h, w, c), np.float32)
        elif (out.dtype != np.float32 or out.shape != (b, h, w, c)
              or not out.flags.c_contiguous):
            raise ValueError(f"out must be C-contiguous float32 {(b, h, w, c)}, got "
                             f"{out.dtype} {out.shape}")
        flip_ptr = None
        if flip is not None:
            flip = np.ascontiguousarray(flip, np.uint8)
            flip_ptr = flip.ctypes.data_as(ctypes.c_void_p)
        rc = self.lib.gather_normalize(images_u8.ctypes.data_as(_U8P),
                                       indices.ctypes.data_as(_I64P), b, h, w, c, flip_ptr,
                                       out.ctypes.data_as(_F32P), self.num_threads)
        if rc != 0:
            raise RuntimeError(f"gather_normalize failed with code {rc}")
        return out
