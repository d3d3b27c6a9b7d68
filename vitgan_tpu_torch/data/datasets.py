"""Datasets of the port: the CIFAR-10 and MNIST decoders and the synthetic
source.

Counterpart of vitgan_tpu/data/datasets.py.  The decoders read the raw
on-disk formats from local files (nothing is downloaded): CIFAR-10's
``cifar-10-batches-py`` pickles, extracted or in ``cifar-10-python.tar.gz``,
and MNIST's IDX files, plain or gzipped.  ``synthetic_dataset`` is the same
numpy stream as the JAX package's, so its bytes are identical.  Every source
returns ``(images, labels)``: uint8 (N, H, W, C) and int32 (N,).
``load_dataset`` resizes a decoded set to the model's size with the
reference's Resize -> CenterCrop (data/transforms.py).
"""

from __future__ import annotations

import gzip
import os
import pickle
import struct
import tarfile
from typing import Optional, Tuple

import numpy as np

from vitgan_tpu_torch.utils.run_dirs import data_dir as default_data_dir

CIFAR_DIR = "cifar-10-batches-py"
CIFAR_ARCHIVE = "cifar-10-python.tar.gz"


def load_cifar10(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode the ``cifar-10-batches-py`` pickles under ``root`` (the
    directory itself, ``root/cifar-10-batches-py``, or the archive in
    ``root``, extracted there on first use)."""
    batch_dir = _find_cifar_dir(root)
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    images, labels = [], []
    for name in names:
        with open(os.path.join(batch_dir, name), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        images.append(np.asarray(d[b"data"], np.uint8))
        labels.append(np.asarray(d[b"labels"], np.int64))
    x = np.concatenate(images).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.concatenate(labels).astype(np.int32)


def _find_cifar_dir(root: str) -> str:
    for cand in (root, os.path.join(root, CIFAR_DIR)):
        if os.path.isfile(os.path.join(cand, "data_batch_1")):
            return cand
    archive = os.path.join(root, CIFAR_ARCHIVE)
    if os.path.isfile(archive):
        with tarfile.open(archive) as tf:
            tf.extractall(root, filter="data")
        return os.path.join(root, CIFAR_DIR)
    raise FileNotFoundError(
        f"CIFAR-10 not found under {root}: none of {os.path.join(root, 'data_batch_1')}, "
        f"{os.path.join(root, CIFAR_DIR, 'data_batch_1')} or {archive} exists.  Place the "
        f"extracted {CIFAR_DIR}/ or {CIFAR_ARCHIVE} there, or point data.data_dir at them "
        "(nothing is downloaded).")


def load_mnist(root: str, train: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Decode MNIST's IDX files under ``root`` (plain or .gz): the 28x28
    digits zero-padded to 32x32 and replicated to 3 channels."""
    prefix = "train" if train else "t10k"

    def _open(path):
        return gzip.open(path, "rb") if path.endswith(".gz") else open(path, "rb")

    def _find(kind: str, rank: int) -> str:
        base = os.path.join(root, f"{prefix}-{kind}-idx{rank}-ubyte")
        for path in (base, base + ".gz"):
            if os.path.isfile(path):
                return path
        raise FileNotFoundError(f"MNIST {prefix} {kind} not found: neither {base} nor "
                                f"{base}.gz exists (nothing is downloaded)")

    with _open(_find("images", 3)) as f:
        _, n, h, w = struct.unpack(">IIII", f.read(16))
        x = np.frombuffer(f.read(), np.uint8).reshape(n, h, w)
    with _open(_find("labels", 1)) as f:
        f.read(8)
        y = np.frombuffer(f.read(), np.uint8).astype(np.int32)
    # 28 -> 32 and three channels, so that the models see one shape.
    x = np.repeat(np.pad(x, ((0, 0), (2, 2), (2, 2)))[..., None], 3, axis=-1)
    return np.ascontiguousarray(x), y


def synthetic_dataset(num_samples: int = 2048, image_size: int = 32, channels: int = 3,
                      num_classes: int = 10, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic structured uint8 images (N, H, W, C) and int32 labels:
    per-class mixtures of 2-D Gabor-like waves, each class with its own
    orientation and frequency."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:image_size, 0:image_size].astype(np.float32) / image_size
    labels = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
    imgs = np.empty((num_samples, image_size, image_size, channels), np.float32)
    class_theta = np.linspace(0.0, np.pi, num_classes, endpoint=False)
    for i in range(num_samples):
        theta = class_theta[labels[i]] + rng.normal(0, 0.08)
        freq = 3.0 + labels[i] * 0.7 + rng.normal(0, 0.2)
        phase = rng.uniform(0, 2 * np.pi)
        cx, cy = rng.uniform(0.25, 0.75, 2)
        wave = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
        envelope = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.08))
        base = 0.5 + 0.5 * wave * envelope
        tint = rng.uniform(0.4, 1.0, channels)
        imgs[i] = base[..., None] * tint
    return (imgs * 255).clip(0, 255).astype(np.uint8), labels


def load_dataset(name: str, root: Optional[str] = None, train: bool = True,
                 image_size: int = 32, channels: int = 3, synthetic_samples: int = 2048,
                 seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, H, W, C), labels) of ``cifar10``, ``mnist`` or
    ``synthetic``; a decoded set from ``root`` (default
    utils/run_dirs.data_dir(name)), resized to ``image_size`` by the
    reference's Resize -> CenterCrop where its own size differs."""
    name = name.lower()
    if name == "synthetic":
        return synthetic_dataset(synthetic_samples, image_size, channels, seed=seed)
    root = root or default_data_dir(name)
    if name == "cifar10":
        x, y = load_cifar10(root, train)
    elif name == "mnist":
        x, y = load_mnist(root, train)
    else:
        raise ValueError(f"unknown dataset {name!r}: cifar10, mnist or synthetic")
    if x.shape[1] != image_size or x.shape[2] != image_size:
        from vitgan_tpu_torch.data.transforms import reference_transforms

        x = reference_transforms(x, image_size)
    return x, y
