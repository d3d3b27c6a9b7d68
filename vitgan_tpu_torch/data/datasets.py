"""Datasets of the port: the synthetic source.

Counterpart of vitgan_tpu/data/datasets.py:88-115.  ``synthetic_dataset`` is
the same numpy stream as the JAX package's, so its bytes are identical; the
CIFAR-10 and MNIST decoders are ROADMAP.md queue 1 item 3.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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


def load_dataset(name: str, image_size: int = 32, channels: int = 3,
                 synthetic_samples: int = 2048, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(images uint8 (N, H, W, C), labels) of the named dataset."""
    if name.lower() == "synthetic":
        return synthetic_dataset(synthetic_samples, image_size, channels, seed=seed)
    raise NotImplementedError(f"dataset {name!r} is not ported: the port loads 'synthetic'; "
                              "CIFAR-10 and MNIST are ROADMAP.md queue 1 item 3")
