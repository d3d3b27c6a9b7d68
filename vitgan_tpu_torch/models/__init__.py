"""Model registry of the port: the v2 family's generator for now.

Counterpart of vitgan_tpu/models/__init__.py.  ``build_gan`` binds a family
to its config; ``generator_init`` draws a generator's weights from an explicit
``torch.Generator``; ``sample_latent`` draws its input noise on the host
(train/sample.py says why from numpy's Philox).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig, V2Config

# Families of the JAX package still to port, with their ROADMAP.md queue 1 item.
_NOT_PORTED = {"v1": "10 (the v1 family)", "dcgan": "11 (the baselines)",
               "cnn": "11 (the baselines)", "mlp": "11 (the baselines)"}


@dataclass(frozen=True)
class GANBundle:
    """A model family bound to its config."""

    family: str
    cfg: V2Config
    latent_dim: int
    image_shape: Tuple[int, int, int]  # (H, W, C)

    def generator_init(self, generator: Optional[torch.Generator], device="cuda"):
        from vitgan_tpu_torch.models.vitgan_v2 import Generator

        return Generator(self.cfg, generator, device=device)

    def sample_latent(self, rng: np.random.Generator, batch: int) -> torch.Tensor:
        """Fresh generator input noise: N(0, 1) float32 on the CPU."""
        return torch.from_numpy(rng.standard_normal((batch, self.latent_dim), np.float32))


def build_gan(cfg: ExperimentConfig) -> GANBundle:
    if cfg.family != "v2":
        item = _NOT_PORTED.get(cfg.family)
        where = f"ROADMAP.md queue 1 item {item}" if item else "no such family in the JAX package"
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet ({where})")
    m = cfg.v2
    return GANBundle(family="v2", cfg=m, latent_dim=m.latent_dim,
                     image_shape=(m.image_size, m.image_size, m.channels))


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
