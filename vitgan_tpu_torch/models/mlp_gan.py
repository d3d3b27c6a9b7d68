"""The toy MLP GAN of the reference's idc.py: a ReLU MLP generator with a tanh
output and the mirror MLP discriminator with one logit.

Counterpart of vitgan_tpu/models/mlp_gan.py:16-37.  Both networks hold the
JAX tree's ``layers[i].{w, b}`` (models/layers.MLP, torch nn.Linear's init).
"""

from __future__ import annotations

from typing import Optional

import torch

from vitgan_tpu_torch.config import MLPGANConfig
from vitgan_tpu_torch.models import layers as L


class Generator(L.MLP):
    """latent -> hidden... -> H*W*C."""

    def __init__(self, cfg: MLPGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__(cfg.latent_dim, cfg.image_size ** 2 * cfg.channels, cfg.hidden,
                         generator)
        self.cfg = cfg
        self.to(device)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: Optional[bool] = None) -> torch.Tensor:
        """z (B, latent) -> images (B, H, W, C) in z's dtype."""
        cfg = self.cfg
        x = torch.tanh(L.mlp(self, z, activation="relu"))
        return x.reshape(-1, cfg.image_size, cfg.image_size, cfg.channels)


class Discriminator(L.MLP):
    """H*W*C -> reversed hidden... -> 1."""

    def __init__(self, cfg: MLPGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__(cfg.image_size ** 2 * cfg.channels, 1, tuple(reversed(cfg.hidden)),
                         generator)
        self.cfg = cfg
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: bool = False) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B,)."""
        return L.mlp(self, images.reshape(images.shape[0], -1), activation="relu")[:, 0]
