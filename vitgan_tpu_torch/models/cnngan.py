"""The v2 CNNGAN: a conv generator over image-shaped noise and a 5-conv
discriminator.

Counterpart of vitgan_tpu/models/cnngan.py:25-93, on models/dcgan.py's conv
layers.  G's latent is image-shaped noise carried flat as (B, H*W*C) and
reshaped on entry, so that ``sample_latent`` stays the same for every
family; G downsamples three times with BatchNorm and ReLU and upsamples back
with transposed convs and tanh.  D ends in one logit (the reference applies
a sigmoid; the losses take the logit).  Widths are the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitgan_tpu_torch.config import CNNGANConfig
from vitgan_tpu_torch.models.dcgan import BatchNorm, Conv, _leaky, batch_norm, conv, conv_transpose


class Generator(nn.Module):
    """conv1..3 (C -> 64 -> 128 -> 256), deconv1..3 (256 -> 128 -> 64 -> C),
    bn1..5 (generator_init, cnngan.py:25-40).  Drawn on the CPU from
    ``generator`` in that order and moved to ``device``."""

    def __init__(self, cfg: CNNGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        c = cfg.channels
        self.conv1, self.conv2 = Conv(c, 64, 4, generator), Conv(64, 128, 4, generator)
        self.conv3 = Conv(128, 256, 4, generator)
        self.deconv1, self.deconv2 = Conv(256, 128, 4, generator), Conv(128, 64, 4, generator)
        self.deconv3 = Conv(64, c, 4, generator)
        for i, ch in zip((1, 2, 3, 4, 5), (64, 128, 256, 128, 64)):
            setattr(self, f"bn{i}", BatchNorm(ch))
        self.to(device)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: Optional[bool] = None) -> torch.Tensor:
        """Flat noise (B, H*W*C) -> images (B, H, W, C) (cnngan.py:43-69)."""
        upd = train if update_state is None else update_state
        cfg = self.cfg
        x = z.reshape(-1, cfg.image_size, cfg.image_size, cfg.channels)
        for c, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = F.relu(batch_norm(bn, conv(c, x, 2, 1), train, upd))
        for c, bn in ((self.deconv1, self.bn4), (self.deconv2, self.bn5)):
            x = F.relu(batch_norm(bn, conv_transpose(c, x, 2, 1), train, upd))
        return torch.tanh(conv_transpose(self.deconv3, x, 2, 1))


class Discriminator(nn.Module):
    """conv1..4 (C -> 64 -> 128 -> 256 -> 512, 4x4 stride 2), conv5 (512 ->
    1, 2x2), bn2..4 after conv2..4 (discriminator_init, cnngan.py:72-84)."""

    def __init__(self, cfg: CNNGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        self.conv1 = Conv(cfg.channels, 64, 4, generator)
        self.conv2, self.conv3 = Conv(64, 128, 4, generator), Conv(128, 256, 4, generator)
        self.conv4, self.conv5 = Conv(256, 512, 4, generator), Conv(512, 1, 2, generator)
        self.bn2, self.bn3, self.bn4 = BatchNorm(128), BatchNorm(256), BatchNorm(512)
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: bool = False) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B,) (cnngan.py:87-98)."""
        x = _leaky(conv(self.conv1, images, 2, 1))  # no BN on the first conv
        for c, bn in ((self.conv2, self.bn2), (self.conv3, self.bn3), (self.conv4, self.bn4)):
            x = _leaky(batch_norm(bn, conv(c, x, 2, 1), train, update_state))
        return conv(self.conv5, x, 1, 0).reshape(x.shape[0])
