"""DCGAN baseline: the conv generator and discriminator of the reference's
DCGAN notebook, and the conv layers the baselines share.

Counterpart of vitgan_tpu/models/dcgan.py.  Activations are NHWC as in the
JAX package; the weights keep its layouts, so that weights.from_jax_tree
carries a {'params', 'state'} tree across leaf for leaf: a conv's ``w`` is
HWIO (kH, kW, in, out), a transposed conv's the same (kH, kW, in, out), and
BatchNorm holds ``scale`` and ``bias`` as parameters and ``mean`` and
``var``, its running statistics, as buffers.  The products are cuDNN's
(F.conv2d and F.conv_transpose2d on channels-last views), as the JAX package
leaves them to XLA; BatchNorm's statistics are formed in f32.

BatchNorm in training mode normalises by the batch's statistics and, with
``update_state``, writes the refreshed running statistics back in place
(momentum 0.1, the biased variance, as the JAX `batch_norm` returns them); in
eval mode it reads them.  Placement as the notebook's: G after its second
deconv only, D after each of its first three convs (dcgan.py:84-147).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vitgan_tpu_torch.config import DCGANConfig
from vitgan_tpu_torch.models import layers as L
from vitgan_tpu_torch.ops import draws
from vitgan_tpu_torch.parallel.mesh import all_reduce_sum


class Conv(nn.Module):
    """A conv or transposed-conv weight ``w`` (k, k, in, out), N(0, 0.02)
    (the notebook's weights_init, conv_init in dcgan.py:30-32)."""

    def __init__(self, in_ch: int, out_ch: int, k: int, generator: Optional[torch.Generator]):
        super().__init__()
        w = L.normal((k, k, in_ch, out_ch), generator)
        self.w = nn.Parameter(w * 0.02 if generator is not None else w)


def conv(p: Conv, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """torch Conv2d(stride, padding) on NHWC x, in x's dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p.w.to(x.dtype).permute(3, 2, 0, 1),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def conv_transpose(p: Conv, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """torch ConvTranspose2d(stride, padding) on NHWC x: the JAX form (the
    kernel flipped over an input dilated by the stride) is this product with
    the weight as (in, out, kH, kW)."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), p.w.to(x.dtype).permute(2, 3, 0, 1),
                           stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """scale 1, bias 0; running mean 0 and var 1 as buffers (bn_init)."""

    def __init__(self, ch: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))


def batch_norm(p: BatchNorm, x: torch.Tensor, train: bool, update_state: bool,
               momentum: float = 0.1, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (B, H, W) of NHWC x in f32, cast back (dcgan.py:62-75)."""
    xf = x.float()
    rows = draws.current()
    if train and rows is not None and not rows.identity:
        # the statistics of the global batch (parallel/mesh.py)
        count = float(xf.shape[0] // rows.local * rows.global_ * xf.shape[1] * xf.shape[2])
        mean = all_reduce_sum(xf.sum((0, 1, 2)), rows) / count
        var = all_reduce_sum(((xf - mean) ** 2).sum((0, 1, 2)), rows) / count
    elif train:
        mean = xf.mean((0, 1, 2))
        var = ((xf - mean) ** 2).mean((0, 1, 2))
    if train:
        if update_state:
            with torch.no_grad():
                p.mean.mul_(1 - momentum).add_(momentum * mean)
                p.var.mul_(1 - momentum).add_(momentum * var)
    else:
        mean, var = p.mean, p.var
    y = (xf - mean) * torch.rsqrt(var + eps) * p.scale + p.bias
    return y.to(x.dtype)


def has_batch_stats(module: nn.Module) -> bool:
    """True where a submodule holds BatchNorm running statistics (buffers
    ``mean`` and ``var``): `_tree_has_batch_stats` of the JAX registry."""
    return any({"mean", "var"} <= {n for n, _ in m.named_buffers(recurse=False)}
               for m in module.modules())


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Generator(nn.Module):
    """z (latent,) -> 4x4 -> 8x8 -> 16x16 -> 32x32: deconv1..4 with bn2
    (generator_init, dcgan.py:84-97).  Drawn on the CPU from ``generator``
    (deconv1, deconv2, deconv3, deconv4 in that order) and moved to
    ``device``; with no ``generator`` nothing is drawn (the meta device)."""

    def __init__(self, cfg: DCGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        b = cfg.base_width
        self.deconv1 = Conv(cfg.latent_dim, b * 4, 4, generator)
        self.deconv2 = Conv(b * 4, b * 2, 4, generator)
        self.bn2 = BatchNorm(b * 2)
        self.deconv3 = Conv(b * 2, b, 4, generator)
        self.deconv4 = Conv(b, cfg.channels, 4, generator)
        self.to(device)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: Optional[bool] = None) -> torch.Tensor:
        """z (B, latent) -> images (B, 32, 32, C) in z's dtype.  A training
        forward refreshes bn2's running statistics unless ``update_state``
        is False."""
        upd = train if update_state is None else update_state
        x = z.reshape(z.shape[0], 1, 1, self.cfg.latent_dim)
        x = F.relu(conv_transpose(self.deconv1, x, 1, 0))
        x = conv_transpose(self.deconv2, x, 2, 1)
        x = F.relu(batch_norm(self.bn2, x, train, upd))
        x = F.relu(conv_transpose(self.deconv3, x, 2, 1))
        return torch.tanh(conv_transpose(self.deconv4, x, 2, 1))


class Discriminator(nn.Module):
    """32 -> 16 -> 8 -> 4 -> one logit: conv1..4, bn1..3 (discriminator_init,
    dcgan.py:112-127)."""

    def __init__(self, cfg: DCGANConfig, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        b = cfg.base_width
        self.conv1 = Conv(cfg.channels, b, 4, generator)
        self.conv2 = Conv(b, b * 2, 4, generator)
        self.conv3 = Conv(b * 2, b * 4, 4, generator)
        self.conv4 = Conv(b * 4, 1, 4, generator)
        self.bn1, self.bn2, self.bn3 = BatchNorm(b), BatchNorm(b * 2), BatchNorm(b * 4)
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: bool = False) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B,); ``update_state`` writes the
        batch's running statistics back (a training forward only)."""
        x = images
        for c, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2), (self.conv3, self.bn3)):
            x = _leaky(batch_norm(bn, conv(c, x, 2, 1), train, update_state))
        return conv(self.conv4, x, 1, 0).reshape(x.shape[0])
