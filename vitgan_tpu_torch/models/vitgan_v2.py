"""v2 ViT-GAN generator: latent -> token grid -> encoder stack -> pixels.

Counterpart of vitgan_tpu/models/vitgan_v2.py (patchify/unpatchify 39-53,
the pre-LN encoder block 89-127, generator_init/generator_apply 237-268).
Parameter names and layouts are the JAX tree's.  The discriminator comes
with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vitgan_tpu_torch.config import V2Config
from vitgan_tpu_torch.models import layers as L


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, patch*patch*C)."""
    b, h, w, c = images.shape
    x = images.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def unpatchify(tokens: torch.Tensor, patch: int, image_size: int, channels: int) -> torch.Tensor:
    """(B, N, patch*patch*C) -> (B, H, W, C), inverse of patchify."""
    b = tokens.shape[0]
    side = image_size // patch
    x = tokens.reshape(b, side, side, patch, patch, channels)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, image_size, image_size, channels)


class EncoderBlock(nn.Module):
    """Pre-LN encoder block parameters: ln1, ln2, msha, fc1, fc2."""

    def __init__(self, cfg: V2Config, generator: Optional[torch.Generator]):
        super().__init__()
        hidden = cfg.embed_dim * cfg.mlp_ratio
        self.ln1 = L.LayerNorm(cfg.embed_dim)
        self.ln2 = L.LayerNorm(cfg.embed_dim)
        self.msha = L.MHSA(cfg.embed_dim, cfg.num_heads, generator)
        self.fc1 = L.Dense(cfg.embed_dim, hidden, generator)
        self.fc2 = L.Dense(hidden, cfg.embed_dim, generator)


def encoder_apply(p: EncoderBlock, x: torch.Tensor, cfg: V2Config, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + drop(MHSA(LN1 x)); x + drop(FC2(GELU(FC1(LN2 x)))), through the
    megablock when the policy routes it (vitgan_v2.py:104-127)."""
    from vitgan_tpu_torch.ops.fused_block import maybe_megablock
    from vitgan_tpu_torch.ops.fused_mlp import dispatch_ln_mlp

    fused = maybe_megablock(p, x, cfg, train)
    if fused is not None:
        return fused
    head_dim = cfg.embed_dim // cfg.num_heads
    a = L.mhsa(p.msha, L.layer_norm(p.ln1, x), score_mode="dot", scale=head_dim)
    x = x + L.dropout(a, cfg.dropout, train, generator)
    mlp_out = dispatch_ln_mlp(x, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b,
                              activation="gelu", residual=False)
    return x + L.dropout(mlp_out, cfg.dropout, train, generator)


class Generator(nn.Module):
    """mapping (latent -> N*E), pos (N, E), blocks, ln, to_pixels (E -> p*p*C).

    Weights are drawn on the CPU from ``generator`` (truncated normals as
    generator_init draws them) and then moved to ``device``.  With no
    ``generator`` (built under ``torch.device("meta")``) nothing is drawn:
    the weights are loaded next (utils/run_dirs.restore_run)."""

    def __init__(self, cfg: V2Config, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        patch_dim = cfg.patch_size ** 2 * cfg.channels
        self.mapping = L.Dense(cfg.latent_dim, n_patches * cfg.embed_dim, generator)
        self.pos = nn.Parameter(L.trunc_normal((n_patches, cfg.embed_dim), 0.02, 2.0, generator))
        self.blocks = nn.ModuleList(EncoderBlock(cfg, generator) for _ in range(cfg.depth))
        self.ln = L.LayerNorm(cfg.embed_dim)
        self.to_pixels = L.Dense(cfg.embed_dim, patch_dim, generator)
        self.to(device)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z (B, latent) -> images (B, H, W, C) in [-1, 1], in z's dtype."""
        cfg = self.cfg
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        x = L.dense(self.mapping, z).reshape(-1, n_patches, cfg.embed_dim)
        x = x + self.pos.to(x.dtype)
        for block in self.blocks:
            x = encoder_apply(block, x, cfg, train, generator)
        x = L.layer_norm(self.ln, x)
        pix = torch.tanh(L.dense(self.to_pixels, x))
        return unpatchify(pix, cfg.patch_size, cfg.image_size, cfg.channels)
