"""v2 ViT-GAN: the generator (latent -> token grid -> encoder stack -> pixels)
and the ViT discriminator (patches + CLS -> encoder stack -> tanh head -> logit).

Counterpart of vitgan_tpu/models/vitgan_v2.py (patchify/unpatchify 39-53,
the pre-LN encoder block 89-127, vit_init/vit_encode/vit_apply and
minibatch_std_feature 130-229, generator_init/generator_apply 237-268,
discriminator_init/discriminator_apply 271-284).  Parameter names and layouts
are the JAX tree's.
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


class Discriminator(nn.Module):
    """ViT scoring real/fake with one logit (vit_init, vitgan_v2.py:130-150):
    embed (patch_dim -> E), pos (N, E), cls (1, 1, E), blocks, ln, head_fc1
    (E + head_extra -> E; head_extra 1 with minibatch_std) and head_fc2 (E -> 1).
    Drawn on the CPU from ``generator`` and moved to ``device``, as Generator."""

    def __init__(self, cfg: V2Config, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        n_patches = (cfg.image_size // cfg.patch_size) ** 2
        patch_dim = cfg.patch_size ** 2 * cfg.channels
        head_extra = 1 if cfg.minibatch_std else 0
        self.embed = L.Dense(patch_dim, cfg.embed_dim, generator)
        self.pos = nn.Parameter(L.trunc_normal((n_patches, cfg.embed_dim), 0.02, 2.0, generator))
        self.cls = nn.Parameter(L.trunc_normal((1, 1, cfg.embed_dim), 0.02, 2.0, generator))
        self.blocks = nn.ModuleList(EncoderBlock(cfg, generator) for _ in range(cfg.depth))
        self.ln = L.LayerNorm(cfg.embed_dim)
        self.head_fc1 = L.Dense(cfg.embed_dim + head_extra, cfg.embed_dim, generator)
        self.head_fc2 = L.Dense(cfg.embed_dim, 1, generator)
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B,) in the images' dtype."""
        logits = vit_apply(self, images, self.cfg, train=train, generator=generator,
                           with_mbstd=self.cfg.minibatch_std)
        return logits[:, 0]


def minibatch_std_feature(feats: torch.Tensor, group_size: int = 8) -> torch.Tensor:
    """Per-group batch-std scalar, (B, E) -> (B, 1) (vitgan_v2.py:153-178).
    The group size divides the half batch, so that no group straddles the
    [real; fake] boundary of the concatenated D forward."""
    b = feats.shape[0]
    half = b // 2 if b % 2 == 0 else b
    g = max(1, min(group_size, half))
    while half % g:
        g -= 1
    f = feats.reshape(b // g, g, -1).float()
    std = torch.sqrt(f.var(dim=1, unbiased=False) + 1e-8)  # (groups, E)
    s = std.mean(dim=-1, keepdim=True)  # (groups, 1)
    return s.repeat_interleave(g, dim=0).to(feats.dtype)


def vit_encode(d: Discriminator, images: torch.Tensor, cfg: V2Config, train: bool = False,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """images -> (B, N+1, E) after the final LN.  CLS gets no positional term;
    embedding dropout, then the blocks (vitgan_v2.py:201-214)."""
    x = L.dense(d.embed, patchify(images, cfg.patch_size))
    x = x + d.pos.to(x.dtype)
    cls = d.cls.to(x.dtype).expand(x.shape[0], 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = L.dropout(x, cfg.dropout, train, generator)
    for block in d.blocks:
        x = encoder_apply(block, x, cfg, train, generator)
    return L.layer_norm(d.ln, x)


def vit_apply(d: Discriminator, images: torch.Tensor, cfg: V2Config, train: bool = False,
              generator: Optional[torch.Generator] = None, with_mbstd: bool = False):
    """Encode, then CLS -> Linear -> tanh -> Linear (vitgan_v2.py:217-229)."""
    cls = vit_encode(d, images, cfg, train, generator)[:, 0, :]
    if with_mbstd:
        cls = torch.cat([cls, minibatch_std_feature(cls)], dim=-1)
    return L.dense(d.head_fc2, torch.tanh(L.dense(d.head_fc1, cls)))
