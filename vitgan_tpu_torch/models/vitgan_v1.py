"""v1, the paper's ViTGAN: the SLN generator with its SIREN head and the
ISR/L2-attention discriminator over overlapping patches.

Counterpart of vitgan_tpu/models/vitgan_v1.py (the blocks 39-90, the
generator 98-147, patch_geometry and extract_overlapping_patches 155-175, the
discriminator 183-237).  Parameter names and layouts are the JAX tree's; the
discriminator's ISR state is in buffers under the JAX state tree's names.
Attention goes through ops/attention.dispatch_attention: `dot` scores in G,
`l2` in D, scale H*Dh.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vitgan_tpu_torch.config import V1Config
from vitgan_tpu_torch.models import layers as L


class Block(nn.Module):
    """The discriminator's pre-LN block: ln1, ln2, msha (torch init, no qkv
    bias, ISR state where ``spectral``), mlp (_block_init, vitgan_v1.py:39-51)."""

    def __init__(self, features: int, cfg, spectral: bool, generator: Optional[torch.Generator]):
        super().__init__()
        self.ln1 = L.LayerNorm(features)
        self.ln2 = L.LayerNorm(features)
        self.msha = L.MHSA(features, cfg.num_heads, generator, qkv_bias=False, init="torch",
                           spectral=spectral)
        self.mlp = L.MLP(features, features, cfg.mlp_hidden, generator)


class SLNBlock(nn.Module):
    """The generator's block: sln1, sln2, msha (torch init, no qkv bias, no
    ISR), mlp (_sln_block_init, vitgan_v1.py:54-65)."""

    def __init__(self, features: int, cfg, generator: Optional[torch.Generator]):
        super().__init__()
        self.sln1 = L.SLN(features, generator)
        self.sln2 = L.SLN(features, generator)
        self.msha = L.MHSA(features, cfg.num_heads, generator, qkv_bias=False, init="torch")
        self.mlp = L.MLP(features, features, cfg.mlp_hidden, generator)


def transformer_block(p: Block, x: torch.Tensor, cfg, *, score_mode: str, train: bool,
                      generator: Optional[torch.Generator], update_state: bool) -> torch.Tensor:
    """x + drop(MSHA(LN1 x)); then + MLP(LN2 x) (vitgan_v1.py:68-77)."""
    a = L.mhsa(p.msha, L.layer_norm(p.ln1, x), score_mode=score_mode,
               update_state=update_state)
    x = x + L.dropout(a, cfg.attn_dropout, train, generator)
    return x + L.mlp(p.mlp, L.layer_norm(p.ln2, x), cfg.mlp_activation, cfg.mlp_dropout, train,
                     generator)


def sln_transformer_block(p: SLNBlock, h: torch.Tensor, w: torch.Tensor, cfg, *, train: bool,
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """htmp = drop(MSHA(SLN(h, w))) + h; MLP(SLN(htmp, w)) + htmp
    (vitgan_v1.py:80-90)."""
    a = L.mhsa(p.msha, L.sln(p.sln1, h, w), score_mode="dot")
    htmp = L.dropout(a, cfg.attn_dropout, train, generator) + h
    return L.mlp(p.mlp, L.sln(p.sln2, htmp, w), cfg.mlp_activation, cfg.mlp_dropout, train,
                 generator) + htmp


class Generator(nn.Module):
    """mapping (latent -> image_size * hidden), embedding (image_size,
    hidden) ~ N(0, 1), blocks, sln, siren1 (hidden -> siren_hidden), siren2
    (-> channels * image_size): one token per image row (generator_init,
    vitgan_v1.py:98-115).  Drawn on the CPU from ``generator`` and moved to
    ``device``; with no ``generator`` (built on the meta device) nothing is
    drawn, the weights are loaded next."""

    def __init__(self, cfg: V1Config, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        g = cfg.generator
        n_tokens = cfg.image_size
        self.mapping = L.MLP(cfg.latent_dim, n_tokens * g.hidden_size, (), generator)
        self.embedding = nn.Parameter(L.normal((n_tokens, g.hidden_size), generator))
        self.blocks = nn.ModuleList(SLNBlock(g.hidden_size, g.transformer, generator)
                                    for _ in range(g.depth))
        self.sln = L.SLN(g.hidden_size, generator)
        self.siren1 = L.Siren(g.hidden_size, g.siren_hidden, True, g.siren.omega_0, generator)
        self.siren2 = L.Siren(g.siren_hidden, cfg.channels * cfg.image_size, False,
                              g.siren.omega_0, generator)
        self.to(device)

    def forward(self, z: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z (B, latent) -> images (B, H, W, C) in [-1, 1], in z's dtype
        (generator_apply, vitgan_v1.py:118-147)."""
        cfg = self.cfg
        g = cfg.generator
        w = L.mlp(self.mapping, z).reshape(-1, cfg.image_size, g.hidden_size)
        h = self.embedding.to(w.dtype).expand(w.shape)
        for block in self.blocks:
            h = sln_transformer_block(block, h, w, g.transformer, train=train,
                                      generator=generator)
        y = L.siren(self.siren1, L.sln(self.sln, h, w), g.siren.omega_0)
        y = L.siren(self.siren2, y, g.siren.omega_0)
        return y.reshape(-1, cfg.image_size, cfg.image_size, cfg.channels)


def patch_geometry(image_size: int, patch_size: int, overlap: int) -> Tuple[int, int, int]:
    """(window, stride, tokens per side) (vitgan_v1.py:155-160)."""
    window = patch_size + 2 * overlap
    stride = (image_size - window) // patch_size + 1
    per_side = (image_size - window) // stride + 1
    return window, stride, per_side


def extract_overlapping_patches(images: torch.Tensor, patch_size: int,
                                overlap: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, T, C * window * window) flattened overlapping
    patches, in the feature order of jax.lax.conv_general_dilated_patches:
    channel-major, then the window's rows and columns (vitgan_v1.py:163-175).
    Strided views, no copy before the reshape; differentiable."""
    b, hh, _, c = images.shape
    window, stride, per_side = patch_geometry(hh, patch_size, overlap)
    # (B, per_side, per_side, C, window rows, window cols)
    patches = images.unfold(1, window, stride).unfold(2, window, stride)
    return patches.reshape(b, per_side * per_side, c * window * window)


class Discriminator(nn.Module):
    """proj (patch width -> token_size, no bias), cls (1, 1, E) and pos
    (T + 1, E) ~ N(0, 1), ISR blocks, head (E -> 1) (discriminator_init,
    vitgan_v1.py:183-202).  Drawn on the CPU from ``generator`` and moved to
    ``device``, as Generator."""

    def __init__(self, cfg: V1Config, generator: Optional[torch.Generator], device="cuda"):
        super().__init__()
        self.cfg = cfg
        d = cfg.discriminator
        window, _, per_side = patch_geometry(cfg.image_size, d.patch_size, d.overlap)
        raw_dim = cfg.channels * window * window
        e = d.token_size or raw_dim
        self.proj = L.Linear(raw_dim, e, generator, bias=False)
        self.cls = nn.Parameter(L.normal((1, 1, e), generator))
        self.pos = nn.Parameter(L.normal((per_side * per_side + 1, e), generator))
        self.blocks = nn.ModuleList(Block(e, d.transformer, d.spectral_rescale, generator)
                                    for _ in range(d.depth))
        self.head = L.Linear(e, 1, generator)
        self.to(device)

    def forward(self, images: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                update_state: bool = False) -> torch.Tensor:
        """images (B, H, W, C) -> logits (B,) in the images' dtype
        (discriminator_apply, vitgan_v1.py:205-237).  ``update_state`` writes
        each block's refreshed ISR u back (the D update's forward)."""
        d = self.cfg.discriminator
        tokens = L.dense(self.proj, extract_overlapping_patches(images, d.patch_size, d.overlap))
        cls = self.cls.to(tokens.dtype).expand(tokens.shape[0], 1, tokens.shape[-1])
        x = torch.cat([cls, tokens], dim=1) + self.pos.to(tokens.dtype)
        x = L.dropout(x, d.embed_dropout, train, generator)
        for block in self.blocks:
            x = transformer_block(block, x, d.transformer, score_mode="l2", train=train,
                                  generator=generator, update_state=update_state)
        return L.dense(self.head, x[:, 0, :])[:, 0]
