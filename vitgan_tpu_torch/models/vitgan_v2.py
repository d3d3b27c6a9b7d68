"""v2 ViT-GAN: the generator (latent -> token grid -> encoder stack -> pixels)
and the ViT discriminator (patches + CLS -> encoder stack -> tanh head -> logit).

Counterpart of vitgan_tpu/models/vitgan_v2.py (patchify/unpatchify 39-53,
the pre-LN encoder block 89-127, vit_init/vit_encode/vit_apply and
minibatch_std_feature 130-229, generator_init/generator_apply 237-268,
discriminator_init/discriminator_apply 271-284).  Parameter names and layouts
are the JAX tree's.
"""

from __future__ import annotations

from dataclasses import dataclass
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


def _standard_block(p: EncoderBlock, x: torch.Tensor, cfg: V2Config, m1, m2,
                    seq_len: Optional[int] = None) -> torch.Tensor:
    """The block on the standard path with its dropout keep masks (None: no
    dropout).  ``seq_len``: ``x`` holds this seq rank's tokens of a sequence
    of that length, and attention gathers K/V over the seq group."""
    from vitgan_tpu_torch.ops.fused_mlp import dispatch_ln_mlp

    head_dim = cfg.embed_dim // cfg.num_heads
    kv = None
    if seq_len is not None:
        from vitgan_tpu_torch.ops.policy import sequence_parallel_mesh
        from vitgan_tpu_torch.parallel.context_parallel import gather_kv

        mesh = sequence_parallel_mesh()
        kv = lambda t: gather_kv(t, mesh, seq_len)  # noqa: E731
    a = L.mhsa(p.msha, L.layer_norm(p.ln1, x), score_mode="dot", scale=head_dim, kv=kv)
    x = x + L.apply_dropout(a, m1, cfg.dropout)
    mlp_out = dispatch_ln_mlp(x, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b,
                              activation="gelu", residual=False)
    return x + L.apply_dropout(mlp_out, m2, cfg.dropout)


@dataclass
class BlockDraws:
    """A block's randomness, drawn before it in the order the block would
    draw it: the route (the megablock variant, or None for the standard
    path), the megablock's Philox seed, or the standard path's dropout keep
    masks (None: no dropout)."""

    route: Optional[str]
    seed: Optional[torch.Tensor] = None
    m1: Optional[torch.Tensor] = None
    m2: Optional[torch.Tensor] = None

    def take(self, rows: slice = slice(None), tokens: slice = slice(None)) -> "BlockDraws":
        """The masks' rows and tokens a microbatch or a seq rank runs."""
        cut = lambda m: None if m is None else m[rows, tokens]  # noqa: E731
        return BlockDraws(self.route, self.seed, cut(self.m1), cut(self.m2))


def block_draws(p: EncoderBlock, x: torch.Tensor, cfg: V2Config, train: bool,
                generator: Optional[torch.Generator] = None, shape=None) -> BlockDraws:
    """Route ``x`` through the megablock gate (ops/fused_block.megablock_route)
    and draw the block's randomness from ``generator``: the seed of a
    dropout route, else the two dropout masks, at ``shape`` (default x's)."""
    from vitgan_tpu_torch.ops.fused_block import megablock_route, new_seed

    route = megablock_route(p, x, cfg, train, generator is not None)
    if route is not None:
        return BlockDraws(route, new_seed(generator, x) if train and "dropout" in route else None)
    like = x if shape is None else x.new_empty(()).expand(shape)
    return BlockDraws(None, m1=L.dropout_mask(like, cfg.dropout, train, generator),
                      m2=L.dropout_mask(like, cfg.dropout, train, generator))


def encoder_apply_drawn(p: EncoderBlock, x: torch.Tensor, cfg: V2Config, train: bool,
                        d: BlockDraws, first: int = 0, total: Optional[int] = None,
                        seq_len: Optional[int] = None):
    """The block on its drawn route and randomness (:func:`encoder_apply`).
    ``x`` may be rows ``first``.. of a local batch of ``total`` (a pipeline
    microbatch): the masks take those rows, and the megablock's in-kernel
    dropout keys its bits by them (ops/draws.microbatch); or this seq rank's
    tokens of a sequence of ``seq_len`` (:func:`run_blocks`)."""
    from vitgan_tpu_torch.models.remat import remat_block
    from vitgan_tpu_torch.ops import draws
    from vitgan_tpu_torch.ops.fused_block import fused_encoder_block, megablock_apply

    total = x.shape[0] if total is None else total
    if d.route is not None:
        if not train:
            return fused_encoder_block(x, p, num_heads=cfg.num_heads)

        def block(x, seed):
            with draws.microbatch(first, total):
                return megablock_apply(d.route, p, x, cfg, seed)

        return remat_block(block, x, d.seed)
    if total != x.shape[0]:
        d = d.take(rows=slice(first, first + x.shape[0]))
    return remat_block(lambda x, m1, m2: _standard_block(p, x, cfg, m1, m2, seq_len),
                       x, d.m1, d.m2)


def encoder_apply(p: EncoderBlock, x: torch.Tensor, cfg: V2Config, train: bool = False,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """x + drop(MHSA(LN1 x)); x + drop(FC2(GELU(FC1(LN2 x)))), through the
    megablock when the policy routes it (vitgan_v2.py:104-127), under the
    policy's remat mode (models/remat.py; the JAX `_run_blocks`,
    vitgan_v2.py:182-197).  The block's randomness, its two dropout masks or
    the megablock's seed, is drawn before it, in the order the block would
    draw it, so that a re-run for the backward replays it."""
    return encoder_apply_drawn(p, x, cfg, train, block_draws(p, x, cfg, train, generator))


def run_blocks(blocks, x: torch.Tensor, cfg: V2Config, train: bool = False,
               generator: Optional[torch.Generator] = None, blocks_runner=None):
    """The encoder stack (the JAX `_run_blocks`, vitgan_v2.py:181-197): the
    sequential loop, or a pluggable ``blocks_runner(blocks, x, train,
    generator)`` (parallel/pipeline.py installs the GPipe schedule).  Under
    sequence parallelism (ops/policy.set_sequence_parallel) each seq rank
    runs its tokens: the stack's entry keeps this rank's slice, attention
    gathers K/V over the seq group (models/layers.mhsa), LN and MLP stay
    token-local, and the exit gathers the tokens; each block's masks are
    drawn at the whole sequence and sliced, so that they are the unsharded
    run's."""
    if blocks_runner is not None:
        return blocks_runner(blocks, x, train, generator)
    from vitgan_tpu_torch.ops.policy import sequence_constraint, sequence_parallel_mesh

    mesh = sequence_parallel_mesh()
    if mesh is None:
        for p in blocks:
            x = encoder_apply(p, x, cfg, train, generator)
        return x
    from vitgan_tpu_torch.parallel.context_parallel import gather_sequence, token_slice

    shape = tuple(x.shape)
    tokens = token_slice(shape[1], mesh)
    x = sequence_constraint(x)
    for p in blocks:
        d = block_draws(p, x, cfg, train, generator, shape=shape)
        x = encoder_apply_drawn(p, x, cfg, train, d.take(tokens=tokens), seq_len=shape[1])
    return gather_sequence(x, mesh, shape[1])


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
        self.blocks_runner = None  # the stack's runner (parallel/pipeline.pp_bundle)
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
        x = run_blocks(self.blocks, x, cfg, train, generator, self.blocks_runner)
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
        self.blocks_runner = None  # the stack's runner (parallel/pipeline.pp_bundle)
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
    [real; fake] boundary of the concatenated D forward.  Inside a train
    step under a data axis above 1 (ops/draws.global_rows) the groups are
    the global batch's, as the JAX step's are: the rows are gathered over
    the data group (differentiably), put in the global order (a local batch
    of k blocks, D's [real_l; fake_l], is rows of k blocks of the global
    batch), and this rank's rows of the feature are kept."""
    from vitgan_tpu_torch.ops import draws
    from vitgan_tpu_torch.parallel.mesh import gather_rows

    rows = draws.current()
    if rows is not None and not rows.identity:
        k = feats.shape[0] // rows.local
        n = rows.global_ // rows.local
        every = gather_rows(feats, rows)  # (n ranks x k blocks x local, E), rank-major
        order = every.reshape(n, k, rows.local, -1).transpose(0, 1).reshape(k * rows.global_, -1)
        return _group_std(order, group_size).index_select(
            0, draws.row_index(rows, feats.shape[0], feats.device))
    return _group_std(feats, group_size)


def _group_std(feats: torch.Tensor, group_size: int) -> torch.Tensor:
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
    x = run_blocks(d.blocks, x, cfg, train, generator, d.blocks_runner)
    return L.layer_norm(d.ln, x)


def vit_apply(d: Discriminator, images: torch.Tensor, cfg: V2Config, train: bool = False,
              generator: Optional[torch.Generator] = None, with_mbstd: bool = False):
    """Encode, then CLS -> Linear -> tanh -> Linear (vitgan_v2.py:217-229)."""
    cls = vit_encode(d, images, cfg, train, generator)[:, 0, :]
    if with_mbstd:
        cls = torch.cat([cls, minibatch_std_feature(cls)], dim=-1)
    return L.dense(d.head_fc2, torch.tanh(L.dense(d.head_fc1, cls)))
