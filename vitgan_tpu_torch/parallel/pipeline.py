"""Pipeline parallelism: the GPipe schedule over the mesh's pipe axis.

Counterpart of vitgan_tpu/parallel/pipeline.py.  The JAX package stacks the
block parameters on a leading axis sharded over ``pipe`` and runs every
stage at every tick of a ``lax.scan``, masking the ticks where a stage holds
no microbatch, with ``ppermute`` as the ring hop.  The port runs one process
per stage (parallel/mesh.py), so:

- each pipe rank holds and runs only its ``depth / S`` blocks
  (:func:`stage_blocks`; the parameters of the other stages' blocks, their
  Adam moments and their EMA are freed by the placement,
  parallel/sharding.py), so a stage's block memory and compute are O(depth
  / S);
- stage s computes microbatch t - s at tick t, for t in [s, s + M): it
  receives the microbatch from stage s - 1 and sends its output to stage
  s + 1.  At the other ticks it computes nothing (the JAX package's masked
  filler is no part of the result);
- the hops are autograd Functions: a send's backward receives the cotangent
  from the next stage, a receive's backward sends it back, and each
  backward is built from the same Functions, so that a ``create_graph``
  backward (R1, WGAN-GP) differentiates twice through the ring, as
  ``jax.grad`` of ``ppermute`` does;
- the stack's input enters on stage 0 (the other stages' copies of it are
  not read); in the backward stage 0's input cotangent is broadcast over the
  pipe group, so that the code before the stack (embeddings), which every
  pipe rank runs, takes the same gradient everywhere;
- the last stage's output is broadcast over the pipe group, as the JAX
  ``psum`` is (pipeline.py:206-214): the code after the stack (final LN,
  heads, losses) runs on every pipe rank on the same values, and the last
  stage's backward takes its own cotangent (every rank's is the same).  The
  two are each other's backward (:class:`_Broadcast`, :class:`_Keep`), so
  that a double backward gives every rank's code around the stack the same
  cotangents again.

Why no send or receive waits on another in a cycle: in the forward a stage
receives microbatch j, runs it and sends it, in microbatch order, and
activations move one way; PyTorch's autograd engine runs the ready node
created last first, so every stage's backward walks its microbatches in
reverse order, each to its end, and the cotangents move the other way in
that order on every stage.  A double backward first walks the nodes the
first backward created (the microbatches in forward order, cotangents of
cotangents moving up the pipe), then the forward's (down).  Each of the
first backward's hops takes the matching forward hop's token as an anchor,
so that a double backward that reaches a hop on one rank reaches its
partner on the other (tests/test_torch_pipeline.py runs 4 stages x 4
microbatches with R1 and a toy stack's double backward).  The broadcasts of
the stack's input cotangent come last in a call's backward on every rank.

Random draws.  Every block's randomness (the megablock's Philox seed, or
the standard block's dropout masks, drawn at the whole local batch) is drawn
before the schedule, on every pipe rank, in block order and from the step's
generator, as the unpipelined stack draws it, and a microbatch takes its
rows.  The draws are therefore the unpipelined run's for any S, M and rank
layout, and the megablock's in-kernel dropout keys a microbatch's bits by
their rows in the batch (ops/draws.microbatch, ops/fused_block.mask_rows).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

_BLOCK = re.compile(r"^blocks\.(\d+)\.")


def stack_blocks(blocks: Sequence[torch.nn.Module]) -> dict:
    """List of blocks -> {name: tensor with a leading block axis} of their
    parameters and buffers."""
    named = [dict(b.named_parameters()) | dict(b.named_buffers()) for b in blocks]
    return {k: torch.stack([n[k] for n in named]) for k in named[0]}


def stage_blocks(depth: int, stages: int, stage: int) -> range:
    """The blocks stage ``stage`` of ``stages`` runs: a contiguous
    ``depth / stages``."""
    if depth % stages != 0:
        raise ValueError(f"depth {depth} not divisible by pipeline stages {stages}")
    per = depth // stages
    return range(stage * per, (stage + 1) * per)


def stage_of(name: str, depth: int, stages: int) -> Optional[int]:
    """The stage that holds the leaf ``name`` of a module with ``depth``
    blocks (``blocks.<i>.``...), or None for a leaf outside the stack, which
    every stage holds."""
    m = _BLOCK.match(name)
    return None if m is None else int(m.group(1)) // (depth // stages)


# --- the hops -----------------------------------------------------------------


def _specs(ts) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in ts)


def _token(like: torch.Tensor) -> torch.Tensor:
    return like.new_empty((0,))


class _Send(torch.autograd.Function):
    """Send tensors to ``peer``; returns an empty token that carries the
    send in the graph.  Backward: receive their cotangents from ``peer``.
    ``anchor`` (an empty tensor or None) only ties the node into the graph:
    under ``create_graph`` the backward's hop takes this hop's token (a
    receive's: an empty slice of what it received) as one, so that a double
    backward that reaches the first backward's hop on one rank also reaches
    this hop, and with it the matching hop on the other rank."""

    @staticmethod
    def forward(ctx, peer, group, anchor, *ts):
        ctx.peer, ctx.group, ctx.specs = peer, group, _specs(ts)
        for t in ts:
            dist.send(t.contiguous(), peer, group=group)
        token = _token(ts[0])
        ctx.save_for_backward(token)
        return token

    @staticmethod
    def backward(ctx, dtoken):
        (token,) = ctx.saved_tensors
        got = _Recv.apply(dtoken, ctx.peer, ctx.group, ctx.specs, token)
        return (None, None, None, *got)


class _Recv(torch.autograd.Function):
    """Receive tensors of ``specs`` from ``peer``; ``token`` ties them into
    the graph.  Backward: send their cotangents back to ``peer``."""

    @staticmethod
    def forward(ctx, token, peer, group, specs, anchor):
        ctx.peer, ctx.group = peer, group
        out = []
        for shape, dtype in specs:
            t = torch.empty(shape, dtype=dtype, device=token.device)
            dist.recv(t, peer, group=group)
            out.append(t)
        ctx.save_for_backward(out[0])
        return tuple(out)

    @staticmethod
    def backward(ctx, *dts):
        (got,) = ctx.saved_tensors
        token = _Send.apply(ctx.peer, ctx.group, got.reshape(-1)[:0], *dts)
        return token, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The ``src`` rank's tensors on every rank of ``group``: a value every
    pipe rank holds alike from one that lives on ``src``.  Backward
    (:class:`_Keep`): ``src`` takes the cotangent, which every rank holds
    alike, once."""

    @staticmethod
    def forward(ctx, src, group, is_src, *ts):
        ctx.src, ctx.group, ctx.is_src = src, group, is_src
        out = []
        for t in ts:
            t = t.clone() if is_src else torch.empty_like(t)
            dist.broadcast(t, src, group=group)
            out.append(t)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_Keep.apply(ctx.src, ctx.group, ctx.is_src, *gs))


class _Keep(torch.autograd.Function):
    """The value that lives on ``src`` from one every pipe rank holds alike:
    ``src``'s own (zeros elsewhere, no communication).  Backward
    (:class:`_Broadcast`): the cotangent on ``src`` reaches every rank's
    copy, so that the code that made the value, which every rank runs,
    takes the same gradient everywhere."""

    @staticmethod
    def forward(ctx, src, group, is_src, *ts):
        ctx.src, ctx.group, ctx.is_src = src, group, is_src
        return tuple(t.clone() if is_src else torch.zeros_like(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        return (None, None, None, *_Broadcast.apply(ctx.src, ctx.group, ctx.is_src, *gs))


class _Entry(torch.autograd.Function):
    """The stack's input enters the pipe on stage 0 (identity; the other
    stages do not read theirs), with an empty token that ties each stage's
    receives into the graph.  Backward: stage 0's input cotangent on every
    pipe rank (a broadcast); the token's cotangent is added in as 0, so that
    a double backward reaches the receives' own backwards."""

    @staticmethod
    def forward(ctx, src, group, is_src, *xs):
        ctx.src, ctx.group, ctx.is_src = src, group, is_src
        return (*(x.view_as(x) for x in xs), _token(xs[0]))

    @staticmethod
    def backward(ctx, *gs):
        *dxs, dtoken = gs
        dxs = [d + dtoken.sum().to(d.dtype) for d in dxs]
        return (None, None, None, *_Broadcast.apply(ctx.src, ctx.group, ctx.is_src, *dxs))


class _Exit(torch.autograd.Function):
    """The last stage's outputs broadcast over the pipe group; the other
    stages hand their send tokens, which ties their sends into the graph.
    Backward: the last stage's own cotangent (:class:`_Keep`; every rank's
    is the same), of which the tokens take empty slices (connected, so that
    a double backward reaches the sends' backwards and, through the keep,
    gives every rank's code after the stack the same cotangent)."""

    @staticmethod
    def forward(ctx, src, group, is_src, specs, *ins):
        ctx.src, ctx.group, ctx.is_src, ctx.n_in = src, group, is_src, len(ins)
        out = []
        for i, (shape, dtype) in enumerate(specs):
            t = ins[i].clone() if is_src else torch.empty(shape, dtype=dtype,
                                                          device=ins[0].device)
            dist.broadcast(t, src, group=group)
            out.append(t)
        return tuple(out)

    @staticmethod
    def backward(ctx, *gs):
        kept = _Keep.apply(ctx.src, ctx.group, ctx.is_src, *gs)
        if ctx.is_src:
            return (None, None, None, None, *kept)
        return (None, None, None, None, *(kept[0].reshape(-1)[:0] for _ in range(ctx.n_in)))


# --- the schedule -------------------------------------------------------------


def pipeline_blocks(blocks: Sequence, x, *, mesh, microbatches: int,
                    block_fn: Callable):
    """Apply the blocks to ``x`` with a GPipe schedule over ``mesh``'s pipe
    axis (the JAX `pipeline_blocks`, pipeline.py:50-214).

    ``blocks`` is the whole stack (this stage runs :func:`stage_blocks` of
    it); ``x`` an array or a tuple of arrays sharing the leading batch dim
    (this rank's rows), which must divide by ``microbatches``;
    ``block_fn(i, block, h, j)`` applies block i to microbatch j's ``h`` (a
    tuple where ``x`` is) and keeps its structure, shapes and dtypes.
    Returns what the sequential loop returns, on every pipe rank."""
    stages = mesh.n_pipe
    depth = len(blocks)
    own = stage_blocks(depth, stages, mesh.pipe_index)
    tup = isinstance(x, (tuple, list))
    xs = tuple(x) if tup else (x,)
    batch = xs[0].shape[0]
    if any(t.shape[0] != batch for t in xs):
        raise ValueError("all activation leaves must share the leading batch dim")
    if batch % microbatches != 0:
        raise ValueError(f"local batch {batch} not divisible by microbatches {microbatches}")
    mb = batch // microbatches
    pack = (lambda h: h) if tup else (lambda h: h[0])

    def run(h, j):
        for i in own:
            h = block_fn(i, blocks[i], pack(h), j)
            h = tuple(h) if tup else (h,)
        return h

    group = mesh.pipe_group
    if stages == 1 or group is None:
        outs = [run(tuple(t[j * mb:(j + 1) * mb] for t in xs), j) for j in range(microbatches)]
        return pack(tuple(torch.cat(parts) for parts in zip(*outs)))
    s = mesh.pipe_index
    first, last = mesh.pipe_rank(0), mesh.pipe_rank(stages - 1)
    *xs_in, token = _Entry.apply(first, group, s == 0, *xs)
    outs, tokens = [], []
    for j in range(microbatches):
        if s == 0:
            h = tuple(t[j * mb:(j + 1) * mb] for t in xs_in)
        else:
            h = _Recv.apply(token, mesh.pipe_rank(s - 1), group,
                            tuple(((mb, *t.shape[1:]), t.dtype) for t in xs), None)
        h = run(h, j)
        if s < stages - 1:
            tokens.append(_Send.apply(mesh.pipe_rank(s + 1), group, None, *h))
        else:
            outs.append(h)
    specs = tuple((tuple(t.shape), t.dtype) for t in xs)
    ins = tuple(torch.cat(parts) for parts in zip(*outs)) if s == stages - 1 else tuple(tokens)
    return pack(_Exit.apply(last, group, s == stages - 1, specs, *ins))


def _microbatches(batch: int, mesh, microbatches: int, train: bool) -> int:
    """M where this rank's ``batch`` divides into it, else 1 (the JAX
    `_pipelineable_batch`, pipeline.py:230-249): eval paths call with any
    batch (sample grids, FID chunks) and run it as one microbatch, which is
    the sequential stack (the port's stages hold only their blocks, so the
    fallback is the schedule with M = 1); an indivisible training batch
    would silently never pipeline, so it raises."""
    if batch % microbatches == 0:
        return microbatches
    if train:
        n_dp = mesh.n_data
        raise ValueError(
            f"training batch {batch * n_dp} does not divide into "
            f"{n_dp} data shard(s) x {microbatches} microbatches — "
            f"pipeline parallelism would silently disable; adjust batch_size "
            f"or mesh.pipeline_microbatches")
    return 1


def _stage_draws(blocks, mesh, draw) -> list:
    """Every block's randomness, drawn in block order on every stage by
    ``draw(template)`` (a block this stage holds: the stack is homogeneous,
    so its shapes are every block's); this stage's blocks keep theirs, the
    others' are dropped."""
    own = stage_blocks(len(blocks), mesh.n_pipe, mesh.pipe_index)
    tmpl = blocks[own[0]]
    out = []
    for i in range(len(blocks)):
        d = draw(tmpl)
        out.append(d if i in own else None)
    return out


def _rows(masks, j: int, mb: int) -> list:
    """Microbatch j's rows of a block's keep masks (None: no dropout)."""
    return [None if t is None else t[j * mb:(j + 1) * mb] for t in masks]


# --- the runners ------------------------------------------------------------------


def make_pp_block_runner(cfg, *, mesh, microbatches: int):
    """The v2 encoder stacks' ``blocks_runner`` (the JAX
    `make_pp_block_runner`, pipeline.py:217-245): ``runner(blocks, x,
    train=False, generator=None) -> x``, the contract of the sequential loop
    in models/vitgan_v2 (its blocks under the policy's route and remat)."""
    from vitgan_tpu_torch.models.vitgan_v2 import block_draws, encoder_apply_drawn

    def runner(blocks, x, train: bool = False, generator=None):
        m = _microbatches(x.shape[0], mesh, microbatches, train)
        drawn = _stage_draws(blocks, mesh, lambda t: block_draws(t, x, cfg, train, generator))
        mb = x.shape[0] // m

        def fn(i, blk, h, j):
            return encoder_apply_drawn(blk, h, cfg, train, drawn[i], first=j * mb,
                                       total=x.shape[0])

        return pipeline_blocks(blocks, x, mesh=mesh, microbatches=m, block_fn=fn)

    return runner


def make_pp_v1_generator_runner(tcfg, *, mesh, microbatches: int):
    """The v1 SLN generator stack's ``blocks_runner`` (pipeline.py:248-285):
    ``runner(blocks, (h, w), train=False, generator=None) -> h``.  The style
    vector ``w`` enters every block unchanged, so it rides the ring beside
    ``h``; generator blocks hold no state."""
    from vitgan_tpu_torch.models import vitgan_v1 as V1

    def runner(blocks, hw, train: bool = False, generator=None):
        h, w = hw
        m = _microbatches(h.shape[0], mesh, microbatches, train)
        masks = _stage_draws(blocks, mesh, lambda t: V1.block_masks(t, h, tcfg, train,
                                                                     generator))
        mb = h.shape[0] // m

        def fn(i, blk, hw, j):
            hh, ww = hw
            return (V1.sln_transformer_block(blk, hh, ww, tcfg, masks=_rows(masks[i], j, mb)),
                    ww)

        return pipeline_blocks(blocks, (h, w), mesh=mesh, microbatches=m, block_fn=fn)[0]

    return runner


def make_pp_v1_discriminator_runner(tcfg, *, mesh, microbatches: int):
    """The v1 ISR/L2 discriminator stack's ``blocks_runner``
    (pipeline.py:288-337): ``runner(blocks, x, train=False, generator=None,
    update_state=False) -> x``.  The blocks run with their ISR state frozen
    (the estimate depends on the weights alone, and the forward is the same
    whether or not u is written back), and each stage refreshes its blocks'
    state in one stacked pass outside the ring (pipeline.py:326-335)."""
    from vitgan_tpu_torch.models import layers as L
    from vitgan_tpu_torch.models import vitgan_v1 as V1

    def runner(blocks, x, train: bool = False, generator=None, update_state: bool = False):
        m = _microbatches(x.shape[0], mesh, microbatches, train)
        masks = _stage_draws(blocks, mesh, lambda t: V1.block_masks(t, x, tcfg, train,
                                                                     generator))
        mb = x.shape[0] // m

        def fn(i, blk, h, j):
            return V1.transformer_block(blk, h, tcfg, score_mode="l2",
                                        masks=_rows(masks[i], j, mb))

        out = pipeline_blocks(blocks, x, mesh=mesh, microbatches=m, block_fn=fn)
        mine = [blocks[i] for i in stage_blocks(len(blocks), mesh.n_pipe, mesh.pipe_index)]
        if update_state and mine[0].msha.isr is not None:
            qkv = torch.stack([b.msha.qkv for b in mine])
            isr = stack_blocks([b.msha.isr for b in mine])
            state = _Stacked(sigma0=isr["sigma0"], u=isr["u"].clone())
            L.spectral_rescale(qkv, state, update=True)
            with torch.no_grad():
                for k, b in enumerate(mine):
                    b.msha.isr.u.copy_(state.u[k])
        return out

    return runner


@dataclasses.dataclass
class _Stacked:
    """The ISR state of a stage's blocks, stacked (layers.ISRState's fields)."""

    sigma0: torch.Tensor
    u: torch.Tensor


def pp_bundle(gan, cfg, *, mesh, microbatches: int):
    """The GANBundle whose modules run their block stacks pipelined over
    ``mesh``'s pipe axis (the JAX `pp_bundle`, pipeline.py:340-405): v2 (G
    and D) and v1 (the SLN generator and the ISR/L2 discriminator).  Each
    module built by the bundle carries its runner (``blocks_runner``), so
    every forward of it, training or eval, goes through the schedule.  The
    parameter layout (the list of blocks) is unchanged: checkpoints stay
    interchangeable with the unpipelined run."""
    mcfg = cfg.model
    stages = mesh.n_pipe
    axis = mesh.pipe_axis or "pipe"
    depths = ((mcfg.depth,) if gan.family == "v2"
              else (mcfg.generator.depth, mcfg.discriminator.depth)
              if gan.family == "v1" else ())
    for depth in depths:
        if depth % stages != 0:
            raise ValueError(
                f"{gan.family} block depth {depth} not divisible by "
                f"pipeline stages {stages} (axis {axis!r})")
    if gan.family == "v2":
        runners = {"g": make_pp_block_runner(mcfg, mesh=mesh, microbatches=microbatches),
                   "d": make_pp_block_runner(mcfg, mesh=mesh, microbatches=microbatches)}
    elif gan.family == "v1":
        runners = {"g": make_pp_v1_generator_runner(mcfg.generator.transformer, mesh=mesh,
                                                    microbatches=microbatches),
                   "d": make_pp_v1_discriminator_runner(mcfg.discriminator.transformer,
                                                        mesh=mesh, microbatches=microbatches)}
    else:
        raise ValueError(f"pipeline parallelism supports v1/v2 ViT stacks, not {gan.family!r}")
    return dataclasses.replace(gan, blocks_runners=runners)


def held(name: str, depth: int, mesh) -> bool:
    """Whether this pipe rank holds the leaf ``name`` of a module with
    ``depth`` blocks."""
    s = stage_of(name, depth, mesh.n_pipe)
    return s is None or s == mesh.pipe_index


def module_depth(module: torch.nn.Module) -> int:
    return len(module.blocks) if hasattr(module, "blocks") else 0


def free_other_stages(module: torch.nn.Module, mesh) -> List[str]:
    """Free the parameters and buffers of the blocks this pipe rank does not
    hold (each becomes an empty tensor of its dtype on its device); returns
    their names."""
    depth = module_depth(module)
    freed = []
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        if not held(name, depth, mesh):
            t.data = t.data.new_empty((0,))
            freed.append(name)
    return freed
