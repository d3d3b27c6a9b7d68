"""Context (sequence) parallelism: the token axis over a mesh axis.

Counterpart of vitgan_tpu/parallel/context_parallel.py (the gather and ring
schedules, ``shard_sequence``) and of the GSPMD sequence parallelism that
the JAX package's v2 stacks run under (ops/policy.set_sequence_parallel,
models/vitgan_v2._run_blocks).  One process per device: each rank holds its
tokens, (B, H, N / P, D) for the attention schedules here, and the group of
the mesh axis moves K/V between them.

- :func:`cp_attention` gathers K/V over the group (differentiably: the
  backward reduce-scatters their cotangents) and runs
  ``ops/attention.dispatch_attention`` on its queries; cross shapes take the
  plain route there, as in the JAX package.
- :func:`ring_cp_attention` keeps one K/V block resident and rotates it
  P - 1 times around the ring (a paired send and receive, the JAX
  ``ppermute``), folding each block into an f32 online softmax; each fold is
  recomputed in the backward (``torch.utils.checkpoint``, the JAX
  ``jax.checkpoint``), and the backward rotates the other way.
- The v2 stacks under SP (models/vitgan_v2.run_blocks): the stack's entry
  keeps this rank's tokens (:func:`enter_sequence`), attention gathers K/V
  (:func:`gather_kv`, models/layers.mhsa), the exit gathers the tokens
  (:func:`gather_sequence`).  A sequence that does not divide (the v2
  discriminator's N + 1) gives the last rank fewer tokens, the slices of a
  ceil(N / P) split, as GSPMD pads the last shard; the gathers pad to the
  split and drop the padding.

Which backward each gather takes: K/V are read by every rank's queries, so
their cotangents are summed onto the owner (a reduce-scatter).  The code
before and after the stack runs on every seq rank on the same whole
sequence, so the exit's backward keeps this rank's tokens of the (equal)
cotangent, and the entry's backward gathers every rank's, so that the code
before the stack takes the same gradient on every rank.  Gradients of the
leaves used on token slices (the blocks') are therefore summed over the seq
group, those of the leaves used on the whole sequence averaged
(parallel/sharding.Placement).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from vitgan_tpu_torch.parallel.mesh import all_gather_into, reduce_scatter_into


def token_slice(n: int, mesh, axis: Optional[str] = None) -> slice:
    """This rank's tokens of ``n`` over the mesh's seq axis (or ``axis``):
    slices of ceil(n / P), the last one shorter where P does not divide n."""
    axis = axis or mesh.seq_axis
    p, r = mesh.shape[axis], mesh.index(axis)
    c = -(-n // p)
    return slice(min(n, r * c), min(n, (r + 1) * c))


def _gather(x: torch.Tensor, dim: int, n: int, group, p: int) -> torch.Tensor:
    """Every rank's slice of ``n`` along ``dim`` (ceil(n / p) each, the last
    shorter), in rank order."""
    c = -(-n // p)
    pad = c - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros((*x.shape[:dim], pad, *x.shape[dim + 1:]))], dim)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((p * c, *x.shape[1:]))
    all_gather_into(out, x, group)
    return out[:n].movedim(0, dim)


def _scatter_sum(g: torch.Tensor, dim: int, n: int, group, p: int, sl: slice):
    """This rank's slice along ``dim`` of the group's summed ``g``."""
    c = -(-n // p)
    g = g.movedim(dim, 0)
    if p * c > n:
        g = torch.cat([g, g.new_zeros((p * c - n, *g.shape[1:]))])
    out = g.new_empty((c, *g.shape[1:]))
    reduce_scatter_into(out, g.contiguous(), group)
    return out[:sl.stop - sl.start].movedim(0, dim)


class _GatherKV(torch.autograd.Function):
    """Every rank's tokens of K or V (all-gather); backward: the summed
    cotangents of this rank's tokens (reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, n, group, p, sl):
        ctx.args = (dim, n, group, p, sl)
        return _gather(x, dim, n, group, p)

    @staticmethod
    def backward(ctx, g):
        return (_ScatterSum.apply(g, *ctx.args), None, None, None, None, None)


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, dim, n, group, p, sl):
        ctx.args = (dim, n, group, p, sl)
        return _scatter_sum(g, dim, n, group, p, sl)

    @staticmethod
    def backward(ctx, gg):
        return (_GatherKV.apply(gg, *ctx.args), None, None, None, None, None)


class _Exit(torch.autograd.Function):
    """Every rank's tokens (all-gather); backward: this rank's tokens of the
    cotangent, which every rank holds alike."""

    @staticmethod
    def forward(ctx, x, dim, n, group, p, sl):
        ctx.args = (dim, n, group, p, sl)
        return _gather(x, dim, n, group, p)

    @staticmethod
    def backward(ctx, g):
        return (_Enter.apply(g, *ctx.args), None, None, None, None, None)


class _Enter(torch.autograd.Function):
    """This rank's tokens of a tensor every rank holds alike; backward: the
    cotangent gathered from every rank's tokens."""

    @staticmethod
    def forward(ctx, x, dim, n, group, p, sl):
        ctx.args = (dim, n, group, p, sl)
        return x.narrow(dim, sl.start, sl.stop - sl.start).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_Exit.apply(g, *ctx.args), None, None, None, None, None)


def _args(mesh, axis: Optional[str], dim: int, n: int) -> tuple:
    axis = axis or mesh.seq_axis
    return dim, n, mesh.group(axis), mesh.shape[axis], token_slice(n, mesh, axis)


def enter_sequence(x: torch.Tensor, mesh, axis: Optional[str] = None, dim: int = 1):
    """This rank's tokens of (B, N, E) ``x``, which every rank holds alike."""
    return _Enter.apply(x, *_args(mesh, axis, dim, x.shape[dim]))


def gather_sequence(x: torch.Tensor, mesh, n: int, axis: Optional[str] = None, dim: int = 1):
    """The whole sequence of ``n`` tokens from every rank's slice, the same
    on every rank."""
    return _Exit.apply(x, *_args(mesh, axis, dim, n))


def gather_kv(t: torch.Tensor, mesh, n: int, axis: Optional[str] = None, dim: int = 2):
    """Every rank's K or V tokens, (B, H, n, D) from this rank's slice."""
    return _GatherKV.apply(t, *_args(mesh, axis, dim, n))


def shard_sequence(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """This rank's tokens of (B, H, N, D) ``x`` over ``axis`` (the JAX
    `shard_sequence` places N over it); N must divide by the axis."""
    n, p = x.shape[-2], mesh.shape[axis]
    if n % p != 0:
        raise ValueError(f"sequence {n} not divisible by axis {axis}={p}")
    c = n // p
    r = mesh.index(axis)
    return x[..., r * c:(r + 1) * c, :].contiguous()


def cp_attention(q, k, v, mesh, axis: str = "model", score_mode: str = "dot",
                 scale: Optional[float] = None):
    """(B, H, N / P, D) shards of q, k, v over ``axis`` -> this rank's
    (B, H, N / P, D) shard of the attention output (the JAX `cp_attention`,
    context_parallel.py:39-62): K/V gathered over the axis's group, the
    local queries through ``dispatch_attention`` (a plain version for cross
    shapes)."""
    from vitgan_tpu_torch.ops.attention import dispatch_attention

    scale_f = float(scale if scale is not None else q.shape[-1])
    p = mesh.shape[axis]
    if p == 1:
        return dispatch_attention(q, k, v, score_mode, scale_f)
    n = q.shape[-2] * p
    args = (2, n, mesh.group(axis), p, token_slice(n, mesh, axis))
    return dispatch_attention(q, _GatherKV.apply(k, *args), _GatherKV.apply(v, *args),
                              score_mode, scale_f)


class _Rotate(torch.autograd.Function):
    """Send to the next rank of the ring, receive from the previous one
    (both posted together, so that no rank waits on another's send);
    backward: the same the other way."""

    @staticmethod
    def forward(ctx, x, ranks, me, step):
        ctx.ranks, ctx.me, ctx.step = ranks, me, step
        return _shift(x, ranks, me, step)

    @staticmethod
    def backward(ctx, g):
        return _Rotate.apply(g, ctx.ranks, ctx.me, -ctx.step), None, None, None


def _shift(x, ranks, me: int, step: int) -> torch.Tensor:
    p = len(ranks)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(me + step) % p]),
           dist.P2POp(dist.irecv, out, ranks[(me - step) % p])]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


def _fold(q, scale: float, score_mode: str, m, l, o, kc, vc):
    """One K/V block into the online-softmax state (m, l, o), f32."""
    from vitgan_tpu_torch.ops.attention import _scores

    s = _scores(q, kc, scale, score_mode)
    m_new = torch.maximum(m, s.amax(-1))
    pr = torch.exp(s - m_new[..., None])
    o_blk = torch.einsum("bhnm,bhmd->bhnd", pr.to(q.dtype).float(), vc.float())
    alpha = torch.exp(m - m_new)
    return m_new, l * alpha + pr.sum(-1), o * alpha[..., None] + o_blk


def ring_cp_attention(q, k, v, mesh, axis: str = "model", score_mode: str = "dot",
                      scale: Optional[float] = None):
    """Ring-schedule context-parallel attention (the JAX `ring_cp_attention`,
    context_parallel.py:65-114): this rank's (B, H, N / P, D) shards in,
    its output shard out.  The K/V blocks rotate P - 1 times around the
    axis's ranks and are folded into an f32 online softmax (m, l, o), the
    flash kernel's streaming algebra: the result is exact, not an
    approximation."""
    scale_f = float(scale if scale is not None else q.shape[-1])
    p = mesh.shape[axis]
    b, h, nq, d = q.shape
    m = torch.full((b, h, nq), -math.inf, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, nq), dtype=torch.float32, device=q.device)  # noqa: E741
    o = torch.zeros((b, h, nq, d), dtype=torch.float32, device=q.device)
    group = mesh.group(axis)
    ranks = (dist.get_process_group_ranks(group) if p > 1 else [0])
    me = mesh.index(axis)
    kc, vc = k, v
    for step in range(p):
        m, l, o = checkpoint(_fold, q, scale_f, score_mode, m, l, o, kc, vc,  # noqa: E741
                             use_reentrant=False)
        if step + 1 < p:
            kc = _Rotate.apply(kc, ranks, me, 1)
            vc = _Rotate.apply(vc, ranks, me, 1)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
