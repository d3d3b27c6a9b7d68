"""The device mesh: data, tensor, pipeline and sequence parallelism over
ranks, one process per device.

Counterpart of vitgan_tpu/parallel/mesh.py.  The JAX package drives all of a
host's devices from one controller and lets GSPMD insert the collectives.
The port runs one process per device instead (a deliberate departure,
ROADMAP.md queue 3): a :class:`Mesh` is this rank's place in a (data, model)
grid of ranks, or a (data, model, pipe) or (data, model, seq) one, with a
process group per axis, and the train step issues its collectives itself
(train/step.py, train/state.py, parallel/sharding.py, parallel/pipeline.py,
parallel/context_parallel.py):

- every rank takes its rows of the global batch (:func:`batch_rows`); its
  random draws are drawn at the global batch and sliced (ops/draws.py), so
  a rank's step on its rows is the single-device step on the global batch;
  the ranks of one pipe or seq group take the same rows;
- gradients are averaged over the data axis before the clip;
- batch-global terms (the diversity loss's pairs, BatchNorm's statistics,
  the minibatch-std feature, the metrics' means) are taken over the data
  axis (:func:`gather_rows`, :func:`all_reduce_sum`, both differentiable).

``make_mesh`` at one rank without a process group is a 1x1 mesh with no
groups, and the step then issues no collective at all.  No process group is
started at import: :func:`initialize_distributed` starts it when the
launcher's variables ask for one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
import torch.distributed as dist

from vitgan_tpu_torch.config import MeshConfig
from vitgan_tpu_torch.ops import draws

def initialize_distributed(device="cuda") -> bool:
    """Start the process group from the JAX package's variables: with
    ``COORDINATOR_ADDRESS`` (host:port of rank 0), ``NUM_PROCESSES`` and
    ``PROCESS_ID`` set, ``init_process_group`` over TCP, NCCL for ``cuda``
    (each process takes device ``LOCAL_RANK``, else PROCESS_ID modulo the
    visible cards) and gloo for ``cpu``.  Without ``COORDINATOR_ADDRESS`` it
    does nothing and returns False; a group already started is kept.  Any
    other failure raises: a rank that trains alone thinking it is one of
    many is the worst outcome."""
    if "COORDINATOR_ADDRESS" not in os.environ:
        return False
    if dist.is_initialized():
        return True
    missing = [k for k in ("NUM_PROCESSES", "PROCESS_ID") if k not in os.environ]
    if missing:
        raise RuntimeError(f"COORDINATOR_ADDRESS is set but {missing} are not: one process "
                           "per device needs the world size and this process's rank")
    world, rank = int(os.environ["NUM_PROCESSES"]), int(os.environ["PROCESS_ID"])
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=f"tcp://{os.environ['COORDINATOR_ADDRESS']}",
                            world_size=world, rank=rank)
    return True


@dataclass
class Mesh:
    """This rank's place in a (data, model) grid, or a (data, model, pipe)
    or (data, model, seq) one: with ``inner`` ranks on the third axis (1
    without one), rank r sits at data index r // (model * inner), model
    index (r // inner) % model and third-axis index r % inner (the JAX
    reshape(n // (mp * inner), mp, inner)).  ``data_group`` holds the ranks
    of this rank's other indices, ``model_group`` and ``pipe_group`` or
    ``seq_group`` likewise; all None without a process group.
    ``pipe_axis`` or ``seq_axis`` names the third axis."""

    shape: Dict[str, int]
    rank: int = 0
    data_group: object = None
    model_group: object = None
    axis_names: tuple = field(default=("data", "model"))
    pipe_axis: Optional[str] = None
    seq_axis: Optional[str] = None
    pipe_group: object = None
    seq_group: object = None

    @property
    def n_data(self) -> int:
        return self.shape[self.axis_names[0]]

    @property
    def n_model(self) -> int:
        return self.shape[self.axis_names[1]]

    @property
    def n_inner(self) -> int:
        return self.shape[self.axis_names[2]] if len(self.axis_names) > 2 else 1

    @property
    def n_pipe(self) -> int:
        return self.shape[self.pipe_axis] if self.pipe_axis else 1

    @property
    def n_seq(self) -> int:
        return self.shape[self.seq_axis] if self.seq_axis else 1

    @property
    def size(self) -> int:
        return self.n_data * self.n_model * self.n_inner

    @property
    def data_index(self) -> int:
        return self.rank // (self.n_model * self.n_inner)

    @property
    def model_index(self) -> int:
        return (self.rank // self.n_inner) % self.n_model

    @property
    def pipe_index(self) -> int:
        return self.rank % self.n_inner if self.pipe_axis else 0

    @property
    def seq_index(self) -> int:
        return self.rank % self.n_inner if self.seq_axis else 0

    def group(self, axis: str):
        """The process group of the axis named ``axis``."""
        return {self.axis_names[0]: self.data_group, self.axis_names[1]: self.model_group,
                self.pipe_axis: self.pipe_group, self.seq_axis: self.seq_group}[axis]

    def index(self, axis: str) -> int:
        """This rank's index on the axis named ``axis``."""
        return {self.axis_names[0]: self.data_index, self.axis_names[1]: self.model_index,
                self.pipe_axis: self.pipe_index, self.seq_axis: self.seq_index}[axis]

    def pipe_rank(self, stage: int) -> int:
        """The global rank of this rank's pipe group at ``stage``."""
        return self.rank - self.pipe_index + stage

    @property
    def distributed(self) -> bool:
        """True where the step issues collectives (a process group exists)."""
        return self.data_group is not None

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def make_mesh(cfg: MeshConfig = MeshConfig(), world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The (data, model) mesh over the process group's ranks (or over
    ``world_size`` ranks as a plan, without groups, where no group is
    started): ``model_parallel`` ranks on the model axis, the rest on data;
    ``pipeline_parallel`` or ``context_parallel`` above 1 adds the pipe or
    the seq axis innermost, as the JAX make_mesh does (mesh.py:53-85), with
    its errors.  One rank gives a 1x1 mesh.  Every rank of a group must call
    it (it makes the axes' subgroups)."""
    mp = max(1, cfg.model_parallel)
    pp = max(1, cfg.pipeline_parallel)
    sp = max(1, cfg.context_parallel)
    if sp > 1 and pp > 1:
        raise ValueError(
            "context_parallel does not compose with pipeline_parallel: the "
            "pipeline shard_map owns the block stack the sequence sharding "
            "would constrain (pick one)")
    grouped = dist.is_initialized()
    n = dist.get_world_size() if grouped else (world_size or 1)
    r = dist.get_rank() if grouped else (rank or 0)
    if n % (mp * pp * sp) != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={mp} x "
                         f"pipeline_parallel={pp} x context_parallel={sp}")
    inner = pp * sp
    nd = n // (mp * inner)
    names = (cfg.data_axis, cfg.model_axis)
    kw = {}
    if sp > 1:
        names, kw = names + (cfg.seq_axis,), {"seq_axis": cfg.seq_axis}
    elif pp > 1:
        names, kw = names + (cfg.pipe_axis,), {"pipe_axis": cfg.pipe_axis}
    shape = {cfg.data_axis: nd, cfg.model_axis: mp}
    if inner > 1:
        shape[names[2]] = inner
    mesh = Mesh(shape, rank=r, axis_names=names, **kw)
    if grouped:
        at = lambda d, m, i: (d * mp + m) * inner + i  # noqa: E731
        # every rank makes every group, in one order
        for m in range(mp):
            for i in range(inner):
                g = _group([at(d, m, i) for d in range(nd)], n)
                if (m, i) == (mesh.model_index, mesh.rank % inner):
                    mesh.data_group = g
        for d in range(nd):
            for i in range(inner):
                g = _group([at(d, m, i) for m in range(mp)], n)
                if (d, i) == (mesh.data_index, mesh.rank % inner):
                    mesh.model_group = g
        if inner > 1:
            for d in range(nd):
                for m in range(mp):
                    g = _group([at(d, m, i) for i in range(inner)], n)
                    if (d, m) == (mesh.data_index, mesh.model_index):
                        if pp > 1:
                            mesh.pipe_group = g
                        else:
                            mesh.seq_group = g
    return mesh


def _group(ranks, world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def batch_rows(mesh: Mesh, global_batch: int) -> tuple:
    """(first, local): this rank's rows of a global batch, the data axis's
    share (the counterpart of ``batch_sharding``)."""
    if global_batch % mesh.n_data:
        raise ValueError(f"global batch {global_batch} not divisible by data axis "
                         f"{mesh.n_data}")
    local = global_batch // mesh.n_data
    return mesh.data_index * local, local


def shard_batch(mesh: Mesh, batch):
    """This rank's rows (dimension 0) of a global batch, numpy or torch."""
    first, local = batch_rows(mesh, batch.shape[0])
    return batch[first:first + local]


def local_row_map(mesh: Optional[Mesh], local: int) -> Optional[draws.RowMap]:
    """The draws' row map (ops/draws.py) of a rank whose step holds ``local``
    rows; None without a mesh or collectives."""
    if mesh is None or not mesh.distributed:
        return None
    return draws.RowMap(local, local * mesh.n_data, mesh.data_index * local, mesh.data_group)


def local_batch_size(global_batch: int, mesh: Mesh,
                     process_count: Optional[int] = None) -> int:
    """Per-process slice of the global batch (vitgan_tpu/parallel/mesh.py:
    113-128): the global batch must divide by the data axis (sharding) and
    by the process count (loading)."""
    n_data = mesh.n_data
    pc = process_count if process_count is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if global_batch % n_data != 0:
        raise ValueError(f"global batch {global_batch} not divisible by data axis {n_data}")
    if global_batch % pc != 0:
        raise ValueError(f"global batch {global_batch} not divisible by process count {pc}")
    return global_batch // pc


# --- collectives -------------------------------------------------------------


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """out (n * len(inp), ...) = the group's inputs stacked along dim 0."""
    fn = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    fn(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """out = this rank's block of dim 0 of the group's summed inputs."""
    fn = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def average_(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` in place: the group's mean.  NCCL averages in the collective
    (ReduceOp.AVG, which at one rank still launches its kernel); gloo, which
    has no AVG, sums and divides."""
    if dist.get_backend(group) == "nccl":
        dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
        return t
    dist.all_reduce(t, group=group)
    return t.div_(float(dist.get_world_size(group)))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        all_gather_into(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        out = grad.new_empty((grad.shape[0] // n, *grad.shape[1:]))
        reduce_scatter_into(out, grad.contiguous(), ctx.group)
        return out, None


def gather_rows(x: torch.Tensor, rows: Optional[draws.RowMap]) -> torch.Tensor:
    """The global batch of a per-rank tensor (rows stacked in rank order),
    differentiable: the backward sums every rank's gradient into the
    owner's rows, which, with the gradients averaged over the data axis, is
    the gradient of the term taken once over the global batch."""
    if rows is None or rows.identity:
        return x
    return _GatherRows.apply(x, rows.group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, rows: Optional[draws.RowMap]) -> torch.Tensor:
    """The data axis's sum of ``x``, differentiable (identity at one rank)."""
    if rows is None or rows.identity:
        return x
    return _AllReduceSum.apply(x, rows.group)


def mean_over(x: torch.Tensor, group) -> torch.Tensor:
    """The group's mean of ``x`` (a new tensor, no autograd); ``x`` itself
    without a group."""
    if group is None:
        return x
    return average_(x.clone(), group)
