"""Placement plans: tensor parallelism over the model axis and fully-sharded
data parallelism over the data axis, per ``state_dict`` name.

Counterpart of vitgan_tpu/parallel/sharding.py.  The rules are the JAX
package's, matched on the port's names (the JAX tree's paths joined by '.',
weights.from_jax_tree):

- ``qkv`` (3, H, E, Dh) and ``qkv_b`` (3, H, Dh): the heads H on ``model``;
- the ISR state ``isr.sigma0`` (3, H) and ``isr.u`` (3, H, E): heads too;
- ``out.w`` (H*Dh, E) and ``fc2.w`` (hidden, E): the rows on ``model``;
- ``fc1.w`` (E, hidden) and ``fc1.b``: the hidden columns on ``model``;
- everything else replicated; a rule whose axis does not divide its
  dimension falls back to replicated.  FSDP then gives the data axis to the
  largest still-free dimension that it divides, for leaves of at least
  ``fsdp_min_size`` elements.

A plan is a tuple per leaf, one entry per dimension: None or an axis name
(the JAX ``PartitionSpec`` padded to the leaf's rank).  :class:`Placement`
carries a plan out over one network's parameters for one rank
(:func:`shard_train_state`): each rank stores its slice of every sharded
parameter and of both Adam moments (the optimizer steps the slices,
train/state.Optimizer), gathers the full parameters after each update into
the module's own tensors, which the forward reads whatever the layout (so
that a kernel block sees whole weights and no layout changes which kernels
launch, as GSPMD gathers around a ``pallas_call``), and reduces the full
gradients to its slices: averaged over the data axis (reduce-scattered
where the data axis shards the leaf) and cut along the model axis (every
rank of a model group computes the same full gradient: the plain route
does not split heads).  The clip's global norm takes each leaf's norm over
the ranks that split it, then the norm over the leaves as without a mesh.
Under a pipe axis a stage holds only its blocks' leaves, and under a seq
axis the blocks' gradients are summed over it (:class:`Placement`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from vitgan_tpu_torch.parallel.mesh import Mesh, all_gather_into, average_, reduce_scatter_into

Spec = tuple


def _spec_for(name: str, ndim: int) -> Spec:
    """The TP rule of the leaf ``name`` (vitgan_tpu/parallel/sharding.py:27-46)."""
    names = name.split(".")
    rep = (None,) * ndim
    if names[-1] == "qkv" and ndim == 4:
        return (None, "model", None, None)
    if names[-1] == "qkv_b" and ndim == 3:
        return (None, "model", None)
    if "isr" in names and names[-1] in ("sigma0", "u"):
        return (None, "model") if ndim == 2 else (None, "model", None)
    if len(names) >= 2 and names[-2] == "out" and names[-1] == "w" and ndim == 2:
        return ("model", None)
    if len(names) >= 2 and names[-2] == "fc1" and ndim == 2:
        return (None, "model")
    if len(names) >= 2 and names[-2] == "fc1" and names[-1] == "b" and ndim == 1:
        return ("model",)
    if len(names) >= 2 and names[-2] == "fc2" and names[-1] == "w" and ndim == 2:
        return ("model", None)
    return rep


def _divisible(shape: Sequence[int], spec: Spec, sizes: Dict[str, int]) -> bool:
    return all(a is None or shape[d] % sizes[a] == 0 for d, a in enumerate(spec))


def _fsdp_extend(shape: Sequence[int], spec: Spec, sizes: Dict[str, int], data_axis: str,
                 min_size: int) -> Spec:
    """The data axis on the largest free dimension it divides
    (vitgan_tpu/parallel/sharding.py:78-92); leaves under ``min_size``
    elements and scalars keep ``spec``."""
    n = sizes.get(data_axis, 1)
    numel = 1
    for s in shape:
        numel *= s
    if n <= 1 or not shape or numel < min_size:
        return spec
    dims = list(spec)
    for i in sorted(range(len(shape)), key=lambda i: -shape[i]):
        if dims[i] is None and shape[i] % n == 0:
            dims[i] = data_axis
            return tuple(dims)
    return spec


def placement_specs(shapes: Dict[str, Sequence[int]], sizes: Dict[str, int],
                    tensor_parallel: bool, fsdp_axis: Optional[str],
                    min_size: int = 2048) -> Dict[str, Spec]:
    """One rule set for every placement: the TP spec (when enabled and
    divisible), extended by FSDP over ``fsdp_axis``."""
    out = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        spec = _spec_for(name, len(shape)) if tensor_parallel else (None,) * len(shape)
        if any(spec) and not _divisible(shape, spec, sizes):
            spec = (None,) * len(shape)
        if fsdp_axis:
            spec = _fsdp_extend(shape, spec, sizes, fsdp_axis, min_size)
        out[name] = spec
    return out


def tp_specs(shapes: Dict[str, Sequence[int]], sizes: Dict[str, int]) -> Dict[str, Spec]:
    """The TP plan (``tp_shardings``)."""
    return placement_specs(shapes, sizes, True, None)


def fsdp_specs(shapes: Dict[str, Sequence[int]], sizes: Dict[str, int],
               tensor_parallel: bool = False, data_axis: str = "data",
               min_size: int = 2048) -> Dict[str, Spec]:
    """The FSDP plan, composed with TP (``fsdp_shardings``)."""
    return placement_specs(shapes, sizes, tensor_parallel, data_axis, min_size)


def train_state_specs(shapes: Dict[str, Sequence[int]], mesh: Mesh,
                      tensor_parallel: bool = False, fsdp: bool = False,
                      fsdp_min_size: int = 2048) -> Dict[str, Spec]:
    """The plan ``shard_train_state`` carries out (sharding.py:120-137): TP
    only where the model axis is above 1, FSDP only where the data axis is."""
    use_tp = tensor_parallel and mesh.n_model > 1
    use_fsdp = fsdp and mesh.n_data > 1
    specs = placement_specs(shapes, {"data": mesh.n_data, "model": mesh.n_model}, use_tp,
                            "data" if use_fsdp else None, fsdp_min_size)
    # the rules name the JAX axes; a mesh may rename them
    data_axis, model_axis = mesh.axis_names[:2]
    rename = {"model": model_axis, "data": data_axis}
    return {k: tuple(rename.get(a, a) if a else None for a in s) for k, s in specs.items()}


class Placement:
    """A plan carried out over one network's parameters for this rank.

    Under a pipe axis (parallel/pipeline.py) each block's leaves are held by
    one stage (``owners``, the stage or None for a leaf every stage holds):
    this rank steps only the leaves it holds, whose gradients it averages
    over the data group alone; the leaves every stage holds (embeddings,
    heads, final LN) are averaged over the data and the pipe groups, so that
    the pipe replicas stay equal.  Under a seq axis (parallel/
    context_parallel.py) the blocks' gradients, taken on this rank's tokens,
    are summed over the seq group and the others, taken on the whole
    sequence, averaged.  ``shapes`` are the leaves' full shapes (a leaf of
    another stage is an empty tensor here)."""

    def __init__(self, mesh: Mesh, named: Sequence[tuple], specs: Dict[str, Spec],
                 owners: Optional[Sequence[Optional[int]]] = None,
                 shapes: Optional[Sequence[tuple]] = None):
        self.mesh = mesh
        data_axis, model_axis = mesh.axis_names[:2]
        self.params = [p for _, p in named]
        self.names = [name for name, _ in named]
        self.owners = list(owners) if owners is not None else [None] * len(self.params)
        self.shapes = [tuple(s) for s in shapes] if shapes is not None else [
            tuple(p.shape) for p in self.params]
        self.held = [o is None or o == mesh.pipe_index for o in self.owners]
        self.dims = []  # per leaf: (data dim or None, model dim or None)
        for (name, p), held in zip(named, self.held):
            spec = specs.get(name, (None,) * p.dim()) if held else ()
            dd = spec.index(data_axis) if data_axis in spec else None
            md = spec.index(model_axis) if model_axis in spec else None
            self.dims.append((dd, md))
        with torch.no_grad():
            self.shards = [p if dd is None and md is None else
                           torch.nn.Parameter(self.cut(p.detach(), i).clone())
                           for i, (p, (dd, md)) in enumerate(zip(self.params, self.dims))]
        staged = [o is not None and mesh.n_pipe > 1 for o in self.owners]
        self.sharded = any(dd is not None or md is not None for dd, md in self.dims) or any(staged)
        # the seq axis: the blocks' gradients are summed over it
        self.seq_sum = [name.startswith("blocks.") for name in self.names]
        # the leaves whose norms are split over each combination of the data
        # and model axes, then those held by one stage (the same leaves on
        # every pipe rank, so that the pipe group's reduction matches), as
        # index tensors made here (a captured step reads them)
        split = {}
        for i, (dd, md) in enumerate(self.dims):
            axes = tuple(a for a, on in (("data", dd is not None), ("model", md is not None))
                         if on)
            if axes:
                split.setdefault(axes, []).append(i)
        if any(staged):
            split[("pipe",)] = [i for i, st in enumerate(staged) if st]
        device = self.params[0].device
        self._split_by_axes = [(axes, torch.tensor(idx, device=device))
                               for axes, idx in sorted(split.items(), key=lambda kv: (
                                   kv[0] == ("pipe",), kv[0]))]

    def _group(self, axis: str):
        m = self.mesh
        return {"data": m.data_group, "model": m.model_group, "pipe": m.pipe_group}[axis]

    def split(self, i: int) -> bool:
        """Whether leaf i is stored other than whole here (sliced, or held by
        one stage)."""
        return self.shards[i] is not self.params[i] or (self.owners[i] is not None
                                                        and self.mesh.n_pipe > 1)

    # -- slicing ---------------------------------------------------------------

    def cut(self, full: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of leaf i's full-shape tensor (a view; empty for
        a leaf of another stage)."""
        if not self.held[i]:
            return full.reshape(-1)[:0]
        dd, md = self.dims[i]
        m = self.mesh
        if md is not None:
            full = full.chunk(m.n_model, md)[m.model_index]
        if dd is not None:
            full = full.chunk(m.n_data, dd)[m.data_index]
        return full

    def gather(self, shard: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's full tensor from every rank's slice (a collective)."""
        dd, md = self.dims[i]
        out = shard
        if dd is not None:
            out = _gather_dim(out, dd, self.mesh.n_data, self.mesh.data_group)
        if md is not None:
            out = _gather_dim(out, md, self.mesh.n_model, self.mesh.model_group)
        return self.from_stage(out, i)

    def from_stage(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's whole tensor on every pipe rank, broadcast from the stage
        that holds it (``t`` itself for a leaf every stage holds)."""
        return stage_broadcast(t, self.owners[i], self.shapes[i], self.mesh)

    # -- the step's collectives ------------------------------------------------

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Full gradients (identical across the model axis) -> this rank's
        slices, averaged over the data axis: one all-reduce of the leaves
        the data axis does not split, one reduce-scatter of those it does;
        then the pipe and seq reductions (class docstring)."""
        m = self.mesh
        n = float(m.n_data)
        out: List[Optional[torch.Tensor]] = [g if not h else None
                                             for g, h in zip(grads, self.held)]
        whole = [i for i, (dd, _) in enumerate(self.dims) if dd is None and self.held[i]]
        split = [i for i, (dd, _) in enumerate(self.dims) if dd is not None]
        if whole:
            flat = average_(torch.cat([grads[i].reshape(-1) for i in whole]), m.data_group)
            for i, part in zip(whole, flat.split([grads[i].numel() for i in whole])):
                out[i] = self.cut(part.view_as(grads[i]), i)
        if split:
            # each leaf's data-axis blocks, rank-major, model slice first
            blocks = []
            for i in split:
                dd, md = self.dims[i]
                g = grads[i]
                if md is not None:
                    g = g.chunk(m.n_model, md)[m.model_index]
                blocks.append(_blocks(g, dd, m.n_data))
            send = torch.cat(blocks, 1).contiguous().reshape(-1)
            recv = send.new_empty(send.numel() // m.n_data)
            reduce_scatter_into(recv, send, m.data_group)
            recv = recv / n
            for i, part in zip(split, recv.split([b.shape[1] for b in blocks])):
                out[i] = part.reshape(self.shards[i].shape)
        if m.n_pipe > 1:
            _reduce(out, [i for i, o in enumerate(self.owners) if o is None], m.pipe_group,
                    mean=True)
        if m.n_seq > 1:
            _reduce(out, [i for i, s in enumerate(self.seq_sum) if not s], m.seq_group,
                    mean=True)
            _reduce(out, [i for i, s in enumerate(self.seq_sum) if s], m.seq_group,
                    mean=False)
        return out

    def reload(self) -> None:
        """Cut the slices again from the module's tensors (after a restore)."""
        with torch.no_grad():
            for i, (p, s) in enumerate(zip(self.params, self.shards)):
                if s is not p:
                    s.copy_(self.cut(p.detach(), i))

    def gather_params(self) -> None:
        """Write the full parameters into the module's tensors from the
        updated slices."""
        if not any(s is not p for s, p in zip(self.shards, self.params)):
            return
        with torch.no_grad():
            for i, (p, s) in enumerate(zip(self.params, self.shards)):
                if s is not p:
                    dd, md = self.dims[i]
                    out = s.detach()
                    if dd is not None:
                        out = _gather_dim(out, dd, self.mesh.n_data, self.mesh.data_group)
                    if md is not None:
                        out = _gather_dim(out, md, self.mesh.n_model, self.mesh.model_group)
                    p.copy_(out)

    def leaf_norms(self, parts: torch.Tensor, squared: bool) -> torch.Tensor:
        """Each leaf's whole-leaf value from this rank's slice values
        (``parts``, one a leaf): squared norms are summed over the axes that
        split a leaf (a leaf of one stage has none elsewhere); norms are
        squared, summed and rooted (at one rank, sqrt(x * x) is x, so the
        values stay those of the unsplit leaves)."""
        out = parts.clone()
        for axes, sel in self._split_by_axes:
            v = out.index_select(0, sel)
            v = v if squared else v * v
            for axis in axes:
                dist.all_reduce(v, group=self._group(axis))
            out = out.index_copy(0, sel, v if squared else torch.sqrt(v))
        return out

    # -- the module's state ------------------------------------------------------

    def module_state(self, sd: Dict[str, torch.Tensor], depth: int,
                     shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
        """A module's state_dict with every stage's leaves (a collective over
        the pipe group); ``shapes`` are the entries' full shapes."""
        if self.mesh.n_pipe == 1:
            return sd
        from vitgan_tpu_torch.parallel.pipeline import stage_of

        return {k: stage_broadcast(v, stage_of(k, depth, self.mesh.n_pipe), shapes[k], self.mesh)
                for k, v in sd.items()}

    def held_state(self, sd: Dict[str, torch.Tensor], own: Dict[str, torch.Tensor],
                   depth: int) -> Dict[str, torch.Tensor]:
        """A whole state_dict ``sd`` cut to what this rank holds (``own``, the
        module's state_dict, gives the other stages' empty tensors)."""
        if self.mesh.n_pipe == 1:
            return sd
        from vitgan_tpu_torch.parallel.pipeline import held

        return {k: v if held(k, depth, self.mesh) else own[k] for k, v in sd.items()}


def stage_broadcast(t: torch.Tensor, owner: Optional[int], shape: tuple, mesh: Mesh):
    """``t`` from the pipe rank of stage ``owner`` on every pipe rank (a
    tensor of ``shape``); ``t`` itself where ``owner`` is None or there is
    one stage."""
    if owner is None or mesh.n_pipe == 1:
        return t
    out = t.contiguous() if mesh.pipe_index == owner else t.new_empty(shape)
    dist.broadcast(out, mesh.pipe_rank(owner), group=mesh.pipe_group)
    return out


def _reduce(out: List[torch.Tensor], idx: List[int], group, mean: bool) -> None:
    """``out[i]`` for i in ``idx`` all-reduced over ``group`` in one flat
    tensor (summed, or averaged)."""
    if not idx:
        return
    flat = torch.cat([out[i].reshape(-1) for i in idx])
    if mean:
        average_(flat, group)
    else:
        dist.all_reduce(flat, group=group)
    for i, part in zip(idx, flat.split([out[i].numel() for i in idx])):
        out[i] = part.view_as(out[i])


def _blocks(g: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """(n, numel / n): row r is the r-th block of ``g`` along ``dim``, flat."""
    return torch.stack([c.reshape(-1) for c in g.chunk(n, dim)])


def _gather_dim(shard: torch.Tensor, dim: int, n: int, group) -> torch.Tensor:
    """The full tensor along ``dim`` from the group's n slices (rank order)."""
    flat = shard.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    all_gather_into(out, flat, group)
    return torch.cat([c.reshape(shard.shape) for c in out.chunk(n)], dim)


def shard_train_state(state, mesh: Mesh, tensor_parallel: bool = False, fsdp: bool = False,
                      fsdp_min_size: int = 2048):
    """Place a train state under the plan (train_state_specs).  Returns the
    plans by network."""
    plans = {net: train_state_specs({k: tuple(p.shape) for k, p in
                                     getattr(state, net).named_parameters()},
                                    mesh, tensor_parallel, fsdp, fsdp_min_size)
             for net in ("g", "d")}
    place_train_state(state, mesh, plans)
    return plans


def place_train_state(state, mesh: Mesh, plans: Dict[str, Dict[str, Spec]]) -> None:
    """Both optimizers take a :class:`Placement` of their network under
    ``plans`` (by network, on the mesh's axis names); D's ISR buffers stay
    whole (they are never trained; the plan names them for the JAX
    package's layout only).  Under a pipe axis each stage keeps only its
    blocks: the other stages' parameters, buffers and EMA entries are freed
    here (parallel/pipeline.free_other_stages), and the state records the
    full shapes that a checkpoint gathers to (train/state.TrainState)."""
    from vitgan_tpu_torch.parallel.pipeline import module_depth, stage_of

    for net, opt in (("g", state.g_opt), ("d", state.d_opt)):
        module = getattr(state, net)
        named = list(module.named_parameters())
        depth = module_depth(module)
        owners = [stage_of(name, depth, mesh.n_pipe) if mesh.n_pipe > 1 else None
                  for name, _ in named]
        shapes = [tuple(p.shape) for _, p in named]
        state.full_shapes[net] = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        if mesh.n_pipe > 1:
            from vitgan_tpu_torch.parallel.pipeline import free_other_stages

            free_other_stages(module, mesh)
            if net == "g" and state.g_ema is not None:
                for i, o in enumerate(owners):
                    if o is not None and o != mesh.pipe_index:
                        state.g_ema[i] = state.g_ema[i].new_empty((0,))
        opt.place(Placement(mesh, named, plans[net], owners, shapes))
