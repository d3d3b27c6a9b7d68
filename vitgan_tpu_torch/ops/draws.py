"""The train step's random draws under data parallelism.

Every draw of the train step (dropout keep masks, DiffAugment, the data
flips, instance noise, WGAN-GP's mixing weights) goes through :func:`rand`,
:func:`randn` or :func:`randint`.  Inside :func:`global_rows` a draw whose
leading dimension counts samples is drawn at the global batch and this
rank's rows are kept, so that a rank draws what the single-device step
draws for the same samples, from the same generator state
(parallel/mesh.py).  A leading dimension of k local batches (D's
``[real; fake]`` forward) is k blocks of the global batch.  Outside the
context, or at one rank, a draw is ``torch.rand`` itself.

A pipelined block stack (parallel/pipeline.py) runs its blocks on
microbatches, rows of the step's batch: :func:`microbatch` says which, so
that the megablock's in-kernel dropout keys a microbatch's bits by the rows
they are in the whole batch (ops/fused_block.mask_rows).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch


@dataclass(frozen=True)
class RowMap:
    """This rank's samples: ``local`` rows from ``first`` in a global batch
    of ``global_``; ``group`` is the data axis's process group (or None at
    one rank without a group)."""

    local: int
    global_: int
    first: int
    group: object = None

    @property
    def identity(self) -> bool:
        return self.local == self.global_

    def global_index(self, n: int) -> List[int]:
        """The global rows of a local leading dimension ``n`` (k local blocks)."""
        if n % self.local:
            raise ValueError(f"a draw of leading dimension {n} is not a multiple of the local "
                             f"batch {self.local}")
        return [j * self.global_ + self.first + i for j in range(n // self.local)
                for i in range(self.local)]


_ROWS: Optional[RowMap] = None


def current() -> Optional[RowMap]:
    return _ROWS


@contextlib.contextmanager
def global_rows(rows: Optional[RowMap]) -> Iterator[None]:
    """Draws inside take ``rows`` of the global batch (None: no mapping)."""
    global _ROWS
    prev, _ROWS = _ROWS, rows
    try:
        yield
    finally:
        _ROWS = prev


_MICROBATCH: Optional[tuple] = None


def current_microbatch() -> Optional[tuple]:
    """(first row, rows of the whole local batch) of the running microbatch,
    or None."""
    return _MICROBATCH


@contextlib.contextmanager
def microbatch(first: int, total: int) -> Iterator[None]:
    """Blocks inside run on rows ``first``.. of a local batch of ``total``."""
    global _MICROBATCH
    prev, _MICROBATCH = _MICROBATCH, (int(first), int(total))
    try:
        yield
    finally:
        _MICROBATCH = prev


def _draw(kind, shape, generator, device, low=0, high=0):
    if kind == "rand":
        return torch.rand(shape, generator=generator, device=device)
    if kind == "randn":
        return torch.randn(shape, generator=generator, device=device)
    return torch.randint(low, high, shape, generator=generator, device=device)


def _mapped(kind, shape, generator, device, batched: bool, low=0, high=0):
    rows = _ROWS
    if not batched or rows is None or rows.identity:
        return _draw(kind, tuple(shape), generator, device, low, high)
    n = shape[0]
    full = _draw(kind, (n // rows.local * rows.global_, *shape[1:]), generator, device,
                 low, high)
    return full.index_select(0, row_index(rows, n, full.device))


_INDEX: dict = {}


def row_index(rows: RowMap, n: int, device) -> torch.Tensor:
    """The global rows of a local leading dimension ``n`` as a device
    tensor, made once (a captured step's eager first run makes it; the
    capture reads it)."""
    key = (rows.local, rows.global_, rows.first, n, str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.tensor(rows.global_index(n), device=device)
    return _INDEX[key]


def rand(shape, generator, device, batched: bool = True) -> torch.Tensor:
    """U[0, 1) f32; ``batched``: dimension 0 counts samples."""
    return _mapped("rand", shape, generator, device, batched)


def randn(shape, generator, device, batched: bool = True) -> torch.Tensor:
    return _mapped("randn", shape, generator, device, batched)


def randint(low: int, high: int, shape, generator, device, batched: bool = True):
    return _mapped("randint", shape, generator, device, batched, low, high)
