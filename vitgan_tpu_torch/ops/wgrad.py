"""Weight gradients of the megablock backward: dW = A^T . B and db = the
column sums of B over all rows.  The CUDA kernel (csrc/wgrad_gemm.cu), its
plain version, the planning of its row splits, and the second-pass sum of
per-tile partials (the kernel's `sum_partials` entry).

Counterpart of the parameter-gradient sums of `_bwd_kernel` in
vitgan_tpu/ops/fused_block.py, which accumulate down the TPU's sequential
grid.  CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions.  Every pass sums in a fixed order, so the results are
deterministic.
"""

from __future__ import annotations

import functools
import math

import torch

from vitgan_tpu_torch.ops import build

TILE = 128        # output rows and columns of one block of the kernel
STAGE_ROWS = 64   # rows of A and B a pipeline stage holds
SMS = 132         # streaming multiprocessors of an H100 SXM; the wrapper reads the card's
# The planning model's costs in units of one stage of one block (a 128 x 128
# x 64 product): a block's fixed cost (barrier set-up, pipeline fill,
# epilogue), and the f32 partial elements a split adds (written, then read by
# the second pass) per such unit.  Estimates, held to a sweep of
# rows_per_split on the card by scripts/kernel_ab.py --splits (PERF.md).
BLOCK_OVERHEAD_STAGES = 8
PARTIALS_PER_STAGE = 2 ** 18
MAX_SPLITS = 256


def wgrad_reference(a, b):
    """Plain version: (A^T . B, column sums of B), f32."""
    return a.float().T @ b.float(), b.float().sum(0)


def row_tiles(ka: int) -> int:
    """Output-row tiles of the kernel's grid: its db partials per split."""
    return math.ceil(ka / TILE)


@functools.lru_cache(maxsize=None)
def plan(m: int, ka: int, nb: int, sms: int = SMS) -> int:
    """rows_per_split for an (ka, nb) output over m rows.

    The rows are cut into ranges of whole 64-row stages, one grid z index
    each: the C entry takes rows_per_split and sums rows [s * rows_per_split,
    min(m, (s + 1) * rows_per_split)) in split s < ceil(m / rows_per_split).  One block a streaming multiprocessor runs at a time, so a plan
    takes ceil(tiles * splits / sms) waves of rows_per_split / 64 stages each;
    it is chosen to minimise that, plus a block's fixed cost per wave and the
    partials' traffic per split.  Cached: a train step asks for the same few
    shapes every block."""
    tiles = row_tiles(ka) * math.ceil(nb / TILE)
    stages = max(1, math.ceil(m / STAGE_ROWS))
    best = None
    for want in range(1, min(stages, MAX_SPLITS) + 1):
        rps = math.ceil(stages / want) * STAGE_ROWS
        splits = max(1, math.ceil(m / rps))
        waves = math.ceil(tiles * splits / sms)
        cost = (waves * (rps // STAGE_ROWS + BLOCK_OVERHEAD_STAGES)
                + splits * ka * nb / PARTIALS_PER_STAGE)
        if best is None or cost < best[0]:
            best = (cost, rps)
    return best[1]


def scratch_floats(m: int, ka: int, nb: int, rows_per_split: int) -> int:
    """f32 elements of the kernel's scratch: splits dW partials of ka * nb,
    then splits * row_tiles(ka) db partials of nb (the C entry's layout)."""
    splits = max(1, math.ceil(m / rows_per_split))
    return splits * ka * nb + splits * row_tiles(ka) * nb


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_gemm(a, b):
    """Launch csrc/wgrad_gemm.cu: a (M, Ka), b (M, Nb) bf16 CUDA tensors ->
    (dW (Ka, Nb) f32, db (Nb,) f32).  The entry launches the product over
    :func:`plan`'s row splits and then `wgrad_reduce_kernel`, the one fixed-
    order sum of the dW and db partials; a call counts one launch."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("wgrad_gemm launches a CUDA kernel: a and b must be CUDA tensors")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"wgrad_gemm takes bf16 operands, got {a.dtype}, {b.dtype}; other "
                        "dtypes are ROADMAP.md queue 1 item 7")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"wgrad_gemm: a {tuple(a.shape)} and b {tuple(b.shape)} must be 2-D "
                         "with the same rows")
    m, ka = a.shape
    nb = b.shape[1]
    if ka % 8 or nb % 8:
        raise ValueError(f"wgrad_gemm takes widths that are multiples of 8, got {ka}, {nb}; "
                         "other shapes are ROADMAP.md queue 1 item 7")
    dev = a.device
    a, b = build.aligned16(a.contiguous()), build.aligned16(b.contiguous())
    rps = plan(m, ka, nb, _sm_count(dev))
    dw = torch.empty((ka, nb), dtype=torch.float32, device=dev)
    db = torch.empty((nb,), dtype=torch.float32, device=dev)
    scratch = torch.empty((scratch_floats(m, ka, nb, rps),), dtype=torch.float32, device=dev)
    fn = build.entry("wgrad_gemm")
    build.check(fn, fn(build.ptr(a), build.ptr(b), build.ptr(dw), build.ptr(db),
                       build.ptr(scratch), m, ka, nb, rps, build.stream_ptr(dev)))
    if m:  # no rows: the entry zeroes dW and db and launches nothing
        build.LAUNCHES["wgrad_gemm"] += 1
    return dw, db


def wgrad(a, b):
    """The kernel for CUDA tensors (or raise), the plain version for CPU ones."""
    if a.device.type == "cpu":
        return wgrad_reference(a, b)
    return wgrad_gemm(a, b)


def sum_partials(part):
    """(S, C) f32 partials -> (C,) f32 sums over S in order: the kernel for a
    CUDA tensor, ``part.sum(0)`` for a CPU one."""
    if part.device.type == "cpu":
        return part.sum(0)
    if part.dtype != torch.float32 or part.dim() != 2:
        raise ValueError(f"sum_partials takes a 2-D f32 tensor, got {part.dtype} "
                         f"{tuple(part.shape)}")
    part = part.contiguous()
    out = torch.empty((part.shape[1],), dtype=torch.float32, device=part.device)
    fn = build.entry("sum_partials")
    build.check(fn, fn(build.ptr(part), build.ptr(out), part.shape[0], part.shape[1],
                       build.stream_ptr(part.device)))
    build.LAUNCHES["sum_partials"] += 1
    return out
