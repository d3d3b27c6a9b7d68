"""Weight gradients of the megablock backward: dW = A^T . B and db = the
column sums of B over all rows.  The CUDA kernel (csrc/wgrad_gemm.cu), its
plain version, and the second-pass sum of per-tile partials (the kernel's
`sum_partials` entry).

Counterpart of the parameter-gradient sums of `_bwd_kernel` in
vitgan_tpu/ops/fused_block.py, which accumulate down the TPU's sequential
grid.  CUDA tensors launch the kernels (or raise); CPU tensors take the plain
versions.  Both kernel passes sum in a fixed order, so the results are
deterministic.
"""

from __future__ import annotations

import math

import torch

from vitgan_tpu_torch.ops import build

# Blocks to aim for (4 a streaming multiprocessor of an H100) when the rows
# are split over the grid.
TARGET_BLOCKS = 4 * 132


def wgrad_reference(a, b):
    """Plain version: (A^T . B, column sums of B), f32."""
    return a.float().T @ b.float(), b.float().sum(0)


def splits_for(m: int, ka: int, nb: int) -> int:
    """Row ranges for an (ka, nb) output over m rows: about TARGET_BLOCKS
    blocks, each range at least 256 rows."""
    tiles = math.ceil(ka / 64) * math.ceil(nb / 64)
    return max(1, min(math.ceil(TARGET_BLOCKS / tiles), math.ceil(m / 256)))


def wgrad_gemm(a, b):
    """Launch csrc/wgrad_gemm.cu: a (M, Ka), b (M, Nb) bf16 CUDA tensors ->
    (dW (Ka, Nb) f32, db (Nb,) f32).  The entry launches the product and then
    `sum_partials_kernel` twice; each launch is counted under its own name."""
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
    splits = splits_for(m, ka, nb)
    dw = torch.empty((ka, nb), dtype=torch.float32, device=dev)
    db = torch.empty((nb,), dtype=torch.float32, device=dev)
    scratch = torch.empty((splits * (ka * nb + nb),), dtype=torch.float32, device=dev)
    fn = build.entry("wgrad_gemm")
    build.check(fn, fn(build.ptr(a), build.ptr(b), build.ptr(dw), build.ptr(db),
                       build.ptr(scratch), m, ka, nb, splits, build.stream_ptr(dev)))
    build.LAUNCHES["wgrad_gemm"] += 1
    # the entry's second passes over the partials, one for dW and one for db
    build.LAUNCHES["sum_partials"] += 2
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
