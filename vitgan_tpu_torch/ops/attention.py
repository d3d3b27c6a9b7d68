"""Flash attention (`dot` scores): the CUDA kernel, its plain version, routing.

Counterpart of vitgan_tpu/ops/attention.py.  ``flash_attention`` launches
csrc/flash_attn_fwd.cu on CUDA tensors and takes ``attention_reference`` on
CPU tensors; ``dispatch_attention`` chooses between the two by policy.  The
kernel is forward-only: the backward kernels and the ``l2``/``l2ref`` score
modes belong to the training slice (ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda

MAX_HEAD_DIM = 128   # the kernel pads Dh to a multiple of 16 up to this
MAX_BATCH_HEADS = 65535  # CUDA grid.y limit


def _check_mode(score_mode: str) -> None:
    if score_mode != "dot":
        raise NotImplementedError(
            f"score_mode {score_mode!r}: only 'dot' is ported; 'l2'/'l2ref' "
            "are listed in ROADMAP.md")


def attention_reference(q, k, v, score_mode: str = "dot", scale: Optional[float] = None):
    """Plain attention, (B, H, N, D) -> (B, H, N, D): f32 scores and softmax,
    probabilities cast to the input dtype before P.V, as the JAX reference."""
    _check_mode(score_mode)
    scale = float(scale if scale is not None else q.shape[-1])
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) / math.sqrt(scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(q.dtype)


def kernel_fits(head_dim: int, batch_heads: int) -> bool:
    """Dh <= 128 and a multiple of 8 (16-byte copies), B*H <= 65535."""
    return head_dim <= MAX_HEAD_DIM and head_dim % 8 == 0 and batch_heads <= MAX_BATCH_HEADS


def flash_forward(q, k, v, scale: float, out: Optional[torch.Tensor] = None):
    """Launch the kernel: q, k, v (B, H, N, D) bf16 contiguous CUDA tensors.

    Returns (o, lse): o (B, H, N, D) and the f32 log-sum-exp (B, H, N).  With
    ``out`` given, o is written there in the (B, N, H*D) layout instead (the
    megablock's out-projection input) and ``out`` is returned as o."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_forward launches a CUDA kernel: q, k, v must be CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}; "
                        "other dtypes are ROADMAP.md queue 1 item 7 (or set "
                        "runtime.use_pallas=never)")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"q, k, v must share one (B, H, N, D) shape: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    b, h, n, d = q.shape
    if not kernel_fits(d, b * h):
        raise ValueError(f"flash kernel takes D <= {MAX_HEAD_DIM}, a multiple of 8, and "
                         f"B*H <= {MAX_BATCH_HEADS}, got D={d}, B*H={b * h}; other shapes are "
                         "ROADMAP.md queue 1 item 7")
    if out is None:
        o = torch.empty_like(q)
    else:
        if out.shape != (b, n, h * d) or out.dtype != q.dtype or not out.is_contiguous():
            raise ValueError(f"out must be a contiguous bf16 ({b}, {n}, {h * d}) tensor")
        o = out
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    q, k, v = build.aligned16(q), build.aligned16(k), build.aligned16(v)
    fn = build.entry("flash_attn_fwd")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), build.ptr(lse),
                       b * h, n, d, h, 1.0 / math.sqrt(scale), int(out is not None),
                       build.stream_ptr(q.device)))
    build.LAUNCHES["flash_attn_fwd"] += 1
    return o, lse


def flash_attention(q, k, v, score_mode: str = "dot", scale: Optional[float] = None):
    """(B, H, N, D) q/k/v -> (B, H, N, D) attention output.

    CUDA tensors launch the kernel (or raise); CPU tensors take
    :func:`attention_reference`."""
    _check_mode(score_mode)
    scale = float(scale if scale is not None else q.shape[-1])
    if q.device.type == "cpu":
        return attention_reference(q, k, v, score_mode, scale)
    return flash_forward(q, k, v, scale)[0]


def use_flash_attention(q, seq_len: int) -> bool:
    """'always'/'never' force; 'auto' takes the kernel for CUDA tensors at
    sequences of at least ``min_seq_len`` (the JAX package's TPU threshold,
    not yet measured on the GPU).  A dtype or shape the kernel does not take
    raises in :func:`flash_forward`; it is never sent to the plain version."""
    mode = _POLICY["mode"]
    if mode == "never":
        return False
    if mode == "always":
        return True
    return on_cuda(q) and seq_len >= _POLICY["min_seq_len"]


def dispatch_attention(q, k, v, score_mode: str, scale: float):
    """Policy-routed attention: the flash kernel or the plain version.
    Cross-attention shapes (nq != nk) take the plain version."""
    if q.shape[-2] == k.shape[-2] and use_flash_attention(q, q.shape[-2]):
        return flash_attention(q, k, v, score_mode, scale)
    return attention_reference(q, k, v, score_mode, scale)
