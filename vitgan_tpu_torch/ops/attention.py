"""Flash attention (`dot`, `l2` and `l2ref` scores): the CUDA kernels, their
plain versions, routing.

Counterpart of vitgan_tpu/ops/attention.py.  ``flash_attention`` is a
``torch.autograd.Function``: its forward launches csrc/flash_attn_fwd.cu and
saves q, k, v, o and the natural-log LSE, as the JAX `_fwd` does
(attention.py:846-858); its backward launches csrc/flash_attn_bwd_fused.cu or
csrc/flash_attn_bwd_dq.cu then csrc/flash_attn_bwd_dkv.cu, on the route the
JAX package's `_flash_backward` takes (:func:`backward_route`).  CPU tensors
take the plain version of each kernel instead.  ``dispatch_attention``
chooses between the kernels, the plain attention and the chunked plain
attention by policy.

Score modes (attention.py:50-61, layers.py:268-290), with inv = 1/sqrt(scale):
``dot`` inv * q.k; ``l2`` -inv * d2 and ``l2ref`` inv * sqrt(d2 + 1e-12), where
d2 = max(|q|^2 + |k|^2 - 2 q.k, 0) in f32 from input-dtype operands.  The
kernels compute all three forward and `dot`/`l2` backward; as in the JAX
package, the `l2ref` backward is autograd through the plain chunked
recompute.  The `l2`/`l2ref` kernels (forward, single pass, dq, dk/dv: one
persistent skeleton, csrc/flash_l2.cuh) read and write a head width that is
a multiple of 4 where it lies (the v1 discriminator's 108) and return
contiguous outputs; the `dot` wrappers zero-pad a width that is not a
multiple of 8 to one and slice the outputs back: zero columns add nothing
to q.k.

The kernels take bf16 or f32 tensors (:func:`kernel_dtype`), as the TPU
kernels compute in their input dtype.  f32 calls launch the f32 kernels of
csrc/flash_f32.cuh and csrc/flash_f32_bwd.cuh (csrc/flash_attn_*_f32.cu: TF32
products, f32 softmax),
counted apart under ``name_f32[mode]``; the backward route reads the
dtype's size, as the JAX package's does.
"""

from __future__ import annotations

import functools
import math
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda, sequence_parallel_active

MAX_HEAD_DIM = 128   # the widest head the kernels take
MAX_BATCH_HEADS = 65535  # CUDA grid.y limit
SCORE_MODES = ("dot", "l2", "l2ref")
MODE_ID = {"dot": 0, "l2": 1, "l2ref": 2}  # the kernels' `mode` argument

# The JAX package's block and budget constants (attention.py:209-218, 627-630):
# they decide the backward route, which is the TPU's decision kept unmeasured
# on the GPU (:func:`backward_route`).
WHOLE_SEQ_MAX = 1152
KV_VMEM_BUDGET_BYTES = 8 * 1024 * 1024
FUSED_BWD_KV_BUDGET_BYTES = 4 * 1024 * 1024
FUSED_BWD_MAX_BLOCK = 512

# Once-differentiable, as the JAX package's flash_attention is: its backward
# is a pallas_call, and a second derivative through it fails there with
# "Linearization failed to produce known values for all output primals".
DOUBLE_BACKWARD = ("the flash-attention kernels are once-differentiable, as the JAX package's "
                   "flash_attention is (its backward is a pallas_call): a double backward "
                   "(WGAN-GP, R1) through them is not a port item (ROADMAP.md queue 2 item 2); "
                   "set runtime.use_pallas=never for these recipes")


def _check_mode(score_mode: str, backward: bool = False) -> None:
    if score_mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {score_mode!r} (have {SCORE_MODES})")
    if backward and score_mode == "l2ref":
        raise ValueError("score_mode 'l2ref' has no backward kernel: as in the JAX package, "
                         "its backward is autograd through attention_chunked")


def launch_key(name: str, score_mode: str, dtype: torch.dtype = torch.bfloat16) -> str:
    """The ``build.LAUNCHES`` key of a kernel's launches in ``score_mode``:
    the kernel's name for bf16 `dot`, ``name[mode]`` for the other bf16
    modes, ``name_f32[mode]`` for every f32 mode."""
    if dtype == torch.float32:
        return f"{name}_f32[{score_mode}]"
    return name if score_mode == "dot" else f"{name}[{score_mode}]"


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _scores(q, k, scale: float, score_mode: str = "dot"):
    """f32 scores (B, H, N, M) in ``score_mode`` (module docstring)."""
    qk = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float())
    if score_mode == "dot":
        return qk / math.sqrt(scale)
    inv = 1.0 / math.sqrt(scale)
    qq = (q.float() ** 2).sum(-1)[..., :, None]
    kk = (k.float() ** 2).sum(-1)[..., None, :]
    # maximum, not clamp: at d2 == 0 its gradient splits as JAX's maximum does
    d2 = torch.maximum(qq + kk - 2.0 * qk, qk.new_zeros(()))
    if score_mode == "l2":
        return -d2 * inv
    return torch.sqrt(d2 + 1e-12) * inv


def _softmax_v(s, v, dtype):
    """softmax(s) cast to ``dtype`` before P.V, as the JAX reference."""
    p = torch.softmax(s, dim=-1).to(dtype)
    return torch.einsum("bhnm,bhmd->bhnd", p.float(), v.float()).to(dtype)


def attention_reference(q, k, v, score_mode: str = "dot", scale: Optional[float] = None):
    """Plain attention, (B, H, N, D) -> (B, H, N, D): f32 scores and softmax,
    probabilities cast to the input dtype before P.V, as the JAX reference."""
    _check_mode(score_mode)
    scale = float(scale if scale is not None else q.shape[-1])
    return _softmax_v(_scores(q, k, scale, score_mode), v, q.dtype)


def attention_chunked(q, k, v, score_mode: str = "dot", scale: Optional[float] = None,
                      chunk: int = 256):
    """Memory-bounded plain attention (attention.py:770-795): q in chunks, each
    under ``torch.utils.checkpoint`` when gradients are on, so the backward
    recomputes one chunk's (chunk, N) scores at a time instead of keeping
    (B, H, N, N) for every block."""
    n = q.shape[-2]
    if n <= chunk:
        return attention_reference(q, k, v, score_mode, scale)
    outs = []
    for i in range(0, n, chunk):
        qc = q[..., i:i + chunk, :]
        if torch.is_grad_enabled():
            outs.append(checkpoint(attention_reference, qc, k, v, score_mode, scale,
                                   use_reentrant=False, preserve_rng_state=False))
        else:
            outs.append(attention_reference(qc, k, v, score_mode, scale))
    return torch.cat(outs, dim=-2)


def attention_forward_reference(q, k, v, scale: float, score_mode: str = "dot"):
    """Plain version of the forward kernel: (o, lse), lse the f32 natural-log
    log-sum-exp of the scores, (B, H, N)."""
    _check_mode(score_mode)
    s = _scores(q, k, scale, score_mode)
    return _softmax_v(s, v, q.dtype), torch.logsumexp(s, dim=-1)


def kernel_fits(head_dim: int, batch_heads: int) -> bool:
    """Dh <= 128 (the `dot` wrappers pad it to a multiple of 8, the `l2`
    kernels take a multiple of 4), B*H <= 65535."""
    return head_dim <= MAX_HEAD_DIM and batch_heads <= MAX_BATCH_HEADS


def _pad_head(*ts):
    """Zero-pad the last axis to a multiple of 8 (the `dot` kernels copy 16
    bytes at a time); the tensors themselves when it is one already."""
    pad = (-ts[0].shape[-1]) % 8
    return ts if not pad else tuple(F.pad(t, (0, pad)) for t in ts)


KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def kernel_dtype(what: str, *ts) -> torch.dtype:
    """The dtype the kernels run in for tensors ``ts``: bf16 or f32, one
    dtype for all (the TPU kernels compute in their input dtype).  Raises
    TypeError for any other dtype or a mix.  The flash and the LayerNorm
    families' wrappers share it (fused_mlp.kernel_dtype)."""
    dtypes = {t.dtype for t in ts}
    if len(dtypes) != 1 or not dtypes <= set(KERNEL_DTYPES):
        raise TypeError(f"{what} takes bf16 or f32 tensors of one dtype, got "
                        f"{[t.dtype for t in ts]}; f16, f64 and mixed dtypes have no kernel "
                        "(ROADMAP.md queue 1 item 7; or set runtime.use_pallas=never)")
    return dtypes.pop()


def _check_kernel_inputs(what: str, *ts) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must be CUDA tensors")
    kernel_dtype(what, *ts)
    shape = ts[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in ts):
        raise ValueError(f"{what}: tensors must share one (B, H, N, D) shape: "
                         f"{[tuple(t.shape) for t in ts]}")
    if not kernel_fits(shape[3], shape[0] * shape[1]):
        raise ValueError(f"{what} takes D <= {MAX_HEAD_DIM} and B*H <= "
                         f"{MAX_BATCH_HEADS}, got D={shape[3]}, B*H={shape[0] * shape[1]}; "
                         "other shapes are ROADMAP.md queue 1 item 7")


def _check_l2_width(what: str, q) -> None:
    """The `l2`/`l2ref` kernels read 8-byte row granules where the rows lie:
    a head width that is not a multiple of 4 raises (it is neither padded nor
    sent to a plain version)."""
    if q.shape[-1] % 4:
        raise ValueError(f"{what}: the `l2` kernels take a head width that is a multiple of 4, "
                         f"got {q.shape[-1]}; other widths are ROADMAP.md queue 1 item 7")


def flash_forward(q, k, v, scale: float, out: Optional[torch.Tensor] = None,
                  score_mode: str = "dot"):
    """Launch the forward kernel: q, k, v (B, H, N, D) bf16 or f32
    contiguous CUDA tensors.

    Returns (o, lse): o (B, H, N, D), contiguous, and the f32 log-sum-exp (B,
    H, N) of the ``score_mode`` scores.  `dot` only: with ``out`` given (in
    q's dtype), o is written there in the (B, N, H*D) layout instead (the
    megablock's out-projection input; D a multiple of 8) and ``out`` is
    returned as o."""
    _check_mode(score_mode)
    if score_mode != "dot":
        _check_l2_width("flash_forward", q)
        if out is not None:
            raise ValueError(f"flash_forward: out= (the (B, N, H*D) layout) is the `dot` "
                             f"forward's; the {score_mode!r} kernel writes (B, H, N, D)")
    _check_kernel_inputs("flash_forward", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    b, h, n, d = q.shape
    if out is not None and (out.shape != (b, n, h * d) or out.dtype != q.dtype
                            or not out.is_contiguous() or d % 8):
        raise ValueError(f"out must be a contiguous {q.dtype} ({b}, {n}, {h * d}) tensor, D a "
                         "multiple of 8")
    if q.dtype == torch.float32:
        return _flash_forward_f32(q, k, v, scale, score_mode, out)
    grid = 0
    if score_mode != "dot":
        grid = l2_grid(n, d, b * h, _sm_count(q.device.index or 0))
        o = torch.empty_like(q)
    elif out is None:
        q, k, v = _pad_head(q, k, v)
        o = torch.empty_like(q)
    else:
        o = out
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    q, k, v = build.aligned16(q), build.aligned16(k), build.aligned16(v)
    fn = build.entry("flash_attn_fwd")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), build.ptr(lse),
                       b * h, n, q.shape[-1], h, 1.0 / math.sqrt(scale), int(out is not None),
                       MODE_ID[score_mode], grid, build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_fwd", score_mode)] += 1
    return (o if out is not None or o.shape[-1] == d else o[..., :d]), lse


def _pad_head_f32(*ts):
    """The f32 kernels read a head width that is a multiple of 4 where it
    lies (16-byte rows; zero columns up to the instantiation's in shared
    memory only); another `dot` width is zero-padded to a multiple of 8."""
    return ts if ts[0].shape[-1] % 4 == 0 else _pad_head(*ts)


def _flash_forward_f32(q, k, v, scale: float, score_mode: str, out=None):
    """csrc/flash_attn_fwd_f32.cu on checked f32 q, k, v, read where they lie
    at a head width that is a multiple of 4 (`l2`/`l2ref` take no other);
    o is then contiguous, or ``out`` (checked: `dot`, (B, N, H*D), D a
    multiple of 8) in the megablock's layout."""
    b, h, n, d = q.shape
    if out is None:
        q, k, v = _pad_head_f32(q, k, v)
    o = torch.empty_like(q) if out is None else out
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    q, k, v = build.aligned16(q), build.aligned16(k), build.aligned16(v)
    fn = build.entry("flash_attn_fwd_f32")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), build.ptr(lse),
                       b * h, n, q.shape[-1], 1.0 / math.sqrt(scale), MODE_ID[score_mode], h,
                       int(out is not None), build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_fwd", score_mode, torch.float32)] += 1
    return (o if out is not None or o.shape[-1] == d else o[..., :d]), lse


# --- backward --------------------------------------------------------------


def default_blocks(n: int) -> tuple:
    """The JAX package's default (block_q, block_k) for N tokens
    (attention.py:835-843, no explicit blocks)."""
    n_ceil = _ceil_to(n, 128)
    if n_ceil <= WHOLE_SEQ_MAX:
        return n_ceil, n_ceil
    block = 1024 if n >= 4096 else 512
    return min(block, n_ceil), min(block, n_ceil)


def backward_route(n: int, d: int, itemsize: int, score_mode: str = "dot") -> str:
    """'fused' or 'two_pass': the choice of the JAX `_flash_backward`
    (attention.py:633-681) at its default blocks, from N, Dh and the input
    dtype's size.  The JAX package's TPU decision (VMEM budgets), kept
    unmeasured on the GPU, where both routes stream at every length."""
    block_q, block_k = default_blocks(n)
    n_pad = _ceil_to(n, max(block_q, block_k))
    kv_bytes = 2 * n_pad * _ceil_to(d, 128) * itemsize
    stream = kv_bytes > KV_VMEM_BUDGET_BYTES
    asked = _POLICY["bwd_fusion"]
    fuse = asked
    if fuse == "auto":
        fuse = ("fused" if score_mode == "dot" and kv_bytes <= FUSED_BWD_KV_BUDGET_BYTES
                else "two_pass")
    if fuse == "fused":
        fb_q, fb_k = min(block_q, FUSED_BWD_MAX_BLOCK), min(block_k, FUSED_BWD_MAX_BLOCK)
        if not stream and n_pad % fb_q == 0 and n_pad % fb_k == 0:
            return "fused"
        if asked == "fused":
            warnings.warn(f"bwd_fusion='fused' requested but inapplicable at this shape "
                          f"(n_pad={n_pad}, K/V bytes={kv_bytes}, streaming={stream}) — "
                          "falling back to the two-pass backward", stacklevel=2)
    return "two_pass"


def _delta(o, do):
    """delta = rowsum(dO * O) in f32, (B, H, N) (attention.py:640)."""
    return (do.float() * o.float()).sum(-1)


def _bwd_terms(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """P = exp(S - lse) and dS = P * (dO.V^T - delta), f32 (B, H, N, N);
    delta = rowsum(dO * O) unless given."""
    _check_mode(score_mode, backward=True)
    p = torch.exp(_scores(q, k, scale, score_mode) - lse.float()[..., None])
    dp = torch.einsum("bhnd,bhmd->bhnm", do.float(), v.float())
    delta = _delta(o, do) if delta is None else delta.float()
    return p, p * (dp - delta[..., None])


def _score_grad(prod, ds, x, scale: float, score_mode: str, axis: int):
    """The gradient of the scores' operand from prod = dS.K (dS^T.Q):
    inv * prod for `dot`; for `l2`, 2 inv (prod - sum(dS) x) with the f32 dS
    summed over keys (axis -1, for dq) or queries (axis -2, for dk)
    (attention.py:290-292, 316-321, 425-431)."""
    inv = 1.0 / math.sqrt(scale)
    if score_mode == "dot":
        return prod * inv
    return 2.0 * inv * (prod - ds.sum(axis)[..., None] * x.float())


def flash_bwd_dq_reference(q, k, v, o, lse, do, scale: float, delta=None,
                           score_mode: str = "dot"):
    """Plain version of the dq kernel: dq = inv_scale * dS.K (`dot`), dS cast
    to the input dtype before the product, as the TPU kernel does."""
    _, ds = _bwd_terms(q, k, v, o, lse, do, scale, delta, score_mode)
    dq = torch.einsum("bhnm,bhmd->bhnd", ds.to(q.dtype).float(), k.float())
    return _score_grad(dq, ds, q, scale, score_mode, -1).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, o, lse, do, scale: float, delta=None,
                            score_mode: str = "dot"):
    """Plain version of the dk/dv kernel: dv = P^T.dO, dk = inv_scale * dS^T.Q (`dot`)."""
    p, ds = _bwd_terms(q, k, v, o, lse, do, scale, delta, score_mode)
    dv = torch.einsum("bhnm,bhnd->bhmd", p.to(q.dtype).float(), do.float())
    dk = torch.einsum("bhnm,bhnd->bhmd", ds.to(q.dtype).float(), q.float())
    return _score_grad(dk, ds, k, scale, score_mode, -2).to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, o, lse, do, scale: float, delta=None,
                              score_mode: str = "dot"):
    """Plain version of the single-pass kernel: dq, dk, dv from one P and dS."""
    p, ds = _bwd_terms(q, k, v, o, lse, do, scale, delta, score_mode)
    dsb, pb = ds.to(q.dtype).float(), p.to(q.dtype).float()
    dq = _score_grad(torch.einsum("bhnm,bhmd->bhnd", dsb, k.float()), ds, q, scale, score_mode,
                     -1)
    dk = _score_grad(torch.einsum("bhnm,bhnd->bhmd", dsb, q.float()), ds, k, scale, score_mode,
                     -2)
    dv = torch.einsum("bhnm,bhnd->bhmd", pb, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, o, lse, do, what, delta, score_mode):
    """Checked, contiguous, aligned kernel inputs: bf16 `dot` head-padded to
    a multiple of 8; `l2` and f32 where they lie, which their kernels take at
    a width that is a multiple of 4 (an f32 `dot` width that is not: padded).
    delta = rowsum(dO * O) (B, H, N) f32 unless given (the megablock backward
    forms it in its own kernel; o may then be None)."""
    _check_mode(score_mode, backward=True)
    if score_mode == "l2":
        _check_l2_width(what, q)
    _check_kernel_inputs(what, q, k, v, do, *(() if o is None else (o,)))
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be f32 {tuple(q.shape[:3])}")
    if delta is None:
        delta = _delta(o, do)
    elif delta.shape != q.shape[:3] or delta.dtype != torch.float32:
        raise ValueError(f"{what}: delta must be f32 {tuple(q.shape[:3])}")
    ts = tuple(t.contiguous() for t in (q, k, v, do))
    if q.dtype == torch.float32:
        ts = _pad_head_f32(*ts)
    elif score_mode == "dot":
        ts = _pad_head(*ts)
    q, k, v, do = (build.aligned16(t) for t in ts)
    return q, k, v, do, lse.contiguous(), delta.contiguous()


# The `l2`/`l2ref` kernels (csrc/flash_l2.cuh: the forward, the single pass,
# dq and dk/dv): persistent blocks, one an SM (each takes ~200 KB of shared
# memory), walking units of one (batch*head, resident rows) each.
L2_BLOCKS_PER_SM = 1
L2_TILE = 64  # rows of a streamed tile
L2_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_fused", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")


def l2_unit_rows(d: int) -> int:
    """Resident rows of a unit of the `l2` kernels at head width d: 64 where
    the head pads past one 64-column box (the two consumer warpgroups split
    the columns), else 128 (they split the rows)."""
    return 64 if _ceil_to(d, 16) > 64 else 128


def l2_grid(n: int, d: int, batch_heads: int, sms: int) -> int:
    """The `l2` kernels' grid: min(units, SMs x blocks an SM)."""
    units = batch_heads * -(-n // l2_unit_rows(d))
    return min(units, sms * L2_BLOCKS_PER_SM)


def l2_ticketed(entry: str, n: int) -> bool:
    """Whether ``entry``'s blocks take their units in the order of an atomic
    ticket (the single pass past one 64-key tile, whose units add dQ in
    key-block order and so wait on one another) rather than walking
    blockIdx.x, + gridDim.x, ..."""
    return entry == "flash_attn_bwd_fused" and n > L2_TILE


def l2_units(entry: str, n: int, d: int, batch_heads: int, grid: int, order=None) -> list:
    """The units each block of ``entry``'s grid takes, in its order: a list a
    block of (batch*head, first resident row).  Unit u is (u // per, u % per
    * rows), per = ceil(n / rows).  Static walk: block b takes units b, b +
    grid, ...  Ticket (:func:`l2_ticketed`): the units in ticket order, each to
    the block that asks first, modelled as the blocks asking in turn in
    ``order`` (a permutation of the grid; default blockIdx order)."""
    rows = l2_unit_rows(d)
    per = -(-n // rows)
    units = [(u // per, u % per * rows) for u in range(batch_heads * per)]
    if not l2_ticketed(entry, n):
        return [units[blk::grid] for blk in range(grid)]
    order = list(range(grid)) if order is None else list(order)
    walked = [[] for _ in range(grid)]
    for ticket, unit in enumerate(units):
        walked[order[ticket % grid]].append(unit)
    return walked


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _entry_name(entry: str, dtype: torch.dtype) -> str:
    return f"{entry}_f32" if dtype == torch.float32 else entry


def _bwd_grid(q, score_mode: str) -> int:
    """The bf16 `l2` backward kernels' persistent grid; 0 (unread) otherwise."""
    if score_mode != "l2" or q.dtype == torch.float32:
        return 0
    b, h, n, d = q.shape
    return l2_grid(n, d, b * h, _sm_count(q.device.index or 0))


def _bwd_launch(entry: str, ts, outs, scale: float, score_mode: str) -> None:
    """Launch a two-pass entry on kernel inputs ``ts`` (q, k, v, dO, lse,
    delta) into ``outs``: f32 inputs the entry's f32 kernel."""
    b, h, n, d = ts[0].shape
    ptrs = [build.ptr(t) for t in (*ts, *outs)]
    fn = build.entry(_entry_name(entry, ts[0].dtype))
    build.check(fn, fn(*ptrs, b * h, n, d, 1.0 / math.sqrt(scale), MODE_ID[score_mode],
                       _bwd_grid(ts[0], score_mode), build.stream_ptr(ts[0].device)))
    build.LAUNCHES[launch_key(entry, score_mode, ts[0].dtype)] += 1


def flash_backward_dq(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_dq.cu (f32: flash_attn_bwd_dq_f32.cu);
    returns dq (B, H, N, D) in the inputs' dtype, contiguous."""
    d = q.shape[-1]
    ts = _bwd_args(q, k, v, o, lse, do, "flash_backward_dq", delta, score_mode)
    dq = torch.empty_like(ts[0])
    _bwd_launch("flash_attn_bwd_dq", ts, (dq,), scale, score_mode)
    return dq if dq.shape[-1] == d else dq[..., :d]


def flash_backward_dkv(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_dkv.cu (f32: flash_attn_bwd_dkv_f32.cu);
    returns (dk, dv) in the inputs' dtype, contiguous at `l2`."""
    d = q.shape[-1]
    ts = _bwd_args(q, k, v, o, lse, do, "flash_backward_dkv", delta, score_mode)
    dk, dv = torch.empty_like(ts[1]), torch.empty_like(ts[2])
    _bwd_launch("flash_attn_bwd_dkv", ts, (dk, dv), scale, score_mode)
    return (dk, dv) if dk.shape[-1] == d else (dk[..., :d], dv[..., :d])


# The single pass's key blocks (`dot`: csrc/flash_attn_bwd.cuh; `l2`:
# csrc/flash_l2_bwd.cuh): keys a block and heads a group of the order in each
# score mode; every block streams all queries, 64 a tile.  The f32 k-block
# kernel (csrc/flash_f32_bwd.cuh) takes, by the head width padded to 32 (its
# DP), 128 keys a block and 64-query tiles up to DP 64, 64 keys and 32-query
# tiles above, and orders the single pass's blocks as bf16 `dot`'s, 32 heads
# a group, in both modes.
FUSED_BLOCK_KEYS = {"dot": 128, "l2": 64}
FUSED_GROUP_HEADS = {"dot": 32, "l2": 1}
FUSED_TILE_QUERIES = 64
F32_BLOCK_KEYS = {32: 128, 64: 128, 96: 64, 128: 64}
F32_TILE_QUERIES = {32: 64, 64: 64, 96: 32, 128: 32}
F32_GROUP_HEADS = 32


@dataclass(frozen=True)
class FusedSchedule:
    """The single-pass kernel's grid and the order of its dQ additions.

    The grid's linear order runs in groups of ``group_heads`` heads, k-block
    slowest within a group (:meth:`index`; one head a group is k-block
    fastest).  Each block streams q_tiles query tiles (64 queries; the f32
    kernel's 32 at a padded head width over 64).  The `l2` kernel's
    persistent blocks take units of ``unit_blocks`` consecutive key blocks of
    a head (its two warpgroups' keys at Dh <= 64, which add in warpgroup
    order) by the ticket; `dot`'s blocks are one key block each.  Block (kb, head)
    adds its dQ of tile qt once the flag of (head, qt) reads kb, then sets
    it to kb + 1: the k-blocks of a head add every tile in key-block order,
    so each dQ element is summed in one fixed order.  A block waits only on
    :meth:`waits_on`, a lower linear index.  Each block's linear index is its
    ticket: the count of the launch's blocks that started before it, taken
    from the int32 after the flags (:attr:`ticket`) by one atomic as the
    block starts, not from blockIdx.  So the block waited on started earlier
    and holds its place on the card until it finishes, and every block
    finishes whatever order the hardware dispatches them in
    (tests/test_torch_flash_edges.py models it).  The group spaces a head's
    k-blocks apart in that order, so that a block's predecessor has usually
    added its tiles before it needs them."""

    k_blocks: int
    q_tiles: int
    batch_heads: int
    group_heads: int = 1
    unit_blocks: int = 1

    @property
    def ticket(self) -> Optional[int]:
        """Offset of the ticket in the flags buffer, after one flag per
        (batch*head, tile); None with one k-block, where no block waits and
        each takes blockIdx as its index."""
        return self.batch_heads * self.q_tiles if self.k_blocks > 1 else None

    @property
    def flags(self) -> tuple:
        """Shape of the int32 buffer of the flags and the ticket (zeroed by
        the entry); empty with one k-block."""
        return (0,) if self.ticket is None else (self.ticket + 1,)

    def _group(self, head: int) -> tuple:
        """(first head, heads) of ``head``'s group."""
        base = head // self.group_heads * self.group_heads
        return base, min(self.group_heads, self.batch_heads - base)

    def index(self, kb: int, head: int) -> int:
        """The linear index of block (kb, head)."""
        base, heads = self._group(head)
        return base * self.k_blocks + kb * heads + head - base

    def coords(self, index: int) -> tuple:
        """(kb, head) of the block at linear ``index``."""
        base, heads = self._group(index // self.k_blocks)
        kb, rest = divmod(index - base * self.k_blocks, heads)
        return kb, base + rest

    def waits_on(self, index: int) -> Optional[int]:
        """The linear index of the block whose additions block ``index``
        waits for, tile by tile; None for a head's first k-block."""
        kb, head = self.coords(index)
        return None if kb == 0 else self.index(kb - 1, head)


def fused_dq_schedule(n: int, batch_heads: int, score_mode: str = "dot",
                      d: int = 64, dtype: torch.dtype = torch.bfloat16) -> FusedSchedule:
    """:class:`FusedSchedule` of the single pass at N tokens and head width d
    (bf16 `l2`: its units of :func:`l2_unit_rows` keys; f32: the blocks and
    tiles of F32_BLOCK_KEYS and F32_TILE_QUERIES at d padded to 32, 32 heads
    a group, in either mode)."""
    if dtype == torch.float32:
        dp = _ceil_to(d, 32)
        return FusedSchedule(-(-n // F32_BLOCK_KEYS[dp]), -(-n // F32_TILE_QUERIES[dp]),
                             batch_heads, F32_GROUP_HEADS)
    keys = FUSED_BLOCK_KEYS[score_mode]
    unit = l2_unit_rows(d) // keys if score_mode == "l2" else 1
    return FusedSchedule(-(-n // keys), -(-n // FUSED_TILE_QUERIES), batch_heads,
                         FUSED_GROUP_HEADS[score_mode], unit)


def flash_backward_fused(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_fused.cu (f32: flash_attn_bwd_fused_f32.cu);
    returns (dq, dk, dv) in the inputs' dtype, contiguous at `l2`.  Past one
    key block the key blocks of a head add dq in key-block order
    (:func:`fused_dq_schedule`) and the last one finishes it, so dq is
    bit-deterministic as dk and dv are; bf16 `l2` at N <= 64 finishes dq in
    one block a head, with no scratch."""
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(q, k, v, o, lse, do, "flash_backward_fused", delta,
                                        score_mode)
    b, h, n, dp = q.shape
    plan = fused_dq_schedule(n, b * h, score_mode, dp, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = (torch.empty(q.shape, dtype=torch.float32, device=q.device)
              if plan.k_blocks > 1 else None)
    flags = torch.empty(plan.flags, dtype=torch.int32, device=q.device)
    fn = build.entry(_entry_name("flash_attn_bwd_fused", q.dtype))
    build.check(fn, fn(*(build.ptr(t) for t in (q, k, v, do, lse, delta, dq, dk, dv, dq_acc,
                                                flags)),
                       b * h, n, dp, 1.0 / math.sqrt(scale), MODE_ID[score_mode],
                       _bwd_grid(q, score_mode), build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_bwd_fused", score_mode, q.dtype)] += 1
    return (dq, dk, dv) if dp == d else (dq[..., :d], dk[..., :d], dv[..., :d])


def flash_backward(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """(dq, dk, dv) on :func:`backward_route`'s route: the kernels for CUDA
    tensors (or raise), their plain versions for CPU tensors.  With ``delta``
    given, ``o`` is not read.  `dot` and `l2` scores."""
    route = backward_route(q.shape[-2], q.shape[-1], q.element_size(), score_mode)
    if route == "two_pass" and delta is None:  # one delta for both passes (attention.py:640)
        delta = _delta(o, do)
    args = (q, k, v, o, lse, do, scale, delta, score_mode)
    if q.device.type == "cpu":
        if route == "fused":
            return flash_bwd_fused_reference(*args)
        return flash_bwd_dq_reference(*args), *flash_bwd_dkv_reference(*args)
    if route == "fused":
        return flash_backward_fused(*args)
    return flash_backward_dq(*args), *flash_backward_dkv(*args)


def _l2ref_backward(q, k, v, do, scale: float):
    """The `l2ref` backward: autograd through the plain chunked recompute, as
    the JAX `_bwd` differentiates `attention_chunked`
    (vitgan_tpu/ops/attention.py:861-870), whose package has no backward
    kernel for this mode (its sqrt makes the chain rule singular at d2 = 0;
    it is the reference's parity mode).  This is that mode's backward on
    every device, not a fallback from a kernel.  Under create_graph the
    gradients stay differentiable through the recompute."""
    create = torch.is_grad_enabled()
    with torch.enable_grad():
        xs = [t if create and t.requires_grad else t.detach().requires_grad_() for t in (q, k, v)]
        out = attention_chunked(*xs, "l2ref", scale)
        return torch.autograd.grad(out, xs, do, create_graph=create)


@torch.library.custom_op("vitgan_tpu_torch::flash_fwd", mutates_args=())
def flash_forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     score_mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of the flash forward: the kernel on CUDA tensors (or it
    raises), the plain version on CPU tensors.  An operator, so that a
    selective-checkpoint policy can name its outputs and keep them
    (models/remat.py, remat='attn'), as the JAX package names its
    ``flash_out`` and ``flash_lse`` (attention.py:850-857)."""
    if q.device.type == "cpu":
        return attention_forward_reference(q, k, v, scale, score_mode)
    return flash_forward(q, k, v, scale, score_mode=score_mode)


@flash_forward_op.register_fake
def _(q, k, v, scale, score_mode):
    """Shapes only, after the kernel's own checks: a tensor that is neither on
    the CPU nor on CUDA (a meta tensor) raises as the kernel's wrapper does."""
    _check_mode(score_mode)
    _check_kernel_inputs("flash_forward", q, k, v)
    return torch.empty_like(q), q.new_empty(q.shape[:-1], dtype=torch.float32)


FLASH_FORWARD_OP = torch.ops.vitgan_tpu_torch.flash_fwd.default


class _FlashAttention(torch.autograd.Function):
    """softmax(scores).v with the flash backward (custom VJP of
    attention.py:803-873)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, score_mode):
        o, lse = flash_forward_op(q, k, v, scale, score_mode)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.score_mode = scale, score_mode
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if ctx.score_mode == "l2ref":
            return (*_l2ref_backward(q, k, v, do, ctx.scale), None, None)
        if torch.is_grad_enabled() and q.device.type != "cpu":
            raise NotImplementedError(DOUBLE_BACKWARD)
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(), ctx.scale,
                                    score_mode=ctx.score_mode)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, score_mode: str = "dot", scale: Optional[float] = None):
    """(B, H, N, D) q/k/v -> (B, H, N, D) attention output, differentiable.

    CUDA tensors launch the kernels (or raise); CPU tensors take their plain
    versions, forward and backward."""
    _check_mode(score_mode)
    scale = float(scale if scale is not None else q.shape[-1])
    return _FlashAttention.apply(q, k, v, scale, score_mode)


def use_flash_attention(q, seq_len: int) -> bool:
    """'always'/'never' force; 'auto' takes the kernel for CUDA tensors at
    sequences of at least ``min_seq_len`` (the JAX package's TPU threshold,
    not yet measured on the GPU).  A dtype or shape the kernel does not take
    raises in :func:`flash_forward`; it is never sent to the plain version."""
    if sequence_parallel_active():
        # under sequence parallelism no block takes a kernel, as in the JAX
        # package (attention.py:896-899)
        return False
    mode = _POLICY["mode"]
    if mode == "never":
        return False
    if mode == "always":
        return True
    return on_cuda(q) and seq_len >= _POLICY["min_seq_len"]


def dispatch_attention(q, k, v, score_mode: str, scale: float):
    """Policy-routed attention (attention.py:912-926): the flash kernels, the
    chunked plain attention above 1,024 tokens, or the plain attention.
    Cross-attention shapes (nq != nk) take a plain version."""
    if q.shape[-2] == k.shape[-2] and use_flash_attention(q, q.shape[-2]):
        return flash_attention(q, k, v, score_mode, scale)
    if max(q.shape[-2], k.shape[-2]) > 1024:
        return attention_chunked(q, k, v, score_mode, scale)
    return attention_reference(q, k, v, score_mode, scale)
