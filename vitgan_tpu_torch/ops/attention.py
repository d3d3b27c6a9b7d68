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
recompute.  A head width that is not a multiple of 8 (the v1
discriminator's 108) is zero-padded to one in the wrapper and the outputs
sliced back: zero columns add nothing to q.k, |q|^2 or |k|^2.
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda

MAX_HEAD_DIM = 128   # the kernels pad Dh to a multiple of 16 up to this
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

DOUBLE_BACKWARD = ("the flash-attention kernels are once-differentiable: a double backward "
                   "(WGAN-GP, R1) through them is ROADMAP.md queue 2 item 2; set "
                   "runtime.use_pallas=never for these recipes")


def _check_mode(score_mode: str, backward: bool = False) -> None:
    if score_mode not in SCORE_MODES:
        raise ValueError(f"unknown score_mode {score_mode!r} (have {SCORE_MODES})")
    if backward and score_mode == "l2ref":
        raise ValueError("score_mode 'l2ref' has no backward kernel: as in the JAX package, "
                         "its backward is autograd through attention_chunked")


def launch_key(name: str, score_mode: str) -> str:
    """The ``build.LAUNCHES`` key of a kernel's launches in ``score_mode``:
    the kernel's name for `dot`, ``name[mode]`` otherwise."""
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
    """Dh <= 128 (the wrappers pad it to a multiple of 8), B*H <= 65535."""
    return head_dim <= MAX_HEAD_DIM and batch_heads <= MAX_BATCH_HEADS


def _pad_head(*ts):
    """Zero-pad the last axis to a multiple of 8 (the kernels copy 16 bytes
    at a time); the tensors themselves when it is one already."""
    pad = (-ts[0].shape[-1]) % 8
    return ts if not pad else tuple(F.pad(t, (0, pad)) for t in ts)


def _check_kernel_inputs(what: str, *ts) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must be CUDA tensors")
    if not all(t.dtype == torch.bfloat16 for t in ts):
        raise TypeError(f"{what} takes bf16 tensors, got {[t.dtype for t in ts]}; other "
                        "dtypes are ROADMAP.md queue 1 item 7 (or set runtime.use_pallas=never)")
    shape = ts[0].shape
    if len(shape) != 4 or any(t.shape != shape for t in ts):
        raise ValueError(f"{what}: tensors must share one (B, H, N, D) shape: "
                         f"{[tuple(t.shape) for t in ts]}")
    if not kernel_fits(shape[3], shape[0] * shape[1]):
        raise ValueError(f"{what} takes D <= {MAX_HEAD_DIM} and B*H <= "
                         f"{MAX_BATCH_HEADS}, got D={shape[3]}, B*H={shape[0] * shape[1]}; "
                         "other shapes are ROADMAP.md queue 1 item 7")


def flash_forward(q, k, v, scale: float, out: Optional[torch.Tensor] = None,
                  score_mode: str = "dot"):
    """Launch the forward kernel: q, k, v (B, H, N, D) bf16 contiguous CUDA tensors.

    Returns (o, lse): o (B, H, N, D) and the f32 log-sum-exp (B, H, N) of the
    ``score_mode`` scores.  With ``out`` given, o is written there in the
    (B, N, H*D) layout instead (the megablock's out-projection input; D a
    multiple of 8) and ``out`` is returned as o."""
    _check_mode(score_mode)
    _check_kernel_inputs("flash_forward", q, k, v)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous q/k/v")
    b, h, n, d = q.shape
    if out is None:
        q, k, v = _pad_head(q, k, v)
        o = torch.empty_like(q)
    else:
        if out.shape != (b, n, h * d) or out.dtype != q.dtype or not out.is_contiguous() \
                or d % 8:
            raise ValueError(f"out must be a contiguous bf16 ({b}, {n}, {h * d}) tensor, D a "
                             "multiple of 8")
        o = out
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    q, k, v = build.aligned16(q), build.aligned16(k), build.aligned16(v)
    fn = build.entry("flash_attn_fwd")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), build.ptr(lse),
                       b * h, n, q.shape[-1], h, 1.0 / math.sqrt(scale), int(out is not None),
                       MODE_ID[score_mode], build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_fwd", score_mode)] += 1
    return (o if out is not None else o[..., :d]), lse


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
    """Checked, head-padded, aligned kernel inputs.  delta = rowsum(dO * O)
    (B, H, N) f32 unless given (the megablock backward forms it in its own
    kernel; o may then be None)."""
    _check_mode(score_mode, backward=True)
    _check_kernel_inputs(what, q, k, v, do, *(() if o is None else (o,)))
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32:
        raise ValueError(f"{what}: lse must be f32 {tuple(q.shape[:3])}")
    if delta is None:
        delta = _delta(o, do)
    elif delta.shape != q.shape[:3] or delta.dtype != torch.float32:
        raise ValueError(f"{what}: delta must be f32 {tuple(q.shape[:3])}")
    q, k, v, do = (build.aligned16(t) for t in _pad_head(*(t.contiguous() for t in (q, k, v, do))))
    return q, k, v, do, lse.contiguous(), delta.contiguous()


def flash_backward_dq(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_dq.cu; returns dq (B, H, N, D) bf16."""
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(q, k, v, o, lse, do, "flash_backward_dq", delta,
                                        score_mode)
    b, h, n, dp = q.shape
    dq = torch.empty_like(q)
    fn = build.entry("flash_attn_bwd_dq")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do), build.ptr(lse),
                       build.ptr(delta), build.ptr(dq), b * h, n, dp, 1.0 / math.sqrt(scale),
                       MODE_ID[score_mode], build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_bwd_dq", score_mode)] += 1
    return dq[..., :d]


def flash_backward_dkv(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_dkv.cu; returns (dk, dv) bf16."""
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(q, k, v, o, lse, do, "flash_backward_dkv", delta,
                                        score_mode)
    b, h, n, dp = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = build.entry("flash_attn_bwd_dkv")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do), build.ptr(lse),
                       build.ptr(delta), build.ptr(dk), build.ptr(dv), b * h, n, dp,
                       1.0 / math.sqrt(scale), MODE_ID[score_mode], build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_bwd_dkv", score_mode)] += 1
    return dk[..., :d], dv[..., :d]


def flash_backward_fused(q, k, v, o, lse, do, scale: float, delta=None, score_mode: str = "dot"):
    """Launch csrc/flash_attn_bwd_fused.cu; returns (dq, dk, dv) bf16.  dq
    (and for `l2` the rows' sums of dS) is summed across k-blocks by f32
    atomics into scratch buffers, then finished and cast, so its bits vary
    from run to run (PERF.md)."""
    d = q.shape[-1]
    q, k, v, do, lse, delta = _bwd_args(q, k, v, o, lse, do, "flash_backward_fused", delta,
                                        score_mode)
    b, h, n, dp = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    rs_acc = (torch.empty((b, h, n), dtype=torch.float32, device=q.device)
              if score_mode == "l2" else None)
    fn = build.entry("flash_attn_bwd_fused")
    build.check(fn, fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do), build.ptr(lse),
                       build.ptr(delta), build.ptr(dq), build.ptr(dk), build.ptr(dv),
                       build.ptr(dq_acc), build.ptr(rs_acc), b * h, n, dp,
                       1.0 / math.sqrt(scale), MODE_ID[score_mode], build.stream_ptr(q.device)))
    build.LAUNCHES[launch_key("flash_attn_bwd_fused", score_mode)] += 1
    return dq[..., :d], dk[..., :d], dv[..., :d]


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


class _FlashAttention(torch.autograd.Function):
    """softmax(scores).v with the flash backward (custom VJP of
    attention.py:803-873)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, score_mode):
        if q.device.type == "cpu":
            o, lse = attention_forward_reference(q, k, v, scale, score_mode)
        else:
            o, lse = flash_forward(q, k, v, scale, score_mode=score_mode)
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
