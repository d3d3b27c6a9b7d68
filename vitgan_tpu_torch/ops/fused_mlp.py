"""Fused LN -> fc1 -> GELU -> fc2 [+ residual]: the CUDA stages, their plain
versions, routing.

Counterpart of vitgan_tpu/ops/fused_mlp.py.  ``fused_ln_mlp`` is a
``torch.autograd.Function``: its forward runs csrc/ln_mlp_fwd.cu on CUDA
tensors and takes ``_reference`` on CPU tensors; its backward is autograd of
``_reference`` on the saved inputs, the JAX package's own recompute VJP
(fused_mlp.py:174-190), and so differentiates twice as the JAX one does.  On the card its f32 products run in TF32 (10
mantissa bits, where the forward kernel's bf16 operands keep 7): in full f32
they took 58% of a highres128 train step (PERF.md).

The forward is a chain of two wgmma GEMM stages (:func:`ln_fc1_stage`:
LayerNorm prologue, GELU epilogue; :func:`linear_stage`: bias, optional
dropout mask and residual in the epilogue), each with a plain version; h
passes between them in bf16.  The megablock (ops/fused_block.py) runs the
same stages after an out-projection through :func:`ln_mlp_forward` (serving)
and ``fused_block.ln_mlp_train_forward`` (training).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda

# ln_mlp_fwd.cu's fc1 stage holds a 128-row tile of the LayerNorm input whole
# in shared memory: E <= 384 (ln_qkv_fwd shares the limit).
MAX_WIDTH = 384


def kernel_fits(e: int, hidden: int, hd: int = 0) -> bool:
    """E <= 384; E, hidden and the prologue's H*Dh multiples of 8 (TMA's 16-byte strides)."""
    return e <= MAX_WIDTH and e % 8 == 0 and hidden % 8 == 0 and hd % 8 == 0


def threshold(rate: float) -> int:
    """The TPU kernel's dropout rule (fused_block.py:115): keep where the bits
    are >= this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


def _check_activation(activation: str) -> None:
    if activation != "gelu":
        raise NotImplementedError(
            f"activation {activation!r}: the port's LN->MLP takes 'gelu', the "
            "only activation the v2 encoder block uses")


def _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
               eps: float = 1e-5, residual: bool = True):
    """Plain LN -> MLP in f32, cast back to x's dtype (the JAX `_reference`)."""
    _check_activation(activation)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    h = F.gelu(y @ w1.float() + b1.float())
    out = h @ w2.float() + b2.float()
    if residual:
        out = out + xf
    return out.to(x.dtype)


# --- the two stages of csrc/ln_mlp_fwd.cu, and their plain versions --------------


def linear_stage_reference(a, w, bias, res=None, mask=None):
    """Plain linear stage: [res +] [mask *] (a . w + bias) in f32, bf16 out."""
    v = a.float() @ w.float() + bias.float()
    if mask is not None:
        v = v * mask
    if res is not None:
        v = v + res.float()
    return v.to(torch.bfloat16)


def ln_fc1_stage_reference(a, ln_s, ln_b, w1, b1, eps: float = 1e-5):
    """Plain LN -> fc1 -> GELU stage: (h, z1) in bf16, z1 = LN(a) . w1 + b1 and
    h = gelu(z1) formed in f32."""
    af = a.float()
    mean = af.mean(-1, keepdim=True)
    var = ((af - mean) ** 2).mean(-1, keepdim=True)
    y = (af - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()
    z = y @ w1.float() + b1.float()
    return F.gelu(z).to(torch.bfloat16), z.to(torch.bfloat16)


def ln_mlp_stages_reference(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                            residual: bool = True, attn=None, wout=None, bout=None):
    """The plain LN->MLP (or, with ``attn``, the megablock's serving form)
    composed from the stage plain versions, with the kernels' bf16 roundings
    of x1 and h: rows (M, E) -> (M, E) bf16."""
    if attn is not None:
        x = linear_stage_reference(attn, wout, bout, x)
    h, _ = ln_fc1_stage_reference(x, ln_s, ln_b, w1, b1, eps)
    return linear_stage_reference(h, w2, b2, x if residual or attn is not None else None)


def _bf16_rows(t, what: str):
    if not t.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must be CUDA tensors")
    if t.dtype != torch.bfloat16 or t.dim() != 2:
        raise TypeError(f"{what} takes 2-D bf16 activations, got {t.dtype} {tuple(t.shape)}; "
                        "other dtypes are ROADMAP.md queue 1 item 7 (or set "
                        "runtime.use_pallas=never)")
    return build.aligned16(t.contiguous())


def _operands(dev, *pairs):
    """Weights in bf16 and LN parameters, biases and masks in f32 on ``dev``,
    as the kernels read them (16-byte aligned); None stays None."""
    return [None if t is None else build.aligned16(t.to(device=dev, dtype=dt).contiguous())
            for t, dt in pairs]


def linear_stage(a, w, bias, res=None, seed=None, rate: float = 0.0, mask_id: int = 0):
    """Launch ln_mlp_fwd.cu's linear stage on bf16 CUDA rows a (M, K), w (K,
    N): (out, mask) with out = [res +] [mask *] (a . w + bias) bf16 (M, N)
    and, for ``rate > 0``, the f32 multiply-mask of Philox stream ``mask_id``
    drawn from the one-element int64 ``seed`` (else None)."""
    a = _bf16_rows(a, "linear_stage")
    m, k = a.shape
    n = w.shape[-1]
    if w.shape != (k, n) or k % 8 or n % 8:
        raise ValueError(f"linear_stage takes w (K, N) with K, N multiples of 8, got a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")
    dev = a.device
    if res is not None:
        res = _bf16_rows(res, "linear_stage")
        if res.shape != (m, n):
            raise ValueError(f"residual {tuple(res.shape)} does not fit ({m}, {n})")
    mask = None
    if rate > 0.0:
        if seed is None or seed.device != dev or seed.dtype != torch.int64:
            raise ValueError("dropout needs a one-element int64 seed on the activations' device")
        mask = torch.empty((m, n), dtype=torch.float32, device=dev)
    # every operand bound to a name until the launch: a temporary freed
    # earlier could hand its memory to the next one
    wb, biasf = _operands(dev, (w, torch.bfloat16), (bias, torch.float32))
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    fn = build.entry("ln_mlp_linear")
    build.check(fn, fn(build.ptr(a), build.ptr(wb), build.ptr(biasf), build.ptr(res),
                       build.ptr(seed if mask is not None else None), build.ptr(out),
                       build.ptr(mask), m, k, n, mask_id, threshold(rate),
                       float(1.0 / (1.0 - rate)), build.stream_ptr(dev)))
    build.LAUNCHES["ln_mlp_linear"] += 1
    return out, mask


def ln_fc1_stage(a, ln_s, ln_b, w1, b1, eps: float = 1e-5, want_z1: bool = False):
    """Launch ln_mlp_fwd.cu's LN -> fc1 -> GELU stage on bf16 CUDA rows a (M,
    E): (h, z1) bf16 (M, hidden), z1 None unless ``want_z1``."""
    a = _bf16_rows(a, "ln_fc1_stage")
    m, e = a.shape
    hidden = w1.shape[-1]
    if w1.shape != (e, hidden) or not kernel_fits(e, hidden):
        raise ValueError(f"ln_fc1_stage takes E <= {MAX_WIDTH} and E, hidden multiples of 8, "
                         f"got a {tuple(a.shape)}, w1 {tuple(w1.shape)}; wider blocks are "
                         "ROADMAP.md queue 1 item 7")
    dev = a.device
    f32 = torch.float32
    w1b, ln_sf, ln_bf, b1f = _operands(dev, (w1, torch.bfloat16), (ln_s, f32), (ln_b, f32),
                                       (b1, f32))
    h = torch.empty((m, hidden), dtype=torch.bfloat16, device=dev)
    z1 = torch.empty_like(h) if want_z1 else None
    fn = build.entry("ln_mlp_fc1")
    build.check(fn, fn(build.ptr(a), build.ptr(ln_sf), build.ptr(ln_bf), build.ptr(w1b),
                       build.ptr(b1f), build.ptr(h), build.ptr(z1), m, e, hidden, float(eps),
                       build.stream_ptr(dev)))
    build.LAUNCHES["ln_mlp_fc1"] += 1
    return h, z1


def ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
                   residual: bool = True, attn: Optional[torch.Tensor] = None,
                   wout: Optional[torch.Tensor] = None, bout: Optional[torch.Tensor] = None):
    """Run the LN->MLP stages on a bf16 CUDA x (..., E): two launches (fc1,
    then fc2, each counted by its stage), and one call of "ln_mlp_fwd".

    With ``attn`` (..., H*Dh) bf16, ``wout`` (H*Dh, E) and ``bout`` (E,), the
    out-projection x1 = x + attn . wout + bout runs first (a third launch,
    x1 kept in bf16) and the result is x1 + mlp(LN(x1)) (``residual`` is then
    implied), counted as one call of "proj_ln_mlp_fwd"."""
    if not x.is_cuda:
        raise ValueError("ln_mlp_forward launches a CUDA kernel: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"LN->MLP kernel takes bf16 activations, got {x.dtype}; other dtypes "
                        "are ROADMAP.md queue 1 item 7 (or set runtime.use_pallas=never)")
    e = x.shape[-1]
    hidden = w1.shape[-1]
    hd = 0 if attn is None else attn.shape[-1]
    if not kernel_fits(e, hidden, hd):
        raise ValueError(f"LN->MLP kernel takes E <= {MAX_WIDTH} and E, hidden, H*Dh "
                         f"multiples of 8, got E={e}, hidden={hidden}, H*Dh={hd}; wider "
                         "blocks are ROADMAP.md queue 1 item 7")
    if w1.shape != (e, hidden) or w2.shape != (hidden, e):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not fit E={e}")
    rows = x.reshape(-1, e)
    m = rows.shape[0]
    if attn is not None:
        if attn.dtype != torch.bfloat16 or attn.numel() != m * hd:
            raise ValueError(f"attn must be bf16 with {m} rows, got {attn.dtype} "
                             f"{tuple(attn.shape)}")
        if wout.shape != (hd, e):
            raise ValueError(f"wout {tuple(wout.shape)} does not fit ({hd}, {e})")
        rows, _ = linear_stage(attn.reshape(m, hd), wout, bout, rows)
        name, residual = "proj_ln_mlp_fwd", True
    else:
        name = "ln_mlp_fwd"
    h, _ = ln_fc1_stage(rows, ln_scale, ln_bias, w1, b1, eps)
    out, _ = linear_stage(h, w2, b2, rows if residual else None)
    build.LAUNCHES[name] += 1
    return out.reshape(x.shape)


@contextlib.contextmanager
def _tf32_products(on: bool):
    """TF32 for f32 matrix products inside the block when ``on``, restoring
    the process's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = prev or on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _LnMlp(torch.autograd.Function):
    """The kernel forward with the recompute backward of fused_mlp.py:181-187.

    Under ``create_graph`` (WGAN-GP, R1) the backward is autograd of
    ``_reference`` on the saved tensors themselves, with its graph kept, so
    that a second derivative reaches x and the parameters: the JAX package's
    ``jax.vjp`` of its reference differentiates the same way."""

    @staticmethod
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps, ctx.residual = eps, residual
        if x.device.type == "cpu":
            return _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, "gelu", eps, residual)
        return ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        create = torch.is_grad_enabled()
        with torch.enable_grad(), _tf32_products(g.is_cuda):
            leaves = saved if create else [t.detach().requires_grad_(n)
                                           for t, n in zip(saved, need)]
            out = _reference(*leaves, "gelu", ctx.eps, ctx.residual)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g, create_graph=create)
                         if wanted else ())
        return (*(next(grads) if n else None for n in need), None, None)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
                 eps: float = 1e-5, residual: bool = True):
    """out = [x +] fc2(gelu(fc1(LN(x)))), x: (..., E), differentiable.  CUDA
    tensors launch the kernel (or raise); CPU tensors take :func:`_reference`."""
    _check_activation(activation)
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, float(eps), bool(residual))


def dispatch_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
                    residual: bool = True):
    """Policy-routed LN+MLP: 'auto' takes the kernel for CUDA tensors of at
    least ``min_mlp_rows`` rows and hidden >= 512 (the JAX package's TPU
    gate, not yet measured on the GPU).  A dtype or width the kernel does
    not take raises in :func:`ln_mlp_forward`; it is never sent to the plain
    version."""
    rows = x.numel() // x.shape[-1]
    mode = _POLICY["mode"]
    big_enough = rows >= _POLICY["min_mlp_rows"] and w1.shape[-1] >= 512
    use = mode == "always" or (mode == "auto" and on_cuda(x) and big_enough)
    if use:
        return fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, 1e-5, residual)
    return _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, 1e-5, residual)
