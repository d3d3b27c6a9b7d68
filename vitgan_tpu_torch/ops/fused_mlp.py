"""Fused LN -> fc1 -> act -> fc2 [+ residual]: the CUDA stages, their plain
versions, routing.

Counterpart of vitgan_tpu/ops/fused_mlp.py.  ``fused_ln_mlp`` is a
``torch.autograd.Function``: its forward runs csrc/ln_mlp_fwd.cu on CUDA
tensors and takes ``_reference`` on CPU tensors; its backward is autograd of
``_reference`` on the saved inputs, the JAX package's own recompute VJP
(fused_mlp.py:174-190), and so differentiates twice as the JAX one does.  On the card its f32 products run in TF32 (10
mantissa bits, where the forward kernel's bf16 operands keep 7, and the f32
forward kernel's TF32 operands as many): in full f32 they took 58% of a
highres128 train step (PERF.md).

The forward is a chain of two wgmma GEMM stages (:func:`ln_fc1_stage`:
LayerNorm prologue, activation epilogue; :func:`linear_stage`: bias, optional
dropout mask and residual in the epilogue), each with a plain version; h
passes between them in bf16.  The activation is one of the JAX `_ACTS`
(fused_mlp.py:63-69, :data:`ACTIVATIONS`).  The megablock (ops/fused_block.py)
runs the same stages, with GELU, after an out-projection through
:func:`ln_mlp_forward` (serving) and ``fused_block.ln_mlp_train_forward``
(training).

The LN -> fc1 stage holds a 128-row tile of its input whole on chip, so it
takes E <= 384 (:data:`RESIDENT_WIDTH`).  A wider E (or ``wide=True``) takes
the wide variant: :func:`ln_rows` writes LN(x) in bf16 with the resident
kernel's statistics, then :func:`fc1_stage` streams those rows through the
same product and epilogue.  Every width that is a multiple of 8 has a kernel.

The stages take bf16 or f32 activations (:func:`kernel_dtype`), as the TPU
kernel computes in its input dtype.  f32 calls launch csrc/ln_f32.cuh's
entries (csrc/ln_mlp_fc1_f32.cu, csrc/ln_mlp_linear_f32.cu: the LayerNorm
rows in f32, then csrc/tile_f32.cuh's TF32 wgmma tile with the fc1 or linear
epilogue), counted as "ln_mlp_fc1_f32" and "ln_mlp_linear_f32"; their rows
stream, so one kernel takes every E and ``wide`` does not apply to them.
The tile reads its weight K-major: each f32 call hands it :func:`kmajor`'s
copy, made anew in the call.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn.functional as F

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.attention import _entry_name, kernel_dtype
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda, recomputing, sequence_parallel_active

# ln_mlp_fwd.cu's fc1 stage holds a 128-row tile of the LayerNorm input whole
# in shared memory: E <= 384 (ln_qkv_fwd and the megablock backward's
# resident stages share the limit).  Wider rows take the wide variants.
RESIDENT_WIDTH = 384


def kernel_fits(e: int, hidden: int, hd: int = 0) -> bool:
    """E, hidden and the prologue's H*Dh multiples of 8 (TMA's 16-byte
    strides); any such E has a kernel, E > 384 the wide variants."""
    return e % 8 == 0 and hidden % 8 == 0 and hd % 8 == 0


def wide_route(e: int, wide: bool = False) -> bool:
    """Whether a call at width E takes the wide variants: E > 384, or
    ``wide`` (a test or chip_smoke.py forcing them at any width)."""
    return wide or e > RESIDENT_WIDTH


def _width_error(what: str, **widths) -> ValueError:
    got = ", ".join(f"{k}={v}" for k, v in widths.items())
    return ValueError(f"{what} takes widths that are multiples of 8, got {got}; other widths "
                      "are ROADMAP.md queue 1 item 7")


def threshold(rate: float) -> int:
    """The TPU kernel's dropout rule (fused_block.py:115): keep where the bits
    are >= this."""
    return min(int(rate * 2 ** 32), 2 ** 32 - 1)


# The activations of the JAX `_ACTS` (vitgan_tpu/ops/fused_mlp.py:63-69), each
# with its id in ln_mlp_fwd.cu's fc1 epilogue (`act`).  GELU is the exact erf
# form, as nn.GELU() computes it.
ACTIVATIONS = {"gelu": F.gelu, "relu": F.relu, "tanh": torch.tanh, "sigmoid": torch.sigmoid}
ACT_ID = {name: i for i, name in enumerate(ACTIVATIONS)}


def _act(activation: str):
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r} (have {tuple(ACTIVATIONS)})")
    return ACTIVATIONS[activation]


def _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
               eps: float = 1e-5, residual: bool = True):
    """Plain LN -> MLP in f32, cast back to x's dtype (the JAX `_reference`)."""
    act = _act(activation)
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    h = act(y @ w1.float() + b1.float())
    out = h @ w2.float() + b2.float()
    if residual:
        out = out + xf
    return out.to(x.dtype)


# --- the two stages of csrc/ln_mlp_fwd.cu, and their plain versions --------------


def linear_stage_reference(a, w, bias, res=None, mask=None,
                           dtype: torch.dtype = torch.bfloat16):
    """Plain linear stage: [res +] [mask *] (a . w + bias) in f32, ``dtype``
    out (the kernel's: bf16, or f32 for the f32 kernel)."""
    v = a.float() @ w.float() + bias.float()
    if mask is not None:
        v = v * mask
    if res is not None:
        v = v + res.float()
    return v.to(dtype)


def ln_fc1_stage_reference(a, ln_s, ln_b, w1, b1, eps: float = 1e-5,
                           dtype: torch.dtype = torch.bfloat16, activation: str = "gelu"):
    """Plain LN -> fc1 -> act stage: (h, z1) in ``dtype`` (the bf16 kernel's,
    or f32: the f32 kernel's, and the scale the wide variant's plain versions
    are held to), z1 = LN(a) . w1 + b1 and h = act(z1) formed in f32."""
    af = a.float()
    mean = af.mean(-1, keepdim=True)
    var = ((af - mean) ** 2).mean(-1, keepdim=True)
    y = (af - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()
    z = y @ w1.float() + b1.float()
    return _act(activation)(z).to(dtype), z.to(dtype)


def ln_rows_reference(x, ln_s, ln_b, eps: float = 1e-5, dtype: torch.dtype = torch.bfloat16):
    """Plain LayerNorm rows (the wide variants' first launch): LN(x) formed
    in f32, in ``dtype`` (the kernel's bf16)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()).to(dtype)


def fc1_stage_reference(y, w1, b1, dtype: torch.dtype = torch.bfloat16,
                        activation: str = "gelu"):
    """Plain wide fc1 stage on y = LN(x): (h, z1) in ``dtype``, z1 = y . w1 +
    b1 and h = act(z1) formed in f32.  After :func:`ln_rows_reference` it
    is :func:`ln_fc1_stage_reference`."""
    z = y.float() @ w1.float() + b1.float()
    return _act(activation)(z).to(dtype), z.to(dtype)


def ln_mlp_stages_reference(x, ln_s, ln_b, w1, b1, w2, b2, eps: float = 1e-5,
                            residual: bool = True, attn=None, wout=None, bout=None,
                            dtype: torch.dtype = torch.bfloat16, activation: str = "gelu"):
    """The plain LN->MLP (or, with ``attn``, the megablock's serving form)
    composed from the stage plain versions, with the kernels' roundings of x1
    and h to ``dtype`` (bf16; none in f32): rows (M, E) -> (M, E) ``dtype``."""
    if attn is not None:
        x = linear_stage_reference(attn, wout, bout, x, dtype=dtype)
    h, _ = ln_fc1_stage_reference(x, ln_s, ln_b, w1, b1, eps, dtype, activation)
    return linear_stage_reference(h, w2, b2, x if residual or attn is not None else None,
                                  dtype=dtype)


def _on_card(what: str, *ts) -> None:
    """The kernels have no other device: raise unless every tensor is CUDA."""
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must be CUDA tensors")


def _kernel_rows(t, what: str):
    _on_card(what, t)
    if t.dim() != 2:
        raise ValueError(f"{what} takes 2-D rows, got {tuple(t.shape)}")
    return build.aligned16(t.contiguous())


def _bf16_only(what: str, t) -> None:
    """The wide bf16 route's own launches (the LN rows, the streamed fc1 and
    qkv products) take bf16 alone: the f32 stages stream every E in one
    kernel and have no such launch."""
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{what} is a launch of the wide bf16 route and takes bf16 rows, got "
                        f"{t.dtype}; the f32 LayerNorm stages stream every E in one kernel "
                        "(ln_fc1_stage, fused_block.ln_qkv_forward)")


def _operands(dev, *pairs):
    """Each tensor in its dtype on ``dev``, as the kernels read them (16-byte
    aligned): weights in the activations' dtype, LN parameters, biases and
    masks in f32; None stays None."""
    return [None if t is None else build.aligned16(t.to(device=dev, dtype=dt).contiguous())
            for t, dt in pairs]


def kmajor(w):
    """A (K, N) weight's K-major copy (N, K): the f32 tile reads both operands
    K-major (csrc/tile_f32.cuh).  Made in each call: a copy kept beside the
    parameter would go stale where a captured step's optimizer updates the
    weight in place between replays."""
    return w.t().contiguous()


def linear_stage(a, w, bias, res=None, seed=None, rate: float = 0.0, mask_id: int = 0,
                 rows=None):
    """Launch the linear stage on bf16 or f32 CUDA rows a (M, K), w (K, N)
    (ln_mlp_fwd.cu's, or ln_mlp_linear_f32.cu's on w K-major in f32): (out, mask) with
    out = [res +] [mask *] (a . w + bias) (M, N) in a's dtype and, for
    ``rate > 0``, the f32 multiply-mask of Philox stream ``mask_id`` drawn
    from the one-element int64 ``seed`` (else None), the same bits in either
    dtype.  ``rows`` (rows a sample, local batch, global batch, first
    sample) keys the mask's rows by their place in the global batch
    (fused_block.mask_rows)."""
    a = _kernel_rows(a, "linear_stage")
    dt = kernel_dtype("linear_stage", *(t for t in (a, res) if t is not None))
    m, k = a.shape
    n = w.shape[-1]
    if w.shape != (k, n) or k % 8 or n % 8:
        raise ValueError(f"linear_stage takes w (K, N) with K, N multiples of 8, got a "
                         f"{tuple(a.shape)}, w {tuple(w.shape)}")
    dev = a.device
    if res is not None:
        res = _kernel_rows(res, "linear_stage")
        if res.shape != (m, n):
            raise ValueError(f"residual {tuple(res.shape)} does not fit ({m}, {n})")
    mask = None
    if rate > 0.0:
        if seed is None or seed.device != dev or seed.dtype != torch.int64:
            raise ValueError("dropout needs a one-element int64 seed on the activations' device")
        mask = torch.empty((m, n), dtype=torch.float32, device=dev)
    # every operand bound to a name until the launch: a temporary freed
    # earlier could hand its memory to the next one; f32 takes w K-major
    wk, biasf = _operands(dev, (kmajor(w) if dt == torch.float32 else w, dt),
                          (bias, torch.float32))
    out = torch.empty((m, n), dtype=dt, device=dev)
    name = _entry_name("ln_mlp_linear", dt)
    fn = build.entry(name)
    build.check(fn, fn(build.ptr(a), build.ptr(wk), build.ptr(biasf), build.ptr(res),
                       build.ptr(seed if mask is not None else None), build.ptr(out),
                       build.ptr(mask), m, k, n, mask_id, threshold(rate),
                       float(1.0 / (1.0 - rate)), *(rows or (1, 1, 1, 0)),
                       build.stream_ptr(dev)))
    build.LAUNCHES[name] += 1
    return out, mask


def ln_rows(x, ln_s, ln_b, eps: float = 1e-5):
    """Launch csrc/ln_rows.cuh's LayerNorm rows (in ln_mlp_fwd's library) on
    bf16 CUDA rows x (M, E), E a multiple of 8: y = LN(x) bf16 (M, E), the
    statistics in the resident kernels' order."""
    x = _kernel_rows(x, "ln_rows")
    _bf16_only("ln_rows", x)
    m, e = x.shape
    if e % 8:
        raise _width_error("ln_rows", E=e)
    dev, f32 = x.device, torch.float32
    ln_sf, ln_bf = _operands(dev, (ln_s, f32), (ln_b, f32))
    y = torch.empty_like(x)
    fn = build.entry("ln_rows")
    build.check(fn, fn(build.ptr(x), build.ptr(ln_sf), build.ptr(ln_bf), build.ptr(y), m, e,
                       float(eps), build.stream_ptr(dev)))
    build.LAUNCHES["ln_rows"] += 1
    return y


def fc1_stage(y, w1, b1, want_z1: bool = False, activation: str = "gelu"):
    """Launch ln_mlp_fwd.cu's wide fc1 stage on bf16 CUDA rows y = LN(x) (M,
    E), streamed: (h, z1) bf16 (M, hidden) as :func:`fc1_stage_reference`,
    z1 None unless ``want_z1``."""
    _act(activation)
    y = _kernel_rows(y, "fc1_stage")
    _bf16_only("fc1_stage", y)
    m, e = y.shape
    hidden = w1.shape[-1]
    if w1.shape != (e, hidden):
        raise ValueError(f"fc1_stage takes w1 (E, hidden), got y {tuple(y.shape)}, w1 "
                         f"{tuple(w1.shape)}")
    if not kernel_fits(e, hidden):
        raise _width_error("fc1_stage", E=e, hidden=hidden)
    dev = y.device
    w1b, b1f = _operands(dev, (w1, torch.bfloat16), (b1, torch.float32))
    h = torch.empty((m, hidden), dtype=torch.bfloat16, device=dev)
    z1 = torch.empty_like(h) if want_z1 else None
    fn = build.entry("ln_mlp_fc1_wide")
    build.check(fn, fn(build.ptr(y), build.ptr(w1b), build.ptr(b1f), build.ptr(h), build.ptr(z1),
                       m, e, hidden, ACT_ID[activation], build.stream_ptr(dev)))
    build.LAUNCHES["ln_mlp_fc1_wide"] += 1
    return h, z1


def ln_fc1_stage(a, ln_s, ln_b, w1, b1, eps: float = 1e-5, want_z1: bool = False,
                 wide: bool = False, activation: str = "gelu"):
    """Launch the LN -> fc1 -> act stage on bf16 or f32 CUDA rows a (M, E):
    (h, z1) (M, hidden) in a's dtype, z1 None unless ``want_z1``.  bf16 runs
    ln_mlp_fwd.cu's stage, and E > 384 (or ``wide``) its wide variant,
    :func:`ln_rows` then :func:`fc1_stage`.  f32 runs ln_mlp_fc1_f32.cu
    (the LayerNorm rows into an f32 scratch, then the tile on w1 K-major),
    which streams every E: ``wide`` is accepted and does not apply."""
    _act(activation)
    a = _kernel_rows(a, "ln_fc1_stage")
    dt = kernel_dtype("ln_fc1_stage", a)
    m, e = a.shape
    hidden = w1.shape[-1]
    if w1.shape != (e, hidden):
        raise ValueError(f"ln_fc1_stage takes w1 (E, hidden), got a {tuple(a.shape)}, w1 "
                         f"{tuple(w1.shape)}")
    if not kernel_fits(e, hidden):
        raise _width_error("ln_fc1_stage", E=e, hidden=hidden)
    if dt == torch.bfloat16 and wide_route(e, wide):
        return fc1_stage(ln_rows(a, ln_s, ln_b, eps), w1, b1, want_z1, activation)
    dev = a.device
    f32 = torch.float32
    w1k, ln_sf, ln_bf, b1f = _operands(dev, (kmajor(w1) if dt == f32 else w1, dt), (ln_s, f32),
                                       (ln_b, f32), (b1, f32))
    h = torch.empty((m, hidden), dtype=dt, device=dev)
    z1 = torch.empty_like(h) if want_z1 else None
    name = _entry_name("ln_mlp_fc1", dt)
    fn = build.entry(name)
    # f32: the LayerNorm rows, which the entry's first kernel writes
    y = torch.empty((m, e), dtype=f32, device=dev) if dt == f32 else None
    extra = [] if y is None else [build.ptr(y)]
    build.check(fn, fn(build.ptr(a), build.ptr(ln_sf), build.ptr(ln_bf), build.ptr(w1k),
                       build.ptr(b1f), build.ptr(h), build.ptr(z1), *extra, m, e, hidden,
                       float(eps), ACT_ID[activation], build.stream_ptr(dev)))
    build.LAUNCHES[name] += 1
    return h, z1


def ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
                   residual: bool = True, attn: Optional[torch.Tensor] = None,
                   wout: Optional[torch.Tensor] = None, bout: Optional[torch.Tensor] = None,
                   activation: str = "gelu"):
    """Run the LN->MLP stages on a bf16 or f32 CUDA x (..., E): two launches
    (fc1, then fc2, each counted by its stage), and one call of
    "ln_mlp_fwd".  In bf16, E > 384 takes the wide LN -> fc1 variant
    (:func:`ln_fc1_stage`), a launch more; f32 takes the f32 stages at every
    E.

    With ``attn`` (..., H*Dh) in x's dtype, ``wout`` (H*Dh, E) and ``bout``
    (E,), the out-projection x1 = x + attn . wout + bout runs first (a third
    launch, x1 kept in x's dtype) and the result is x1 + mlp(LN(x1))
    (``residual`` is then implied), counted as one call of
    "proj_ln_mlp_fwd".  ``activation`` is fc1's (:data:`ACTIVATIONS`)."""
    _on_card("ln_mlp_forward", x)
    kernel_dtype("LN->MLP kernel", x, *([] if attn is None else [attn]))
    e = x.shape[-1]
    hidden = w1.shape[-1]
    hd = 0 if attn is None else attn.shape[-1]
    if not kernel_fits(e, hidden, hd):
        raise _width_error("LN->MLP kernel", E=e, hidden=hidden, HDh=hd)
    if w1.shape != (e, hidden) or w2.shape != (hidden, e):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do not fit E={e}")
    rows = x.reshape(-1, e)
    m = rows.shape[0]
    if attn is not None:
        if attn.numel() != m * hd:
            raise ValueError(f"attn must have {m} rows, got {tuple(attn.shape)}")
        if wout.shape != (hd, e):
            raise ValueError(f"wout {tuple(wout.shape)} does not fit ({hd}, {e})")
        rows, _ = linear_stage(attn.reshape(m, hd), wout, bout, rows)
        name, residual = "proj_ln_mlp_fwd", True
    else:
        name = "ln_mlp_fwd"
    h, _ = ln_fc1_stage(rows, ln_scale, ln_bias, w1, b1, eps, activation=activation)
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
    def forward(ctx, x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual, activation):
        ctx.save_for_backward(x, ln_scale, ln_bias, w1, b1, w2, b2)
        ctx.eps, ctx.residual, ctx.activation = eps, residual, activation
        if recomputing():
            # A rematerialised block re-running for its backward: nothing
            # there reads this output (the backward recomputes from the
            # inputs), so the kernel is not launched again, as XLA drops it
            # from the JAX package's recompute (models/remat.py).  x stands
            # in for it: detach is the one op that needs no place in a
            # selective checkpoint's record of the forward.
            return x.detach()
        if x.device.type == "cpu":
            return _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, eps, residual)
        return ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual,
                              activation=activation)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        create = torch.is_grad_enabled()
        with torch.enable_grad(), _tf32_products(g.is_cuda):
            leaves = saved if create else [t.detach().requires_grad_(n)
                                           for t, n in zip(saved, need)]
            out = _reference(*leaves, ctx.activation, ctx.eps, ctx.residual)
            wanted = [t for t, n in zip(leaves, need) if n]
            grads = iter(torch.autograd.grad(out, wanted, g, create_graph=create)
                         if wanted else ())
        return (*(next(grads) if n else None for n in need), None, None, None)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
                 eps: float = 1e-5, residual: bool = True):
    """out = [x +] fc2(act(fc1(LN(x)))), x: (..., E), differentiable, act one
    of :data:`ACTIVATIONS`.  CUDA tensors launch the kernel (or raise); CPU
    tensors take :func:`_reference`."""
    _act(activation)
    return _LnMlp.apply(x, ln_scale, ln_bias, w1, b1, w2, b2, float(eps), bool(residual),
                        activation)


def dispatch_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
                    residual: bool = True):
    """Policy-routed LN+MLP: 'auto' takes the kernel for CUDA tensors of at
    least ``min_mlp_rows`` rows and hidden >= 512 (the JAX package's TPU
    gate, not yet measured on the GPU) whose widths are multiples of 8
    (:func:`kernel_fits`: every such E has a kernel, E > 384 the wide
    variant; other widths are ROADMAP.md queue 1 item 7), in bf16 or f32.
    'always' sends every block to the kernel: a dtype or width it does not
    take raises in :func:`ln_mlp_forward`, and so does a dtype (f16, f64)
    under 'auto'; neither is sent to the plain version."""
    rows = x.numel() // x.shape[-1]
    mode = _POLICY["mode"]
    big_enough = rows >= _POLICY["min_mlp_rows"] and w1.shape[-1] >= 512
    has_variant = kernel_fits(x.shape[-1], w1.shape[-1])
    use = mode == "always" or (mode == "auto" and on_cuda(x) and big_enough and has_variant)
    if sequence_parallel_active():  # sequence parallelism (fused_mlp.py:211-212)
        use = False
    if use:
        return fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, 1e-5, residual)
    return _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, 1e-5, residual)
