"""Fused LN -> fc1 -> GELU -> fc2 [+ residual]: the CUDA kernel, its plain
version, routing.

Counterpart of vitgan_tpu/ops/fused_mlp.py.  ``fused_ln_mlp`` launches
csrc/ln_mlp_fwd.cu on CUDA tensors and takes ``_reference`` on CPU tensors.
The same kernel, with its out-projection prologue, is the third launch of
the megablock (ops/fused_block.py), through :func:`ln_mlp_forward`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.policy import _POLICY, on_cuda

# ln_mlp_fwd's 64-row tiles and 64-wide hidden chunks fill shared memory at
# E = 384 (ln_qkv_fwd, which shares this limit, would take 416).
MAX_WIDTH = 384


def kernel_fits(e: int, hidden: int, hd: int = 0) -> bool:
    """E <= 384; E, hidden and the prologue's H*Dh multiples of 8 (16-byte copies)."""
    return e <= MAX_WIDTH and e % 8 == 0 and hidden % 8 == 0 and hd % 8 == 0


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


def ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps: float = 1e-5,
                   residual: bool = True, attn: Optional[torch.Tensor] = None,
                   wout: Optional[torch.Tensor] = None, bout: Optional[torch.Tensor] = None):
    """Launch the kernel on a bf16 CUDA x (..., E).  Weights are cast to bf16
    and LN parameters and biases to f32, as the TPU kernel reads them.

    With ``attn`` (..., H*Dh) bf16, ``wout`` (H*Dh, E) and ``bout`` (E,), the
    prologue x1 = x + attn . wout + bout runs first and the result is
    x1 + mlp(LN(x1)) (``residual`` is then implied)."""
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
    dev = x.device
    bf = lambda t: build.aligned16(t.to(device=dev, dtype=torch.bfloat16).contiguous())  # noqa: E731
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    x2 = bf(x.reshape(-1, e))
    m = x2.shape[0]
    w1b, w2b = bf(w1), bf(w2)
    ln_s, ln_b, b1f, b2f = f32(ln_scale), f32(ln_bias), f32(b1), f32(b2)
    if attn is not None:
        if attn.dtype != torch.bfloat16 or attn.numel() != m * hd:
            raise ValueError(f"attn must be bf16 with {m} rows, got {attn.dtype} "
                             f"{tuple(attn.shape)}")
        if wout.shape != (hd, e):
            raise ValueError(f"wout {tuple(wout.shape)} does not fit ({hd}, {e})")
        attn2, woutb, boutf = bf(attn.reshape(m, hd)), bf(wout), f32(bout)
        name = "proj_ln_mlp_fwd"
    else:
        attn2 = woutb = boutf = None
        name = "ln_mlp_fwd"
    out = torch.empty_like(x2)
    fn = build.entry("ln_mlp_fwd")
    build.check(fn, fn(build.ptr(x2), build.ptr(attn2), build.ptr(woutb), build.ptr(boutf),
                       build.ptr(ln_s), build.ptr(ln_b), build.ptr(w1b), build.ptr(b1f),
                       build.ptr(w2b), build.ptr(b2f), build.ptr(out), m, e, hd, hidden,
                       float(eps), int(residual), build.stream_ptr(dev)))
    build.LAUNCHES[name] += 1
    return out.reshape(x.shape)


def fused_ln_mlp(x, ln_scale, ln_bias, w1, b1, w2, b2, activation: str = "gelu",
                 eps: float = 1e-5, residual: bool = True):
    """out = [x +] fc2(gelu(fc1(LN(x)))), x: (..., E).  CUDA tensors launch the
    kernel (or raise); CPU tensors take :func:`_reference`."""
    _check_activation(activation)
    if x.device.type == "cpu":
        return _reference(x, ln_scale, ln_bias, w1, b1, w2, b2, activation, eps, residual)
    return ln_mlp_forward(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual)


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
