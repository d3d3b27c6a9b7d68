"""The v2 encoder block through fused CUDA launches ("megablock"), forward and
saved-residual backward.

Counterpart of vitgan_tpu/ops/fused_block.py.  The TPU kernel `_kernel` runs
the whole pre-LN block for a group of samples in one VMEM-resident program.
An H100 SM has 227 KB of shared memory, and one sample's qkv at 1,024 tokens
is 2.4 MB in bf16, so the port splits the block where the data must leave
the chip anyway:

1. csrc/ln_qkv_fwd.cu: LN1 -> qkv projection + bias, written straight into
   the (3, B, H, N, Dh) layout;
2. csrc/flash_attn_fwd.cu: per-head softmax(q.k^T/sqrt(Dh)).v, written in
   the (B, N, H*Dh) layout, with its LSE;
3. csrc/ln_mlp_fwd.cu as three wgmma GEMM stages: x1 = x + attn.wout + bout
   (in bf16), then LN2 -> fc1 -> GELU, then fc2 -> + x1.  Its training form
   (:func:`ln_mlp_train_forward`) draws the dropout masks in the stages'
   epilogues from Philox4x32-10 and keeps x1 and z1 as saved residuals.

The saved-residual backward (`fused_encoder_block_bwd`, the TPU's single
`_bwd_kernel`) becomes csrc/megablock_bwd_mlp.cu (MLP half, out-projection,
dao and delta, as three wgmma GEMM stages: dz1, dx1 with the LN2 backward,
dao with delta), the qkv recompute by ln_qkv_fwd, the flash backward kernels
on the JAX route, csrc/megablock_bwd_ln1.cu (LN1 half) and
csrc/wgrad_gemm.cu (the 12 parameter gradients, summed over row ranges and a
second deterministic pass).

Each launch has a plain PyTorch version; composed, they are the block's plain
forward and backward, which CPU tensors take.  The four autograd Functions
carry the JAX names (`encoder_block_fused[_dropout][_saved]`), and
:func:`maybe_megablock` is the JAX gate.
"""

from __future__ import annotations

import math
import operator
import warnings
from types import SimpleNamespace
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.attention import (attention_forward_reference, attention_reference,
                                            flash_backward, flash_forward)
from vitgan_tpu_torch.ops.fused_mlp import _operands, _tf32_products
from vitgan_tpu_torch.ops.fused_mlp import _reference as mlp_reference
from vitgan_tpu_torch.ops.fused_mlp import kernel_fits as mlp_kernel_fits
from vitgan_tpu_torch.ops.fused_mlp import (linear_stage, linear_stage_reference, ln_fc1_stage,
                                            ln_fc1_stage_reference, ln_mlp_forward, threshold)
from vitgan_tpu_torch.ops.policy import megablock_bwd_mode, megablock_mode, on_cuda, same_device
from vitgan_tpu_torch.ops.wgrad import sum_partials, wgrad


def _qkv_weight(qkv_w, dtype):
    """(3, H, E, Dh) -> (E, 3*H*Dh), columns [q_h0..q_hH, k_h0.., v_h0..] as
    `_pad_params` lays them out (fused_block.py:280)."""
    _, h, e, dh = qkv_w.shape
    return qkv_w.permute(2, 0, 1, 3).reshape(e, 3 * h * dh).to(dtype)


def _qkv_bias(p):
    """(3, H, Dh) -> (3*H*Dh,), in `_qkv_weight`'s column order."""
    return p.msha.qkv_b.reshape(-1)


def _ln_qkv_reference(x, ln_scale, ln_bias, qkv_w, qkv_b, eps: float = 1e-5):
    """Plain LN1 -> qkv: x (B, N, E) -> (3, B, H, N, Dh) in x's dtype, f32 math."""
    b, n, e = x.shape
    _, h, _, dh = qkv_w.shape
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    qkv = y @ _qkv_weight(qkv_w, torch.float32) + qkv_b.float()
    return qkv.reshape(b, n, 3, h, dh).permute(2, 0, 3, 1, 4).contiguous().to(x.dtype)


def ln_qkv_forward(x, ln_scale, ln_bias, qkv_w, qkv_b, eps: float = 1e-5):
    """Launch csrc/ln_qkv_fwd.cu on a bf16 CUDA x (B, N, E); returns the
    (3, B, H, N, Dh) bf16 q/k/v."""
    if not x.is_cuda:
        raise ValueError("ln_qkv_forward launches a CUDA kernel: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"LN->qkv kernel takes bf16 activations, got {x.dtype}; other dtypes "
                        "are ROADMAP.md queue 1 item 7 (or set runtime.use_pallas=never)")
    b, n, e = x.shape
    _, h, e_w, dh = qkv_w.shape
    if e_w != e:
        raise ValueError(f"qkv weight width {e_w} does not fit E={e}")
    if dh % 8 or not mlp_kernel_fits(e, 0):
        raise ValueError(f"LN->qkv kernel takes E <= 384 and E, Dh multiples of 8, got "
                         f"E={e}, Dh={dh}; wider blocks are ROADMAP.md queue 1 item 7")
    dev, f32 = x.device, torch.float32
    x2 = build.aligned16(x.contiguous())
    w, bias, ln_s, ln_b = _operands(dev, (_qkv_weight(qkv_w, torch.bfloat16), torch.bfloat16),
                                    (qkv_b, f32), (ln_scale, f32), (ln_bias, f32))
    out = torch.empty((3, b, h, n, dh), dtype=torch.bfloat16, device=dev)
    fn = build.entry("ln_qkv_fwd")
    build.check(fn, fn(build.ptr(x2), build.ptr(ln_s), build.ptr(ln_b), build.ptr(w),
                       build.ptr(bias), build.ptr(out), b, n, e, h, dh, float(eps),
                       build.stream_ptr(dev)))
    build.LAUNCHES["ln_qkv_fwd"] += 1
    return out


def _proj_ln_mlp_reference(x, attn, wout, bout, ln_scale, ln_bias, w1, b1, w2, b2,
                           eps: float = 1e-5):
    """Plain x1 = x + attn.wout + bout; x1 + MLP(LN2(x1)), f32 math, x's dtype."""
    x1 = x.float() + attn.float() @ wout.float() + bout.float()
    out = x1 + mlp_reference(x1, ln_scale, ln_bias, w1, b1, w2, b2, "gelu", eps, False)
    return out.to(x.dtype)


def _block_reference(x, p, num_heads: int, eps: float = 1e-5):
    """Plain v2 block (dropout-free): the three launches' plain versions composed.
    ``p`` is an encoder block (models/vitgan_v2.EncoderBlock) in the JAX layout."""
    b, n, e = x.shape
    _, h, _, dh = p.msha.qkv.shape
    if h != num_heads:
        raise ValueError(f"params carry {h} heads, num_heads={num_heads}")
    qkv = _ln_qkv_reference(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
    attn = attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(dh))
    attn = attn.transpose(1, 2).reshape(b, n, h * dh)
    return _proj_ln_mlp_reference(x, attn, p.msha.out.w, p.msha.out.b, p.ln2.scale, p.ln2.bias,
                                  p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b, eps)


# --- dropout bits: Philox4x32-10 ------------------------------------------------

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant a and the
    int64 tensor b (both < 2**32), without overflowing int64."""
    p_lo, p_hi = b * (a & 0xFFFF), b * (a >> 16)
    mid = ((p_hi & 0xFFFF) << 16) + p_lo
    return (p_hi >> 16) + (mid >> 32), mid & _M32


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding 32-bit
    words: the plain version of csrc/common.cuh's, bit for bit."""
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(seed, mask_id: int, count: int):
    """The 32 dropout bits of elements 0..count-1 of mask ``mask_id`` as an
    int64 tensor on the seed's device: element i is word i % 4 of
    philox(counter (i // 4 low, i // 4 high, mask_id, 0), key (seed low, seed
    high)), so it depends on nothing but the seed and its place.  ``seed`` is
    a one-element int64 tensor; it is never read back to the host."""
    s = seed.reshape(()).to(torch.int64)
    q = torch.arange((count + 3) // 4, dtype=torch.int64, device=seed.device)
    words = philox4x32_10(q & _M32, q >> 32, torch.full_like(q, mask_id), torch.zeros_like(q),
                          s & _M32, (s >> 32) & _M32)
    return torch.stack(words, -1).reshape(-1)[:count]


def dropout_mask(seed, mask_id: int, shape, rate: float):
    """The f32 multiply-mask the kernels draw: 1 / (1 - rate) where the bits
    are >= fused_mlp.threshold, else 0."""
    bits = dropout_bits(seed, mask_id, math.prod(shape))
    keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=seed.device)
    return torch.where(bits >= threshold(rate), keep, torch.zeros_like(keep)).reshape(shape)


def new_seed(generator: torch.Generator, x: torch.Tensor):
    """One int64 seed on x's device from the step's generator (the JAX gate
    draws `seed` from its rng, fused_block.py:985); no host sync."""
    if not same_device(generator, x):
        raise ValueError(f"dropout draws on x's device {x.device}, the generator is on "
                         f"{generator.device}")
    return torch.randint(0, 2 ** 62, (1,), generator=generator, device=x.device)


# --- training forward: masks and saved residuals --------------------------------


def _proj_ln_mlp_train_reference(x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2, seed,
                                 rate: float, eps: float = 1e-5):
    """Plain version of ln_mlp_train_fwd on (M, E) rows: (out, m1, m2, x1,
    z1), masks None without dropout.  a = attn.wout + bout; x1 = x + m1*a;
    z1 = LN2(x1).w1 + b1; out = x1 + m2*(gelu(z1).w2 + b2); f32 math,
    x's dtype out (masks f32)."""
    a = attn.float() @ wout.float() + bout.float()
    m1 = m2 = None
    if rate > 0.0:
        m1 = dropout_mask(seed, 0, a.shape, rate)
        a = a * m1
    x1 = x.float() + a
    mean = x1.mean(-1, keepdim=True)
    var = ((x1 - mean) ** 2).mean(-1, keepdim=True)
    y2 = (x1 - mean) * torch.rsqrt(var + eps) * ln_s.float() + ln_b.float()
    z1 = y2 @ w1.float() + b1.float()
    mlp = F.gelu(z1) @ w2.float() + b2.float()
    if rate > 0.0:
        m2 = dropout_mask(seed, 1, mlp.shape, rate)
        mlp = mlp * m2
    return (x1 + mlp).to(x.dtype), m1, m2, x1.to(x.dtype), z1.to(x.dtype)


def _proj_ln_mlp_train_stages_reference(x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2,
                                        seed, rate: float, eps: float = 1e-5):
    """The training form composed from the stage plain versions (fused_mlp),
    with the kernels' bf16 roundings of x1 and h: (out, m1, m2, x1, z1) as
    :func:`_proj_ln_mlp_train_reference`."""
    m1 = dropout_mask(seed, 0, x.shape, rate) if rate > 0.0 else None
    x1 = linear_stage_reference(attn, wout, bout, x, m1)
    h, z1 = ln_fc1_stage_reference(x1, ln_s, ln_b, w1, b1, eps)
    m2 = dropout_mask(seed, 1, x1.shape, rate) if rate > 0.0 else None
    return linear_stage_reference(h, w2, b2, x1, m2), m1, m2, x1, z1


def ln_mlp_train_forward(x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2, seed, rate: float,
                         eps: float = 1e-5):
    """Run ln_mlp_fwd.cu's training form on bf16 CUDA rows x (M, E), attn
    (M, H*Dh): three launches (out-projection, LN2 -> fc1 -> GELU, fc2),
    each counted by its stage, and one call of "ln_mlp_train_fwd"; returns (out, m1, m2, x1, z1)
    as the plain version."""
    if not (x.is_cuda and attn.is_cuda):
        raise ValueError("ln_mlp_train_forward launches a CUDA kernel: x must be a CUDA tensor")
    if x.dtype != torch.bfloat16 or attn.dtype != torch.bfloat16:
        raise TypeError(f"LN->MLP kernel takes bf16 activations, got {x.dtype}; other dtypes "
                        "are ROADMAP.md queue 1 item 7 (or set runtime.use_pallas=never)")
    m, e = x.shape
    hidden, hd = w1.shape[-1], attn.shape[-1]
    if not mlp_kernel_fits(e, hidden, hd) or attn.shape[0] != m:
        raise ValueError(f"LN->MLP kernel takes E <= 384 and E, hidden, H*Dh multiples of 8, "
                         f"got E={e}, hidden={hidden}, H*Dh={hd}; wider blocks are ROADMAP.md "
                         "queue 1 item 7")
    if w1.shape != (e, hidden) or w2.shape != (hidden, e) or wout.shape != (hd, e):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} / wout "
                         f"{tuple(wout.shape)} do not fit E={e}, H*Dh={hd}")
    x1, m1 = linear_stage(attn, wout, bout, x, seed, rate, 0)
    h, z1 = ln_fc1_stage(x1, ln_s, ln_b, w1, b1, eps, want_z1=True)
    out, m2 = linear_stage(h, w2, b2, x1, seed, rate, 1)
    build.LAUNCHES["ln_mlp_train_fwd"] += 1
    return out, m1, m2, x1, z1


class Residuals(NamedTuple):
    """What the saved-residual backward reads: the input, the f32 dropout
    masks (None without dropout), x1 (B, N, E), z1 (B, N, hidden), the
    attention output ao (B, N, H*Dh) and its LSE (B, H, N), f32."""

    x: torch.Tensor
    m1: Optional[torch.Tensor]
    m2: Optional[torch.Tensor]
    x1: torch.Tensor
    z1: torch.Tensor
    ao: torch.Tensor
    lse: torch.Tensor


def fused_encoder_block(x, p, *, num_heads: int, eps: float = 1e-5, rate: float = 0.0,
                        seed=None, want_residuals: bool = False):
    """x (B, N, E) -> one v2 encoder block forward (the JAX
    `fused_encoder_block`).  CUDA tensors run the kernels (or raise); CPU
    tensors take their plain versions.

    With ``rate > 0`` (and a one-element int64 ``seed`` tensor) the dropout
    masks are drawn from Philox4x32-10 and returned as f32 multiply-masks:
    ``(out, m1, m2)``.  With ``want_residuals`` it returns ``(out,
    Residuals)`` for :func:`fused_encoder_block_bwd`."""
    b, n, e = x.shape
    _, h, _, dh = p.msha.qkv.shape
    if h != num_heads:
        raise ValueError(f"params carry {h} heads, num_heads={num_heads}")
    if rate > 0.0 and seed is None:
        raise ValueError("dropout rate > 0 requires a seed")
    cpu = x.device.type == "cpu"
    if rate == 0.0 and not want_residuals:  # the inference form: three launches
        if cpu:
            return _block_reference(x, p, num_heads, eps)
        qkv = ln_qkv_forward(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
        attn = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device=x.device)
        flash_forward(qkv[0], qkv[1], qkv[2], float(dh), out=attn)
        return ln_mlp_forward(x, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b,
                              eps, attn=attn, wout=p.msha.out.w, bout=p.msha.out.b)
    if cpu:
        qkv = _ln_qkv_reference(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
        ao, lse = attention_forward_reference(qkv[0], qkv[1], qkv[2], float(dh))
        ao = ao.transpose(1, 2).reshape(b, n, h * dh)
        mlp = _proj_ln_mlp_train_reference
    else:
        qkv = ln_qkv_forward(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
        ao = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device=x.device)
        _, lse = flash_forward(qkv[0], qkv[1], qkv[2], float(dh), out=ao)
        mlp = ln_mlp_train_forward
    out, m1, m2, x1, z1 = mlp(x.reshape(b * n, e), ao.reshape(b * n, h * dh), p.msha.out.w,
                              p.msha.out.b, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w,
                              p.fc2.b, seed, rate, eps)
    shape = (b, n, e)
    m1, m2 = (None if t is None else t.reshape(shape) for t in (m1, m2))
    out = out.reshape(shape)
    if want_residuals:
        return out, Residuals(x, m1, m2, x1.reshape(shape), z1.reshape(b, n, -1), ao, lse)
    return out, m1, m2


def _block_reference_masked(x, p, m1, m2, num_heads: int, eps: float = 1e-5):
    """Plain v2 block applying pre-drawn f32 multiply-masks (the JAX
    `_block_reference_masked`, fused_block.py:819-833): the recompute
    backward of the dropout forward."""
    b, n, e = x.shape
    _, h, _, dh = p.msha.qkv.shape
    qkv = _ln_qkv_reference(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
    attn = attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(dh))
    attn = attn.transpose(1, 2).reshape(b, n, h * dh)
    a = (attn.float() @ p.msha.out.w.float() + p.msha.out.b.float()).to(x.dtype)
    x1 = x + (a.float() * m1).to(x.dtype)
    mlp = mlp_reference(x1, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b,
                        "gelu", eps, False)
    return x1 + (mlp.float() * m2).to(x.dtype)


# --- saved-residual backward ------------------------------------------------------


def _gelu_grad(z):
    """d/dz of the exact erf GELU (the forward kernels' and F.gelu's)."""
    return 0.5 * (1.0 + torch.erf(z * 0.7071067811865476)) + z * 0.3989422804014327 * torch.exp(
        -0.5 * z * z)


def _ln_stats(x, eps: float):
    """(yhat, rstd) of rows of the f32 x."""
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt(((x - mean) ** 2).mean(-1, keepdim=True) + eps)
    return (x - mean) * rstd, rstd


def _ln_bwd(dy, yhat, rstd, scale):
    """dX of y = yhat * scale + bias given dY (`_ln_bwd`, fused_block.py:464-470)."""
    t = dy * scale
    return (t - t.mean(-1, keepdim=True) - yhat * (t * yhat).mean(-1, keepdim=True)) * rstd


class BwdMlp(NamedTuple):
    """megablock_bwd_mlp's outputs: dmlp, dz1, h1 = gelu(z1), y2 = LN2(x1) and
    da in the activations' dtype (dmlp is g itself without dropout), dx1 f32,
    dao (B, H, N, Dh), delta (B, H, N) f32 and the column partials of dln2
    (tiles, 2E) f32 (scale, then bias)."""

    dmlp: torch.Tensor
    dz1: torch.Tensor
    h1: torch.Tensor
    y2: torch.Tensor
    dx1: torch.Tensor
    da: torch.Tensor
    dao: torch.Tensor
    delta: torch.Tensor
    part: torch.Tensor


def _bwd_mlp_reference(g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, batch: int, n: int,
                       heads: int, eps: float = 1e-5) -> BwdMlp:
    """Plain version of megablock_bwd_mlp on (M, .) rows (f32 math, the MLP
    half of `_bwd_kernel`, fused_block.py:528-561, with delta of :602)."""
    dt = g.dtype
    gf = g.float()
    dmlp = gf * m2 if m2 is not None else gf
    z = z1.float()
    dz1 = (dmlp @ w2.float().T) * _gelu_grad(z)
    dy2 = dz1 @ w1.float().T
    yhat, rstd = _ln_stats(x1.float(), eps)
    dx1 = gf + _ln_bwd(dy2, yhat, rstd, ln_s.float())
    da = dx1 * m1 if m1 is not None else dx1
    dao = da @ wout.float().T
    dh = dao.shape[-1] // heads
    delta = (dao * ao.float()).reshape(batch, n, heads, dh).sum(-1).transpose(1, 2)
    dao = dao.reshape(batch, n, heads, dh).transpose(1, 2)
    part = torch.cat([(dy2 * yhat).sum(0), dy2.sum(0)])[None]
    y2 = yhat * ln_s.float() + ln_b.float()
    return BwdMlp(dmlp.to(dt), dz1.to(dt), F.gelu(z).to(dt), y2.to(dt), dx1, da.to(dt),
                  dao.to(dt).contiguous(), delta.contiguous(), part)


def _check_bwd(what: str, *ts) -> None:
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} launches a CUDA kernel: its tensors must be CUDA tensors")
    if not all(t.dtype == torch.bfloat16 for t in ts):
        raise TypeError(f"{what} takes bf16 activations, got {[t.dtype for t in ts]}; other "
                        "dtypes are ROADMAP.md queue 1 item 7 (or set runtime.use_pallas=never)")


# --- the MLP half as csrc/megablock_bwd_mlp.cu's three stages --------------------

# Rows of the LayerNorm-backward kernels' tiles (the dx1 stage, the LN1
# half): one row of LN column partials each.
BWD_TILE_ROWS = 64


def _tile_partials(dy, yhat):
    """(ceil(M / 64), 2E) f32: each 64-row tile's column sums of dy * yhat,
    then of dy (an LN scale's and bias's partials, as the kernels give them)."""
    m, e = dy.shape
    tiles = -(-m // BWD_TILE_ROWS)
    cols = torch.cat([dy * yhat, dy], 1)
    return F.pad(cols, (0, 0, 0, tiles * BWD_TILE_ROWS - m)).reshape(
        tiles, BWD_TILE_ROWS, 2 * e).sum(1)


def bwd_dz1_stage_reference(g, m2, z1, w2):
    """Plain dz1 stage: (dmlp, dz1, h1) bf16 with dmlp = g * m2 rounded to
    bf16 (g itself without a mask) as the kernel's product reads it, dz1 =
    (dmlp . w2^T) * gelu'(z1) and h1 = gelu(z1) formed in f32."""
    dmlp = g if m2 is None else (g.float() * m2).to(torch.bfloat16)
    z = z1.float()
    dz1 = (dmlp.float() @ w2.float().T) * _gelu_grad(z)
    return dmlp, dz1.to(torch.bfloat16), F.gelu(z).to(torch.bfloat16)


def bwd_dx1_stage_reference(dz1, g, m1, x1, w1, ln_s, ln_b, eps: float = 1e-5):
    """Plain dx1 stage on bf16 rows: (dx1 f32, da bf16, y2 bf16, part) with
    dy2 = dz1 . w1^T, dx1 = g + LN2^T(dy2) (statistics from x1), da = dx1 *
    m1, y2 = LN2(x1), and part (ceil(M / 64), 2E) f32 the column sums of dy2
    * yhat2 and of dy2 over each 64-row tile."""
    dy2 = dz1.float() @ w1.float().T
    yhat, rstd = _ln_stats(x1.float(), eps)
    dx1 = g.float() + _ln_bwd(dy2, yhat, rstd, ln_s.float())
    da = dx1 * m1 if m1 is not None else dx1
    y2 = yhat * ln_s.float() + ln_b.float()
    return dx1, da.to(torch.bfloat16), y2.to(torch.bfloat16), _tile_partials(dy2, yhat)


def bwd_dao_stage_reference(da, ao, wout, batch: int, n: int, heads: int):
    """Plain dao stage: dao (B, H, N, Dh) bf16 = da . wout^T and delta (B, H,
    N) f32, each head's sum of dao * ao with dao in f32."""
    dao = da.float() @ wout.float().T
    dh = dao.shape[-1] // heads
    delta = (dao * ao.float()).reshape(batch, n, heads, dh).sum(-1).transpose(1, 2)
    dao = dao.reshape(batch, n, heads, dh).transpose(1, 2)
    return dao.to(torch.bfloat16).contiguous(), delta.contiguous()


def bwd_mlp_stages_reference(g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, batch: int,
                             n: int, heads: int, eps: float = 1e-5) -> BwdMlp:
    """The MLP half composed from the stage plain versions, with the kernels'
    bf16 hand-offs of dmlp, dz1 and da: a BwdMlp as :func:`_bwd_mlp_reference`,
    part by 64-row tiles."""
    dmlp, dz1, h1 = bwd_dz1_stage_reference(g, m2, z1, w2)
    dx1, da, y2, part = bwd_dx1_stage_reference(dz1, g, m1, x1, w1, ln_s, ln_b, eps)
    dao, delta = bwd_dao_stage_reference(da, ao, wout, batch, n, heads)
    return BwdMlp(dmlp, dz1, h1, y2, dx1, da, dao, delta, part)


def _bwd_fits(e: int, hidden: int, hd: int) -> None:
    if not mlp_kernel_fits(e, hidden, hd):
        raise ValueError(f"megablock backward kernels take E <= 384 and E, hidden, H*Dh "
                         f"multiples of 8, got E={e}, hidden={hidden}, H*Dh={hd}; wider blocks "
                         "are ROADMAP.md queue 1 item 7")


def bwd_dz1_stage(g, m2, z1, w2):
    """Launch megablock_bwd_mlp.cu's dz1 stage on bf16 CUDA rows g (M, E), z1
    (M, hidden), w2 (hidden, E), m2 (M, E) f32 or None: (dmlp, dz1, h1) as
    the plain version (dmlp is g itself without a mask)."""
    _check_bwd("megablock_bwd_mlp_dz1", g, z1)
    m, e = g.shape
    hidden = z1.shape[-1]
    _bwd_fits(e, hidden, 0)
    if z1.shape[0] != m or w2.shape != (hidden, e):
        raise ValueError(f"z1 {tuple(z1.shape)} / w2 {tuple(w2.shape)} do not fit g "
                         f"{tuple(g.shape)}")
    dev = g.device
    g2, z12 = build.aligned16(g.contiguous()), build.aligned16(z1.contiguous())
    m2f, w2b = _operands(dev, (m2, torch.float32), (w2, torch.bfloat16))
    dmlp = g2 if m2 is None else torch.empty_like(g2)
    dz1, h1 = torch.empty_like(z12), torch.empty_like(z12)
    fn = build.entry("megablock_bwd_mlp_dz1")
    build.check(fn, fn(build.ptr(g2), build.ptr(m2f), build.ptr(z12), build.ptr(w2b),
                       build.ptr(dmlp if m2 is not None else None), build.ptr(dz1), build.ptr(h1),
                       m, e, hidden, build.stream_ptr(dev)))
    build.LAUNCHES["megablock_bwd_mlp_dz1"] += 1
    return dmlp, dz1, h1


def bwd_dx1_stage(dz1, g, m1, x1, w1, ln_s, ln_b, eps: float = 1e-5):
    """Launch megablock_bwd_mlp.cu's dx1 stage on bf16 CUDA rows dz1 (M,
    hidden), g, x1 (M, E), w1 (E, hidden), m1 (M, E) f32 or None: (dx1 f32,
    da, y2, part (ceil(M / 64), 2E) f32) as the plain version."""
    _check_bwd("megablock_bwd_mlp_dx1", dz1, g, x1)
    m, e = g.shape
    hidden = dz1.shape[-1]
    _bwd_fits(e, hidden, 0)
    if dz1.shape[0] != m or x1.shape != (m, e) or w1.shape != (e, hidden):
        raise ValueError(f"dz1 {tuple(dz1.shape)} / x1 {tuple(x1.shape)} / w1 "
                         f"{tuple(w1.shape)} do not fit g {tuple(g.shape)}")
    dev = g.device
    dz12, g2, x12 = (build.aligned16(t.contiguous()) for t in (dz1, g, x1))
    f32 = torch.float32
    m1f, w1b, ln_sf, ln_bf = _operands(dev, (m1, f32), (w1, torch.bfloat16), (ln_s, f32),
                                           (ln_b, f32))
    dx1 = torch.empty((m, e), dtype=f32, device=dev)
    da, y2 = torch.empty_like(g2), torch.empty_like(g2)
    part = torch.empty((-(-m // BWD_TILE_ROWS), 2 * e), dtype=f32, device=dev)
    fn = build.entry("megablock_bwd_mlp_dx1")
    build.check(fn, fn(build.ptr(dz12), build.ptr(g2), build.ptr(m1f), build.ptr(x12),
                       build.ptr(w1b), build.ptr(ln_sf), build.ptr(ln_bf), build.ptr(dx1),
                       build.ptr(da), build.ptr(y2), build.ptr(part), m, e, hidden, float(eps),
                       build.stream_ptr(dev)))
    build.LAUNCHES["megablock_bwd_mlp_dx1"] += 1
    return dx1, da, y2, part


def bwd_dao_stage(da, ao, wout, batch: int, n: int, heads: int):
    """Launch megablock_bwd_mlp.cu's dao stage on bf16 CUDA rows da (M, E),
    ao (M, H*Dh), wout (H*Dh, E), M = batch * n, Dh a multiple of 8: (dao
    (B, H, N, Dh) bf16, delta (B, H, N) f32) as the plain version."""
    _check_bwd("megablock_bwd_mlp_dao", da, ao)
    m, e = da.shape
    hd = ao.shape[-1]
    _bwd_fits(e, 0, hd)
    if m != batch * n or ao.shape[0] != m or hd % heads or wout.shape != (hd, e):
        raise ValueError(f"ao {tuple(ao.shape)} / wout {tuple(wout.shape)} do not fit da "
                         f"{tuple(da.shape)} as ({batch}, {n}) rows of {heads} heads")
    if (hd // heads) % 8:
        raise ValueError(f"the dao stage takes Dh a multiple of 8 (as LN->qkv), got "
                         f"Dh={hd // heads}")
    dev = da.device
    da2, ao2 = build.aligned16(da.contiguous()), build.aligned16(ao.contiguous())
    (woutb,) = _operands(dev, (wout, torch.bfloat16))
    dao = torch.empty((batch, heads, n, hd // heads), dtype=torch.bfloat16, device=dev)
    delta = torch.empty((batch, heads, n), dtype=torch.float32, device=dev)
    fn = build.entry("megablock_bwd_mlp_dao")
    build.check(fn, fn(build.ptr(da2), build.ptr(ao2), build.ptr(woutb), build.ptr(dao),
                       build.ptr(delta), batch, n, e, heads, hd // heads, build.stream_ptr(dev)))
    build.LAUNCHES["megablock_bwd_mlp_dao"] += 1
    return dao, delta


def megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, batch: int, n: int,
                      heads: int, eps: float = 1e-5) -> BwdMlp:
    """Run csrc/megablock_bwd_mlp.cu's three stages on bf16 CUDA rows g, x1
    (M, E), z1 (M, hidden), ao (M, H*Dh); masks (M, E) f32 or None: three
    launches (dz1, dx1, dao, each counted by its stage) and one call of
    "megablock_bwd_mlp"."""
    _check_bwd("megablock_bwd_mlp", g, x1, z1, ao)
    _bwd_fits(g.shape[-1], z1.shape[-1], ao.shape[-1])
    if (m1 is None) != (m2 is None):
        raise ValueError("megablock_bwd_mlp takes both dropout masks or neither")
    dmlp, dz1, h1 = bwd_dz1_stage(g, m2, z1, w2)
    dx1, da, y2, part = bwd_dx1_stage(dz1, g, m1, x1, w1, ln_s, ln_b, eps)
    dao, delta = bwd_dao_stage(da, ao, wout, batch, n, heads)
    build.LAUNCHES["megablock_bwd_mlp"] += 1
    return BwdMlp(dmlp, dz1, h1, y2, dx1, da, dao, delta, part)


def _bwd_ln1_reference(dqkv, qkv_w, x, dx1, ln_s, ln_b, eps: float = 1e-5):
    """Plain version of megablock_bwd_ln1 on (M, .) rows: (dx and y1 = LN1(x)
    in x's dtype, dln1 column partials (ceil(M / 64), 2E) f32, a row a
    64-row tile as the kernel gives them)."""
    dy1 = dqkv.float() @ _qkv_weight(qkv_w, torch.float32).T
    yhat, rstd = _ln_stats(x.float(), eps)
    dx = dx1.float() + _ln_bwd(dy1, yhat, rstd, ln_s.float())
    y1 = yhat * ln_s.float() + ln_b.float()
    return dx.to(x.dtype), y1.to(x.dtype), _tile_partials(dy1, yhat)


def megablock_bwd_ln1(dqkv, qkv_w, x, dx1, ln_s, ln_b, eps: float = 1e-5):
    """Launch csrc/megablock_bwd_ln1.cu on bf16 CUDA rows dqkv (M, 3*H*Dh),
    x (M, E) and f32 dx1 (M, E); returns as the plain version."""
    _check_bwd("megablock_bwd_ln1", dqkv, x)
    m, e = x.shape
    k = dqkv.shape[-1]
    if not mlp_kernel_fits(e, 0, k) or dx1.shape != (m, e):
        raise ValueError(f"megablock backward kernels take E <= 384 and E, 3*H*Dh multiples "
                         f"of 8, got E={e}, 3*H*Dh={k}; wider blocks are ROADMAP.md queue 1 "
                         "item 7")
    dev, f32 = x.device, torch.float32
    dqkv2, x2 = build.aligned16(dqkv.contiguous()), build.aligned16(x.contiguous())
    w, dx1f, ln_sf, ln_bf = _operands(dev, (_qkv_weight(qkv_w, torch.bfloat16), torch.bfloat16),
                                      (dx1, f32), (ln_s, f32), (ln_b, f32))
    dx, y1 = torch.empty_like(x2), torch.empty_like(x2)
    part = torch.empty((-(-m // BWD_TILE_ROWS), 2 * e), dtype=f32, device=dev)
    fn = build.entry("megablock_bwd_ln1")
    build.check(fn, fn(build.ptr(dqkv2), build.ptr(w), build.ptr(x2), build.ptr(dx1f),
                       build.ptr(ln_sf), build.ptr(ln_bf), build.ptr(dx), build.ptr(y1),
                       build.ptr(part), m, e, k, float(eps), build.stream_ptr(dev)))
    build.LAUNCHES["megablock_bwd_ln1"] += 1
    return dx, y1, part


# Parameters of an encoder block in the order the autograd Functions take them.
BLOCK_PARAMS = ("ln1.scale", "ln1.bias", "msha.qkv", "msha.qkv_b", "msha.out.w", "msha.out.b",
                "ln2.scale", "ln2.bias", "fc1.w", "fc1.b", "fc2.w", "fc2.b")


def block_params(p) -> list:
    return [operator.attrgetter(name)(p) for name in BLOCK_PARAMS]


def _block_view(tensors):
    """The block's parameters as an EncoderBlock-shaped namespace."""
    d = dict(zip(BLOCK_PARAMS, tensors))
    ns = SimpleNamespace
    return ns(ln1=ns(scale=d["ln1.scale"], bias=d["ln1.bias"]),
              ln2=ns(scale=d["ln2.scale"], bias=d["ln2.bias"]),
              msha=ns(qkv=d["msha.qkv"], qkv_b=d["msha.qkv_b"],
                      out=ns(w=d["msha.out.w"], b=d["msha.out.b"])),
              fc1=ns(w=d["fc1.w"], b=d["fc1.b"]), fc2=ns(w=d["fc2.w"], b=d["fc2.b"]))


def fused_encoder_block_bwd(params, g, res: Residuals, *, num_heads: int, eps: float = 1e-5,
                            need_params: bool = True):
    """Saved-residual block backward (the JAX `fused_encoder_block_bwd`):
    ``params`` in :data:`BLOCK_PARAMS` order, ``g`` the output cotangent
    (B, N, E).  Returns (dx, [12 gradients or None], in each parameter's
    dtype).  CUDA tensors launch megablock_bwd_mlp, ln_qkv_fwd (the qkv
    recompute), the flash backward kernels on the JAX route,
    megablock_bwd_ln1 and, with ``need_params``, wgrad_gemm four times and
    sum_partials twice; CPU tensors take their plain versions."""
    ln1s, ln1b, qkv_w, qkv_b, wout, bout, ln2s, ln2b, w1, b1, w2, b2 = params
    b, n, e = res.x.shape
    _, h, _, dh = qkv_w.shape
    if h != num_heads:
        raise ValueError(f"params carry {h} heads, num_heads={num_heads}")
    m, hd, hidden = b * n, h * dh, w1.shape[-1]
    cpu = g.device.type == "cpu"
    x2, x12 = res.x.reshape(m, e), res.x1.reshape(m, e)
    z12, ao2 = res.z1.reshape(m, hidden), res.ao.reshape(m, hd)
    masks = [None if t is None else t.reshape(m, e) for t in (res.m1, res.m2)]
    mlp = (_bwd_mlp_reference if cpu else megablock_bwd_mlp)(
        g.reshape(m, e).to(res.x.dtype), *masks, x12, z12, ao2, w1, w2, wout, ln2s, ln2b, b, n, h,
        eps)
    qkv = (_ln_qkv_reference if cpu else ln_qkv_forward)(res.x, ln1s, ln1b, qkv_w,
                                                         qkv_b.reshape(-1), eps)
    dq, dk, dv = flash_backward(qkv[0], qkv[1], qkv[2], None, res.lse, mlp.dao, float(dh),
                                delta=mlp.delta)
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(m, 3 * hd)
    dx, y1, ln1_part = (_bwd_ln1_reference if cpu else megablock_bwd_ln1)(
        dqkv, qkv_w, x2, mlp.dx1, ln1s, ln1b, eps)
    dx = dx.reshape(b, n, e)
    if not need_params:
        return dx, [None] * len(BLOCK_PARAMS)
    dw2, db2 = wgrad(mlp.h1, mlp.dmlp)
    dw1, db1 = wgrad(mlp.y2, mlp.dz1)
    dwout, dbout = wgrad(ao2, mlp.da)
    dwqkv, dbqkv = wgrad(y1, dqkv)
    dln1, dln2 = sum_partials(ln1_part), sum_partials(mlp.part)
    grads = [dln1[:e], dln1[e:], dwqkv.reshape(e, 3, h, dh).permute(1, 2, 0, 3),
             dbqkv.reshape(3, h, dh), dwout, dbout, dln2[:e], dln2[e:], dw1, db1, dw2, db2]
    return dx, [gr.to(p.dtype) for gr, p in zip(grads, params)]


# --- autograd Functions (the JAX custom_vjps) ---------------------------------------

# The saved-residual Functions are once-differentiable, as the JAX package's
# are: its `encoder_block_fused_saved` backward is a pallas_call, and a second
# derivative through it fails there with "Linearization failed to produce
# known values for all output primals".
DOUBLE_BACKWARD = ("the megablock's saved-residual Functions are once-differentiable, as the "
                   "JAX package's encoder_block_fused_saved is (its backward is a pallas_call): "
                   "a double backward (WGAN-GP, R1) through them is not a port item (ROADMAP.md "
                   "queue 2 item 2); set runtime.megablock_bwd=recompute or "
                   "runtime.use_pallas=never for these recipes")


class _RecomputeBlock(torch.autograd.Function):
    """Kernel forward (with in-kernel dropout when rate > 0); backward by
    autograd of the plain block on the saved masks, f32 products in TF32 on
    the card (the JAX `_bwd` and `_bwd_dropout`, fused_block.py:776-782,
    858-866).  Under ``create_graph`` the plain block is rebuilt from the
    saved tensors themselves and its gradient keeps its graph, so that a
    second derivative reaches x and the parameters, as in the JAX package."""

    @staticmethod
    def forward(ctx, x, seed, rate, num_heads, eps, *params):
        p = _block_view(params)
        m1 = m2 = None
        if rate > 0.0:
            out, m1, m2 = fused_encoder_block(x, p, num_heads=num_heads, eps=eps, rate=rate,
                                              seed=seed)
        else:
            out = fused_encoder_block(x, p, num_heads=num_heads, eps=eps)
        ctx.save_for_backward(x, m1, m2, *params)
        ctx.num_heads, ctx.eps = num_heads, eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, m1, m2, *params = ctx.saved_tensors
        need = (ctx.needs_input_grad[0], *ctx.needs_input_grad[5:])
        create = torch.is_grad_enabled()
        with torch.enable_grad(), _tf32_products(g.is_cuda):
            leaves = ((x, *params) if create else
                      [t.detach().requires_grad_(nd) for t, nd in zip((x, *params), need)])
            p = _block_view(leaves[1:])
            if m1 is None:
                out = _block_reference(leaves[0], p, ctx.num_heads, ctx.eps)
            else:
                out = _block_reference_masked(leaves[0], p, m1, m2, ctx.num_heads, ctx.eps)
            wanted = [t for t, nd in zip(leaves, need) if nd]
            grads = iter(torch.autograd.grad(out, wanted, g, create_graph=create)
                         if wanted else ())
        dx, *dparams = (next(grads) if nd else None for nd in need)
        return (dx, None, None, None, None, *dparams)


class _SavedBlock(torch.autograd.Function):
    """Kernel forward that keeps the residuals; backward by the saved-residual
    kernels, no forward product re-run but the qkv projection (the JAX
    `_fwd_saved`/`_bwd_saved` and their dropout forms, fused_block.py:801-906).
    Once-differentiable."""

    @staticmethod
    def forward(ctx, x, seed, rate, num_heads, eps, *params):
        out, res = fused_encoder_block(x, _block_view(params), num_heads=num_heads, eps=eps,
                                       rate=rate, seed=seed, want_residuals=True)
        ctx.save_for_backward(*res, *params)
        ctx.num_heads, ctx.eps = num_heads, eps
        return out

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(DOUBLE_BACKWARD)
        saved = ctx.saved_tensors
        res, params = Residuals(*saved[:len(Residuals._fields)]), saved[len(Residuals._fields):]
        dx, dparams = fused_encoder_block_bwd(params, g.contiguous(), res,
                                              num_heads=ctx.num_heads, eps=ctx.eps,
                                              need_params=any(ctx.needs_input_grad[5:]))
        dparams = [d if nd else None for d, nd in zip(dparams, ctx.needs_input_grad[5:])]
        return (dx, None, None, None, None, *dparams)


def encoder_block_fused(x, p, num_heads: int, eps: float = 1e-5):
    """Differentiable megablock: kernel forward, recompute backward."""
    return _RecomputeBlock.apply(x, None, 0.0, num_heads, eps, *block_params(p))


def encoder_block_fused_saved(x, p, num_heads: int, eps: float = 1e-5):
    """Differentiable megablock with the saved-residual backward kernels."""
    return _SavedBlock.apply(x, None, 0.0, num_heads, eps, *block_params(p))


def encoder_block_fused_dropout(x, p, seed, rate: float, num_heads: int, eps: float = 1e-5):
    """In-kernel dropout (Philox from ``seed``), recompute backward on the
    same masks."""
    return _RecomputeBlock.apply(x, seed, float(rate), num_heads, eps, *block_params(p))


def encoder_block_fused_dropout_saved(x, p, seed, rate: float, num_heads: int,
                                      eps: float = 1e-5):
    """In-kernel dropout with the saved-residual backward kernels, which apply
    the forward's masks exactly."""
    return _SavedBlock.apply(x, seed, float(rate), num_heads, eps, *block_params(p))


# --- the gate ------------------------------------------------------------------------

# The JAX package's scoped-VMEM budget of the megablock (fused_block.py:69,
# its default 96 MB less 0.5 MB).  The training gate's clamps check against
# it, so that the gate decides as the JAX package does; they mean nothing
# for the H100's memory.
VMEM_BUDGET = 96 * 2 ** 20 - 2 ** 19


def _ceil_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def saved_fwd_group(group: int, n_pad: int, e_pad: int, hidden_pad: int, hd_pad: int,
                    dropout: bool = False) -> int:
    """The JAX package's VMEM clamp of the saved-residual forward
    (fused_block.py:213-238): halves ``group`` until its estimate fits, 0 when
    even one sample cannot."""
    per_row = 4 * (3.5 * e_pad + 2 * hidden_pad + 1.5 * hd_pad)
    per_row += 2 * (2 * e_pad + hidden_pad)
    if dropout:
        per_row += 4 * 8 * e_pad
    score = 16 * n_pad * n_pad
    while group >= 1 and group * n_pad * per_row + score > VMEM_BUDGET:
        group //= 2
    return group


def saved_bwd_group(group: int, n_pad: int, e_pad: int, hidden_pad: int, hd_pad: int,
                    dropout: bool = False) -> int:
    """The JAX package's VMEM clamp of the saved-residual backward
    (fused_block.py:241-265)."""
    per_row = 4 * (5 * e_pad + 4 * hidden_pad + 2 * hd_pad)
    per_row += 2 * (2 * e_pad + 2 * hidden_pad + hd_pad)
    if dropout:
        per_row += 4 * 10 * e_pad
    score = 24 * n_pad * n_pad
    while group >= 1 and group * n_pad * per_row + score > VMEM_BUDGET:
        group //= 2
    return group


def megablock_route(p, x, cfg, train: bool, has_generator: bool) -> Optional[str]:
    """The JAX `maybe_megablock` decision (fused_block.py:909-998), with "on
    TPU" read as "tensor on CUDA": the name of the variant it takes, or None
    for the standard path.  Under 'auto' training blocks need the saved
    backward (runtime.megablock_bwd='saved'), 128..1056 tokens and both VMEM
    clamps of the JAX package; under 'on' a training block whose saved
    backward the clamps refuse takes the standard path with a warning.
    Dropout needs the step's generator and a CUDA tensor (the JAX gate: rng
    and a real TPU)."""
    mode = megablock_mode()
    if mode == "off":
        return None
    saved = train and megablock_bwd_mode() == "saved"
    n, e = x.shape[1], x.shape[2]
    _, h, _, dh = p.msha.qkv.shape
    hidden = p.fc1.w.shape[-1]
    drop = train and cfg.dropout > 0.0
    pads = (_ceil_to(n, 8), _ceil_to(e, 128), _ceil_to(hidden, 128), _ceil_to(3 * h * dh, 128))
    if saved and saved_bwd_group(1, *pads, dropout=drop) < 1:
        if mode == "on":
            warnings.warn(f"megablock='on' requested but the saved backward cannot fit the "
                          f"JAX package's scoped VMEM at N={n} E={e} hidden={hidden}; falling "
                          "back to the standard path for this block", stacklevel=3)
            return None
        saved = False
    if mode == "auto":
        fits = saved_fwd_group(1, *pads, dropout=drop) >= 1
        if (train and not saved) or not 128 <= n <= 1056 or not fits or not on_cuda(x):
            return None
    if drop:
        if not has_generator or not on_cuda(x):
            return None
        return "encoder_block_fused_dropout_saved" if saved else "encoder_block_fused_dropout"
    return "encoder_block_fused_saved" if saved else "encoder_block_fused"


def maybe_megablock(p, x, cfg, train: bool, generator: Optional[torch.Generator] = None):
    """Policy gate for models/vitgan_v2.encoder_apply: the block through the
    megablock variant :func:`megablock_route` names, or None for the standard
    path.  Inference runs the three-launch forward; training runs one of the
    four autograd Functions, a dropout variant with a seed drawn from
    ``generator`` on the card.  A dtype or width the kernels do not take
    raises in the launches; it is never sent to the plain version."""
    route = megablock_route(p, x, cfg, train, generator is not None)
    if route is None:
        return None
    if not train:
        return fused_encoder_block(x, p, num_heads=cfg.num_heads)
    if route == "encoder_block_fused":
        return encoder_block_fused(x, p, cfg.num_heads)
    if route == "encoder_block_fused_saved":
        return encoder_block_fused_saved(x, p, cfg.num_heads)
    seed = new_seed(generator, x)
    if route == "encoder_block_fused_dropout":
        return encoder_block_fused_dropout(x, p, seed, cfg.dropout, cfg.num_heads)
    return encoder_block_fused_dropout_saved(x, p, seed, cfg.dropout, cfg.num_heads)
