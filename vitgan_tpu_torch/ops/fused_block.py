"""The v2 encoder block forward as three fused CUDA launches ("megablock").

Counterpart of the forward of vitgan_tpu/ops/fused_block.py (`_kernel`,
`fused_encoder_block`, `maybe_megablock`), at ``rate=0`` and without saved
residuals: the inference form.  The TPU kernel runs the whole pre-LN block
for a group of samples in one VMEM-resident program.  An H100 SM has 227 KB
of shared memory, and one sample's qkv at 1,024 tokens is 2.4 MB in bf16, so
the port splits the block where the data must leave the chip anyway:

1. csrc/ln_qkv_fwd.cu: LN1 -> qkv projection + bias, written straight into
   the (3, B, H, N, Dh) layout;
2. csrc/flash_attn_fwd.cu: per-head softmax(q.k^T/sqrt(Dh)).v, written in
   the (B, N, H*Dh) layout;
3. csrc/ln_mlp_fwd.cu with its prologue: x1 = x + attn.wout + bout kept on
   chip in f32, then LN2 -> fc1 -> GELU -> fc2 -> + x1.

Each launch has a plain PyTorch version; composed, they are the block's plain
version, which CPU tensors take.  The dropout and saved-residual variants and
the backward kernel are ROADMAP.md queue 2 items 1 and 4: a training block
that the JAX package's gate sends to them raises (:func:`maybe_megablock`).
"""

from __future__ import annotations

import torch

from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops.attention import attention_reference, flash_forward
from vitgan_tpu_torch.ops.fused_mlp import _reference as mlp_reference
from vitgan_tpu_torch.ops.fused_mlp import kernel_fits as mlp_kernel_fits
from vitgan_tpu_torch.ops.fused_mlp import ln_mlp_forward
from vitgan_tpu_torch.ops.policy import megablock_mode, on_cuda


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
    dev = x.device
    x2 = build.aligned16(x.contiguous())
    w = build.aligned16(_qkv_weight(qkv_w.to(dev), torch.bfloat16).contiguous())
    bias = qkv_b.to(device=dev, dtype=torch.float32).contiguous()
    ln_s = ln_scale.to(device=dev, dtype=torch.float32).contiguous()
    ln_b = ln_bias.to(device=dev, dtype=torch.float32).contiguous()
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


def fused_encoder_block(x, p, *, num_heads: int, eps: float = 1e-5):
    """x (B, N, E) -> one v2 encoder block forward.  CUDA tensors run the
    three kernels (or raise); CPU tensors take :func:`_block_reference`."""
    if x.device.type == "cpu":
        return _block_reference(x, p, num_heads, eps)
    b, n, e = x.shape
    _, h, _, dh = p.msha.qkv.shape
    if h != num_heads:
        raise ValueError(f"params carry {h} heads, num_heads={num_heads}")
    qkv = ln_qkv_forward(x, p.ln1.scale, p.ln1.bias, p.msha.qkv, _qkv_bias(p), eps)
    attn = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device=x.device)
    flash_forward(qkv[0], qkv[1], qkv[2], float(dh), out=attn)
    return ln_mlp_forward(x, p.ln2.scale, p.ln2.bias, p.fc1.w, p.fc1.b, p.fc2.w, p.fc2.b, eps,
                          attn=attn, wout=p.msha.out.w, bout=p.msha.out.b)


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


def jax_routes_training_block(p, x, cfg, mode: str) -> bool:
    """True where the JAX package's `maybe_megablock` (fused_block.py:909-998,
    with its default megablock_bwd='saved') sends a TRAINING block through the
    megablock, with "on TPU" read as "tensor on CUDA"."""
    n, e = x.shape[1], x.shape[2]
    _, h, _, dh = p.msha.qkv.shape
    hidden = p.fc1.w.shape[-1]
    drop = cfg.dropout > 0.0
    pads = (_ceil_to(n, 8), _ceil_to(e, 128), _ceil_to(hidden, 128), _ceil_to(3 * h * dh, 128))
    saved = saved_bwd_group(1, *pads, dropout=drop) >= 1
    if not saved and mode == "on":
        return False
    if mode == "auto" and not (saved and 128 <= n <= 1056 and on_cuda(x)
                               and saved_fwd_group(1, *pads, dropout=drop) >= 1):
        return False
    return not (drop and not on_cuda(x))


def maybe_megablock(p, x, cfg, train: bool):
    """Policy gate for models/vitgan_v2._encoder_apply: the fused forward or
    None for the standard path.  'on' routes every inference block; 'auto'
    routes CUDA blocks of 128..1056 tokens (the JAX package's TPU gate, not
    yet measured on the GPU).  A dtype or width the kernels do not take
    raises in the launches; it is never sent to the plain version.

    Training: the gate is the JAX package's (:func:`jax_routes_training_block`),
    which under 'auto' routes every CUDA training block of 128..1056 tokens
    that fits its VMEM clamps, highres128's and deit64's included.  The
    megablock's dropout and saved-residual variants and its backward are not
    ported (ROADMAP.md queue 2 items 1 and 4), so such a block raises rather
    than take another path; runtime.megablock=off trains on the flash and
    LN->MLP kernels with their backward."""
    mode = megablock_mode()
    if mode == "off":
        return None
    if train:
        if jax_routes_training_block(p, x, cfg, mode):
            raise NotImplementedError(
                f"megablock={mode!r}: the JAX package routes this training block "
                f"(N={x.shape[1]}, E={x.shape[2]}) through the megablock, whose dropout and "
                "saved-residual variants and backward are ROADMAP.md queue 2 items 1 and 4; "
                "set runtime.megablock=off to train on the flash and LN->MLP kernels")
        return None
    if mode == "auto" and not (128 <= x.shape[1] <= 1056 and on_cuda(x)):
        return None
    return fused_encoder_block(x, p, num_heads=cfg.num_heads)
