"""Core layers in the JAX package's parameter layouts.

Counterpart of vitgan_tpu/models/layers.py.  Each layer is an ``nn.Module``
that holds its parameters under the JAX leaf names (dense ``w`` is (in, out);
attention is ``qkv`` (3, H, E, Dh) with ``qkv_b`` (3, H, Dh)), so a JAX tree
maps onto ``state_dict`` keys leaf for leaf (weights.py), and a plain
function applies it.  Initialisers draw from an explicit ``torch.Generator``;
they follow the JAX package's distributions, not its random stream.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vitgan_tpu_torch.ops.attention import dispatch_attention


def trunc_normal(shape, std: float, bound: float,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """std * N(0, 1) truncated to [-bound, bound] (bound in units of std),
    drawn on the CPU by inverse-CDF sampling.  With no ``generator``, an
    uninitialised tensor for weights that are loaded next (on the meta
    device, utils/run_dirs.restore_run)."""
    if generator is None:
        return torch.empty(shape)
    lo = 0.5 * (1.0 + math.erf(-bound / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(bound / math.sqrt(2.0)))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    z = torch.special.ndtri(lo + (hi - lo) * u).clamp_(-bound, bound)  # u == 0 gives -inf
    return (std * z).float()


class Dense(nn.Module):
    """y = x w + b with w (in, out).  Init: trunc_normal(0.02) truncated at
    +-2 absolute, as torch's trunc_normal_(std=0.02) (layers.py:45-59), zero
    bias."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator], std: float = 0.02):
        super().__init__()
        self.w = nn.Parameter(trunc_normal((in_features, out_features), std, 2.0 / std,
                                           generator))
        self.b = nn.Parameter(torch.zeros(out_features))


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x w + b with the weight and bias cast to the activation dtype
    (layers.py:62-67)."""
    return x @ p.w.to(x.dtype) + p.b.to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))


def layer_norm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis; f32 statistics, cast back (layers.py:106-113)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * p.scale.float() + p.bias.float()
    return y.to(x.dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout; identity unless training with rate > 0."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode requires a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=generator.device) < keep
    return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class MHSA(nn.Module):
    """Fused multi-head self-attention parameters: qkv (3, H, E, Dh), qkv_b
    (3, H, Dh), out (H*Dh -> E).  v2 init: qkv trunc_normal(0.02) truncated at
    +-2 sigma (layers.py:255), out as Dense, zero biases."""

    def __init__(self, features: int, num_heads: int, generator: Optional[torch.Generator]):
        super().__init__()
        head_dim = features // num_heads
        self.qkv = nn.Parameter(trunc_normal((3, num_heads, features, head_dim), 0.02, 2.0,
                                             generator))
        self.qkv_b = nn.Parameter(torch.zeros(3, num_heads, head_dim))
        self.out = Dense(num_heads * head_dim, features, generator)


def mhsa(p, x: torch.Tensor, *, score_mode: str = "dot",
         scale: Optional[float] = None) -> torch.Tensor:
    """Fused multi-head self-attention, x (B, N, E) -> (B, N, E) (layers.py:293-340).
    ``scale`` defaults to H*Dh; the v2 family passes Dh."""
    qkv_w = p.qkv
    _, num_heads, _, head_dim = qkv_w.shape
    if scale is None:
        scale = num_heads * head_dim
    qkv = torch.einsum("bnd,phde->pbhne", x, qkv_w.to(x.dtype))
    qkv = qkv + p.qkv_b.to(x.dtype)[:, None, :, None, :]
    out = dispatch_attention(qkv[0].contiguous(), qkv[1].contiguous(), qkv[2].contiguous(),
                             score_mode, float(scale))
    out = out.transpose(1, 2).reshape(*x.shape[:-1], num_heads * head_dim)
    return dense(p.out, out)
