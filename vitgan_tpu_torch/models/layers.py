"""Core layers in the JAX package's parameter layouts.

Counterpart of vitgan_tpu/models/layers.py.  Each layer is an ``nn.Module``
that holds its parameters under the JAX leaf names (dense ``w`` is (in, out);
attention is ``qkv`` (3, H, E, Dh) with ``qkv_b`` (3, H, Dh)), so a JAX tree
maps onto ``state_dict`` keys leaf for leaf (weights.py), and a plain
function applies it.  Initialisers draw from an explicit ``torch.Generator``;
they follow the JAX package's distributions, not its random stream.  The
spectral-rescaling (ISR) state of the v1 discriminator's attention lives in
buffers, under the JAX state tree's names (``msha.isr.sigma0``, ``.u``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from vitgan_tpu_torch.ops.attention import dispatch_attention
from vitgan_tpu_torch.ops.policy import same_device


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


def uniform(shape, bound: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-bound, bound) f32 drawn on the CPU; uninitialised with no
    ``generator`` (weights that are loaded next, as trunc_normal)."""
    if generator is None:
        return torch.empty(shape)
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * bound


def normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """N(0, 1) f32 drawn on the CPU; uninitialised with no ``generator``."""
    return torch.empty(shape) if generator is None else torch.randn(shape, generator=generator)


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


class Linear(nn.Module):
    """y = x w (+ b), torch nn.Linear's init U(+-1/sqrt(in)) for both
    (torch_linear_init, layers.py:34-42); ``bias=False`` holds no ``b``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator], bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.w = nn.Parameter(uniform((in_features, out_features), bound, generator))
        self.b = nn.Parameter(uniform((out_features,), bound, generator)) if bias else None


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """x w + b with the weight and bias cast to the activation dtype
    (layers.py:62-67); no bias where ``p.b`` is None."""
    y = x @ p.w.to(x.dtype)
    return y if p.b is None else y + p.b.to(x.dtype)


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
    """Inverted dropout; identity unless training with rate > 0.  The mask is
    drawn on x's device, from a generator on that device."""
    if not train or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode requires a torch.Generator")
    if not same_device(generator, x):
        raise ValueError(f"dropout draws on x's device {x.device}, the generator is on "
                         f"{generator.device}")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def pick_activation(name: str):
    """The activation picker (layers.py:85-94): unknown names give sigmoid."""
    return {
        "relu": torch.relu,
        "gelu": torch.nn.functional.gelu,  # exact erf form
        "tanh": torch.tanh,
        "sigmoid": torch.sigmoid,
        "leaky_relu": lambda x: torch.nn.functional.leaky_relu(x, 0.2),
    }.get(name, torch.sigmoid)


class MLP(nn.Module):
    """A chain of Linear layers [in] + hidden + [out] (mlp_init, layers.py:138-144)."""

    def __init__(self, in_features: int, out_features: int, hidden=(),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_features, *hidden, out_features]
        self.layers = nn.ModuleList(Linear(a, b, generator) for a, b in zip(dims[:-1], dims[1:]))


def mlp(p: MLP, x: torch.Tensor, activation: str = "gelu", dropout_rate: float = 0.0,
        train: bool = False, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Dropout after every linear, the activation between all but the last
    (layers.py:147-160)."""
    act = pick_activation(activation)
    n = len(p.layers)
    for i, layer in enumerate(p.layers):
        x = dropout(dense(layer, x), dropout_rate, train, generator)
        if i != n - 1:
            x = act(x)
    return x


class SLN(nn.Module):
    """Self-modulated LayerNorm: ln plus scalar gamma, beta (1, 1, 1) ~ N(0, 1)
    (sln_init, layers.py:116-123)."""

    def __init__(self, features: int, generator: Optional[torch.Generator]):
        super().__init__()
        self.ln = LayerNorm(features)
        self.gamma = nn.Parameter(normal((1, 1, 1), generator))
        self.beta = nn.Parameter(normal((1, 1, 1), generator))


def sln(p: SLN, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """gamma * w * LN(h) + beta * w (layers.py:126-130)."""
    g, b = p.gamma.to(h.dtype), p.beta.to(h.dtype)
    return g * w * layer_norm(p.ln, h) + b * w


class Siren(nn.Module):
    """A SIREN layer's w (in, out), b: the first layer U(+-1/in), later ones
    U(+-sqrt(6/in)/omega_0); the bias U(+-1/sqrt(in)) (siren_init, layers.py:168-177)."""

    def __init__(self, in_features: int, out_features: int, is_first: bool, omega_0: float,
                 generator: Optional[torch.Generator]):
        super().__init__()
        bound = (1.0 / in_features) if is_first else (math.sqrt(6.0 / in_features) / omega_0)
        self.w = nn.Parameter(uniform((in_features, out_features), bound, generator))
        self.b = nn.Parameter(uniform((out_features,), 1.0 / math.sqrt(in_features), generator))


def siren(p: Siren, x: torch.Tensor, omega_0: float = 30.0) -> torch.Tensor:
    """sin(omega_0 * (x w + b)) (layers.py:180-182)."""
    return torch.sin(omega_0 * dense(p, x))


class ISRState(nn.Module):
    """Spectral-rescaling state of a stack of matrices (..., rows, cols), as
    buffers: sigma0, the exact largest singular value of each at init (one
    SVD), and u, a unit vector per matrix (spectral_state_init,
    layers.py:200-208).  Never trained: the train step leaves it out of
    every optimizer, and only a forward with ``update_state`` writes u."""

    def __init__(self, w_stack: torch.Tensor, generator: Optional[torch.Generator]):
        super().__init__()
        if generator is None:
            sigma0, u = torch.empty(w_stack.shape[:-2]), torch.empty(w_stack.shape[:-1])
        else:
            sigma0 = torch.linalg.svdvals(w_stack.detach().double())[..., 0].float()
            u = torch.randn(w_stack.shape[:-1], generator=generator)
            u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-12)
        self.register_buffer("sigma0", sigma0)
        self.register_buffer("u", u)


def spectral_rescale(w_stack: torch.Tensor, state: ISRState, update: bool) -> torch.Tensor:
    """ISR: W * (sigma0 / sigma_hat(W)) (layers.py:211-231).  One power
    iteration runs from the stored u on the detached f32 W; sigma_hat comes
    from its result, and u is written back (in place) only when ``update``.
    Gradients flow through W alone: the estimate is detached."""
    with torch.no_grad():
        wf = w_stack.detach().float()
        u = state.u
        v = torch.einsum("...r,...rc->...c", u, wf)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        u = torch.einsum("...c,...rc->...r", v, wf)
        u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-12)
        sigma = torch.einsum("...r,...rc,...c->...", u, wf, v).abs().clamp_min(1e-12)
        scale = (state.sigma0 / sigma)[..., None, None]
        if update:
            state.u.copy_(u)
    return w_stack * scale.to(w_stack.dtype)


class MHSA(nn.Module):
    """Fused multi-head self-attention parameters: qkv (3, H, E, Dh), qkv_b
    (3, H, Dh) where ``qkv_bias``, out (H*Dh -> E), and with ``spectral`` the
    ISR state ``isr`` (mhsa_init, layers.py:239-265).  ``init='trunc_normal'``
    (v2): qkv trunc_normal(0.02) truncated at +-2 sigma, out as Dense, zero
    biases; ``init='torch'`` (v1): qkv U(+-1/sqrt(E)), out as Linear."""

    def __init__(self, features: int, num_heads: int, generator: Optional[torch.Generator],
                 qkv_bias: bool = True, init: str = "trunc_normal", spectral: bool = False):
        super().__init__()
        head_dim = features // num_heads
        shape = (3, num_heads, features, head_dim)
        if init == "torch":
            self.qkv = nn.Parameter(uniform(shape, 1.0 / math.sqrt(features), generator))
            self.out = Linear(num_heads * head_dim, features, generator)
        else:
            self.qkv = nn.Parameter(trunc_normal(shape, 0.02, 2.0, generator))
            self.out = Dense(num_heads * head_dim, features, generator)
        self.qkv_b = nn.Parameter(torch.zeros(3, num_heads, head_dim)) if qkv_bias else None
        self.isr = ISRState(self.qkv, generator) if spectral else None


def mhsa(p, x: torch.Tensor, *, score_mode: str = "dot", scale: Optional[float] = None,
         update_state: bool = False) -> torch.Tensor:
    """Fused multi-head self-attention, x (B, N, E) -> (B, N, E) (layers.py:293-340).
    ``scale`` defaults to H*Dh; the v2 family passes Dh.  With ISR state the
    qkv weights are spectrally rescaled first, u refreshed where
    ``update_state``."""
    qkv_w = p.qkv
    if p.isr is not None:
        qkv_w = spectral_rescale(qkv_w, p.isr, update_state)
    _, num_heads, _, head_dim = qkv_w.shape
    if scale is None:
        scale = num_heads * head_dim
    qkv = torch.einsum("bnd,phde->pbhne", x, qkv_w.to(x.dtype))
    if p.qkv_b is not None:
        qkv = qkv + p.qkv_b.to(x.dtype)[:, None, :, None, :]
    out = dispatch_attention(qkv[0].contiguous(), qkv[1].contiguous(), qkv[2].contiguous(),
                             score_mode, float(scale))
    out = out.transpose(1, 2).reshape(*x.shape[:-1], num_heads * head_dim)
    return dense(p.out, out)
