"""GAN losses: BCE/MSE criteria, the Wasserstein losses, WGAN-GP and R1,
diversity loss, accuracy.

Counterpart of vitgan_tpu/train/losses.py:21-110.  Discriminators emit
logits; every loss is computed in f32.  ``gradient_penalty`` and
``r1_penalty`` differentiate D with ``create_graph=True`` (a double backward),
as the JAX package differentiates its custom VJPs twice.  The recompute
Functions take it: the LN->MLP (``ops/fused_mlp.fused_ln_mlp``) and the
megablock under ``megablock_bwd=recompute`` run their kernels forward and
differentiate their plain versions twice.  The flash and saved-megablock
Functions raise, as the JAX package's flash_attention and
encoder_block_fused_saved fail a second derivative (ROADMAP.md queue 2 item
2): such recipes keep attention on the plain route (it is there below 256
tokens) or set ``runtime.use_pallas=never``.
"""

from __future__ import annotations

from typing import Callable

import torch


def bce_with_logits(logits: torch.Tensor, targets) -> torch.Tensor:
    """Mean binary cross-entropy on raw logits."""
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def mse_on_probs(logits: torch.Tensor, targets) -> torch.Tensor:
    """MSE on sigmoid probabilities."""
    return torch.mean((torch.sigmoid(logits.float()) - targets) ** 2)


def pick_criterion(name: str) -> Callable:
    if name == "bce":
        return bce_with_logits
    if name == "mse":
        return mse_on_probs
    raise ValueError(f"unknown criterion {name!r}")


def d_adversarial_loss(criterion, real_logits, fake_logits) -> torch.Tensor:
    """D: real -> 1, fake -> 0."""
    return (criterion(real_logits, torch.ones_like(real_logits, dtype=torch.float32))
            + criterion(fake_logits, torch.zeros_like(fake_logits, dtype=torch.float32)))


def g_adversarial_loss(criterion, fake_logits) -> torch.Tensor:
    """G: fake -> 1, the non-saturating loss."""
    return criterion(fake_logits, torch.ones_like(fake_logits, dtype=torch.float32))


def wasserstein_d_loss(real_logits, fake_logits) -> torch.Tensor:
    """E[D(fake)] - E[D(real)]."""
    return fake_logits.float().mean() - real_logits.float().mean()


def wasserstein_g_loss(fake_logits) -> torch.Tensor:
    """-E[D(fake)]."""
    return -fake_logits.float().mean()


def gradient_penalty(disc_fn: Callable, real: torch.Tensor, fake: torch.Tensor,
                     eps: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: mean((||grad_x D(x_interp)||_2 - 1)^2), x_interp = eps * real +
    (1 - eps) * fake with ``eps`` (B, 1, 1, 1) f32 drawn by the caller."""
    interp = (eps * real.float() + (1 - eps) * fake.float()).to(real.dtype)
    interp = interp.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(interp).float().sum(), interp, create_graph=True)
    grads = grads.float().reshape(grads.shape[0], -1)
    norms = torch.sqrt((grads ** 2).sum(-1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def r1_penalty(disc_fn: Callable, real: torch.Tensor) -> torch.Tensor:
    """R1: E[||grad_x D(x)||^2] on real samples; the caller scales by gamma/2."""
    real = real.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_fn(real).float().sum(), real, create_graph=True)
    grads = grads.float().reshape(grads.shape[0], -1)
    return torch.mean((grads ** 2).sum(-1))


def diversity_loss(fakes: torch.Tensor) -> torch.Tensor:
    """Mean pairwise L1 distance over flattened fakes; the trainer subtracts
    it (losses.py:95-104)."""
    flat = fakes.reshape(fakes.shape[0], -1).float()
    diffs = (flat[:, None, :] - flat[None, :, :]).abs().mean(-1)
    n = flat.shape[0]
    return diffs.sum() / (n * (n - 1) + 1e-12)


def accuracy_from_logits(logits: torch.Tensor, is_real: bool) -> torch.Tensor:
    pred = logits.float() > 0.0
    return (pred if is_real else ~pred).float().mean()
