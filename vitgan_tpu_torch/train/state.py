"""Train state: both networks, both optimizers, the EMA, the step and the
device's random stream.

Counterpart of vitgan_tpu/train/state.py:23-167.  The optax chains become
``torch.optim`` optimizers behind :class:`Optimizer`, which clips first with
optax's ``clip_by_global_norm`` arithmetic (``torch.nn.utils.clip_grad_norm_``
adds 1e-6 to the norm, which optax does not) and sets the learning rate of
each update from the optax schedule of the update count.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from vitgan_tpu_torch.config import ExperimentConfig, OptimConfig


def make_lr(cfg: OptimConfig) -> Callable[[int], float]:
    """The learning rate as a function of the update count (0 at the first
    update): optax's constant, linear-warmup, cosine and warmup-cosine
    schedules (state.py:50-76)."""
    lr = cfg.learning_rate
    if cfg.schedule == "constant":
        if cfg.warmup_steps > 0:
            return lambda count: lr * min(count, cfg.warmup_steps) / cfg.warmup_steps
        return lambda count: lr
    if cfg.schedule not in ("cosine", "warmup_cosine"):
        raise ValueError(f"unknown schedule {cfg.schedule!r} (constant | cosine | warmup_cosine)")
    if not cfg.decay_steps:
        raise ValueError(f"schedule={cfg.schedule!r} requires decay_steps")

    def cosine(count: int, peak: float, steps: int, alpha: float) -> float:
        frac = min(count, steps) / steps
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac)) + alpha)

    if cfg.schedule == "cosine":
        if cfg.warmup_steps > 0:
            raise ValueError("schedule='cosine' ignores warmup_steps — use "
                             "schedule='warmup_cosine'")
        return lambda count: cosine(count, lr, cfg.decay_steps, cfg.min_lr_ratio)
    if cfg.warmup_steps <= 0:
        raise ValueError("schedule='warmup_cosine' requires warmup_steps > 0 "
                         "(or use schedule='cosine')")
    warm = cfg.warmup_steps

    def warmup_cosine(count: int) -> float:
        if count < warm:
            return lr * count / warm
        return cosine(count - warm, lr, cfg.decay_steps - warm, cfg.min_lr_ratio)

    return warmup_cosine


class Optimizer:
    """clip_by_global_norm (when ``grad_clip`` is set), then adam, adamw or
    sgd at the schedule's rate: the optax chain that the JAX `make_optimizer`
    builds (state.py:79-139), over a list of parameters."""

    def __init__(self, cfg: OptimConfig, params: List[torch.nn.Parameter]):
        if cfg.grad_accum > 1:
            raise NotImplementedError("grad_accum > 1 (optax.MultiSteps) is ROADMAP.md queue 1 "
                                      "item 13")
        if cfg.inject_lr:
            raise NotImplementedError("inject_lr is ROADMAP.md queue 1 item 13")
        self.cfg = cfg
        self.params = list(params)
        self.lr = make_lr(cfg)
        self.count = 0
        lr0 = self.lr(0)
        if cfg.name == "adam":
            self.opt = torch.optim.Adam(self.params, lr=lr0, betas=(cfg.beta1, cfg.beta2),
                                        eps=1e-8)
        elif cfg.name == "adamw":
            self.opt = torch.optim.AdamW(self.params, lr=lr0, betas=(cfg.beta1, cfg.beta2),
                                         eps=1e-8, weight_decay=cfg.weight_decay)
        elif cfg.name == "sgd":
            self.opt = torch.optim.SGD(self.params, lr=lr0)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def step(self) -> torch.Tensor:
        """Clip the gradients, apply one update; returns the global norm of the
        unclipped gradients (a device scalar, no host sync).  The parameters'
        ``grad`` hold the unclipped gradients again afterwards."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        if self.cfg.grad_clip is not None:
            clip = float(self.cfg.grad_clip)
            keep = norm < clip
            for p, g in zip(self.params, grads):
                p.grad = torch.where(keep, g, g / norm.to(g.dtype) * clip)
        for group in self.opt.param_groups:
            group["lr"] = self.lr(self.count)
        self.opt.step()
        for p, g in zip(self.params, grads):
            p.grad = g
        self.count += 1
        return norm


def _optim_cfg(cfg: ExperimentConfig, which: str) -> OptimConfig:
    """``{gen,disc}_optim`` of the model config; v1 nests them under
    generator/discriminator (state.py:142-147)."""
    m = cfg.model
    if hasattr(m, f"{which}_optim"):
        return getattr(m, f"{which}_optim")
    return getattr(m, "generator" if which == "gen" else "discriminator").optim


@dataclass
class TrainState:
    """``step`` counts train steps; ``rng`` draws dropout, augment and noise
    on the device; ``seed`` keys the host latents (train/sample.latent_rng)."""

    step: int
    seed: int
    rng: torch.Generator
    g: torch.nn.Module
    d: torch.nn.Module
    g_opt: Optimizer
    d_opt: Optimizer
    g_ema: Optional[List[torch.Tensor]] = None  # EMA of g's parameters when run.ema_decay > 0

    def ema_state_dict(self) -> dict:
        """g's state_dict with the EMA in place of the live parameters, when tracked."""
        sd = {k: v.detach() for k, v in self.g.state_dict().items()}
        if self.g_ema is not None:
            for (name, _), e in zip(self.g.named_parameters(), self.g_ema):
                sd[name] = e
        return sd


def create_train_state(gan, cfg: ExperimentConfig, device="cuda") -> TrainState:
    """G then D drawn on the CPU from one generator seeded with the model
    seed, moved to ``device``; the device generator seeded from it too.  The
    optimizers hold the parameters only: D's ISR state is buffers, which the
    train step updates in place."""
    seed = int(cfg.model.seed)
    init = torch.Generator().manual_seed(seed)
    g = gan.generator_init(init, device=device)
    d = gan.discriminator_init(init, device=device)
    rng = torch.Generator(device=device).manual_seed(seed)
    ema = ([p.detach().clone() for p in g.parameters()] if cfg.run.ema_decay > 0 else None)
    return TrainState(step=0, seed=seed, rng=rng, g=g, d=d,
                      g_opt=Optimizer(_optim_cfg(cfg, "gen"), list(g.parameters())),
                      d_opt=Optimizer(_optim_cfg(cfg, "disc"), list(d.parameters())),
                      g_ema=ema)
