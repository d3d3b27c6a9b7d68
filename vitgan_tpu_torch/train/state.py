"""Train state: both networks, both optimizers, the EMA, the step and the
device's random stream.

Counterpart of vitgan_tpu/train/state.py:23-167.  The optax chains become
``torch.optim`` optimizers behind :class:`Optimizer`, which clips first with
optax's ``clip_by_global_norm`` arithmetic (``torch.nn.utils.clip_grad_norm_``
adds 1e-6 to the norm, which optax does not) and sets the learning rate of
each update from the optax schedule of the update count, read before the
update as optax reads it.  ``TrainState.state_dict`` is what a checkpoint
holds (utils/checkpoint.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
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


# torch.optim's fused Adam/AdamW on the card (one kernel family for the whole
# update) rather than its foreach form; both are capturable with a device
# rate.  PERF.md (optimizer group) records the measurement behind it.
FUSED_ON_CUDA = True


class Optimizer:
    """clip_by_global_norm (when ``grad_clip`` is set), then adam, adamw or
    sgd at the schedule's rate: the optax chain that the JAX `make_optimizer`
    builds (state.py:79-139), over a list of parameters.

    ``grad_accum`` k > 1 is optax.MultiSteps around that chain: each call
    folds its gradients into a running mean (``acc + (g - acc) / (mini_step
    + 1)``), and every k-th call applies the chain to the mean (the clip
    sees the mean) and zeroes it; the other calls leave the parameters and
    the moments as they are.  The schedule's count and Adam's step advance
    once per applied update.  ``inject_lr`` keeps a constant rate in the
    state (``learning_rate``), which a caller may set and the checkpoint
    carries (optax.inject_hyperparams).

    Under a mesh (``place``, parallel/sharding.py) the optimizer steps this
    rank's slices of the parameters: each update first reduces the full
    gradients to the slices (averaged over the data axis), takes the global
    norm over every rank's slices, and afterwards gathers the full
    parameters back into the module.

    On the CPU the rate is a Python float set on each update, and the clip is
    optax's arithmetic leaf by leaf.  On CUDA the update is one a CUDA graph
    can replay (train/step.py captures it): Adam/AdamW with
    ``capturable=True`` and the rate a device tensor (``rate``) that each
    update writes on the device; the global norm and the clip are
    ``torch._foreach_*`` products by one device scale; ``zero_grad`` zeroes
    the gradient buffers in place, so they live across steps; the
    accumulator and its mini step live on the device.  The call count stays
    on the host (``count``), and with it which calls apply: the caller plans
    them (``applies``), as it plans the rates.  SGD on CUDA is one foreach
    product-and-add at the device rate.
    """

    def __init__(self, cfg: OptimConfig, params: List[torch.nn.Parameter]):
        if cfg.inject_lr:
            if cfg.schedule != "constant" or cfg.warmup_steps:
                raise ValueError("inject_lr supports constant lr only")
            if cfg.grad_accum > 1:
                raise ValueError("inject_lr is incompatible with grad_accum")
        if cfg.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {cfg.grad_accum}")
        self.cfg = cfg
        self.params = list(params)
        self.placement = None
        self.leaves = self.params  # what the update steps: the parameters or their slices
        self.k = int(cfg.grad_accum)
        self._schedule = make_lr(cfg)
        # the injected rate (a state leaf) under inject_lr, else None
        self.learning_rate = float(cfg.learning_rate) if cfg.inject_lr else None
        self.count = 0  # calls; the applied updates are count // k
        lr0 = self.lr(0)
        on_cuda = self.params[0].is_cuda
        device = self.params[0].device
        # the device rate on CUDA, None on the CPU
        self.rate = torch.tensor(lr0, dtype=torch.float32, device=device) if on_cuda else None
        self.mini_step = (torch.zeros((), dtype=torch.float32, device=device)
                          if on_cuda and self.k > 1 else 0)
        self._build()

    def _build(self) -> None:
        """The torch optimizer and MultiSteps' accumulator over ``leaves``."""
        cfg, on_cuda = self.cfg, self.rate is not None
        lr0 = self.lr(0)
        self.acc = [torch.zeros_like(p) for p in self.leaves] if self.k > 1 else None
        kw = ({"lr": self.rate, "capturable": True,
               **({"fused": True} if FUSED_ON_CUDA else {"foreach": True})}
              if on_cuda else {"lr": lr0})
        if cfg.name == "adam":
            self.opt = torch.optim.Adam(self.leaves, betas=(cfg.beta1, cfg.beta2), eps=1e-8, **kw)
        elif cfg.name == "adamw":
            self.opt = torch.optim.AdamW(self.leaves, betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                         weight_decay=cfg.weight_decay, **kw)
        elif cfg.name == "sgd":
            self.opt = None if on_cuda else torch.optim.SGD(self.leaves, lr=lr0)
        else:
            raise ValueError(f"unknown optimizer {cfg.name!r}")

    def place(self, placement) -> None:
        """Step ``placement``'s slices from now on (before the first update)."""
        if self.count:
            raise ValueError("place the optimizer before its first update")
        self.placement = placement
        self.leaves = placement.shards
        self._build()

    def lr(self, updates: int) -> float:
        """The rate of the update that follows ``updates`` applied ones: the
        schedule's, or the injected rate."""
        return self.learning_rate if self.learning_rate is not None else self._schedule(updates)

    def applies(self, count: int) -> bool:
        """Whether call ``count`` (0 the first) applies an update: MultiSteps'
        pre-update ``mini_step == k - 1``."""
        return count % self.k == self.k - 1

    def zero_grad(self) -> None:
        if self.rate is None:
            for p in self.params:
                p.grad = None
            return
        grads = [p.grad for p in self.params if p.grad is not None]
        if grads:
            torch._foreach_zero_(grads)

    def _norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm; under a sharded placement each leaf's value is
        taken over every rank's slice first (parallel/sharding.Placement)."""
        place = self.placement if self.placement is not None and self.placement.sharded else None
        if self.rate is None:
            sq = [(g.float() ** 2).sum() for g in grads]
            if place is not None:
                sq = list(place.leaf_norms(torch.stack(sq), squared=True))
            return torch.sqrt(sum(sq))
        norms = torch.stack(torch._foreach_norm(grads))
        if place is not None:
            norms = place.leaf_norms(norms, squared=False)
        return torch.linalg.vector_norm(norms)

    def _accumulate(self, grads: List[torch.Tensor]) -> None:
        """acc + (g - acc) / (mini_step + 1), MultiSteps' running mean."""
        if self.rate is None:
            n = self.mini_step + 1
            self.acc = [a + (g - a) / n for a, g in zip(self.acc, grads)]
            return
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, self.mini_step + 1)
        torch._foreach_add_(self.acc, diff)

    def update(self, rate, apply: bool = True) -> torch.Tensor:
        """Clip the gradients, apply one update at ``rate`` (a float, or on
        CUDA a 0-d device tensor); returns the global norm of the unclipped
        gradients (a device scalar, no host sync).  Under ``grad_accum`` the
        gradients are folded into the mean first, and only a call with
        ``apply`` (the k-th) updates, from the mean.  The parameters' ``grad``
        hold this call's unclipped gradients again afterwards.  ``count`` is
        the caller's to advance."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        if self.placement is not None:
            grads = self.placement.reduce_grads(grads)
        norm = self._norm(grads)
        step_grads = grads
        if self.k > 1:
            if self.rate is None and apply != (self.mini_step == self.k - 1):
                raise ValueError(f"apply={apply} at mini step {self.mini_step} of {self.k}")
            self._accumulate(grads)
            if not apply:
                if self.rate is None:
                    self.mini_step += 1
                else:
                    self.mini_step.add_(1)
                return norm
            step_grads = self.acc
        clipped = step_grads
        if self.cfg.grad_clip is not None:
            clip = float(self.cfg.grad_clip)
            mean_norm = norm if step_grads is grads else self._norm(step_grads)
            if self.rate is None:
                keep = mean_norm < clip
                clipped = [torch.where(keep, g, g / mean_norm.to(g.dtype) * clip)
                           for g in step_grads]
            else:
                scale = torch.where(mean_norm < clip, torch.ones_like(mean_norm),
                                    clip / mean_norm)
                clipped = torch._foreach_mul(step_grads, scale)
        if self.rate is None:
            for group in self.opt.param_groups:
                group["lr"] = float(rate)
        elif isinstance(rate, torch.Tensor):
            self.rate.copy_(rate)
        else:
            self.rate.fill_(rate)
        if self.opt is None:  # SGD on CUDA
            with torch.no_grad():
                torch._foreach_add_(self.leaves, torch._foreach_mul(clipped, self.rate),
                                    alpha=-1.0)
        else:
            for p, g in zip(self.leaves, clipped):
                p.grad = g
            self.opt.step()
            for p, g in zip(self.leaves, grads):
                p.grad = g
        if self.placement is not None:
            self.placement.gather_params()
        if self.k > 1:  # MultiSteps zeroes the accumulator on the applying call
            if self.rate is None:
                self.acc = [torch.zeros_like(a) for a in self.acc]
                self.mini_step = 0
            else:
                torch._foreach_zero_(self.acc)
                self.mini_step.zero_()
        return norm

    def step(self) -> torch.Tensor:
        """One call at the schedule's rate, which advances ``count``."""
        norm = self.update(self.lr(self.count // self.k), self.applies(self.count))
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """The call count, each parameter's optimizer state (by its index),
        the accumulator and its mini step under ``grad_accum``, and the
        injected rate, on the CPU."""
        state = {}
        if self.opt is not None:
            for i, p in enumerate(self.leaves):
                if p in self.opt.state:
                    state[i] = {k: self._full(v, i).cpu().clone()
                                for k, v in self.opt.state[p].items()}
        sd = {"count": self.count, "state": state}
        if self.k > 1:
            sd["acc"] = [self._full(a, i).cpu().clone() for i, a in enumerate(self.acc)]
            sd["mini_step"] = int(self.mini_step)
        if self.learning_rate is not None:
            sd["learning_rate"] = self.learning_rate
        return sd

    def _full(self, v: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's state at the parameter's full shape (gathered from every
        rank's slice, or from the stage that holds it, under a sharded
        placement: a collective)."""
        v = v.detach()
        if self.placement is None or v.dim() == 0 or not self.placement.split(i):
            return v
        return self.placement.gather(v, i)

    def _cut(self, v: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf i's full-shape state cut to this rank's slice."""
        if self.placement is None or v.dim() == 0 or not self.placement.split(i):
            return v
        return self.placement.cut(v, i)

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict``'s values.  State the optimizer already holds
        is written in place (zeroed where the checkpoint precedes the first
        update), so a CUDA graph captured over it replays the restored
        values."""
        self.count = int(sd["count"])
        if self.k > 1:
            if "acc" not in sd:
                raise ValueError(f"the checkpoint holds no accumulator for grad_accum={self.k}")
            with torch.no_grad():
                for i, (a, v) in enumerate(zip(self.acc, sd["acc"])):
                    a.copy_(self._cut(v, i))
            if self.rate is None:
                self.mini_step = int(sd["mini_step"])
            else:
                self.mini_step.fill_(int(sd["mini_step"]))
        if self.learning_rate is not None:
            self.learning_rate = float(sd.get("learning_rate", self.learning_rate))
        if self.placement is not None:
            self.placement.reload()
        if self.opt is None:
            return
        for i, p in enumerate(self.leaves):
            src = sd["state"].get(i)
            if src is not None:
                src = {k: self._cut(v, i) for k, v in src.items()}
            have = self.opt.state.get(p)
            if src is None:  # no update yet: the state a first update creates (zeros), in place
                for v in (have or {}).values():
                    v.zero_()
                continue
            if have:
                for k, v in src.items():
                    have[k].copy_(v)
            else:  # 'step' stays on the host unless the update is capturable
                self.opt.state[p] = {k: v.to(p.device if (k != "step" or self.rate is not None)
                                             else "cpu", copy=True) for k, v in src.items()}


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
    # {'g', 'd'}: the full shape of each state_dict entry, recorded where a
    # pipe axis frees the other stages' blocks (parallel/sharding.py)
    full_shapes: dict = field(default_factory=dict)

    def ema_state_dict(self) -> dict:
        """g's state_dict with the EMA in place of the live parameters, when
        tracked; under a pipe axis this rank's stage's (the others' blocks
        empty), which a module of this rank loads."""
        sd = {k: v.detach() for k, v in self.g.state_dict().items()}
        if self.g_ema is not None:
            for (name, _), e in zip(self.g.named_parameters(), self.g_ema):
                sd[name] = e
        return sd

    def full_ema_state_dict(self) -> dict:
        """:meth:`ema_state_dict` with every stage's blocks (a collective
        over the pipe group: every rank calls it)."""
        return self._whole("g", self.ema_state_dict())

    def _whole(self, net: str, sd: dict) -> dict:
        place = getattr(self, f"{net}_opt").placement
        if place is None or net not in self.full_shapes:
            return sd
        from vitgan_tpu_torch.parallel.pipeline import module_depth

        return place.module_state(sd, module_depth(getattr(self, net)), self.full_shapes[net])

    def state_dict(self) -> dict:
        """Everything a resume needs, on the CPU: both networks' state_dicts
        (D's ISR buffers among them), both optimizers (moments and update
        counts), the EMA, the step, the seed and the device generator's
        state, at the single-device layout (under a mesh every rank calls
        it: slices and stages are gathered)."""
        cpu = lambda sd: {k: v.detach().cpu().clone() for k, v in sd.items()}  # noqa: E731
        ema = None
        if self.g_ema is not None:
            place = self.g_opt.placement
            ema = [(e if place is None else place.from_stage(e.detach(), i)).cpu().clone()
                   for i, e in enumerate(self.g_ema)]
        return {"step": self.step, "seed": self.seed, "rng": self.rng.get_state(),
                "g": cpu(self._whole("g", self.g.state_dict())),
                "d": cpu(self._whole("d", self.d.state_dict())),
                "g_opt": self.g_opt.state_dict(), "d_opt": self.d_opt.state_dict(),
                "g_ema": ema}

    def load_state_dict(self, sd: dict) -> None:
        """Restore ``state_dict``'s values into this state's own tensors (in
        place: a captured step replays them); under a pipe axis each rank
        takes its stage's blocks."""
        from vitgan_tpu_torch.parallel.pipeline import module_depth

        for net, opt in (("g", self.g_opt), ("d", self.d_opt)):
            module = getattr(self, net)
            whole = sd[net]
            if opt.placement is not None:
                whole = opt.placement.held_state(whole, module.state_dict(), module_depth(module))
            module.load_state_dict(whole)
        self.g_opt.load_state_dict(sd["g_opt"])
        self.d_opt.load_state_dict(sd["d_opt"])
        if (sd["g_ema"] is None) != (self.g_ema is None):
            raise ValueError("the checkpoint and this run disagree on run.ema_decay > 0")
        if self.g_ema is not None:
            with torch.no_grad():
                for e, v in zip(self.g_ema, sd["g_ema"]):
                    if e.numel() or not v.numel():
                        e.copy_(v)
        self.rng.set_state(sd["rng"])
        self.step, self.seed = int(sd["step"]), int(sd["seed"])


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
