"""The alternating G/D train step.

Counterpart of vitgan_tpu/train/step.py:37-293, with its semantics: one G
forward whose graph is kept; the D update on the concatenated
``[real; fake.detach()]`` batch with instance noise (WGAN-GP) and DiffAugment;
``disc_steps - 1`` extra critic updates on fresh latents; lazy R1 or the
gradient penalty; then the G update against the UPDATED D, back through the
same G graph, with D's parameters excluded from that backward; the EMA; the
same metric keys.

D's state (the v1 ISR vectors, buffers updated in place, never in autograd
or an optimizer) follows the JAX step's threading: each D update's forward
refreshes it (``update_state``, step.py:112-115); the penalties' forwards
read it as that update found it, so they run before it (a D without state
keeps them after its main forward); the G update's forward reads the
refreshed state and leaves it (step.py:234-236).

Random draws.  Latents come from the host's numpy Philox keyed by (seed,
step) (train/sample.latent_rng); dropout, augment, instance noise and the
gradient penalty's mixing weights come from the state's device generator.
``step(state, real, z=None, draws=None)`` takes fixed latents and fixed draws
(keys of :data:`DRAW_KEYS`) instead, so that a test can hand it the JAX
step's own.

Multi-step (step.py:321-373).  ``make_multi_train_step`` and
``make_device_data_train_fn`` run n true sequential updates per call, the
same as n calls of the single step, and return each metric stacked on axis 0.
What the step reads from the host is planned per call (:func:`plan_steps`):
the latent block, each update's learning rate at its pre-update count, the
lazy-R1 pattern and, under ``grad_accum``, which optimizer calls apply.  On
the CPU the call is the eager loop (the plain version).  On CUDA it is the counterpart of ``lax.scan``: one step is
captured as a CUDA graph and replayed n times.  Each replay takes its batch
(the index row, gathered from the uint8 dataset, normalised and flipped
there), latents and rates from the call's buffers by a device step counter
that the graph advances, and writes its metric row; the indices, latents and
rates cross to the device in one copy each per call.  The first step of each
kind (with and without R1) that a function meets runs eagerly on the
capture's side stream, which builds every kernel and the optimizer's state,
and is then captured; the graphs (one per kind: with or without R1, and
under ``grad_accum`` which of the step's optimizer calls apply) share one
memory pool and the host picks one per step.  A step that cannot be
captured raises: nothing runs eagerly on the card in a graph's place.  The kernels' launch counts
(ops/build.LAUNCHES) are counted at capture and added on each replay.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import draws as RD
from vitgan_tpu_torch.ops.augment import apply_augment, apply_draws, apply_flip, draw_flip
from vitgan_tpu_torch.parallel.mesh import gather_rows, local_row_map, mean_over
from vitgan_tpu_torch.train import losses as LO
from vitgan_tpu_torch.train.sample import compute_dtype, latent_block
from vitgan_tpu_torch.train.state import TrainState

# Fixed draws a caller may pass: instance noise on the real and fake D inputs
# (B, H, W, C), the augment draws of the real, fake and G-update D inputs
# ([(name, draws)], ops/augment.draw_augment) and WGAN-GP's mixing weights
# (B, 1, 1, 1).
DRAW_KEYS = ("noise_real", "noise_fake", "aug_real", "aug_fake", "aug_g", "gp_eps")


# The baselines' configs carry no training knobs: the getattr reads below give
# them the JAX step's defaults (step.py:42-62).


def _disc_steps(cfg: ExperimentConfig) -> int:
    return max(1, int(getattr(cfg.model, "disc_steps", 1) or 1))


def _r1(m) -> tuple:
    """(r1_gamma, r1_interval, whether R1 runs at all)."""
    gamma = float(getattr(m, "r1_gamma", 0.0) or 0.0)
    interval = max(1, int(getattr(m, "r1_interval", 1) or 1))
    return gamma, interval, gamma > 0 and getattr(m, "loss", "bce") != "wgan-gp"


def metric_keys(cfg: ExperimentConfig) -> tuple:
    """The step's metric keys, sorted (the JAX step's)."""
    keys = ["d_loss", "d_loss_real", "d_loss_fake", "g_loss", "d_real_acc", "d_fake_acc",
            "d_grad_norm", "g_grad_norm"]
    if _r1(cfg.model)[2]:
        keys.append("d_r1")
    return tuple(sorted(keys))


@dataclass
class StepPlan:
    """What n consecutive steps read from the host: ``latents`` (n, D, B,
    latent_dim) f32, row i the step's z then its extra critic updates'
    (D = disc_steps); ``g_rates`` (n,) and ``d_rates`` (n, D), each update's
    learning rate at its pre-update count; ``with_r1`` (n,), the lazy-R1
    gate of each step; ``g_apply`` (n,) and ``d_apply`` (n, D), whether
    each optimizer call applies its update (always, without grad_accum;
    each critic update is one D call)."""

    latents: np.ndarray
    g_rates: np.ndarray
    d_rates: np.ndarray
    with_r1: np.ndarray
    g_apply: np.ndarray
    d_apply: np.ndarray

    def kind(self, i: int) -> tuple:
        """Step i's graph variant: (with_r1, g_apply, d_apply per critic update)."""
        return (bool(self.with_r1[i]), bool(self.g_apply[i]),
                tuple(bool(a) for a in self.d_apply[i]))


def plan_steps(gan, cfg: ExperimentConfig, state: TrainState, n: int, batch: int,
               latents: Optional[np.ndarray] = None, mesh=None) -> StepPlan:
    """The plan of the n steps from ``state.step`` (``latents`` replaces the
    block drawn from the host, as ``z`` does for one step).  Under a
    ``mesh`` with collectives ``batch`` is this rank's rows: the host block
    is drawn at the global batch and its rows kept."""
    ds = _disc_steps(cfg)
    rows = local_row_map(mesh, batch)
    if latents is None and rows is not None:
        latents = latent_block(gan, state.seed, state.step, n, rows.global_, ds)
        latents = np.ascontiguousarray(latents[:, :, rows.first:rows.first + batch])
    elif latents is None:
        latents = latent_block(gan, state.seed, state.step, n, batch, ds)
    else:
        latents = np.asarray(latents, np.float32)
        if latents.shape != (n, ds, batch, gan.latent_dim):
            raise ValueError(f"latents {latents.shape}, expected {(n, ds, batch, gan.latent_dim)}")
    _, interval, r1 = _r1(cfg.model)
    g, d = state.g_opt, state.d_opt
    g_calls = [g.count + i for i in range(n)]
    d_calls = [[d.count + i * ds + j for j in range(ds)] for i in range(n)]
    return StepPlan(
        latents=latents,
        g_rates=np.array([g.lr(c // g.k) for c in g_calls], np.float64),
        d_rates=np.array([[d.lr(c // d.k) for c in row] for row in d_calls],
                         np.float64).reshape(n, ds),
        with_r1=np.array([r1 and (state.step + i) % interval == 0 for i in range(n)], bool),
        g_apply=np.array([g.applies(c) for c in g_calls], bool),
        d_apply=np.array([[d.applies(c) for c in row] for row in d_calls], bool).reshape(n, ds))


def _advance(state: TrainState, cfg: ExperimentConfig, n: int) -> None:
    """The host's counters after n steps."""
    state.step += n
    state.g_opt.count += n
    state.d_opt.count += n * _disc_steps(cfg)


def device_batch(dataset: torch.Tensor, idx: torch.Tensor, flip: bool,
                 gen: torch.Generator) -> torch.Tensor:
    """Gather a batch from the uint8 (N, H, W, C) dataset on its device,
    normalise to [-1, 1] and, with ``flip``, flip each sample with p = 0.5
    (step.py:360-367)."""
    real = dataset.index_select(0, idx).float() * (2.0 / 255.0) - 1.0
    return apply_flip(real, draw_flip(gen, real)) if flip else real


class _Losses:
    """The step's D inputs and losses (:func:`_make_core`).  ``gen`` is the
    step's generator; ``disc(x, update_state=False)`` runs D in train
    mode."""

    def __init__(self, gan, cfg: ExperimentConfig):
        mcfg = cfg.model
        self.gan, self.mcfg = gan, mcfg
        loss_name = getattr(mcfg, "loss", "bce")
        self.criterion = LO.pick_criterion(loss_name if loss_name in ("bce", "mse") else "bce")
        self.use_wgan = loss_name == "wgan-gp"
        self.r1_gamma, self.r1_interval, _ = _r1(mcfg)
        self.g_diversity = getattr(mcfg, "g_diversity", False)
        self.spec = cfg.run.diff_augment

    def d_inputs(self, gen, real, fake, draws):
        """Instance noise, then DiffAugment, on D's real and fake inputs."""
        mcfg, spec = self.mcfg, self.spec
        real_in, fake_in = real, fake
        if self.use_wgan and mcfg.instance_noise > 0:
            nr, nf = draws.get("noise_real"), draws.get("noise_fake")
            nr = RD.randn(real.shape, gen, real.device) if nr is None else nr
            nf = RD.randn(fake.shape, gen, fake.device) if nf is None else nf
            real_in = real + mcfg.instance_noise * nr.to(real.device, real.dtype)
            fake_in = fake + mcfg.instance_noise * nf.to(fake.device, fake.dtype)
        if spec:
            a_r, a_f = draws.get("aug_real"), draws.get("aug_fake")
            real_in = (apply_augment(gen, real_in, spec) if a_r is None
                       else apply_draws(real_in, a_r))
            fake_in = (apply_augment(gen, fake_in, spec) if a_f is None
                       else apply_draws(fake_in, a_f))
        return real_in, fake_in

    def d_loss(self, disc, gen, real_in, fake_in, with_r1, draws):
        """(loss, aux) of one D update."""
        gan, mcfg = self.gan, self.mcfg
        b = real_in.shape[0]

        def penalties():
            if self.use_wgan:
                eps = draws.get("gp_eps")
                if eps is None:
                    eps = RD.rand((b, 1, 1, 1), gen, real_in.device)
                return LO.gradient_penalty(disc, real_in, fake_in, eps.to(real_in.device))
            if with_r1:
                return LO.r1_penalty(disc, real_in).float()
            return torch.zeros((), device=real_in.device)

        # Where D has state, the penalties first: their forwards read it as
        # this update found it, as the JAX step's `dv` does.  Elsewhere after
        # the main forward, so that its dropout draws come first.
        if gan.d_has_state:
            penalty = penalties()
        if gan.d_has_batch_stats:
            # Two forwards, each refreshing the running statistics: the JAX
            # step keeps the state the fake forward returns, which it
            # computed from the real forward's (step.py:105-123).
            real_logits = disc(real_in, update_state=True)
            fake_logits = disc(fake_in, update_state=True)
        else:
            logits = disc(torch.cat([real_in, fake_in], dim=0), update_state=True)
            real_logits, fake_logits = logits[:b], logits[b:]
        if not gan.d_has_state:
            penalty = penalties()
        r1 = penalty if with_r1 else torch.zeros((), device=real_in.device)
        if self.use_wgan:
            loss = LO.wasserstein_d_loss(real_logits, fake_logits) + mcfg.gp_lambda * penalty
            loss_real, loss_fake = -real_logits.float().mean(), fake_logits.float().mean()
        else:
            loss_real = self.criterion(real_logits,
                                       torch.ones_like(real_logits, dtype=torch.float32))
            loss_fake = self.criterion(fake_logits,
                                       torch.zeros_like(fake_logits, dtype=torch.float32))
            loss = loss_real + loss_fake
            if with_r1:
                loss = loss + 0.5 * self.r1_gamma * self.r1_interval * r1
        aux = {"loss_real": loss_real, "loss_fake": loss_fake, "r1": r1,
               "real_acc": LO.accuracy_from_logits(real_logits, True),
               "fake_acc": LO.accuracy_from_logits(fake_logits, False)}
        return loss, aux

    def g_loss(self, disc, gen, fake, draws):
        """G's loss against D (``disc`` reads the updated D); the diversity
        term pairs the samples of the global batch (parallel/mesh.py)."""
        mcfg, spec = self.mcfg, self.spec
        g_in = fake
        if spec:
            a_g = draws.get("aug_g")
            g_in = apply_augment(gen, fake, spec) if a_g is None else apply_draws(fake, a_g)
        fake_logits = disc(g_in)
        if self.use_wgan:
            g_loss = LO.wasserstein_g_loss(fake_logits)
            if mcfg.diversity_weight > 0:
                g_loss = g_loss - mcfg.diversity_weight * LO.diversity_loss(
                    gather_rows(fake, RD.current()))
        else:
            g_loss = LO.g_adversarial_loss(self.criterion, fake_logits)
            if self.g_diversity and mcfg.diversity_weight > 0:
                g_loss = g_loss - mcfg.diversity_weight * LO.diversity_loss(
                    gather_rows(fake, RD.current()))
        return g_loss


def _make_core(gan, cfg: ExperimentConfig, mesh=None):
    """(state, real, zs (D, B, L), with_r1, g_rate, d_rates, draws, g_apply,
    d_apply) -> metrics: one step with its latents, rates, R1 gate and
    applying optimizer calls given; the host's counters untouched.  A rate
    is a float, or on CUDA a 0-d device tensor.  Under a ``mesh`` with
    collectives, ``real`` and ``zs`` are this rank's rows and the draws
    take them from the global batch (ops/draws.py); the metrics are the
    data axis's means.  v2's minibatch-std feature groups the global batch
    (models/vitgan_v2.minibatch_std_feature)."""
    parts = _Losses(gan, cfg)
    disc_steps = _disc_steps(cfg)
    dtype = compute_dtype(cfg)
    ema_decay = cfg.run.ema_decay

    def d_update(state, real_in, fake_in, with_r1, draws, rate, apply):
        def disc(x, update_state=False):
            return gan.discriminator_apply(state.d, x, train=True, generator=state.rng,
                                           update_state=update_state)

        loss, aux = parts.d_loss(disc, state.rng, real_in, fake_in, with_r1, draws)
        state.d_opt.zero_grad()
        loss.backward()
        return loss.detach(), aux, state.d_opt.update(rate, apply)

    def core(state: TrainState, real: torch.Tensor, zs: torch.Tensor, with_r1: bool,
             g_rate, d_rates: Sequence, draws: Dict, g_apply: bool,
             d_apply: Sequence) -> Dict[str, torch.Tensor]:
        rows = local_row_map(mesh, real.shape[0])
        with RD.global_rows(rows):
            m = body(state, real, zs, with_r1, g_rate, d_rates, draws, g_apply, d_apply)
        if rows is None:
            return m
        keys = sorted(m)
        means = mean_over(torch.stack([m[k].reshape(()) for k in keys]), rows.group)
        return {k: means[j] for j, k in enumerate(keys)}

    def body(state, real, zs, with_r1, g_rate, d_rates, draws, g_apply, d_apply):
        g, d, gen = state.g, state.d, state.rng
        device = next(g.parameters()).device
        real = real.to(device=device, dtype=dtype)
        zs = zs.to(device=device, dtype=dtype)
        fake = g(zs[0], train=True, generator=gen)
        real_in, fake_in = parts.d_inputs(gen, real, fake.detach(), draws)

        for j in range(disc_steps - 1):  # extra critic updates on fresh latents
            with torch.no_grad():  # its BatchNorm state is dropped, as in JAX
                fake_i = gan.generator_apply(g, zs[1 + j], train=True, generator=gen,
                                             update_state=False)
            r_i, f_i = parts.d_inputs(gen, real, fake_i, {})
            d_update(state, r_i, f_i, False, {}, d_rates[j], d_apply[j])

        d_loss, d_aux, d_grad_norm = d_update(state, real_in, fake_in, with_r1, draws,
                                              d_rates[disc_steps - 1], d_apply[-1])

        # G update against the updated D; D's parameters stay out of it.
        d_params = list(d.parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            g_loss = parts.g_loss(
                lambda x: gan.discriminator_apply(d, x, train=True, generator=gen), gen,
                fake, draws)
            state.g_opt.zero_grad()
            g_loss.backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        g_grad_norm = state.g_opt.update(g_rate, g_apply)
        # Under grad_accum G moves only on applying calls, and so does the
        # EMA (step.py:255-269), so that its horizon counts effective updates.
        if ema_decay > 0 and state.g_ema is not None and g_apply:
            with torch.no_grad():
                params = [p.detach() for p in g.parameters()]
                torch._foreach_mul_(state.g_ema, ema_decay)
                torch._foreach_add_(state.g_ema, params, alpha=1.0 - ema_decay)
        metrics = {"d_loss": d_loss, "d_loss_real": d_aux["loss_real"].detach(),
                   "d_loss_fake": d_aux["loss_fake"].detach(), "g_loss": g_loss.detach(),
                   "d_real_acc": d_aux["real_acc"], "d_fake_acc": d_aux["fake_acc"],
                   "d_grad_norm": d_grad_norm, "g_grad_norm": g_grad_norm}
        if parts.r1_gamma > 0 and not parts.use_wgan:
            metrics["d_r1"] = d_aux["r1"].detach()
        return {k: v.float() for k, v in metrics.items()}

    return core


def make_train_step(gan, cfg: ExperimentConfig, mesh=None):
    """(state, real (B, H, W, C) in [-1, 1], z=None, draws=None) -> metrics, a
    dict of f32 device scalars; the state is updated in place.  Under a
    ``mesh`` with collectives ``real`` (and ``z``) are this rank's rows of
    the global batch (parallel/mesh.shard_batch)."""
    core = _make_core(gan, cfg, mesh)

    def step(state: TrainState, real: torch.Tensor, z: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        unknown = set(draws) - set(DRAW_KEYS)
        if unknown:
            raise ValueError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
        plan = plan_steps(gan, cfg, state, 1, real.shape[0], mesh=mesh)
        zs = torch.from_numpy(plan.latents[0])
        if z is not None:
            zs[0] = z
        m = core(state, real, zs, bool(plan.with_r1[0]), float(plan.g_rates[0]),
                 [float(r) for r in plan.d_rates[0]], draws, bool(plan.g_apply[0]),
                 [bool(a) for a in plan.d_apply[0]])
        _advance(state, cfg, 1)
        return m

    return step


class _MultiStep:
    """n steps per call over a batch source: the uint8 dataset and an (n, B)
    index block (``gather``), or an (n, B, H, W, C) stack of batches."""

    def __init__(self, gan, cfg: ExperimentConfig, n_steps: int, gather: bool, mesh=None):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        self.gan, self.cfg, self.n, self.gather = gan, cfg, int(n_steps), gather
        self.mesh = mesh
        self.core = _make_core(gan, cfg, mesh)
        self.keys = metric_keys(cfg)
        # The JAX device-data body flips; the stacked-batch one does not.
        self.flip = gather and cfg.data.augment_flip
        # StepPlan.kind -> (CUDAGraph, launches per replay)
        self.graphs: Dict[tuple, tuple] = {}
        self._bound = None  # (state, dataset) the graphs read
        self._bufs: Optional[dict] = None
        self._pool = self._stream = None

    def __call__(self, state: TrainState, source: torch.Tensor, indices=None,
                 latents: Optional[np.ndarray] = None) -> Dict[str, torch.Tensor]:
        n = self.n
        if self.gather:
            indices = np.asarray(indices.cpu() if torch.is_tensor(indices) else indices, np.int64)
            if indices.ndim != 2 or indices.shape[0] != n:
                raise ValueError(f"indices {indices.shape}, expected ({n}, batch)")
            batch = indices.shape[1]
        else:
            if source.ndim != 5 or source.shape[0] != n:
                raise ValueError(f"reals {tuple(source.shape)}, expected ({n}, B, H, W, C)")
            batch = source.shape[1]
        device = next(state.g.parameters()).device
        if self.gather and source.device != device:
            raise ValueError(f"the dataset is on {source.device}, the train state on {device}")
        plan = plan_steps(self.gan, self.cfg, state, n, batch, latents, self.mesh)
        if device.type == "cuda":
            rows = self._captured(state, source, indices, plan)
        else:
            rows = self._eager(state, source, indices, plan)
        _advance(state, self.cfg, n)
        return {k: rows[:, j] for j, k in enumerate(self.keys)}

    # -- the plain version: the eager loop --------------------------------

    def _eager(self, state, source, indices, plan: StepPlan) -> torch.Tensor:
        rows = []
        for i in range(self.n):
            if self.gather:
                with RD.global_rows(local_row_map(self.mesh, indices.shape[1])):
                    real = device_batch(source, torch.from_numpy(indices[i]).to(source.device),
                                        self.flip, state.rng)
            else:
                real = source[i]
            m = self.core(state, real, torch.from_numpy(plan.latents[i]), bool(plan.with_r1[i]),
                          float(plan.g_rates[i]), [float(r) for r in plan.d_rates[i]], {},
                          bool(plan.g_apply[i]), [bool(a) for a in plan.d_apply[i]])
            rows.append(torch.stack([m[k].reshape(()) for k in self.keys]))
        return torch.stack(rows)

    # -- CUDA: one captured step, replayed n times ------------------------

    def _body(self, state) -> None:
        """One step on the call's buffers at the device counter."""
        b = self._bufs
        i = b["counter"]
        if self.gather:
            idx = b["idx"].index_select(0, i)[0]
            with RD.global_rows(local_row_map(self.mesh, idx.shape[0])):
                real = device_batch(self._bound[1], idx, self.flip, state.rng)
        else:
            real = b["real"].index_select(0, i)[0]
        rates = b["rates"].index_select(0, i)[0]
        with_r1, g_apply, d_apply = b["kind"]
        m = self.core(state, real, b["latents"].index_select(0, i)[0], with_r1,
                      rates[0], [rates[1 + j] for j in range(rates.shape[0] - 1)], {},
                      g_apply, d_apply)
        b["metrics"].index_copy_(0, i, torch.stack([m[k].reshape(()) for k in self.keys])[None])
        i.add_(1)

    def _captured(self, state, source, indices, plan: StepPlan) -> torch.Tensor:
        device = source.device
        if self._bound is None:
            self._bound = (state, source if self.gather else None)
        elif self._bound[0] is not state or (self.gather and self._bound[1] is not source):
            raise ValueError("this multi-step function's CUDA graphs were captured over "
                             "another train state or dataset; build a new function")
        if self._bufs is None:
            n, ds = self.n, plan.latents.shape[1]
            b = {"latents": torch.empty(plan.latents.shape, device=device),
                 "rates": torch.empty((n, 1 + ds), device=device),
                 "metrics": torch.zeros((n, len(self.keys)), device=device),
                 "counter": torch.zeros((1,), dtype=torch.int64, device=device)}
            if self.gather:
                b["idx"] = torch.empty((n, indices.shape[1]), dtype=torch.int64, device=device)
            else:
                b["real"] = torch.empty(source.shape, device=device)
            self._bufs = b
        b = self._bufs
        if self.gather:
            b["idx"].copy_(torch.from_numpy(indices).pin_memory(), non_blocking=True)
        else:
            b["real"].copy_(source)
        b["latents"].copy_(torch.from_numpy(plan.latents).pin_memory(), non_blocking=True)
        rates = np.concatenate([plan.g_rates[:, None], plan.d_rates], 1).astype(np.float32)
        b["rates"].copy_(torch.from_numpy(rates).pin_memory(), non_blocking=True)
        b["counter"].zero_()
        for i in range(self.n):
            kind = plan.kind(i)
            if kind not in self.graphs:
                self._warm_up_and_capture(state, kind, device)
                continue
            graph, launches = self.graphs[kind]
            graph.replay()
            for name, count in launches.items():
                build.LAUNCHES[name] += count
        return b["metrics"].clone()

    def _warm_up_and_capture(self, state, kind: tuple, device) -> None:
        """Run this step eagerly on the capture stream (it builds the kernels
        and the optimizer's state, and is a real step), then capture it."""
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError(f"torch {torch.__version__} cannot register the train state's "
                               "generator with a CUDA graph (CUDAGraph.register_generator_"
                               "state): its dropout and augment draws would repeat on every "
                               "replay")
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
            self._pool = torch.cuda.graph_pool_handle()
        self._bufs["kind"] = kind
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            self._body(state)
        current.wait_stream(self._stream)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.rng)
        before = dict(build.LAUNCHES)
        try:
            # thread_local: the host pipeline's producer thread (data/pipeline.py)
            # goes on allocating and copying on its own stream meanwhile,
            # calls that the global mode refuses on every thread.
            with torch.cuda.graph(graph, pool=self._pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                self._body(state)
        except Exception as e:
            raise RuntimeError(f"the train step (with_r1, g_apply, d_apply = {kind}) could not "
                               "be captured as a "
                               f"CUDA graph: {type(e).__name__}: {e}; the multi-step call has "
                               "no eager fallback on the card, and torch leaves this "
                               "process's CUDA generators mid-capture") from e
        finally:
            launches = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                        if v != before.get(k, 0)}
            build.LAUNCHES.update(before)  # a capture launches nothing
        self.graphs[kind] = (graph, launches)


def make_multi_train_step(gan, cfg: ExperimentConfig, n_steps: int, mesh=None):
    """``n_steps`` alternating updates in one call: (state, reals (n, B, H, W,
    C) in [-1, 1], latents=None) -> metrics, each (n,) on the state's device;
    the same as n calls of the single step (true sequential G/D updates).
    ``latents`` (n, disc_steps, B, latent_dim) replaces the host's block.
    Under a ``mesh`` B is this rank's rows."""
    run = _MultiStep(gan, cfg, n_steps, gather=False, mesh=mesh)

    def multi(state: TrainState, reals: torch.Tensor, latents=None):
        return run(state, reals, None, latents)

    multi.graphs = run.graphs
    return multi


def make_device_data_train_fn(gan, cfg: ExperimentConfig, n_steps: int, mesh=None):
    """Device-resident-dataset training: (state, dataset_u8 (N, H, W, C) on
    the state's device, indices (n, B), latents=None) -> metrics, each (n,);
    each step gathers its batch by its index row, normalises it to [-1, 1]
    and flips it (data.augment_flip) on the device.  Only the indices (and
    the latents and rates) cross from the host, once per call.  Under a
    ``mesh`` the index rows are this rank's columns of the global batch."""
    run = _MultiStep(gan, cfg, n_steps, gather=True, mesh=mesh)

    def multi(state: TrainState, dataset_u8: torch.Tensor, indices, latents=None):
        return run(state, dataset_u8, indices, latents)

    multi.graphs = run.graphs
    return multi


def make_eval_step(gan, cfg: ExperimentConfig):
    """No-update validation step (step.py:424-450): (state, real, z) -> D's
    losses and accuracies on the real batch and on G(z), eval mode."""
    loss_name = getattr(cfg.model, "loss", "bce")
    criterion = LO.pick_criterion(loss_name if loss_name in ("bce", "mse") else "bce")
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(state: TrainState, real: torch.Tensor, z: torch.Tensor):
        device = next(state.g.parameters()).device
        real = real.to(device=device, dtype=dtype)
        fake = state.g(z.to(device=device, dtype=dtype))
        real_logits = gan.discriminator_apply(state.d, real)
        fake_logits = gan.discriminator_apply(state.d, fake)
        ones = torch.ones_like(real_logits, dtype=torch.float32)
        zeros = torch.zeros_like(fake_logits, dtype=torch.float32)
        return {"val_d_loss_real": criterion(real_logits, ones),
                "val_d_loss_fake": criterion(fake_logits, zeros),
                "val_g_loss": LO.g_adversarial_loss(criterion, fake_logits),
                "val_real_acc": LO.accuracy_from_logits(real_logits, True),
                "val_fake_acc": LO.accuracy_from_logits(fake_logits, False)}

    return eval_step


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy of a metrics dict."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].reshape(()) for k in keys]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, vals.astype(np.float64))}
