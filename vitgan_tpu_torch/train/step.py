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
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig
from vitgan_tpu_torch.ops.augment import apply_augment, apply_draws
from vitgan_tpu_torch.train import losses as LO
from vitgan_tpu_torch.train.sample import compute_dtype, latent_rng
from vitgan_tpu_torch.train.state import TrainState

# Fixed draws a caller may pass: instance noise on the real and fake D inputs
# (B, H, W, C), the augment draws of the real, fake and G-update D inputs
# ([(name, draws)], ops/augment.draw_augment) and WGAN-GP's mixing weights
# (B, 1, 1, 1).
DRAW_KEYS = ("noise_real", "noise_fake", "aug_real", "aug_fake", "aug_g", "gp_eps")


def make_train_step(gan, cfg: ExperimentConfig):
    """(state, real (B, H, W, C) in [-1, 1], z=None, draws=None) -> metrics, a
    dict of f32 device scalars; the state is updated in place."""
    mcfg = cfg.model
    criterion = LO.pick_criterion(mcfg.loss if mcfg.loss in ("bce", "mse") else "bce")
    use_wgan = mcfg.loss == "wgan-gp"
    r1_gamma = float(mcfg.r1_gamma or 0.0)
    r1_interval = max(1, int(mcfg.r1_interval or 1))
    disc_steps = max(1, int(mcfg.disc_steps or 1))
    dtype = compute_dtype(cfg)
    ema_decay = cfg.run.ema_decay
    spec = cfg.run.diff_augment

    def d_inputs(state, real, fake, draws):
        """Instance noise, then DiffAugment, on D's real and fake inputs."""
        gen = state.rng
        real_in, fake_in = real, fake
        if use_wgan and mcfg.instance_noise > 0:
            nr, nf = draws.get("noise_real"), draws.get("noise_fake")
            nr = torch.randn(real.shape, generator=gen, device=real.device) if nr is None else nr
            nf = torch.randn(fake.shape, generator=gen, device=fake.device) if nf is None else nf
            real_in = real + mcfg.instance_noise * nr.to(real.device, real.dtype)
            fake_in = fake + mcfg.instance_noise * nf.to(fake.device, fake.dtype)
        if spec:
            a_r, a_f = draws.get("aug_real"), draws.get("aug_fake")
            real_in = (apply_augment(gen, real_in, spec) if a_r is None
                       else apply_draws(real_in, a_r))
            fake_in = (apply_augment(gen, fake_in, spec) if a_f is None
                       else apply_draws(fake_in, a_f))
        return real_in, fake_in

    def d_loss_on(state, real_in, fake_in, with_r1, draws):
        b = real_in.shape[0]

        def disc(x, update_state=False):
            return gan.discriminator_apply(state.d, x, train=True, generator=state.rng,
                                           update_state=update_state)

        def penalties():
            if use_wgan:
                eps = draws.get("gp_eps")
                if eps is None:
                    eps = torch.rand((b, 1, 1, 1), generator=state.rng, device=real_in.device)
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
            real_logits = disc(real_in, update_state=True)
            fake_logits = disc(fake_in)
        else:
            logits = disc(torch.cat([real_in, fake_in], dim=0), update_state=True)
            real_logits, fake_logits = logits[:b], logits[b:]
        if not gan.d_has_state:
            penalty = penalties()
        r1 = penalty if with_r1 else torch.zeros((), device=real_in.device)
        if use_wgan:
            loss = LO.wasserstein_d_loss(real_logits, fake_logits) + mcfg.gp_lambda * penalty
            loss_real, loss_fake = -real_logits.float().mean(), fake_logits.float().mean()
        else:
            loss_real = criterion(real_logits, torch.ones_like(real_logits, dtype=torch.float32))
            loss_fake = criterion(fake_logits, torch.zeros_like(fake_logits, dtype=torch.float32))
            loss = loss_real + loss_fake
            if with_r1:
                loss = loss + 0.5 * r1_gamma * r1_interval * r1
        aux = {"loss_real": loss_real, "loss_fake": loss_fake, "r1": r1,
               "real_acc": LO.accuracy_from_logits(real_logits, True),
               "fake_acc": LO.accuracy_from_logits(fake_logits, False)}
        return loss, aux

    def d_update(state, real_in, fake_in, with_r1, draws):
        loss, aux = d_loss_on(state, real_in, fake_in, with_r1, draws)
        state.d_opt.zero_grad()
        loss.backward()
        return loss.detach(), aux, state.d_opt.step()

    def step(state: TrainState, real: torch.Tensor, z: Optional[torch.Tensor] = None,
             draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        draws = draws or {}
        unknown = set(draws) - set(DRAW_KEYS)
        if unknown:
            raise ValueError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
        g, d, gen = state.g, state.d, state.rng
        device = next(g.parameters()).device
        real = real.to(device=device, dtype=dtype)
        b = real.shape[0]
        host = latent_rng(state.seed, state.step)
        if z is None:
            z = gan.sample_latent(host, b)
        fake = g(z.to(device=device, dtype=dtype), train=True, generator=gen)
        real_in, fake_in = d_inputs(state, real, fake.detach(), draws)

        for _ in range(disc_steps - 1):  # extra critic updates on fresh latents
            with torch.no_grad():
                fake_i = g(gan.sample_latent(host, b).to(device=device, dtype=dtype), train=True,
                           generator=gen)
            r_i, f_i = d_inputs(state, real, fake_i, {})
            d_update(state, r_i, f_i, False, {})

        with_r1 = (not use_wgan) and r1_gamma > 0 and state.step % r1_interval == 0
        d_loss, d_aux, d_grad_norm = d_update(state, real_in, fake_in, with_r1, draws)

        # G update against the updated D; D's parameters stay out of it.
        d_params = list(d.parameters())
        for p in d_params:
            p.requires_grad_(False)
        try:
            g_in = fake
            if spec:
                a_g = draws.get("aug_g")
                g_in = apply_augment(gen, fake, spec) if a_g is None else apply_draws(fake, a_g)
            fake_logits = gan.discriminator_apply(d, g_in, train=True, generator=gen)
            if use_wgan:
                g_loss = LO.wasserstein_g_loss(fake_logits)
                if mcfg.diversity_weight > 0:
                    g_loss = g_loss - mcfg.diversity_weight * LO.diversity_loss(fake)
            else:
                g_loss = LO.g_adversarial_loss(criterion, fake_logits)
                if mcfg.g_diversity and mcfg.diversity_weight > 0:
                    g_loss = g_loss - mcfg.diversity_weight * LO.diversity_loss(fake)
            state.g_opt.zero_grad()
            g_loss.backward()
        finally:
            for p in d_params:
                p.requires_grad_(True)
        g_grad_norm = state.g_opt.step()
        if ema_decay > 0 and state.g_ema is not None:
            with torch.no_grad():
                for e, p in zip(state.g_ema, g.parameters()):
                    e.mul_(ema_decay).add_(p.detach(), alpha=1.0 - ema_decay)
        state.step += 1
        metrics = {"d_loss": d_loss, "d_loss_real": d_aux["loss_real"].detach(),
                   "d_loss_fake": d_aux["loss_fake"].detach(), "g_loss": g_loss.detach(),
                   "d_real_acc": d_aux["real_acc"], "d_fake_acc": d_aux["fake_acc"],
                   "d_grad_norm": d_grad_norm, "g_grad_norm": g_grad_norm}
        if r1_gamma > 0 and not use_wgan:
            metrics["d_r1"] = d_aux["r1"].detach()
        return {k: v.float() for k, v in metrics.items()}

    return step


def host_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """One device-to-host copy of a metrics dict."""
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].reshape(()) for k in keys]).cpu().numpy()
    return {k: float(v) for k, v in zip(keys, vals.astype(np.float64))}
