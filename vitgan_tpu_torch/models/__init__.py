"""Model registry of the port: the v1 and v2 families.

Counterpart of vitgan_tpu/models/__init__.py.  ``build_gan`` binds a family
to its config; ``generator_init`` and ``discriminator_init`` draw weights from
an explicit ``torch.Generator``; ``sample_latent`` draws the generator's input
noise on the host (train/sample.py says why from numpy's Philox).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig, V1Config, V2Config

# Families of the JAX package still to port, with their ROADMAP.md queue 1 item.
_NOT_PORTED = {"dcgan": "11 (the baselines)", "cnn": "11 (the baselines)",
               "mlp": "11 (the baselines)"}


@dataclass(frozen=True)
class GANBundle:
    """A model family bound to its config."""

    family: str
    cfg: Union[V1Config, V2Config]
    latent_dim: int
    image_shape: Tuple[int, int, int]  # (H, W, C)
    # True when D carries batch statistics: the train step then runs real and
    # fake through separate forwards.  Neither ViT discriminator has any (the
    # v1 ISR state depends on the weights alone), so each scores the
    # concatenated [real; fake] batch in one forward.
    d_has_batch_stats: bool = False

    @property
    def d_has_state(self) -> bool:
        """True when D's forward refreshes a state of its own (the v1 ISR u
        vectors): the train step then runs a D update's penalties first."""
        return self.family == "v1" and self.cfg.discriminator.spectral_rescale

    def _module(self):
        from vitgan_tpu_torch.models import vitgan_v1, vitgan_v2

        return vitgan_v1 if self.family == "v1" else vitgan_v2

    def generator_init(self, generator: Optional[torch.Generator], device="cuda"):
        return self._module().Generator(self.cfg, generator, device=device)

    def discriminator_init(self, generator: Optional[torch.Generator], device="cuda"):
        return self._module().Discriminator(self.cfg, generator, device=device)

    def discriminator_apply(self, d, images: torch.Tensor, train: bool = False,
                            generator: Optional[torch.Generator] = None,
                            update_state: bool = False) -> torch.Tensor:
        """Raw logits (B,) of the discriminator module ``d``.  With
        ``update_state`` a v1 discriminator writes its refreshed ISR state
        back (the JAX `update_state`); v2 has no state and ignores it."""
        if self.family == "v1":
            return d(images, train=train, generator=generator, update_state=update_state)
        return d(images, train=train, generator=generator)

    def sample_latent(self, rng: np.random.Generator, batch: int) -> torch.Tensor:
        """Fresh generator input noise: N(0, 1) float32 on the CPU."""
        return torch.from_numpy(rng.standard_normal((batch, self.latent_dim), np.float32))


def build_gan(cfg: ExperimentConfig) -> GANBundle:
    if cfg.family not in ("v1", "v2"):
        item = _NOT_PORTED.get(cfg.family)
        where = f"ROADMAP.md queue 1 item {item}" if item else "no such family in the JAX package"
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet ({where})")
    m = cfg.model
    return GANBundle(family=cfg.family, cfg=m, latent_dim=m.latent_dim,
                     image_shape=(m.image_size, m.image_size, m.channels))


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
