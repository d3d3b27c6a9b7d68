"""Model registry of the port: the v1 and v2 ViT-GANs and the baselines
(dcgan, cnn, mlp).

Counterpart of vitgan_tpu/models/__init__.py.  ``build_gan`` binds a family
to its config; ``generator_init`` and ``discriminator_init`` draw weights from
an explicit ``torch.Generator``; ``sample_latent`` draws the generator's input
noise on the host (train/sample.py says why from numpy's Philox).
"""

from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig

_FAMILIES = {"v1": "vitgan_v1", "v2": "vitgan_v2", "dcgan": "dcgan", "cnn": "cnngan",
             "mlp": "mlp_gan"}
# Families whose generator holds BatchNorm running statistics.
_BN_GENERATORS = ("dcgan", "cnn")


@dataclass(frozen=True)
class GANBundle:
    """A model family bound to its config."""

    family: str
    cfg: Any
    latent_dim: int
    image_shape: Tuple[int, int, int]  # (H, W, C)
    # True when D carries batch statistics (BatchNorm): the train step then
    # runs real and fake through separate forwards, each refreshing them.
    # Neither ViT discriminator nor the MLP one has any (the v1 ISR state
    # depends on the weights alone), so each scores the concatenated
    # [real; fake] batch in one forward.  Read from the discriminator itself.
    d_has_batch_stats: bool = False
    # {'g': runner, 'd': runner} that the built modules run their block
    # stacks through (parallel/pipeline.pp_bundle); None for the sequential loop
    blocks_runners: Optional[dict] = field(default=None, compare=False, hash=False)

    @property
    def d_has_state(self) -> bool:
        """True when D's forward refreshes a state of its own (the v1 ISR u
        vectors): the train step then runs a D update's penalties first."""
        return self.family == "v1" and self.cfg.discriminator.spectral_rescale

    def _module(self):
        return importlib.import_module(f"vitgan_tpu_torch.models.{_FAMILIES[self.family]}")

    def generator_init(self, generator: Optional[torch.Generator], device="cuda"):
        return self._runs("g", self._module().Generator(self.cfg, generator, device=device))

    def discriminator_init(self, generator: Optional[torch.Generator], device="cuda"):
        return self._runs("d", self._module().Discriminator(self.cfg, generator, device=device))

    def _runs(self, net: str, module):
        if self.blocks_runners is not None:
            module.blocks_runner = self.blocks_runners[net]
        return module

    def generator_apply(self, g, z: torch.Tensor, train: bool = False,
                        generator: Optional[torch.Generator] = None,
                        update_state: Optional[bool] = None) -> torch.Tensor:
        """Images of the generator module ``g``.  A BatchNorm generator's
        training forward refreshes its running statistics unless
        ``update_state`` is False (the extra critic updates' forwards, whose
        state the JAX step drops); the other families have none."""
        if self.family in _BN_GENERATORS and update_state is not None:
            return g(z, train=train, generator=generator, update_state=update_state)
        return g(z, train=train, generator=generator)

    def discriminator_apply(self, d, images: torch.Tensor, train: bool = False,
                            generator: Optional[torch.Generator] = None,
                            update_state: bool = False) -> torch.Tensor:
        """Raw logits (B,) of the discriminator module ``d``.  With
        ``update_state`` a v1 discriminator writes its refreshed ISR state
        back and a BatchNorm one its running statistics (the JAX
        `update_state` and the state a train forward returns); v2 and the
        MLP have no state and ignore it."""
        if self.family == "v1" or self.d_has_batch_stats:
            return d(images, train=train, generator=generator, update_state=update_state)
        return d(images, train=train, generator=generator)

    def sample_latent(self, rng: np.random.Generator, batch: int) -> torch.Tensor:
        """Fresh generator input noise: N(0, 1) float32 on the CPU."""
        return torch.from_numpy(rng.standard_normal((batch, self.latent_dim), np.float32))


def build_gan(cfg: ExperimentConfig) -> GANBundle:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (have: {sorted(_FAMILIES)})")
    from vitgan_tpu_torch.models.dcgan import has_batch_stats

    m = cfg.model
    bundle = GANBundle(family=cfg.family, cfg=m, latent_dim=m.latent_dim,
                       image_shape=(m.image_size, m.image_size, m.channels))
    # The batch-stats flag from the discriminator's own buffers, built on the
    # meta device (no draw, no allocation), as the JAX registry reads it
    # from an abstract init.
    with torch.device("meta"):
        d = bundle.discriminator_init(None, device="meta")
    return dataclasses.replace(bundle, d_has_batch_stats=has_batch_stats(d))


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
