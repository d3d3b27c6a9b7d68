"""Vectorized trials: the K trials of one shape advanced together, one call a
step (the vectorized sweep, hpo/sweep.py).

Counterpart of ``jax.vmap(make_raw_train_step(...))`` over stacked states
with per-trial injected learning rates (vitgan_tpu/hpo/sweep.py:238-389).
Each trial keeps its own train state (train/state.create_train_state of the
trial's seed, which seeds its device generator and its host latents) with
its injected rates, and a group's step runs the in-place step
(train/step.make_train_step) over the trials in turn on the shared batch.
So a slot reads only its own streams, and a one-trial group is the in-place
step itself.  The JAX package vmaps because one XLA program takes every
trial; the port's step stated as a pure function under ``torch.func.vmap``
kept 1.6 times the memory a trial and stepped four trials slower than four
in-place steps on the H100 (PERF.md §6, PR 18).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from vitgan_tpu_torch.config import ExperimentConfig
from vitgan_tpu_torch.train.state import TrainState, _optim_cfg
from vitgan_tpu_torch.train.step import make_train_step, metric_keys


class TrialGroup:
    """K trials of one shape: ``states`` (one a trial, each from its own
    seed) and ``g_lrs``/``d_lrs`` their injected rates
    (``{gen,disc}_optim.inject_lr``).  ``step(real, zs=None, draws=None)``
    advances every trial by one step on the shared ``real`` batch and returns
    each metric as a (K,) tensor; ``zs`` (K, B, latent) and ``draws`` (K
    dicts of train/step.DRAW_KEYS) replace the trials' own latents and
    draws, as a test hands the JAX step's in."""

    def __init__(self, gan, cfg: ExperimentConfig, states: Sequence[TrainState],
                 g_lrs: Sequence[float], d_lrs: Sequence[float]):
        if not (_optim_cfg(cfg, "gen").inject_lr and _optim_cfg(cfg, "disc").inject_lr):
            raise ValueError("a trial group sets each trial's rates: it needs "
                             "gen_optim.inject_lr and disc_optim.inject_lr "
                             "(vitgan_tpu/hpo/sweep.py:293-298)")
        if not len(states) == len(g_lrs) == len(d_lrs):
            raise ValueError(f"{len(states)} states, {len(g_lrs)} and {len(d_lrs)} rates")
        self.states: List[TrainState] = list(states)
        for st, g, d in zip(self.states, g_lrs, d_lrs):
            st.g_opt.learning_rate, st.d_opt.learning_rate = float(g), float(d)
        self.keys = metric_keys(cfg)
        self._step = make_train_step(gan, cfg)

    @property
    def k(self) -> int:
        return len(self.states)

    def step(self, real: torch.Tensor, zs: Optional[torch.Tensor] = None,
             draws: Optional[Sequence[Dict]] = None) -> Dict[str, torch.Tensor]:
        rows = [self._step(st, real, None if zs is None else zs[i],
                           None if draws is None else draws[i])
                for i, st in enumerate(self.states)]
        return {k: torch.stack([m[k] for m in rows]) for k in self.keys}
