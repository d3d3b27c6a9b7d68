"""A minimal trainer: a device-resident dataset, epochs of train steps,
logging, the NaN abort and the run directory.

Counterpart of the on-device-data path of vitgan_tpu/train/trainer.py
(Trainer.__init__, _epoch_steps_on_device, fit) and of step.py:360-367: the
uint8 dataset lives on the card, each batch is gathered by indices from a
host permutation, normalised to [-1, 1] and optionally flipped there.  The
run directory (utils/run_dirs.save_run) is what ``cli serve`` and
``cli generate`` restore.  Checkpoints and exact resume, sample grids and
pre-emption are ROADMAP.md queue 1 item 4; FID is item 5.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig
from vitgan_tpu_torch.data.datasets import load_dataset
from vitgan_tpu_torch.models import build_gan, count_params
from vitgan_tpu_torch.ops.policy import apply_from_runtime
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import host_metrics, make_train_step
from vitgan_tpu_torch.utils.run_dirs import save_run

log = logging.getLogger("vitgan_tpu_torch")


def default_run_dir(run_name: Optional[str]) -> str:
    """$SCRATCH/output/<run name>, or ./output/<run name> without SCRATCH;
    the name defaults to a timestamp."""
    name = run_name or time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(os.environ.get("SCRATCH", "."), "output", name)


class Trainer:
    def __init__(self, cfg: ExperimentConfig, run_dir: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        apply_from_runtime(cfg.runtime)
        self.gan = build_gan(cfg)
        m = cfg.model
        self.device = torch.device(device)
        images, _ = load_dataset(cfg.data.dataset, m.image_size, m.channels,
                                 cfg.data.synthetic_samples, seed=m.seed)
        if len(images) < m.batch_size:
            raise ValueError(f"{len(images)} samples cannot fill one batch of {m.batch_size}")
        if not cfg.data.drop_last and len(images) % m.batch_size:
            raise NotImplementedError("data.drop_last=False with a partial last batch: the "
                                      "port's trainer runs full batches only; the host "
                                      "pipeline that honours it is ROADMAP.md queue 1 item 3")
        self.dataset = torch.from_numpy(images).to(self.device)  # uint8 (N, H, W, C)
        self._order_rng = np.random.default_rng(m.seed)
        self.state = create_train_state(self.gan, cfg, device=self.device)
        self.train_step = make_train_step(self.gan, cfg)
        self.run_dir = run_dir or default_run_dir(cfg.run_name)
        self.epoch = 0
        log.info("model %s: G params %d, D params %d | device %s", cfg.family,
                 count_params(self.state.g), count_params(self.state.d), self.device)

    def batches(self):
        """Index batches of one epoch: a host permutation (numpy, seeded by the
        model seed, as the JAX pipeline's), full batches only, capped at
        ``run.steps_per_epoch``."""
        b = self.cfg.model.batch_size
        order = np.arange(len(self.dataset))
        if self.cfg.data.shuffle:
            self._order_rng.shuffle(order)
        n = len(order) // b
        if self.cfg.run.steps_per_epoch:
            n = min(n, self.cfg.run.steps_per_epoch)
        return order[: n * b].reshape(n, b)

    def real_batch(self, idx: np.ndarray) -> torch.Tensor:
        """Gather on the card, normalise to [-1, 1], optionally flip."""
        real = self.dataset[torch.from_numpy(idx).to(self.device)].float() * (2.0 / 255.0) - 1.0
        if self.cfg.data.augment_flip:
            flip = torch.rand((real.shape[0], 1, 1, 1), generator=self.state.rng,
                              device=self.device) < 0.5
            real = torch.where(flip, real.flip(2), real)
        return real

    def fit(self, epochs: Optional[int] = None) -> Dict[str, float]:
        """Train ``epochs`` (default run.epochs) epochs; returns the last
        epoch's mean metrics with ``images_per_sec``.  Writes the run
        directory at the end unless the losses went non-finite."""
        run = self.cfg.run
        epochs = epochs if epochs is not None else run.epochs
        means: Dict[str, float] = {}
        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            sums: Dict[str, torch.Tensor] = {}
            t0, images, steps = time.perf_counter(), 0, 0
            for i, idx in enumerate(self.batches()):
                m = self.train_step(self.state, self.real_batch(idx))
                for k, v in m.items():
                    sums[k] = sums[k] + v if k in sums else v
                images += len(idx)
                steps += 1
                if run.log_every_steps and (i + 1) % run.log_every_steps == 0:
                    h = host_metrics({"d": m["d_loss"], "g": m["g_loss"]})
                    log.info("epoch %d step %d | D %.4f G %.4f", epoch, i + 1, h["d"], h["g"])
            means = {k: v / steps for k, v in host_metrics(sums).items()} if steps else {}
            means["images_per_sec"] = images / max(time.perf_counter() - t0, 1e-9)
            log.info("epoch %d: %s", epoch, {k: round(v, 5) for k, v in means.items()})
            if run.abort_on_nan and not all(math.isfinite(means.get(k, 0.0))
                                            for k in ("d_loss", "g_loss")):
                log.error("non-finite losses at epoch %d (d_loss=%s g_loss=%s) — aborting "
                          "without writing the run directory", epoch, means.get("d_loss"),
                          means.get("g_loss"))
                return means
        self.epoch = epochs
        self.save()
        return means

    def save(self) -> None:
        """The run directory: config.json and the generator (the EMA weights
        when run.ema_decay > 0), as ``cli serve`` reads it."""
        meta = {"step": self.state.step, "epoch": self.epoch, "seed": self.state.seed}
        save_run(self.run_dir, self.cfg, self.state.ema_state_dict(), meta=meta)
