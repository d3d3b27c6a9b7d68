"""Logging + metric observability.

The port's copy of vitgan_tpu/utils/logging.py (it imports no JAX).
Parity targets:
- v2's rich timestamped stdout + ``training.log`` file logger (ref:src/v2/utils.py:187-191)
- v1's TensorBoard scalars/images (ref:src/v1/gan.py:33,132-134,149-163)
- v2's per-epoch PNG figure dumps (ref:src/v2/utils.py:46-96)

Scalars always go to JSONL under ``<run>/logs``; TensorBoard too when its
writer imports, and figures only when matplotlib imports.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import sys
from collections import defaultdict
from typing import Dict, Optional

_LOGGERS: Dict[str, logging.Logger] = {}


def get_logger(name: str = "vitgan_tpu_torch", log_file: Optional[str] = None) -> logging.Logger:
    """Timestamped stdout + optional file logger (ref:src/v2/utils.py:187-191)."""
    key = f"{name}:{log_file}"
    if key in _LOGGERS:
        return _LOGGERS[key]
    logger = logging.getLogger(key)
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file), exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger


class MetricLogger:
    """Scalar/image sink: TensorBoard when available, JSONL always.

    Covers the v1 SummaryWriter role (ref:src/v1/gan.py:33) and keeps an in-memory
    history for figure rendering (ref:src/v2/utils.py:46-96).
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.history: Dict[str, list] = defaultdict(list)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        try:  # torch ships a tensorboard writer; optional.
            from torch.utils.tensorboard import SummaryWriter  # type: ignore

            self._tb = SummaryWriter(log_dir=log_dir)
        except Exception:
            self._tb = None

    def scalar(self, tag: str, value: float, step: int) -> None:
        value = float(value)
        self.history[tag].append((step, value))
        self._jsonl.write(json.dumps({"tag": tag, "value": value, "step": step}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for tag, v in values.items():
            self.scalar(tag, v, step)

    def image_grid(self, tag: str, grid_hwc, step: int) -> None:
        """Log an HWC uint8 image grid (ref:src/v1/gan.py:149-163)."""
        import numpy as np

        arr = np.asarray(grid_hwc)
        if self._tb is not None:
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def save_figures(self, out_dir: str) -> None:
        """Loss/FID/grad-norm curve PNGs (ref:src/v2/utils.py:46-96)."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except Exception:
            return
        os.makedirs(out_dir, exist_ok=True)
        groups = defaultdict(list)
        for tag in self.history:
            groups[tag.split("/")[0]].append(tag)
        for group, tags in groups.items():
            fig, ax = plt.subplots(figsize=(8, 5))
            for tag in sorted(tags):
                pts = self.history[tag]
                ax.plot([p[0] for p in pts], [p[1] for p in pts], label=tag)
            ax.set_xlabel("step")
            ax.legend()
            ax.set_title(group)
            fig.savefig(os.path.join(out_dir, f"{group}.png"), dpi=100)
            plt.close(fig)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class MovingAverage:
    """EMA tracker (ref:src/v2/modules.py:9-23)."""

    def __init__(self, alpha: float = 0.9):
        self.alpha = alpha
        self.value: Optional[float] = None

    def update(self, x: float) -> float:
        self.value = x if self.value is None else self.alpha * self.value + (1 - self.alpha) * x
        return self.value


class EarlyStopping:
    """Patience-based early stop on a minimized metric (ref:src/v2/modules.py:26-45)."""

    def __init__(self, patience: int = 5, min_delta: float = 2.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best: Optional[float] = None
        self.bad_epochs = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if self.best is None or metric < self.best - self.min_delta:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        return self.bad_epochs >= self.patience


def now_tag() -> str:
    return datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
