"""Tracing / profiling hooks (counterpart of vitgan_tpu/utils/profiling.py):
per-step timers with EMA and throughput, ``torch.profiler`` trace capture
(a Chrome/Perfetto trace) and named regions inside it."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


class StepTimer:
    """Wall-clock per-step timing with EMA and images/sec."""

    def __init__(self, ema_alpha: float = 0.9):
        self.alpha = ema_alpha
        self.ema_s: Optional[float] = None
        self.total_s = 0.0
        self.steps = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.total_s += dt
        self.steps += 1
        self.ema_s = dt if self.ema_s is None else self.alpha * self.ema_s + (1 - self.alpha) * dt
        return False

    def images_per_sec(self, batch_size: int) -> float:
        if not self.steps:
            return 0.0
        return batch_size / (self.total_s / self.steps)

    def summary(self, batch_size: int) -> Dict[str, float]:
        return {
            "steps": float(self.steps),
            "mean_step_ms": 1e3 * self.total_s / max(self.steps, 1),
            "ema_step_ms": 1e3 * (self.ema_s or 0.0),
            "images_per_sec": self.images_per_sec(batch_size),
        }


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the host and, where there is one, the CUDA device; writes
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto) on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace."""
    with torch.profiler.record_function(name):
        yield
