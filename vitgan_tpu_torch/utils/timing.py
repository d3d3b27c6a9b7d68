"""Device timing (counterpart of vitgan_tpu/utils/timing.py).

On CUDA the time of a call is read from CUDA events recorded around the
timed calls on the current stream, after a synchronise that ends the
warm-up; on the CPU from the host clock.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def sync_timeit(fn: Callable, *args, iters: int = 10, warmup: int = 1,
                device=None) -> float:
    """Mean seconds per call of ``fn(*args)`` on ``device`` (default: CUDA
    when available)."""
    device = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
    for _ in range(max(1, warmup)):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters
