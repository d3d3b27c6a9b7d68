"""Checkpoints of the FULL train state, written with ``torch.save``.

Counterpart of vitgan_tpu/utils/checkpoint.py.  A checkpoint is
``step_%010d/state.pt`` with a JSON sidecar ``step_%010d.json`` holding the
step and the trainer's metadata (the next epoch to run, ...); ``best/`` and
``best.json`` hold the best-metric checkpoint with ``{step, metric, value,
...}``.  What is saved is the caller's dict of tensors and plain values
(``TrainState.state_dict``: both networks, both optimizers with their update
counts, the EMA, the step, the seed and the device generator's state), so a
restore continues bit for bit.  Saves are synchronous (``wait`` only trims),
and each is written to a temporary name and renamed, so a crash mid-save
leaves the earlier checkpoints whole.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import torch

STATE_FILE = "state.pt"


class CheckpointManager:
    """Step-indexed checkpoints with keep-N retention and best-metric tracking."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _write(self, path: str, state: Dict[str, Any], sidecar: Dict[str, Any]) -> str:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)
        with open(path + ".json", "w") as f:
            json.dump(sidecar, f)
        return path

    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict[str, Any]] = None) -> str:
        # Retention runs BEFORE the new save, as the JAX manager's does: the
        # newest `keep` durable checkpoints stay while the new one is written.
        self._retain()
        return self._write(self._path(step), state, {"step": step, **(metadata or {})})

    def save_best(self, step: int, state: Dict[str, Any], metric_name: str,
                  metric_value: float, metadata: Optional[Dict[str, Any]] = None) -> str:
        """Best-model checkpoint keyed on a named criterion."""
        return self._write(os.path.join(self.directory, "best"), state,
                           {"step": step, "metric": metric_name, "value": metric_value,
                            **(metadata or {})})

    def wait(self) -> None:
        """Every save is durable on return; trim to ``keep`` (the save after
        retention may leave keep + 1)."""
        self._retain()

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            p = self._path(s)
            shutil.rmtree(p, ignore_errors=True)
            try:
                os.remove(p + ".json")
            except OSError:
                pass

    def all_steps(self):
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                best: bool = False) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """(state dict on the CPU, metadata) of ``step`` (default: the latest)
        or of the best checkpoint."""
        if best:
            path = os.path.join(self.directory, "best")
        else:
            step = step if step is not None else self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
            path = self._path(step)
        file = os.path.join(path, STATE_FILE)
        if not os.path.exists(file):
            raise FileNotFoundError(f"no checkpoint at {path}")
        state = torch.load(file, map_location="cpu", weights_only=True)
        meta = {}
        if os.path.exists(path + ".json"):
            with open(path + ".json") as f:
                meta = json.load(f)
        return state, meta


def partial_load(target: Dict[str, torch.Tensor],
                 source: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """strict=False warm start over a ``state_dict``: every entry of
    ``target`` whose name and shape ``source`` has takes the source's tensor.
    Returns (merged, n_loaded, n_target_entries)."""
    merged, loaded = {}, 0
    for name, tv in target.items():
        sv = source.get(name)
        if sv is not None and tuple(sv.shape) == tuple(tv.shape):
            merged[name] = sv
            loaded += 1
        else:
            merged[name] = tv
    return merged, loaded, len(target)
