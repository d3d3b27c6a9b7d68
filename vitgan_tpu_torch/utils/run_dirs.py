"""The port's run directory.

Counterpart of vitgan_tpu/utils/run_dirs.py: ``construct_directories``
lays out ``<base>/<name>/{images,input,noise,checkpoints,logs}`` with
``training.log`` (the reference's artifact contract), ``latest_run`` picks
the newest run under a base, ``data_dir`` names a dataset's directory.
The trainer writes full-state checkpoints under ``checkpoints/``
(utils/checkpoint.py) and, for serving, the
generator's ``state_dict`` with ``torch.save`` (``generator.pt``, and
``generator_best.pt`` beside each best checkpoint, ``save_best``) next to
``config.json`` in the JAX schema: ``save_run`` and ``restore_run``, which
``cli serve``, ``generate`` and ``eval`` read (``--best``: the best
generator, with the best checkpoint's ``checkpoints/best.json`` as its
metadata).  The JAX package's Orbax checkpoints
need JAX to read; a JAX generator reaches the port through
weights.from_jax_tree or weights.load_npz instead.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import torch

from vitgan_tpu_torch import config as C

GENERATOR_FILE = "generator.pt"
BEST_FILE = "generator_best.pt"


def default_base() -> str:
    """$SCRATCH/output, or ./output without SCRATCH."""
    return os.path.join(os.environ.get("SCRATCH", "."), "output")


@dataclass(frozen=True)
class RunDirs:
    root: str
    images: str
    input: str
    noise: str
    checkpoints: str
    logs: str

    @property
    def training_log(self) -> str:
        return os.path.join(self.root, "training.log")


def construct_directories(run_name: str | None = None, base: str | None = None) -> RunDirs:
    """Create and return the run-dir tree; the name defaults to a timestamp."""
    root = os.path.join(base or default_base(), run_name or time.strftime("%Y%m%d-%H%M%S"))
    dirs = RunDirs(root=root, **{k: os.path.join(root, k) for k in
                                 ("images", "input", "noise", "checkpoints", "logs")})
    for p in (dirs.root, dirs.images, dirs.input, dirs.noise, dirs.checkpoints, dirs.logs):
        os.makedirs(p, exist_ok=True)
    return dirs


def data_dir(dataset: str) -> str:
    """A dataset's default directory, $SCRATCH/data/<name> (./data/<name>
    without SCRATCH), where data/datasets.load_dataset looks for its files
    (vitgan_tpu/utils/run_dirs.py:49-53; the port does not create it)."""
    return os.path.join(os.environ.get("SCRATCH", "."), "data", dataset)


def latest_run(base: str | None = None) -> str | None:
    """The newest (by name: timestamps sort) run directory under ``base``."""
    base = base or default_base()
    if not os.path.isdir(base):
        return None
    runs = sorted(d for d in os.listdir(base) if os.path.isdir(os.path.join(base, d)))
    return os.path.join(base, runs[-1]) if runs else None


def _save_generator(path: str, generator) -> None:
    """A generator's weights (a module or its state_dict) on the CPU, written
    to a temporary name and renamed."""
    sd = generator if isinstance(generator, dict) else generator.state_dict()
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path + ".tmp")
    os.replace(path + ".tmp", path)


def save_run(run_dir: str, cfg, generator, meta: dict | None = None) -> None:
    """config.json, the generator's weights (a module or its state_dict) and
    meta.json."""
    os.makedirs(run_dir, exist_ok=True)
    C.save_config(cfg, os.path.join(run_dir, "config.json"))
    _save_generator(os.path.join(run_dir, GENERATOR_FILE), generator)
    with open(os.path.join(run_dir, "meta.json"), "w") as f:
        json.dump(meta or {}, f)


def save_best(run_dir: str, generator) -> None:
    """The best generator's weights, ``generator_best.pt`` (the run's
    config.json is the trainer's)."""
    _save_generator(os.path.join(run_dir, BEST_FILE), generator)


def restore_run(run_dir: str, best: bool = False, overrides: dict | None = None,
                device="cuda"):
    """(cfg, gan, generator module, meta) from a run directory, the generator
    on ``device`` with its weights loaded and the run's kernel policy applied."""
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.weights import load_into

    cfg = C.load_config(os.path.join(run_dir, "config.json"))
    if overrides:
        cfg = C.replace(cfg, **overrides)
    apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    path = os.path.join(run_dir, BEST_FILE if best else GENERATOR_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no generator weights at {path}")
    # Shapes come from the config; the module is built on the meta device (no
    # draw, no allocation) and takes the loaded tensors as its own.
    with torch.device("meta"):
        g = gan.generator_init(None, device="meta")
    load_into(g, torch.load(path, map_location="cpu", weights_only=True), assign=True)
    g.to(device)
    meta_path = (os.path.join(run_dir, "checkpoints", "best.json") if best
                 else os.path.join(run_dir, "meta.json"))
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return cfg, gan, g, meta
