"""The port's run directory: ``config.json`` in the JAX schema plus the
generator's ``state_dict`` saved with ``torch.save`` (``generator.pt``, and
``generator_best.pt`` when a best checkpoint is kept).

Counterpart of vitgan_tpu/utils/run_dirs.restore_run.  The JAX package's
Orbax checkpoints need JAX to read; a JAX generator reaches the port through
weights.from_jax_tree or weights.load_npz instead.
"""

from __future__ import annotations

import json
import os

import torch

from vitgan_tpu_torch import config as C

GENERATOR_FILE = "generator.pt"
BEST_FILE = "generator_best.pt"


def save_run(run_dir: str, cfg, generator, meta: dict | None = None) -> None:
    """config.json, the generator's weights (a module or its state_dict) and
    meta.json."""
    os.makedirs(run_dir, exist_ok=True)
    C.save_config(cfg, os.path.join(run_dir, "config.json"))
    sd = generator if isinstance(generator, dict) else generator.state_dict()
    state = {k: v.detach().cpu() for k, v in sd.items()}
    torch.save(state, os.path.join(run_dir, GENERATOR_FILE))
    with open(os.path.join(run_dir, "meta.json"), "w") as f:
        json.dump(meta or {}, f)


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
    meta_path = os.path.join(run_dir, "meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return cfg, gan, g, meta
