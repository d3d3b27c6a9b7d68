"""Benchmark harness pieces: preset resolution, the captured multi-step
measurement, the warm-up and the step's FLOP model.

Counterpart of vitgan_tpu/utils/benchutil.py, read by ``cli bench`` and
``cli warmup``.  The JAX package times its scanned device call; the port
times the same call, ``train/step.make_device_data_train_fn``, which on the
card replays one captured step per step (its first call runs the first step
eagerly and captures it).  The JAX package counts a step's FLOPs with XLA's
cost analysis under ``use_pallas='never'``; the port counts the products of
one step under 'never' with ``torch.utils.flop_counter.FlopCounterMode`` on
the meta device, which holds no memory (the plain attention of a 4,096-token
step would not fit on the card), without rematerialisation, dropout and
DiffAugment (they hold no products).  Over 1,024 tokens the plain route's
chunked attention recomputes its scores in the backward, as the flash
backward does; the count has those products too.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

PRESETS = ("deit64", "hires128", "hires256", "hires256p4")


def build_preset_cfg(name: str):
    """A bench preset name to an ExperimentConfig on synthetic data: the
    families (v1 | v2 | dcgan | cnn | mlp) and the scaling presets (deit64 |
    hires128 | hires256 | hires256p4, or cli train's spelling highres*)."""
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import _FAMILIES

    syn = C.DataConfig(dataset="synthetic")
    if name.startswith("highres"):  # accept cli train's spelling too
        name = "hires" + name[len("highres"):]
    if name == "deit64":
        return C.replace(C.deit64_config(), data=syn)
    if name == "hires256p4":
        return C.replace(C.highres256p4_config(), data=syn)
    if name in ("hires128", "hires256"):
        return C.replace(C.highres_config(int(name[5:])), data=syn)
    if name not in _FAMILIES:
        raise KeyError(f"unknown bench preset {name!r}: "
                       f"{sorted(_FAMILIES)} + ['deit64', 'hires128'/'highres128', "
                       f"'hires256'/'highres256', 'hires256p4'/'highres256p4']")
    return C.ExperimentConfig(family=name, data=syn)


def _without_dropout(section):
    """A model config with every ``*dropout`` rate (nested ones too) at 0."""
    kw = {}
    for f in dataclasses.fields(section):
        v = getattr(section, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _without_dropout(v)
        elif f.name.endswith("dropout"):
            kw[f.name] = 0.0
    return dataclasses.replace(section, **kw)


def step_gflops(cfg) -> float:
    """GFLOP of the products of ONE train step (each product once: 2 * m * n
    * k a matrix product), counted by FlopCounterMode on the meta device
    under use_pallas='never', remat 'never', no dropout and no augment."""
    from torch.utils.flop_counter import FlopCounterMode

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops import policy
    from vitgan_tpu_torch.train.state import Optimizer, TrainState, _optim_cfg
    from vitgan_tpu_torch.train.step import make_train_step

    cfg = C.replace(cfg, **{"runtime.use_pallas": "never", "runtime.remat": "never",
                            "run.diff_augment": "", "run.ema_decay": 0.0,
                            cfg.family: _without_dropout(cfg.model)})
    gan = build_gan(cfg)
    saved = policy.get_policy()
    policy.apply_from_runtime(cfg.runtime)
    try:
        with torch.device("meta"):
            g = gan.generator_init(None, device="meta")
            d = gan.discriminator_init(None, device="meta")
            state = TrainState(step=0, seed=0, rng=torch.Generator(), g=g, d=d,
                               g_opt=Optimizer(_optim_cfg(cfg, "gen"), list(g.parameters())),
                               d_opt=Optimizer(_optim_cfg(cfg, "disc"), list(d.parameters())))
            m = cfg.model
            real = torch.empty((m.batch_size, m.image_size, m.image_size, m.channels))
        counter = FlopCounterMode(display=False)
        with counter:
            make_train_step(gan, cfg)(state, real)
        return counter.get_total_flops() / 1e9
    finally:
        policy.set_policy(**saved)


def build_scanned_harness(cfg, scan_steps: int, dataset_images: int = 512, n_calls: int = 1,
                          device="cuda"):
    """(fn, state, dataset, idx) of the device-data train path: the one
    construction that timing (:func:`measure_scanned_train`) and the warm-up
    share.  ``dataset`` is seeded uint8 on ``device``; ``idx`` has shape
    (n_calls, scan_steps, batch)."""
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_device_data_train_fn

    apply_from_runtime(cfg.runtime)
    m = cfg.model
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device=device)
    host = np.random.default_rng(0)
    b, s, c = m.batch_size, m.image_size, m.channels
    n_data = max(dataset_images, 2 * b)
    dataset = torch.from_numpy(host.integers(0, 256, (n_data, s, s, c), dtype=np.uint8))
    dataset = dataset.to(device)
    idx = host.integers(0, n_data, (n_calls, scan_steps, b)).astype(np.int64)
    fn = make_device_data_train_fn(gan, cfg, scan_steps)
    return fn, state, dataset, idx


def measure_scanned_train(cfg, scan_steps: int, iters: int, dataset_images: int = 512,
                          device="cuda") -> float:
    """Images/s of the device-data train path at ``scan_steps`` steps a call,
    timed by utils/timing.sync_timeit over ``iters`` calls after one
    warm-up call (on the card: the step's eager run, its capture and the
    replays), with the file system flushed before the timed calls."""
    from vitgan_tpu_torch.utils.timing import sync_timeit

    fn, state, dataset, idx = build_scanned_harness(cfg, scan_steps, dataset_images,
                                                    device=device)
    fn(state, dataset, idx[0])  # the warm-up call (the capture on the card)
    os.sync()  # flush pending writes before timing
    t = sync_timeit(fn, state, dataset, idx[0], iters=iters, warmup=1, device=device)
    return cfg.model.batch_size * scan_steps / t


def warmup_dir() -> str:
    """$SCRATCH/warmup (./warmup without SCRATCH): a warm-up's run directories,
    out of utils/run_dirs.latest_run's reach ($SCRATCH/output)."""
    return os.path.join(os.environ.get("SCRATCH", "."), "warmup")


def warmup_compile(cfg, scan_steps: int = 0, device="cuda") -> float:
    """Build what the first step of ``cli train`` under ``cfg`` would build:
    on the card every kernel of ops/csrc/, then the C++ batch assembler, and
    the Trainer ``cli train`` builds (its run directory under
    :func:`warmup_dir`); with ``scan_steps`` also one call of the bench
    harness (on the card: the step's capture).  Returns the seconds taken
    (the build's part near zero when the libraries are already built)."""
    from vitgan_tpu_torch.data import native
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    if torch.device(device).type == "cuda":
        build.build()
    try:
        native.load_library()
    except (OSError, subprocess.SubprocessError):
        pass  # no g++: the trainer assembles batches with numpy (data/pipeline.py)
    run_name = cfg.run_name or f"warmup_{cfg.family}"
    Trainer(cfg, run_dir=os.path.join(warmup_dir(), run_name), device=device,
            fid_extractor="random_conv")
    if scan_steps:
        fn, state, dataset, idx = build_scanned_harness(cfg, scan_steps, device=device)
        fn(state, dataset, idx[0])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
    return time.perf_counter() - t0
