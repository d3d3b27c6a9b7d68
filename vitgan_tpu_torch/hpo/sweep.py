"""Hyperparameter sweeps: random search over the reference's space, the
collapse-aware ranking, resume, striding across workers, and vectorized
trials.

Counterpart of vitgan_tpu/hpo/sweep.py, with its semantics:

- ``sample_search_space`` draws the JAX package's space from a numpy
  generator in the same order, so a seed gives the same trials in both
  packages (generator/discriminator rates log-uniform in [1e-5, 3e-4],
  embed 128/256/512, heads 4/8, batch 128/256, loss bce/wgan-gp,
  diversity weight 0.1/0.5);
- ``run_sweep`` trains the trials one by one through the port's Trainer
  (the kernels the trial's shapes route to), each FID with the
  ``random_conv`` extractor, appends each trial to ``sweep_results.jsonl``
  and writes ``best_config.json``.  Workers that share the file each run
  ``i % trial_stride == trial_offset`` of the same drawn sequence; the
  ranking re-reads the file, so the last worker to finish leaves the
  global best.  A collapsed trial never outranks a viable one;
- ``run_sweep_vectorized`` trains the trials that share a shape as one
  group on the plain route: K states advanced by one call a step on the
  same batches (train/vstep.TrialGroup), with per-trial rates, per-trial
  random streams and the per-trial collapse verdict, then FID per trial
  from its EMA generator against real-side moments taken once per group.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np

from vitgan_tpu_torch.utils import preemption

log = logging.getLogger("vitgan_tpu_torch.sweep")


def sample_search_space(rng: np.random.Generator) -> Dict[str, Any]:
    """One trial of the space (vitgan_tpu/hpo/sweep.py:33-53), in its draw order."""
    return {
        "gen_lr": float(10 ** rng.uniform(-5, np.log10(3e-4))),
        "disc_lr": float(10 ** rng.uniform(-5, np.log10(3e-4))),
        "embed_dim": int(rng.choice([128, 256, 512])),
        "num_heads": int(rng.choice([4, 8])),
        "batch_size": int(rng.choice([128, 256])),
        "loss": str(rng.choice(["bce", "wgan-gp"])),
        "diversity_weight": float(rng.choice([0.1, 0.5])),
    }


def _trial_config(base, trial: Dict[str, Any]):
    """The base config with the trial's keys (sweep.py:56-79); trials of the
    extended space train with Adam(0, 0.99) and no weight decay."""
    from vitgan_tpu_torch import config as C

    over = {
        "v2.embed_dim": trial["embed_dim"],
        "v2.num_heads": trial["num_heads"],
        "v2.batch_size": trial["batch_size"],
        "v2.gen_optim.learning_rate": trial["gen_lr"],
        "v2.disc_optim.learning_rate": trial["disc_lr"],
    }
    if "loss" in trial:
        over["v2.loss"] = trial["loss"]
        for net in ("gen_optim", "disc_optim"):
            over.update({f"v2.{net}.name": "adam", f"v2.{net}.beta1": 0.0,
                         f"v2.{net}.beta2": 0.99, f"v2.{net}.weight_decay": 0.0})
    if "diversity_weight" in trial:
        over["v2.diversity_weight"] = trial["diversity_weight"]
    return C.replace(base, **over)


_EMPTY_BEST = {"trial": None, "params": None, "fid": float("inf")}


def _sweep_base(base_cfg, epochs_per_trial: int, dataset: str):
    """``base_cfg``, else the v2 defaults on ``dataset`` with no periodic
    checkpoints or grids and ``run.collapse_abort`` (sweep.py:85-96)."""
    from vitgan_tpu_torch import config as C

    return base_cfg or C.replace(
        C.ExperimentConfig(family="v2", data=C.DataConfig(dataset=dataset)),
        **{"run.epochs": epochs_per_trial, "run.checkpoint_every_epochs": 0,
           "run.sample_grid_every_epochs": 0,
           # collapsed trials are excluded from the ranking anyway; aborting
           # them returns their remaining budget to the sweep
           "run.collapse_abort": True},
    )


def _sweep_paths(run_base):
    """(sweep directory, its JSONL): ``run_base``, else $SCRATCH/sweeps."""
    from vitgan_tpu_torch import config as C

    out_dir = run_base or os.path.join(C.scratch_root(), "sweeps")
    os.makedirs(out_dir, exist_ok=True)
    return out_dir, os.path.join(out_dir, "sweep_results.jsonl")


def _finish_sweep(results, out_dir, log_path: Optional[str] = None) -> Dict[str, Any]:
    """Rank the trials and write ``best_config.json`` (sweep.py:107-135).
    With ``log_path`` the shared JSONL is read first, so every worker ranks
    every completed trial.  A collapsed trial never outranks a viable one;
    if all collapsed, the best is returned flagged."""
    if log_path:
        merged = _load_recorded_trials(log_path)
        for r in results:
            merged.setdefault(int(r["trial"]), r)
        results = list(merged.values())
    if not results:
        return dict(_EMPTY_BEST)
    viable = [r for r in results if not r.get("collapsed")]
    pool = viable or results
    best = dict(min(pool, key=lambda r: r["fid"] if math.isfinite(r["fid"]) else 1e18))
    best["all_trials_collapsed"] = not viable
    best["excluded_collapsed_trials"] = len(results) - len(viable)
    with open(os.path.join(out_dir, "best_config.json"), "w") as f:
        json.dump(best, f, indent=2)
    return best


def _load_recorded_trials(log_path: str) -> Dict[int, Dict[str, Any]]:
    """The completed trials of a sweep's JSONL by index; a torn last line (a
    kill mid-append) is skipped."""
    done: Dict[int, Dict[str, Any]] = {}
    if os.path.exists(log_path):
        with open(log_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done[int(rec["trial"])] = rec
                except (ValueError, KeyError, TypeError):
                    continue
    return done


def _check_resume(done: Dict[int, Dict[str, Any]], i: int, trial: Dict[str, Any]) -> None:
    if i in done and done[i].get("params") != trial:
        raise ValueError(
            f"resume mismatch: recorded trial {i} params {done[i].get('params')} != drawn "
            f"{trial} — pass the original --seed (or point at a fresh sweep dir)")


def _append(log_path: str, rec: Dict[str, Any]) -> None:
    with open(log_path, "a") as f:
        f.write(json.dumps(rec) + "\n")


def run_sweep(num_trials: int = 10, epochs_per_trial: int = 1, seed: int = 0,
              dataset: str = "synthetic", base_cfg=None, run_base: Optional[str] = None,
              trial_offset: int = 0, trial_stride: int = 1, resume: bool = False,
              device="cuda") -> Dict[str, Any]:
    """Random search: returns the best trial {trial, params, fid, ...}; each
    trial trains in ``<sweep dir>/trial_<i>`` and is appended to the JSONL.
    Every worker draws the same seeded sequence and runs its stride;
    ``resume`` skips the trials the JSONL holds (a drawn trial that differs
    from the recorded one raises).  SIGTERM during a trial discards it and
    ranks the trials already recorded.  Each record carries the trial's
    wall seconds and kernel launches (ops/build.LAUNCHES): the routing
    policy's gates decide, as for ``cli train``, which kernels a trial's
    shapes take."""
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.trainer import Trainer

    if not 0 <= trial_offset < max(1, trial_stride):
        raise ValueError(
            f"trial_offset={trial_offset} out of range for trial_stride={trial_stride} "
            f"(valid: 0..{max(1, trial_stride) - 1}) — an out-of-range offset would "
            "silently run zero trials")
    rng = np.random.default_rng(seed)
    base = _sweep_base(base_cfg, epochs_per_trial, dataset)
    results: List[Dict[str, Any]] = []
    out_dir, log_path = _sweep_paths(run_base)
    done = _load_recorded_trials(log_path) if resume else {}
    results.extend(done.values())  # prior trials compete in the final ranking
    for i in range(num_trials):
        trial = sample_search_space(rng)  # every worker draws every trial
        if i % max(1, trial_stride) != trial_offset:
            continue
        if i in done:
            _check_resume(done, i, trial)
            print(f"resume: skipping trial {i} (recorded fid={done[i].get('fid')})",
                  flush=True)
            continue
        cfg = C.replace(_trial_config(base, trial), run_name=f"trial_{i:03d}")
        t0, before = time.perf_counter(), dict(build.LAUNCHES)
        trainer = Trainer(cfg, run_dir=os.path.join(out_dir, f"trial_{i:03d}"), device=device,
                          fid_extractor="random_conv")
        metrics = trainer.fit(epochs=epochs_per_trial)
        if preemption.requested():
            break  # a partial trial would poison the merged ranking
        rec = {"trial": i, "params": trial, "fid": metrics.get("fid", float("inf")),
               "collapsed": bool(trainer.collapsed),
               "metrics": {k: v for k, v in metrics.items() if isinstance(v, float)},
               "seconds": time.perf_counter() - t0,
               "launches": {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
                            if v != before.get(k, 0)}}
        results.append(rec)
        _append(log_path, rec)
    return _finish_sweep(results, out_dir, log_path)




# ---------------------------------------------------------------------------
# Vectorized trials: same-shape trials as one group
# ---------------------------------------------------------------------------


def _shape_key(trial: Dict[str, Any]):
    """What fixes the step's graph (sweep.py:222-227): only the rates may
    differ inside a group."""
    return (trial["embed_dim"], trial["num_heads"], trial["batch_size"],
            trial.get("loss", "bce"), trial.get("diversity_weight"))


def _train_group(key, members, base, seed: int, epochs_per_trial: int, device, timings):
    """Train one shape group and score its trials: their records, or None
    when SIGTERM stopped it mid-training."""
    import copy

    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.data.datasets import load_dataset
    from vitgan_tpu_torch.data.pipeline import HostDataPipeline
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train import fid as FID
    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.vstep import TrialGroup

    k = len(members)
    cfg = C.replace(_trial_config(base, members[0][1]), **{
        "v2.gen_optim.inject_lr": True, "v2.disc_optim.inject_lr": True,
        "runtime.use_pallas": "never"})
    apply_from_runtime(cfg.runtime)  # the routing policy is process-global
    gan = build_gan(cfg)
    m = cfg.model
    states = [create_train_state(gan, C.replace(cfg, **{"v2.seed": seed * 1000 + i}),
                                 device=device) for i, _ in members]
    group = TrialGroup(gan, cfg, states, [t["gen_lr"] for _, t in members],
                       [t["disc_lr"] for _, t in members])
    images, labels = load_dataset(cfg.data.dataset, root=cfg.data.data_dir,
                                  image_size=m.image_size, channels=m.channels,
                                  synthetic_samples=cfg.data.synthetic_samples, seed=m.seed)
    pipeline = HostDataPipeline(images, labels, m.batch_size, shuffle=cfg.data.shuffle,
                                drop_last=cfg.data.drop_last, augment_flip=cfg.data.augment_flip,
                                seed=m.seed, prefetch=cfg.data.prefetch, device=device)
    steps_cap = base.run.steps_per_epoch
    c_window, c_acc = base.run.collapse_window, base.run.collapse_acc
    consec = np.zeros(k, np.int64)
    tripped = np.zeros(k, bool)
    t0, n_total, step_s = time.perf_counter(), 0, []
    for _epoch in range(epochs_per_trial):
        acc_sum, n_steps = None, 0
        for s_i, (real, _) in enumerate(pipeline.epoch()):
            if real.shape[0] != m.batch_size:
                continue  # every trial of the group steps on full batches
            ts = time.perf_counter()
            metrics = group.step(real)
            a = 0.5 * (metrics["d_real_acc"] + metrics["d_fake_acc"])
            acc_sum = a if acc_sum is None else acc_sum + a
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_s.append(time.perf_counter() - ts)
            n_steps += 1
            if preemption.requested():
                log.warning("preemption: abandoning vectorized group %s mid-training (no "
                            "records written)", key)
                return None
            if steps_cap and s_i + 1 >= steps_cap:
                break
        n_total += n_steps
        if c_window > 0 and n_steps:
            epoch_acc = acc_sum.float().cpu().numpy() / n_steps
            consec = np.where(epoch_acc >= c_acc, consec + 1, 0)
            tripped |= consec >= c_window
    if timings is not None:
        later = step_s[1:] or step_s
        timings.append({"group": list(key), "trials": k, "steps": n_total,
                        "seconds": time.perf_counter() - t0,
                        "step_ms": 1e3 * sum(later) / max(1, len(later)),
                        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                                     if device.type == "cuda" else None)})

    extractor = FID.make_feature_extractor("random_conv", m.channels, device)
    sample_fn = make_sample_fn(gan, cfg)
    num_fid = min(base.run.fid_num_samples, pipeline.num_samples)
    real_stats, seen = None, 0  # the real side once per group
    for rb, _ in pipeline.epoch():
        rb = FID.to_uint8(rb.cpu().numpy())
        take = min(len(rb), num_fid - seen)
        if take <= 0:
            break
        feats = extractor(rb[:take])
        if real_stats is None:
            real_stats = FID.FeatureStats(feats.shape[-1])
        real_stats.update(feats)
        seen += take
    mu_r, cov_r = real_stats.moments()
    sampler = None  # G with a trial's EMA weights, where tracked
    recs = []
    for slot, ((i, t), st) in enumerate(zip(members, states)):
        g = st.g
        if st.g_ema is not None:
            sampler = sampler or copy.deepcopy(st.g)
            sampler.load_state_dict(st.ema_state_dict())
            g = sampler
        fake_stats = FID.FeatureStats(len(mu_r))
        generated, call = 0, 0
        while generated < seen:
            n = min(m.batch_size, seen - generated)
            z = gan.sample_latent(latent_rng(10_000 + i, call), n)
            fake_stats.update(extractor(FID.to_uint8(sample_fn(g, z).cpu().numpy())))
            generated += n
            call += 1
        mu_f, cov_f = fake_stats.moments()
        recs.append({"trial": i, "params": t,
                     "fid": float(FID.frechet_distance(mu_r, cov_r, mu_f, cov_f)),
                     "collapsed": bool(tripped[slot]),
                     "vectorized_group": list(key), "group_size": k})
    return recs


def run_sweep_vectorized(num_trials: int = 10, epochs_per_trial: int = 1, seed: int = 0,
                         dataset: str = "synthetic", base_cfg=None,
                         run_base: Optional[str] = None, resume: bool = False,
                         device="cuda", timings: Optional[list] = None) -> Dict[str, Any]:
    """Trials that share a shape train as one group (train/vstep.TrialGroup)
    on the plain route (``runtime.use_pallas=never``, as the JAX package's
    vectorized trials): trial i's state is drawn from the model seed ``seed *
    1000 + i``, its random streams seeded the same way; every trial of a
    group sees the same real batches (partial batches are skipped).  Each
    trial's collapse verdict is kept on the host (the trainer's rule over
    epoch-mean D accuracy); its FID takes its EMA generator's samples from
    latents of seed 10,000 + i against real-side moments computed once per
    group.  ``timings`` (a list) receives one dict a group: trials, steps,
    seconds, the group step's mean milliseconds after the first and the
    peak memory."""
    import torch

    rng = np.random.default_rng(seed)
    trials = [(i, sample_search_space(rng)) for i in range(num_trials)]
    base = _sweep_base(base_cfg, epochs_per_trial, dataset)
    out_dir, log_path = _sweep_paths(run_base)
    results: List[Dict[str, Any]] = []
    done = _load_recorded_trials(log_path) if resume else {}
    for i, t in trials:
        _check_resume(done, i, t)
    results.extend(done.values())

    groups: Dict[Any, List] = {}
    for i, t in trials:
        if i not in done:
            groups.setdefault(_shape_key(t), []).append((i, t))
    device = torch.device(device)
    for key, members in sorted(groups.items(), key=lambda kv: str(kv[0])):
        if preemption.requested():
            break
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        recs = _train_group(key, members, base, seed, epochs_per_trial, device, timings)
        if recs is None:
            break
        for rec in recs:
            results.append(rec)
            _append(log_path, rec)
    return _finish_sweep(results, out_dir, log_path)
