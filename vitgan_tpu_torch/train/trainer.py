"""Trainer: the epoch loop over the device-resident dataset or the host
pipeline, observability, checkpoints and exact resume.

Counterpart of vitgan_tpu/train/trainer.py on one device (Trainer.__init__,
_epoch_steps, _epoch_steps_on_device, fit).  The dataset (data/datasets.py)
feeds data/pipeline.HostDataPipeline, whose seeded numpy generator draws
every epoch order on both routes.  The route is the JAX trainer's
(trainer.py:141-170):

- the device route, when ``data.on_device`` is set, the uint8 dataset fits
  ``data.on_device_max_bytes`` and no partial batch is asked for: the
  dataset lives on the device; each epoch takes one order, full batches
  only, capped at ``run.steps_per_epoch``, and runs it through
  ``train/step.make_device_data_train_fn`` in calls of k steps, k =
  ``run.steps_per_call`` when above 1, else min(full batches, 1024,
  steps_per_epoch); the leftover steps go through a second function of
  their length, built at first use;
- the host route otherwise: the pipeline assembles each batch on the host
  (flips drawn there) and hands it to the device one ahead; with
  ``run.steps_per_call`` 1 each batch is one call, else k batches stacked
  into ``make_multi_train_step`` and the leftover batches (and a partial
  one) one call each, through a one-step function of their batch size.

On CUDA each call replays a captured step; on the CPU it is the eager loop.
``fit`` draws the input grid's batch from the pipeline before epoch 0, as
the JAX fit does, so the epoch orders are the JAX trainer's;
- per epoch: one metric readback, the JSONL/TensorBoard scalars
  (utils/logging.MetricLogger), the NaN abort, collapse detection, sample
  grids from fixed ``eval_noise``, FID (``evaluate_fid``, train/fid.py) with
  the best checkpoint on ``run.best_metric`` and the ``generator_best.pt``
  that ``generate --best`` and ``serve --best`` read, early stopping, and
  periodic full-state checkpoints (utils/checkpoint.py);
- a crash-safe epilogue under ``preemption.shield()``: the final checkpoint
  (skipped when the state is non-finite), with ``epoch`` the next epoch to
  run, then the run directory that ``cli serve`` and ``generate`` read
  (utils/run_dirs.save_run);
- ``resume`` restores the exact state (parameters, ISR buffers, optimizer
  moments and counts, EMA, step, the device generator and the pipeline's
  generator), so a resumed run continues bit for bit on either route.

Under a mesh (parallel/mesh.py; one process per device, ``mesh`` or
``cfg.mesh`` over the started process group) every rank builds the same
state, places it (parallel/sharding.shard_train_state: DP replicated, FSDP
and TP slices, a pipe stage's blocks), and trains its rows of each global
batch: the device route's index rows are cut to its columns, the host
pipeline takes its process slice.  A pipe axis stages the block stacks
(parallel/pipeline.pp_bundle: the modules run them through the GPipe
schedule, training and eval alike); a seq axis sets sequence parallelism
(v2 only), which routes every block off the kernels.  Rank 0 writes the run
directory and the checkpoints, in the single-device format (the optimizers
gather their slices and stages first), so a run resumes on any layout; the
other ranks keep their logs under ``ranks/<rank>/`` of it and restore from
rank 0's checkpoints.  A SIGTERM on any rank stops every rank after the
same call.

FID runs between device calls, on the caller's stream under
``torch.inference_mode()``: it allocates nothing in a captured step's memory
pool and writes no tensor a captured step reads.  On the device route it
draws from no training generator, so a run with FID on trains bit for bit
like one with it off; on the host route its reals are an epoch of the
pipeline, as in the JAX package, which draws one order from it.
"""

from __future__ import annotations

import copy
import math
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from vitgan_tpu_torch.config import ExperimentConfig, save_config
from vitgan_tpu_torch.data.datasets import load_dataset
from vitgan_tpu_torch.data.pipeline import HostDataPipeline, normalize_to_unit
from vitgan_tpu_torch.models import build_gan, count_params
from vitgan_tpu_torch.ops.policy import apply_from_runtime, set_sequence_parallel
from vitgan_tpu_torch.parallel.mesh import Mesh, batch_rows, make_mesh
from vitgan_tpu_torch.parallel.sharding import shard_train_state
from vitgan_tpu_torch.train import fid as FID
from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import (device_batch, host_metrics, make_device_data_train_fn,
                                         make_eval_step, make_multi_train_step, make_train_step)
from vitgan_tpu_torch.utils import preemption
from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
from vitgan_tpu_torch.utils.images import make_grid, save_png
from vitgan_tpu_torch.utils.logging import EarlyStopping, MetricLogger, get_logger
from vitgan_tpu_torch.utils.manifest import write_env_manifest
from vitgan_tpu_torch.utils.run_dirs import (construct_directories, default_base, save_best,
                                             save_run)


def default_run_dir(run_name: Optional[str]) -> str:
    """$SCRATCH/output/<run name>, or ./output/<run name> without SCRATCH;
    the name defaults to a timestamp."""
    return os.path.join(default_base(), run_name or time.strftime("%Y%m%d-%H%M%S"))


def steps_per_call(cfg: ExperimentConfig, n_samples: int) -> int:
    """k, the steps of one device call on the device route
    (trainer.py:161-167)."""
    if cfg.run.steps_per_call > 1:
        return cfg.run.steps_per_call
    k = min(max(1, n_samples // cfg.model.batch_size), 1024)
    return min(k, cfg.run.steps_per_epoch) if cfg.run.steps_per_epoch else k


class Trainer:
    def __init__(self, cfg: ExperimentConfig, run_dir: Optional[str] = None, device="cuda",
                 fid_extractor: str = "auto", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        apply_from_runtime(cfg.runtime)
        m = cfg.model
        if cfg.mesh.context_parallel > 1 and cfg.family != "v2":
            # Only the v2 encoder stacks run their tokens sharded; any other
            # family would replicate over the seq axis while still losing the
            # kernel routing (trainer.py:55-67).
            raise ValueError(
                f"mesh.context_parallel requires family 'v2' (and its "
                f"deit64/highres presets), got {cfg.family!r}")
        if mesh is None:
            import torch.distributed as dist

            c = cfg.mesh  # the layout's ranks as a plan where no group is started
            planned = max(1, c.model_parallel) * max(1, c.pipeline_parallel) * max(
                1, c.context_parallel)
            mesh = make_mesh(c, world_size=None if dist.is_initialized() else planned)
        self.mesh = mesh
        if self.mesh.size > 1 and not self.mesh.distributed:
            raise ValueError(f"a mesh of {self.mesh.size} ranks needs a started process group "
                             "(parallel/mesh.initialize_distributed)")
        # Sequence parallelism: the v2 stacks run this rank's tokens
        # (models/vitgan_v2.run_blocks); process-global like the kernel
        # routing, which it also turns off.  A trainer without it clears it.
        set_sequence_parallel(self.mesh if self.mesh.n_seq > 1 else None, cfg.mesh.data_axis,
                              cfg.mesh.seq_axis)
        self.is_main = self.mesh.is_main
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None and self.mesh.distributed:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # this rank's rows of each global batch
        self._first, self.local_batch = (batch_rows(self.mesh, m.batch_size)
                                         if self.mesh.distributed else (0, m.batch_size))
        data = cfg.data
        images, labels = load_dataset(data.dataset, root=data.data_dir, image_size=m.image_size,
                                      channels=m.channels,
                                      synthetic_samples=data.synthetic_samples, seed=m.seed)
        if len(images) < m.batch_size:
            raise ValueError(f"{len(images)} samples cannot fill one batch of {m.batch_size}")
        self.pipeline = HostDataPipeline(images, labels, m.batch_size, shuffle=data.shuffle,
                                         drop_last=data.drop_last,
                                         augment_flip=data.augment_flip, seed=m.seed,
                                         prefetch=data.prefetch, device=self.device,
                                         process_index=self.mesh.data_index,
                                         process_count=self.mesh.n_data)
        # The device route runs full batches only, so a partial batch that
        # drop_last=False asks for takes the host route, which trains it.
        honors_partial = data.drop_last or len(images) % m.batch_size == 0
        self.route = ("device" if data.on_device and honors_partial
                      and images.nbytes <= data.on_device_max_bytes else "host")
        root = os.path.abspath(run_dir or default_run_dir(cfg.run_name))
        if not self.is_main:
            root = os.path.join(root, "ranks", str(self.mesh.rank))
        self.dirs = construct_directories(os.path.basename(root), base=os.path.dirname(root))
        self.run_dir = self.dirs.root
        save_config(cfg, os.path.join(self.run_dir, "config.json"))
        write_env_manifest(os.path.join(self.run_dir, "env.json"))
        self.log = get_logger("vitgan_tpu_torch", self.dirs.training_log)
        self.metrics = MetricLogger(self.dirs.logs)
        main_root = root if self.is_main else os.path.dirname(os.path.dirname(root))
        self.ckpts = CheckpointManager(os.path.join(main_root, "checkpoints"),
                                       keep=cfg.run.keep_checkpoints)
        self.gan = build_gan(cfg)
        if self.mesh.pipe_axis is not None:
            # The ViT block stacks staged over the pipe axis (GPipe,
            # parallel/pipeline.py); eval batches that do not divide into the
            # microbatches run as one (trainer.py:87-106).
            from vitgan_tpu_torch.parallel.pipeline import pp_bundle

            self.gan = pp_bundle(self.gan, cfg, mesh=self.mesh,
                                 microbatches=cfg.mesh.pipeline_microbatches)
        # uint8 (N, H, W, C) on the device route, None on the host route
        self.dataset = (torch.from_numpy(images).to(self.device) if self.route == "device"
                        else None)
        self.state = create_train_state(self.gan, cfg, device=self.device)
        if self.mesh.distributed:
            shard_train_state(self.state, self.mesh, tensor_parallel=cfg.mesh.model_parallel > 1,
                              fsdp=cfg.mesh.fsdp, fsdp_min_size=cfg.mesh.fsdp_min_size)
        # the step functions take the mesh where it issues collectives
        self._mesh_kw = {"mesh": self.mesh} if self.mesh.distributed else {}
        self.train_step = make_train_step(self.gan, cfg, **self._mesh_kw)
        self.steps_per_call = (steps_per_call(cfg, len(images)) if self.route == "device"
                               else max(1, cfg.run.steps_per_call))
        self._build_device_fns()
        self.sample_fn = make_sample_fn(self.gan, cfg)
        self._g_sample = None
        # Fixed noise for comparable per-epoch grids.
        self.eval_noise = self.gan.sample_latent(latent_rng(m.seed + 1, 0), min(64, m.batch_size))
        self._extractor_name, self._extractor = fid_extractor, None
        self._fid_fn, self._fid_n_batches = None, None
        self.best_metric = float("inf")
        self.epoch = 0
        self.collapsed = False
        self._poisoned = False
        self._early = None
        if cfg.run.early_stop_patience > 0:
            self._early = EarlyStopping(patience=cfg.run.early_stop_patience,
                                        min_delta=cfg.run.early_stop_min_delta)
        self.log.info("model %s: G params %d, D params %d | device %s | %s route, %d-byte "
                      "dataset of %d, batches assembled by %s | %d steps a call", cfg.family,
                      count_params(self.state.g), count_params(self.state.d), self.device,
                      self.route, images.nbytes, len(images), self.pipeline.assembler,
                      self.steps_per_call)

    def _build_device_fns(self) -> None:
        """The epoch's device functions: the device route's call of k and its
        remainder's (built at first use); the host route's call of k stacked
        batches and its one-step functions by batch size (built at first
        use)."""
        k, kw = self.steps_per_call, self._mesh_kw
        if self.route == "device":
            self._device_train_fn = make_device_data_train_fn(self.gan, self.cfg, k, **kw)
            self._device_rem_fn, self._device_rem_len = None, None
        else:
            self._host_multi_fn = (make_multi_train_step(self.gan, self.cfg, k, **kw)
                                   if k > 1 else None)
            self._host_step_fns: Dict[int, object] = {}

    # ------------------------------------------------------------------ utils

    def batches(self) -> np.ndarray:
        """(steps, B) index batches of one device-route epoch: an order from
        the pipeline's generator (trainer.py:376), full batches only, capped
        at ``run.steps_per_epoch``."""
        b = self.cfg.model.batch_size
        order = self.pipeline._epoch_order()
        n = len(order) // b
        if self.cfg.run.steps_per_epoch:
            n = min(n, self.cfg.run.steps_per_epoch)
        return order[: n * b].reshape(n, b)

    def _local(self, idx: np.ndarray) -> np.ndarray:
        """This rank's columns of (steps, B) global index rows."""
        return idx[:, self._first:self._first + self.local_batch]

    def real_batch(self, idx: np.ndarray) -> torch.Tensor:
        """One batch as a device-route step assembles it (eager)."""
        return device_batch(self.dataset, torch.from_numpy(np.asarray(idx)).to(self.device),
                            self.cfg.data.augment_flip, self.state.rng)

    @property
    def extractor(self) -> FID.Extractor:
        """The FID feature extractor on the trainer's device, built at first use."""
        if self._extractor is None:
            self._extractor = FID.make_feature_extractor(self._extractor_name,
                                                         self.cfg.model.channels, self.device)
            self.log.info("FID extractor %r: %s, %d features", self._extractor_name,
                          self._extractor.name, self._extractor.feature_dim)
        return self._extractor

    def checkpoint_state(self) -> dict:
        return {"state": self.state.state_dict(),
                "data_order": self.pipeline._rng.bit_generator.state}

    def resume(self, step: Optional[int] = None, best: bool = False) -> None:
        """Restore a checkpoint of this run (default: the latest) in place;
        the epoch cursor is the next epoch to run."""
        sd, meta = self.ckpts.restore(step=step, best=best)
        self.state.load_state_dict(sd["state"])
        self.pipeline._rng.bit_generator.state = sd["data_order"]
        self._build_device_fns()  # captured again at first use
        self.epoch = int(meta.get("epoch", 0))
        self.best_metric = float(meta.get("best_metric", float("inf")))
        self.log.info("resumed from step %d (epoch %d)", self.state.step, self.epoch)

    def warm_start_discriminator(self, source) -> int:
        """strict=False warm start of D (trainer.py:261-290) from a
        state_dict, a bare JAX-layout parameter tree or a {'params', 'state'}
        tree (utils/torch_port.import_checkpoint; BatchNorm's running
        statistics are state): every leaf whose name and shape match takes
        the source's value, in place, so that a captured step replays it;
        D's optimizer state is left as it is.  Returns the leaves loaded."""
        from vitgan_tpu_torch.utils.checkpoint import partial_load
        from vitgan_tpu_torch.weights import from_jax_tree

        flat = source if all(isinstance(v, torch.Tensor) for v in source.values()) else (
            from_jax_tree(source))
        own = self.state.d.state_dict()
        merged, loaded, _ = partial_load(own, flat)
        with torch.no_grad():
            for name, t in own.items():
                if merged[name] is not t:
                    t.copy_(merged[name])
        self.log.info("warm-started D: %d of %d leaves loaded", loaded, len(own))
        return loaded

    def _sampling_generator(self):
        """G with the EMA weights when tracked, else the live G."""
        if self.state.g_ema is None:
            return self.state.g
        if self._g_sample is None:
            self._g_sample = copy.deepcopy(self.state.g)
        self._g_sample.load_state_dict(self.state.ema_state_dict())
        return self._g_sample

    def evaluate_fid(self, num_samples: Optional[int] = None,
                     spans: Optional[dict] = None) -> float:
        """FID of the sampling generator against the dataset
        (trainer.py:300-334).  On the device route: n_batches = max(1, num
        // batch) batches a side, the real indices from default_rng(step)
        (with replacement when they outnumber the dataset), fake batch i from
        latent_rng(step, i), features and moments on the device
        (train/fid.make_on_device_fid).  On the host route: the reals are the
        first num images of an epoch of the pipeline (its order drawn from
        the pipeline's generator, as in the JAX package), through
        train/fid.compute_fid.  ``spans`` collects the seconds of the
        generator, the features and the Frechet math."""
        num = min(num_samples or self.cfg.run.fid_num_samples, self.pipeline.num_samples)
        b = self.cfg.model.batch_size
        step = int(self.state.step)
        if self.route == "host":
            g = self._sampling_generator()

            def sample_batch(rng, n):
                return self.sample_fn(g, self.gan.sample_latent(rng, n)).cpu().numpy()

            reals = (x.cpu() for x, _ in self.pipeline.epoch(max_batches=-(-num // b)))
            return FID.compute_fid(sample_batch, reals, self.extractor, step, num, b,
                                   spans=spans)
        n_batches = max(1, num // b)
        if self._fid_n_batches != n_batches:
            ex = self.extractor
            self._fid_fn = FID.make_on_device_fid(self.gan, self.cfg, ex.feature_fn, b,
                                                  n_batches, ex.feature_dim)
            self._fid_n_batches = n_batches
        n_pop = len(self.dataset)
        real_idx = np.random.default_rng(step).choice(n_pop, size=(n_batches, b),
                                                      replace=n_batches * b > n_pop)
        return self._fid_fn(self._sampling_generator(), self.dataset, real_idx, step, spans)

    def validate(self, num_batches: int = 8) -> Dict[str, float]:
        """No-update validation: D/G losses and accuracies (make_eval_step)
        over the dataset's first ``num_batches`` batches in index order, on
        either route, so that the pipeline's generator is left alone (the
        JAX trainer takes pipeline batches, trainer.py:237); the latents of
        batch i from latent_rng(1000 + i, 0)."""
        if not hasattr(self, "_eval_step"):
            self._eval_step = make_eval_step(self.gan, self.cfg)
        b = self.cfg.model.batch_size
        sums: Dict[str, torch.Tensor] = {}
        n = min(num_batches, self.pipeline.num_samples // b)
        for i in range(n):
            real = torch.from_numpy(normalize_to_unit(
                self.pipeline.images[i * b:(i + 1) * b])).to(self.device)
            z = self.gan.sample_latent(latent_rng(1000 + i, 0), b)
            for k, v in self._eval_step(self.state, real, z).items():
                sums[k] = sums[k] + v if k in sums else v
        return {k: v / max(n, 1) for k, v in host_metrics(sums).items()} if sums else {}

    def _first_batch(self) -> np.ndarray:
        """The first batch of a new epoch order from the pipeline, float32 on
        the host, its flip bits drawn: what the JAX trainer's
        ``next(iter(pipeline.epoch()))`` takes for the input grid and the
        profile (trainer.py:253, :421), without its producer's draws for
        the batches after it."""
        return self.pipeline.assemble(self.pipeline._epoch_order()[:self.cfg.model.batch_size])

    def profile(self, n_steps: int = 5) -> str:
        """A torch.profiler trace of ``n_steps`` eager train steps on one
        batch of the pipeline; returns the trace directory (logs/profile)."""
        from vitgan_tpu_torch.utils.profiling import trace

        real = torch.from_numpy(self._first_batch()[self._first:self._first + self.local_batch]
                                ).to(self.device)
        trace_dir = os.path.join(self.dirs.logs, "profile")
        with trace(trace_dir):
            for _ in range(n_steps):
                m = self.train_step(self.state, real)
            host_metrics(m)
        return trace_dir

    # ------------------------------------------------------------------ loop

    def _save_grids(self, epoch: int) -> None:
        imgs = self.sample_fn(self._sampling_generator(), self.eval_noise).cpu().numpy()
        save_png(os.path.join(self.dirs.images, f"epoch_{epoch:04d}.png"), make_grid(imgs))
        self.metrics.image_grid("samples", make_grid(imgs), self.state.step)

    def _epoch_calls(self):
        """Yield (metrics of one device call, images) over one epoch."""
        if self.route == "host":
            yield from self._host_epoch_calls()
            return
        idx = self._local(self.batches())
        b, k = self.cfg.model.batch_size, self.steps_per_call
        full = (len(idx) // k) * k
        for start in range(0, full, k):
            yield self._device_train_fn(self.state, self.dataset, idx[start:start + k]), k * b
        rem = len(idx) - full
        if rem:
            if self._device_rem_len != rem:
                self._device_rem_fn = make_device_data_train_fn(self.gan, self.cfg, rem,
                                                                **self._mesh_kw)
                self._device_rem_len = rem
            yield self._device_rem_fn(self.state, self.dataset, idx[full:]), rem * b

    def _host_step(self, real: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on one pipeline batch, through the one-step function of
        its batch size (a partial batch's is its own capture on CUDA)."""
        fn = self._host_step_fns.get(real.shape[0])
        if fn is None:
            fn = self._host_step_fns[real.shape[0]] = make_multi_train_step(self.gan, self.cfg, 1,
                                                                            **self._mesh_kw)
        return fn(self.state, real[None])

    def _host_epoch_calls(self):
        """The host route's epoch, as the JAX trainer's _epoch_steps
        (trainer.py:343-371): one call a batch, or with steps_per_call k > 1,
        k full batches stacked a call and the batches left (a partial one
        among them) one call each."""
        b, k = self.local_batch, self.steps_per_call
        buf = []
        for real, _ in self.pipeline.epoch(self.cfg.run.steps_per_epoch or None):
            if real.device.type != self.device.type:
                raise RuntimeError(f"the pipeline handed a batch on {real.device}, the train "
                                   f"state is on {self.device}")
            if k == 1:
                yield self._host_step(real), real.shape[0]
                continue
            buf.append(real)
            if len(buf) == k and all(x.shape[0] == b for x in buf):
                yield self._host_multi_fn(self.state, torch.stack(buf)), k * b
                buf = []
        for real in buf:
            yield self._host_step(real), real.shape[0]

    def _save_checkpoint(self, meta: dict) -> None:
        """A checkpoint of the state, written by rank 0 (every rank gathers)."""
        sd = self.checkpoint_state()
        if self.is_main:
            self.ckpts.save(self.state.step, sd, meta)

    def _stop_requested(self) -> bool:
        """SIGTERM on this rank, or under a mesh on any rank (a rank that
        stopped alone would leave the others in their collectives)."""
        stop = preemption.requested()
        if not self.mesh.distributed:
            return stop
        import torch.distributed as dist

        flag = torch.tensor([1.0 if stop else 0.0],
                            device=self.device if self.device.type == "cuda" else "cpu")
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def _params_finite(self) -> bool:
        params = [*self.state.g.parameters(), *self.state.d.parameters()]
        return bool(torch.stack([torch.isfinite(p).all() for p in params]).all())

    def fit(self, epochs: Optional[int] = None) -> Dict[str, float]:
        """Train up to epoch ``epochs`` (default run.epochs) from the epoch
        cursor; returns the last epoch's mean metrics with
        ``images_per_sec``."""
        run = self.cfg.run
        epochs = epochs if epochs is not None else run.epochs
        last: Dict[str, float] = {}
        t_start = time.time()
        self._poisoned = False  # set when abort_on_nan trips (skip the final save)
        self.collapsed = False
        collapse_run = 0  # consecutive epochs at D-wins-everything accuracy
        try:
            if self.epoch == 0:
                # The input grid's batch, drawn from the pipeline before epoch
                # 0's order as in the JAX fit (trainer.py:421); a later fit
                # or a resume draws none, so that its orders continue.
                first = self._first_batch()[:64]
                save_png(os.path.join(self.dirs.input, "real.png"), make_grid(first))
                np.save(os.path.join(self.dirs.noise, "eval_noise.npy"), self.eval_noise.numpy())

            for epoch in range(self.epoch, epochs):
                self.epoch = epoch
                calls: Dict[str, list] = {}
                t0, images_done = time.time(), 0
                for i, (m, n_images) in enumerate(self._epoch_calls()):
                    images_done += n_images
                    for k, v in m.items():
                        calls.setdefault(k, []).append(v)
                    if run.log_every_steps and (i + 1) % run.log_every_steps == 0:
                        lm = host_metrics({"d": m["d_loss"].mean(), "g": m["g_loss"].mean()})
                        self.log.info("epoch %d call %d | D %.4f G %.4f", epoch, i + 1,
                                      lm["d"], lm["g"])
                    if self._stop_requested():
                        break
                if self._stop_requested():
                    # Stop before moving the cursor: the epilogue persists
                    # this epoch as the next to run, as after a crash.
                    self.log.info("preemption requested: stopping in epoch %d after %d images",
                                  epoch, images_done)
                    break
                # One device reduction and one host copy per epoch.
                means = host_metrics({k: torch.cat(v).mean() for k, v in calls.items()})
                means["images_per_sec"] = images_done / max(time.time() - t0, 1e-9)
                self.metrics.scalars({f"train/{k}": v for k, v in means.items()}, self.state.step)
                if run.abort_on_nan and not all(math.isfinite(means.get(k, 0.0))
                                                for k in ("d_loss", "g_loss")):
                    self._poisoned = True
                    last = means
                    self.log.error("non-finite losses at epoch %d (d_loss=%s g_loss=%s): "
                                   "aborting; the final save is skipped so that resume restores "
                                   "the last finite checkpoint (step %s)", epoch,
                                   means.get("d_loss"), means.get("g_loss"),
                                   self.ckpts.latest_step())
                    break
                # Collapse: epoch-mean D accuracy >= collapse_acc for
                # collapse_window epochs means D wins everything and G's
                # gradients vanish, as terminal for a GAN as NaN.
                if run.collapse_window > 0 and "d_real_acc" in means:
                    acc = 0.5 * (means["d_real_acc"] + means["d_fake_acc"])
                    collapse_run = collapse_run + 1 if acc >= run.collapse_acc else 0
                    tripped = collapse_run >= run.collapse_window
                    self.metrics.scalar("train/collapse", float(tripped), self.state.step)
                    if tripped and not self.collapsed:
                        self.collapsed = True
                        self.log.error(
                            "GAN collapse detected at epoch %d: mean D accuracy >= %.2f for %d "
                            "consecutive epochs (d_loss=%.4f g_loss=%.4f).  %s", epoch,
                            run.collapse_acc, run.collapse_window, means["d_loss"],
                            means["g_loss"],
                            "Aborting (run.collapse_abort=True); the final state is finite and "
                            "is checkpointed." if run.collapse_abort else
                            "Continuing (run.collapse_abort=True stops collapsed runs).")
                        if run.collapse_abort:
                            last = means
                            self.epoch = epoch + 1  # the epoch is complete
                            break
                if run.sample_grid_every_epochs and (epoch + 1) % run.sample_grid_every_epochs == 0:
                    self._save_grids(epoch)
                if run.fid_every_epochs and (epoch + 1) % run.fid_every_epochs == 0:
                    t_fid = time.time()
                    fid_val = self.evaluate_fid()
                    means["fid"] = fid_val
                    self.metrics.scalar("eval/fid", fid_val, self.state.step)
                    # images_per_sec excludes eval; its wall time is logged apart.
                    self.metrics.scalar("eval/fid_seconds", time.time() - t_fid,
                                        self.state.step)
                    crit = means.get(run.best_metric, fid_val)
                    if crit < self.best_metric:
                        self.best_metric = crit
                        # The keys resume() reads: resume(best=True) keeps the tracking.
                        sd = self.checkpoint_state()  # every rank: the slices are gathered
                        ema = self.state.full_ema_state_dict()
                        if self.is_main:
                            self.ckpts.save_best(self.state.step, sd, run.best_metric, crit,
                                                 {"epoch": epoch + 1, "best_metric": crit})
                            save_best(self.run_dir, ema)
                    if self._early is not None and self._early.step(fid_val):
                        self.log.info("early stopping at epoch %d (FID %.3f)", epoch, fid_val)
                        last = means
                        self.epoch = epoch + 1  # the epoch is complete
                        break
                if run.checkpoint_every_epochs and (epoch + 1) % run.checkpoint_every_epochs == 0:
                    self._save_checkpoint({"epoch": epoch + 1, "best_metric": self.best_metric})
                self.log.info("epoch %d done | %s", epoch,
                              " ".join(f"{k}={v:.4f}" for k, v in sorted(means.items())))
                last = means
                self.epoch = epoch + 1  # a later fit() or resume continues, not repeats
        finally:
            # The persisted 'epoch' is the next epoch to run: after a
            # completed epoch self.epoch already holds it, after a mid-epoch
            # stop it holds the incomplete epoch, which resume re-runs.  A
            # further SIGTERM must not unwind the save the first one asked for.
            with preemption.shield():
                if not self._poisoned and run.abort_on_nan and not self._params_finite():
                    self._poisoned = True
                    self.log.error("non-finite parameters detected at exit")
                if self._poisoned:
                    self.log.error("final checkpoint SKIPPED: the train state is non-finite "
                                   "(last durable step: %s)", self.ckpts.latest_step())
                else:
                    self._save_checkpoint({"epoch": self.epoch, "best_metric": self.best_metric,
                                           "final": True})
                    self.save()
                self.ckpts.wait()
            self.metrics.save_figures(self.dirs.images)
            if not self._poisoned:
                try:  # the last completed epoch's grid (self.epoch is the cursor)
                    self._save_grids(max(0, self.epoch - 1))
                except Exception:  # noqa: BLE001 - must not mask the exit's own error
                    self.log.exception("the final sample grid failed")
            self.log.info("training finished in %.1fs", time.time() - t_start)
        return last

    def save(self) -> None:
        """The run directory ``cli serve`` reads: config.json and the
        generator (the EMA weights when run.ema_decay > 0), written by rank 0
        (every rank calls it: a pipe axis's stages are gathered)."""
        ema = self.state.full_ema_state_dict()
        if self.is_main:
            meta = {"step": self.state.step, "epoch": self.epoch, "seed": self.state.seed}
            save_run(self.run_dir, self.cfg, ema, meta=meta)
