"""Host data pipeline: batches assembled on the host, handed to the device
one ahead of the step.

Counterpart of vitgan_tpu/data/pipeline.py (the reference's DataLoader role,
ref:src/v1/utils.py:107-112):

- the whole uint8 dataset lives in host RAM; a batch is gathered, normalised
  to [-1, 1] and, with ``augment_flip``, flipped per sample by the C++ loader
  (data/native.py) or, where it does not build, by numpy, bit-equal;
  ``assembler`` names the one taken;
- each epoch's order is a permutation from a seeded numpy generator, and the
  flip bits come from the same generator, batch by batch in order, as in the
  JAX package; ``drop_last=False`` keeps the partial last batch;
- with ``process_count`` > 1 every process draws the same order and takes
  its contiguous share of each full global batch;
- a producer thread assembles the batches ``prefetch`` ahead.  On CUDA it
  writes each into a pinned host buffer (a ring of them, each reused once
  its copy has finished) and copies it to the device on a side stream; the
  consumer's stream waits on the copy's event (the role of
  ``jax.device_put``).  On the CPU the batches are CPU tensors.  A failed
  producer fails the epoch.

``epoch(max_batches)`` stops the producer after that many batches, so an
epoch cut short draws exactly the flip bits of the batches it yields (the
JAX producer may run ahead of a consumer that stops early).  ``stats``
holds the last epoch's host time per batch and the batches the consumer
waited for.
"""

from __future__ import annotations

import logging
import queue
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from vitgan_tpu_torch.data.datasets import load_dataset
from vitgan_tpu_torch.utils.images import denormalize  # noqa: F401 (the JAX module has it)

log = logging.getLogger(__name__)


def normalize_to_unit(batch_u8: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] -> float32 [-1, 1] (Normalize(0.5, 0.5),
    ref:src/v1/utils.py:128-131)."""
    return batch_u8.astype(np.float32) * (2.0 / 255.0) - 1.0


@dataclass
class EpochStats:
    """One epoch of the pipeline: ``batches`` handed over, ``assemble_s`` the
    producer's host seconds gathering, normalising and flipping them,
    ``issue_s`` its host seconds issuing the copies, ``waits`` the batches
    the consumer asked for before they were ready and ``wait_s`` its seconds
    blocked on them."""

    batches: int = 0
    assemble_s: float = 0.0
    issue_s: float = 0.0
    waits: int = 0
    wait_s: float = 0.0


class _Slot:
    """One pinned host buffer of a batch and its labels, and the event of
    the last copy that read it."""

    def __init__(self, shape: tuple):
        self.x = torch.empty(shape, dtype=torch.float32).pin_memory()
        self.y = torch.empty(shape[:1], dtype=torch.int32).pin_memory()
        self.done: Optional[torch.cuda.Event] = None


class HostDataPipeline:
    """Epoch-based batch iterator with device prefetch."""

    def __init__(self, images_u8: np.ndarray, labels: np.ndarray, batch_size: int,
                 shuffle: bool = True, drop_last: bool = True, augment_flip: bool = False,
                 seed: int = 0, prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1, device="cuda"):
        if images_u8.ndim != 4 or images_u8.dtype != np.uint8:
            raise ValueError("expect (N, H, W, C) uint8 images")
        if process_count > 1 and batch_size % process_count:
            raise ValueError(f"global batch {batch_size} not divisible by process count "
                             f"{process_count}")
        self.images, self.labels = images_u8, np.asarray(labels, np.int32)
        self.batch_size, self.shuffle, self.drop_last = batch_size, shuffle, drop_last
        self.augment_flip = augment_flip
        self.prefetch = max(1, prefetch)
        self.process_index, self.process_count = process_index, process_count
        self.device = torch.device(device)
        self._rng = np.random.default_rng(seed)
        from vitgan_tpu_torch.data.native import NativeBatcher

        try:
            self._native = NativeBatcher()
            self.assembler = "native"
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            log.warning("the C++ batch assembler is unavailable (%s: %s); assembling batches "
                        "with numpy (bit-equal)", type(e).__name__, e)
            self._native, self.assembler = None, "numpy"
        self.stats = EpochStats()
        self._stream: Optional[torch.cuda.Stream] = None
        self._slots: List[_Slot] = []

    def __len__(self) -> int:
        n = len(self.images) // self.batch_size
        if self.process_count == 1 and not self.drop_last and len(self.images) % self.batch_size:
            n += 1  # several processes always drop the partial batch (epoch())
        return n

    @property
    def num_samples(self) -> int:
        return len(self.images)

    def _epoch_order(self) -> np.ndarray:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def _slices(self, order: np.ndarray) -> list:
        """The epoch's batches of indices (this process's share of each)."""
        b = self.batch_size
        n_full = len(order) // b
        slices = [order[i * b:(i + 1) * b] for i in range(n_full)]
        if not self.drop_last and len(order) % b:
            slices.append(order[n_full * b:])
        if self.process_count > 1:
            # Each process takes an equal share of a FULL global batch, so
            # the partial batch is dropped whatever drop_last says; __len__
            # counts the same batches.
            local = b // self.process_count
            lo = self.process_index * local
            slices = [sl[lo:lo + local] for sl in slices if len(sl) == b]
        return slices

    def assemble(self, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
        """The float32 batch of ``idx``, its flip bits drawn from the order's
        generator when ``augment_flip``; written into ``out`` when given."""
        flip = (self._rng.integers(0, 2, size=len(idx)).astype(np.uint8)
                if self.augment_flip else None)
        if self._native is not None:
            return self._native.gather_normalize(self.images, idx, flip, out)
        x = normalize_to_unit(self.images[idx])
        if flip is not None:
            f = flip.astype(bool)
            x[f] = x[f, :, ::-1, :]
        if out is None:
            return x
        out[...] = x
        return out

    def _hand_off(self, i: int, idx: np.ndarray, stats: EpochStats) -> tuple:
        """Batch i of the epoch on the pipeline's device: (x, y, the copy's
        event or None)."""
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            x = torch.from_numpy(self.assemble(idx))
            y = torch.from_numpy(self.labels[idx])
            stats.assemble_s += time.perf_counter() - t0
            return x, y, None
        slot = self._slots[i % len(self._slots)]
        if slot.done is not None:
            slot.done.synchronize()  # its last copy has read it
        b = len(idx)
        x_host, y_host = slot.x[:b], slot.y[:b]
        self.assemble(idx, x_host.numpy())
        y_host.numpy()[:] = self.labels[idx]
        t1 = time.perf_counter()
        stats.assemble_s += t1 - t0
        with torch.cuda.stream(self._stream):
            x = x_host.to(self.device, non_blocking=True)
            y = y_host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        slot.done = done
        stats.issue_s += time.perf_counter() - t1
        return x, y, done

    def _receive(self, item: tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        x, y, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(done)
            x.record_stream(stream)  # the allocator keeps them until this stream is done
            y.record_stream(stream)
        return x, y

    def _start_cuda(self) -> None:
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            _, h, w, c = self.images.shape
            local = self.batch_size // self.process_count
            self._slots = [_Slot((local, h, w, c)) for _ in range(self.prefetch + 2)]

    def epoch(self, max_batches: Optional[int] = None
              ) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
        """One pass over the data: (images (B, H, W, C) float32 in [-1, 1],
        labels (B,) int32) on the pipeline's device, the first
        ``max_batches`` batches when given."""
        order = self._epoch_order()
        slices = self._slices(order)
        if max_batches is not None:
            slices = slices[:max_batches]
        if self.device.type == "cuda":
            self._start_cuda()
        stats = self.stats = EpochStats()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure: list = []

        def producer():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                for i, sl in enumerate(slices):
                    if stop.is_set():
                        return
                    q.put(self._hand_off(i, sl, stats))
            except BaseException as e:  # raised in the consumer, not printed
                failure.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                waited = q.empty()
                t0 = time.perf_counter()
                item = q.get()
                if item is None:
                    break
                if waited:
                    stats.waits += 1
                    stats.wait_s += time.perf_counter() - t0
                stats.batches += 1
                yield self._receive(item)
            if failure:
                # A dead producer fails the epoch: the other way out trains on
                # a truncated one.
                raise RuntimeError("data pipeline producer failed") from failure[0]
        finally:
            stop.set()
            while t.is_alive():  # drain, so that the producer never blocks on put()
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
            t.join()


def make_pipeline(cfg, batch_size: int, image_size: int = 32, channels: int = 3,
                  train: bool = True, seed: int = 0, synthetic_samples: int = 2048,
                  device="cuda") -> HostDataPipeline:
    """The pipeline of a DataConfig (the reference's get_dataloader role,
    ref:src/v1/utils.py:107)."""
    images, labels = load_dataset(cfg.dataset, root=cfg.data_dir, train=train,
                                  image_size=image_size, channels=channels,
                                  synthetic_samples=synthetic_samples, seed=seed)
    return HostDataPipeline(images, labels, batch_size, shuffle=cfg.shuffle,
                            drop_last=cfg.drop_last, augment_flip=cfg.augment_flip, seed=seed,
                            prefetch=cfg.prefetch, device=device)
