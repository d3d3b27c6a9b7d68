"""Batched sampling server: serve a generator over HTTP.

Counterpart of vitgan_tpu/serve.py, with the same endpoints and scheduling:

- ``GET  /healthz``  -> JSON model/run info + service counters
- ``GET  /metrics``  -> OpenMetrics text (requests/images/device calls/sample
  seconds, per-priority requests and waits)
- ``POST /sample``   -> body {"n": int, "seed": int?, "model": str?,
  "format": "png"|"npy", "priority": "interactive"|"batch"|int}; returns an
  image grid (image/png) or [-1, 1] float32 samples (.npy bytes) whose values
  are 8-bit grid points: the device hands back uint8.

Every request is served by slicing fixed-batch generator calls.  Seeded
requests are reproducible; unseeded requests coalesce into shared batches.
Device access goes through a priority gate ("interactive" 0 beats "batch"
10, FIFO within a class), re-entered between device calls, so a queued
interactive request pre-empts a long batch request at batch granularity.

Start:  python -m vitgan_tpu_torch.cli serve --run-dir <run> --port 8000
"""

from __future__ import annotations

import heapq
import io
import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union

import numpy as np

PRIORITY_CLASSES = {"interactive": 0, "batch": 10}


def parse_priority(value: Union[str, int, None]) -> int:
    """'interactive' | 'batch' | int -> numeric priority (lower wins)."""
    if value is None:
        return PRIORITY_CLASSES["interactive"]
    if isinstance(value, str):
        if value in PRIORITY_CLASSES:
            return PRIORITY_CLASSES[value]
        raise ValueError(f"unknown priority {value!r} "
                         f"(have: {sorted(PRIORITY_CLASSES)} or an int)")
    return int(value)


class PriorityGate:
    """A lock whose waiters acquire in (priority, arrival) order."""

    def __init__(self):
        self._cond = threading.Condition()
        self._held = False
        self._waiting: list = []
        self._seq = 0

    def acquire(self, priority: int = 0) -> float:
        """Block until first in line; returns seconds spent waiting."""
        t0 = time.perf_counter()
        with self._cond:
            ticket = (priority, self._seq)
            self._seq += 1
            heapq.heappush(self._waiting, ticket)
            while self._held or self._waiting[0] != ticket:
                self._cond.wait()
            heapq.heappop(self._waiting)
            self._held = True
        return time.perf_counter() - t0

    def release(self) -> None:
        with self._cond:
            self._held = False
            self._cond.notify_all()


def _dequant(u8: np.ndarray) -> np.ndarray:
    """uint8 wire format -> [-1, 1] float32."""
    return u8.astype(np.float32) / 127.5 - 1.0


class SamplerService:
    """Thread-safe batched sampler around a generator module.

    ``sample(n, seed)`` derives batch ``call`` of a seeded request from
    (seed, call) alone (train/sample.py), one fixed-shape generator call per
    ``batch`` images.  Unseeded requests draw slices from a shared pool that
    is refilled one batch at a time, so 16 concurrent n=4 requests at batch 64
    cost one generator call."""

    def __init__(self, cfg, gan, generator, batch: int = 64):
        from vitgan_tpu_torch.train.sample import make_serve_sample_fn

        self.cfg = cfg
        self.gan = gan
        self.generator = generator
        self.batch = batch
        self.device = str(next(generator.parameters()).device)
        self.weight_bytes = sum(p.numel() * p.element_size() for p in generator.parameters())
        self._sample = make_serve_sample_fn(gan, cfg, batch)
        self._gate = PriorityGate()
        self._stats_lock = threading.Lock()
        self._counter = 0
        self._device_calls = 0
        self._images_served = 0
        self._sample_seconds = 0.0
        self._by_class = {name: {"requests": 0, "wait_seconds": 0.0}
                          for name in PRIORITY_CLASSES}
        self._pool = np.zeros((0,), np.uint8)  # leftover unseeded samples (uint8)
        # Negative: client seeds are validated to [0, 2**31), so the pool's
        # stream never meets a seeded request's.
        self._pool_seed = -0x5E11
        self._pool_calls = 0
        # Warm-up: builds the kernels (first use) before the first request.
        self._sample(self.generator, 0, 0)

    def info(self) -> dict:
        m = self.cfg.model
        return {
            "family": self.cfg.family,
            "image_size": m.image_size,
            "channels": m.channels,
            "batch": self.batch,
            "weight_bytes": self.weight_bytes,
            "device": self.device,
            "requests_served": self._counter,
            "images_served": self._images_served,
            "device_calls": self._device_calls,
        }

    def metrics_text(self, label: str = "") -> str:
        """OpenMetrics/Prometheus exposition of the service counters."""
        tag = f'{{model="{label}"}}' if label else ""
        lines = [
            "# TYPE vitgan_requests_served counter",
            f"vitgan_requests_served{tag} {self._counter}",
            "# TYPE vitgan_images_served counter",
            f"vitgan_images_served{tag} {self._images_served}",
            "# TYPE vitgan_device_calls counter",
            f"vitgan_device_calls{tag} {self._device_calls}",
            "# TYPE vitgan_sample_seconds counter",
            f"vitgan_sample_seconds{tag} {self._sample_seconds:.6f}",
        ]
        for cls, st in self._by_class.items():
            ptag = (tag[:-1] + f',priority="{cls}"}}') if tag else f'{{priority="{cls}"}}'
            lines += [
                "# TYPE vitgan_priority_requests counter",
                f"vitgan_priority_requests{ptag} {st['requests']}",
                "# TYPE vitgan_priority_wait_seconds counter",
                f"vitgan_priority_wait_seconds{ptag} {st['wait_seconds']:.6f}",
            ]
        return "\n".join(lines) + "\n"

    def _note_request(self, priority: int, waited: float, images: int) -> None:
        cls = "interactive" if priority <= PRIORITY_CLASSES["interactive"] else "batch"
        with self._stats_lock:
            self._counter += 1
            self._images_served += images
            self._by_class[cls]["requests"] += 1
            self._by_class[cls]["wait_seconds"] += waited

    def _generate(self, seed: int, call: int) -> np.ndarray:
        """One fixed-shape generator call, held under the gate: uint8 out."""
        t0 = time.perf_counter()
        u8 = self._sample(self.generator, seed, call)
        self._sample_seconds += time.perf_counter() - t0
        self._device_calls += 1
        return u8

    def sample(self, n: int, seed: Optional[int] = None,
               priority: Union[str, int, None] = None) -> np.ndarray:
        """n images in [-1, 1] float32 (8-bit grid points); seeded =>
        reproducible, unseeded => coalesced."""
        return _dequant(self.sample_quantized(n, seed, priority))

    def sample_quantized(self, n: int, seed: Optional[int] = None,
                         priority: Union[str, int, None] = None) -> np.ndarray:
        """n images as raw uint8.  The gate is re-entered between device calls,
        so a multi-batch request yields to a higher priority at batch
        granularity; batch ``call`` of seed s is the same whatever the
        interleaving."""
        if n < 1:
            raise ValueError("n must be >= 1")
        if seed is not None:
            seed = int(seed)
            if not 0 <= seed < 2 ** 31:
                raise ValueError("seed must be in [0, 2**31) — out-of-range "
                                 "seeds would silently alias another stream")
        prio = parse_priority(priority)
        waited = 0.0
        out = []
        if seed is not None:
            done, call = 0, 0
            while done < n:
                waited += self._gate.acquire(prio)
                try:
                    u8 = self._generate(seed, call)
                finally:
                    self._gate.release()
                take = min(self.batch, n - done)
                out.append(u8[:take])
                done += take
                call += 1
        else:
            need = n
            while need > 0:
                waited += self._gate.acquire(prio)
                try:
                    if self._pool.shape[0] == 0:
                        self._pool = self._generate(self._pool_seed, self._pool_calls)
                        self._pool_calls += 1
                    take = min(need, self._pool.shape[0])
                    out.append(self._pool[:take])
                    self._pool = self._pool[take:]
                    need -= take
                finally:
                    self._gate.release()
        self._note_request(prio, waited, n)
        return np.concatenate(out, 0)


def load_service(run_dir: str, batch: int = 64, best: bool = False,
                 device="cuda") -> SamplerService:
    """Restore a run directory into a SamplerService."""
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    cfg, gan, g, _meta = restore_run(run_dir, best=best, device=device)
    return SamplerService(cfg, gan, g, batch=batch)


def _make_handler(services):
    """``services``: a SamplerService or an ordered {name: service} registry —
    POST /sample selects with {"model": name} (default: the first)."""
    if isinstance(services, SamplerService):
        services = {"default": services}
    default_name = next(iter(services))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, obj) -> None:
            self._reply(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/healthz":
                if len(services) == 1:
                    self._json(200, services[default_name].info())
                else:
                    self._json(200, {name: s.info() for name, s in services.items()})
            elif self.path == "/metrics":
                label = len(services) > 1
                text = "".join(s.metrics_text(name if label else "")
                               for name, s in services.items())
                self._reply(200, text.encode(), "text/plain; version=0.0.4")
            else:
                self._json(404, {"error": "unknown path (try /healthz, /metrics, "
                                          "POST /sample)"})

        def do_POST(self):
            if self.path != "/sample":
                self._json(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                n = int(req.get("n", 16))
                if not 1 <= n <= 4096:
                    raise ValueError("n must be in [1, 4096]")
                name = req.get("model", default_name)
                if name not in services:
                    raise ValueError(f"unknown model {name!r} (have: {sorted(services)})")
                fmt = req.get("format", "png")
                if fmt not in ("png", "npy"):
                    raise ValueError(f"unknown format {fmt!r}")
                u8 = services[name].sample_quantized(n, req.get("seed"), req.get("priority"))
            except (ValueError, TypeError) as e:  # bad request: report, keep serving
                self._json(400, {"error": str(e)})
                return
            if fmt == "npy":
                buf = io.BytesIO()
                np.save(buf, _dequant(u8))
                self._reply(200, buf.getvalue(), "application/octet-stream")
            else:
                from vitgan_tpu_torch.utils.images import make_grid, to_png_bytes

                self._reply(200, to_png_bytes(make_grid(u8)), "image/png")

    return Handler


def serve(run_dirs, host: str = "127.0.0.1", port: int = 8000, batch: int = 64,
          best: bool = False, device="cuda") -> ThreadingHTTPServer:
    """Build the service(s) and return a ready, unstarted HTTP server; call
    ``serve_forever()`` on it.  Several run directories form a registry keyed
    by basename (POST {"model": name})."""
    if isinstance(run_dirs, str):
        run_dirs = [run_dirs]
    names = [os.path.basename(os.path.normpath(d)) for d in run_dirs]
    if len(set(names)) != len(names):
        dups = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate model names in --run-dir: {dups} "
                         "(registry keys are run-dir basenames)")
    services = {name: load_service(d, batch=batch, best=best, device=device)
                for name, d in zip(names, run_dirs)}
    httpd = ThreadingHTTPServer((host, port), _make_handler(services))
    # Non-daemon handler threads + block_on_close: server_close() lets the
    # in-flight responses finish.
    httpd.daemon_threads = False
    httpd.block_on_close = True
    httpd.service = next(iter(services.values()))  # the first model, for callers and tests
    return httpd
