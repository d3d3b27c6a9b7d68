"""Graceful preemption: turn SIGTERM into a clean stop-and-checkpoint.

The port's copy of vitgan_tpu/utils/preemption.py (pure stdlib).
Preemptible/spot machines are terminated with SIGTERM and a short grace
window.  Python's default SIGTERM disposition kills the process without
unwinding the stack, so the trainer's crash-safe ``finally`` (final
checkpoint + figures — the rebuild of ref:main-v1.py:39-44 /
ref:src/v2/training.py:248-268) never runs and up to
``checkpoint_every_epochs`` of work is lost.

``graceful_preemption()`` installs a handler that merely sets a flag; the
trainer polls :func:`requested` at step-group boundaries (cheap — no device
sync) and breaks out of ``fit``, which drives the normal epilogue: durable
final checkpoint with ``epoch`` = the interrupted epoch, so ``resume()``
re-runs it — exactly the established mid-epoch-crash convention
(train/trainer.py fit epilogue).

A second SIGTERM escalates to ``KeyboardInterrupt`` so a stuck step (e.g. a
kernel build) can still be abandoned through the same ``finally``.

The handler is process-global state, installed only inside the context
manager (the CLI wraps ``fit`` in it); library callers who embed the Trainer
keep their own signal handling — :func:`requested` is ``False`` unless the
context is active.  Signal installation is main-thread-only in CPython; in
other threads the context degrades to a no-op rather than raising.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator

_requested = threading.Event()
_installed = False
_shielded = False


def requested() -> bool:
    """True once a SIGTERM has been seen inside a graceful_preemption() scope."""
    return _requested.is_set()


def _handler(signum, frame):
    if _shielded:
        # Inside shield() (the checkpoint epilogue): record the request but
        # never unwind — an escalation here would destroy the very save the
        # first SIGTERM triggered.
        _requested.set()
        return
    if _requested.is_set():
        # Second signal: the poll point was never reached (stuck build /
        # device hang) — unwind NOW through the trainer's finally.
        raise KeyboardInterrupt("second SIGTERM: forcing unwind")
    _requested.set()


@contextlib.contextmanager
def shield() -> Iterator[None]:
    """Scope where SIGTERM can never raise — wrap must-complete cleanup
    (the final durable checkpoint).  Requests are still recorded."""
    global _shielded
    prev = _shielded
    _shielded = True
    try:
        yield
    finally:
        _shielded = prev


@contextlib.contextmanager
def graceful_preemption() -> Iterator[None]:
    """Scope in which SIGTERM requests a stop instead of killing the process."""
    global _installed
    if _installed:
        # Nested scope (e.g. sweep wrapping trainer fits): the outer scope
        # owns the handler AND the flag — clearing it here would drop a
        # pending outer request on inner exit.
        yield
        return
    _requested.clear()
    try:
        prev = signal.signal(signal.SIGTERM, _handler)
    except ValueError:  # not the main thread — signals unavailable, degrade
        yield
        return
    _installed = True
    try:
        yield
    finally:
        _installed = False
        _requested.clear()
        signal.signal(signal.SIGTERM, prev)
