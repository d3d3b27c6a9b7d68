"""Process-wide kernel routing policy, set once from RuntimeConfig.

- ``mode``:         'auto' | 'always' | 'never' — kernel routing
- ``min_seq_len``:  sequence threshold for the flash-attention kernel in 'auto'
- ``min_mlp_rows``: row threshold for the fused LN+MLP kernel in 'auto'
- ``megablock``:    'auto' | 'on' | 'off' — the v2 encoder block as one fused
                    forward (ops/fused_block.py)
- ``bwd_fusion``:   'auto' | 'fused' | 'two_pass' — the flash backward
                    (ops/attention.backward_route)

Where the JAX package asks "on TPU?", the port asks "is the tensor on CUDA?".
The thresholds are the JAX package's, set by measurements on a TPU; they are
kept unmeasured on the GPU until a measurement there replaces them.
"""

from __future__ import annotations

import torch

_POLICY = {"mode": "auto", "min_seq_len": 256, "min_mlp_rows": 2048, "megablock": "auto",
           "bwd_fusion": "auto"}


def set_policy(mode: str | None = None, min_seq_len: int | None = None,
               min_mlp_rows: int | None = None, megablock: str | None = None,
               bwd_fusion: str | None = None) -> None:
    if mode is not None:
        if mode not in ("auto", "always", "never"):
            raise ValueError(f"unknown kernel mode {mode!r}")
        _POLICY["mode"] = mode
    if min_seq_len is not None:
        _POLICY["min_seq_len"] = int(min_seq_len)
    if min_mlp_rows is not None:
        _POLICY["min_mlp_rows"] = int(min_mlp_rows)
    if megablock is not None:
        if megablock not in ("off", "on", "auto"):
            raise ValueError(f"unknown megablock mode {megablock!r}")
        _POLICY["megablock"] = megablock
    if bwd_fusion is not None:
        if bwd_fusion not in ("auto", "fused", "two_pass"):
            raise ValueError(f"unknown bwd_fusion mode {bwd_fusion!r}")
        _POLICY["bwd_fusion"] = bwd_fusion


def get_policy() -> dict:
    return dict(_POLICY)


def megablock_mode() -> str:
    """'on' routes every v2 encoder block through the fused forward, 'auto'
    only inside its gate (ops/fused_block.maybe_megablock), 'off' never.
    ``mode='never'`` is the global kill switch and wins over this knob."""
    if _POLICY["mode"] == "never":
        return "off"
    return _POLICY["megablock"]


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def same_device(generator: torch.Generator, t: torch.Tensor) -> bool:
    """True when ``generator`` draws on ``t``'s device (a generator made for
    device 'cuda' carries no index: it draws on the current device)."""
    g = generator.device
    index = g.index if g.index is not None or g.type != "cuda" else torch.cuda.current_device()
    return g.type == t.device.type and index == t.device.index


def apply_from_runtime(runtime_cfg) -> None:
    """Configure from a RuntimeConfig.  ``runtime.remat`` is carried for the
    preset's parity with the JAX package and not read: the port does not
    rematerialize yet (ROADMAP.md queue 1 item 12)."""
    set_policy(mode=runtime_cfg.use_pallas, megablock=runtime_cfg.megablock,
               bwd_fusion=runtime_cfg.bwd_fusion)
