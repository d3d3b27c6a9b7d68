"""Process-wide kernel routing policy, set once from RuntimeConfig.

- ``mode``:         'auto' | 'always' | 'never' — kernel routing
- ``min_seq_len``:  sequence threshold for the flash-attention kernel in 'auto'
- ``min_mlp_rows``: row threshold for the fused LN+MLP kernel in 'auto'
- ``megablock``:    'auto' | 'on' | 'off' — the v2 encoder block as one fused
                    forward (ops/fused_block.py)

Where the JAX package asks "on TPU?", the port asks "is the tensor on CUDA?".
The thresholds are the JAX package's, set by measurements on a TPU; they are
kept unmeasured on the GPU until a measurement there replaces them.
"""

from __future__ import annotations

import torch

_POLICY = {"mode": "auto", "min_seq_len": 256, "min_mlp_rows": 2048, "megablock": "auto"}


def set_policy(mode: str | None = None, min_seq_len: int | None = None,
               min_mlp_rows: int | None = None, megablock: str | None = None) -> None:
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


def apply_from_runtime(runtime_cfg) -> None:
    """Configure from a RuntimeConfig."""
    set_policy(mode=runtime_cfg.use_pallas, megablock=runtime_cfg.megablock)
