"""Process-wide kernel routing policy, set once from RuntimeConfig.

- ``mode``:            'auto' | 'always' | 'never' — kernel routing
- ``min_seq_len``:     sequence threshold for the flash-attention kernel in 'auto'
- ``min_mlp_rows``:    row threshold for the fused LN+MLP kernel in 'auto'
- ``megablock``:       'auto' | 'on' | 'off' — the v2 encoder block as one fused
                       forward (ops/fused_block.py)
- ``megablock_bwd``:   'saved' | 'recompute' — the megablock's training backward
- ``bwd_fusion``:     'auto' | 'fused' | 'two_pass' — the flash backward
                       (ops/attention.backward_route)
- ``remat``:          'never' | 'full' | 'dots' | 'attn' — rematerialise the v2
                       encoder blocks in training (models/remat.py)

Sequence parallelism (``set_sequence_parallel``) is process-global like the
rest, and routes every block off the kernels, as the JAX package's does.

Where the JAX package asks "on TPU?", the port asks "is the tensor on CUDA?".
The thresholds are the JAX package's, set by measurements on a TPU; they are
kept unmeasured on the GPU until a measurement there replaces them.
"""

from __future__ import annotations

import contextvars

import torch

_POLICY = {"mode": "auto", "min_seq_len": 256, "min_mlp_rows": 2048, "megablock": "auto",
           "bwd_fusion": "auto", "megablock_bwd": "saved", "remat": "never"}

REMAT_MODES = ("never", "full", "dots", "attn")


def set_policy(mode: str | None = None, min_seq_len: int | None = None,
               min_mlp_rows: int | None = None, megablock: str | None = None,
               bwd_fusion: str | None = None, megablock_bwd: str | None = None,
               remat=None) -> None:
    if remat is not None:
        if isinstance(remat, bool):  # the config's back-compat: True is 'full'
            remat = "full" if remat else "never"
        if remat not in REMAT_MODES:
            raise ValueError(f"unknown remat mode {remat!r} ({' | '.join(REMAT_MODES)})")
        _POLICY["remat"] = remat
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
    if megablock_bwd is not None:
        if megablock_bwd not in ("saved", "recompute"):
            raise ValueError(f"unknown megablock_bwd mode {megablock_bwd!r}")
        _POLICY["megablock_bwd"] = megablock_bwd


def get_policy() -> dict:
    return dict(_POLICY)


def megablock_mode() -> str:
    """'on' routes every v2 encoder block through the fused forward, 'auto'
    only inside its gate (ops/fused_block.maybe_megablock), 'off' never.
    ``mode='never'`` is the global kill switch and wins over this knob, as
    does sequence parallelism (policy.py:54-64)."""
    if _POLICY["mode"] == "never" or sequence_parallel_active():
        return "off"
    return _POLICY["megablock"]


# --- sequence (context) parallelism (policy.py:67-113) ------------------------------
# Set by the trainer when mesh.context_parallel > 1: the v2 encoder stacks run
# each seq rank's tokens (models/vitgan_v2.run_blocks).

_SP = {"mesh": None, "data_axis": None, "seq_axis": None}


def set_sequence_parallel(mesh=None, data_axis: str | None = None,
                          seq_axis: str | None = None) -> None:
    """Shard the token axis of every v2 encoder activation over ``mesh``'s
    ``seq_axis`` (a parallel/mesh.Mesh; the batch stays on ``data_axis``).
    ``set_sequence_parallel(None)`` clears it.  While it is set, no block
    takes a kernel: the JAX package routes every ``pallas_call`` off under
    sequence parallelism (GSPMD cannot partition one), and the port keeps
    that decision; attention then takes a plain version on its local queries
    and the gathered keys."""
    if mesh is None:
        _SP["mesh"] = _SP["data_axis"] = _SP["seq_axis"] = None
        return
    if seq_axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {seq_axis!r} (axes: {mesh.axis_names})")
    _SP["mesh"], _SP["data_axis"], _SP["seq_axis"] = mesh, data_axis, seq_axis


def sequence_parallel_active() -> bool:
    return _SP["mesh"] is not None


def sequence_parallel_mesh():
    """The mesh whose seq group shards the tokens, or None."""
    return _SP["mesh"]


def sequence_constraint(x):
    """This seq rank's tokens of a (B, N, E) activation (the JAX
    `sequence_constraint` pins the token axis over the seq mesh axis;
    policy.py:99-113).  Identity when SP is off or ``x`` is not rank-3.
    Uneven token counts (the v2 discriminator's N + 1) give the last rank
    fewer, as GSPMD's padded last shard holds them.  Differentiable: the
    backward gathers every rank's cotangent, so that the code before the
    stack, which each rank runs on the whole sequence, takes the same
    gradient everywhere."""
    mesh = _SP["mesh"]
    if mesh is None or getattr(x, "ndim", 0) != 3:
        return x
    from vitgan_tpu_torch.parallel.context_parallel import enter_sequence

    return enter_sequence(x, mesh)


def megablock_bwd_mode() -> str:
    """'saved': the forward keeps x1/z1/ao/LSE and the backward kernels never
    re-run a forward product but the qkv projection; 'recompute': autograd
    of the plain block (the JAX package's `megablock_bwd_mode`)."""
    return _POLICY["megablock_bwd"]


def remat_mode() -> str:
    """'never' | 'full' | 'dots' | 'attn' (the JAX `remat_mode`, policy.py:163-175):

    - full: a training block keeps only its input; the backward re-runs it;
    - dots: the outputs of products with no batch dimension (the dense
      layers' and the qkv projection's) are kept, the rest re-run;
    - attn: 'dots' plus the flash forward's output and LSE, so that the
      backward does not re-run the flash kernel."""
    return _POLICY["remat"]


# Set while a checkpointed block re-runs its forward for the backward (models/remat.py).
RECOMPUTING = contextvars.ContextVar("vitgan_tpu_torch_recomputing", default=False)


def recomputing() -> bool:
    return RECOMPUTING.get()


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def same_device(generator: torch.Generator, t: torch.Tensor) -> bool:
    """True when ``generator`` draws on ``t``'s device (a generator made for
    device 'cuda' carries no index: it draws on the current device)."""
    g = generator.device
    index = g.index if g.index is not None or g.type != "cuda" else torch.cuda.current_device()
    return g.type == t.device.type and index == t.device.index


def apply_from_runtime(runtime_cfg) -> None:
    """Configure from a RuntimeConfig.  ``runtime.megablock_group`` is carried
    for the preset's parity with the JAX package and not read: it is a TPU
    VMEM knob."""
    set_policy(mode=runtime_cfg.use_pallas, megablock=runtime_cfg.megablock,
               bwd_fusion=runtime_cfg.bwd_fusion, megablock_bwd=runtime_cfg.megablock_bwd,
               remat=runtime_cfg.remat)
