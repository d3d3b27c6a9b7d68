"""Rematerialisation of the v2 encoder blocks in training (the JAX
`_maybe_remat`, vitgan_tpu/models/vitgan_v2.py:61-86), under
``ops/policy.remat_mode``:

- ``full``: the block keeps only its inputs; the backward re-runs it;
- ``dots``: the outputs of products with no batch dimension are kept (the
  dense layers' ``mm``/``addmm``, and the qkv projection, an einsum that
  torch folds into a ``bmm`` of batch 1; not the plain attention's ``bmm``),
  everything else is re-run;
- ``attn``: ``dots`` plus the flash forward's output and LSE
  (``ops/attention.flash_forward_op``), so the backward does not re-run the
  flash kernel (the JAX names ``attn_out``, ``flash_out`` and ``flash_lse``).

A block runs under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``;
under ``dots`` and ``attn`` its ``context_fn`` is a pair of dispatch modes that
keep the named ops' outputs in the forward and hand them back, in order, in
each re-run (torch's own selective checkpoint hands them back once, and R1's
double backward re-runs a block twice).  Products made inside an autograd
Function's forward (grad disabled there: the plain versions on the CPU, the
megablock's pieces) are not kept, as the JAX package keeps no
``pallas_call`` output but the named flash residuals.

The recompute replays the block's randomness: the caller draws the dropout
masks, or the megablock's Philox seed, before the checkpoint and passes them
in (models/vitgan_v2.encoder_apply), so the generator is not read inside it
(``preserve_rng_state`` is off: no ``get_rng_state``, which a CUDA graph
capture refuses).

PyTorch's recompute replays the forward up to the last tensor the backward
needs, where XLA's partial evaluation drops what no backward reads.  The
LN->MLP Function's output is such a value: its backward recomputes from its
inputs, and the dropout after it needs only its mask.  While a block
re-runs (``ops/policy.recomputing``), the Function returns its input in the
output's place instead of launching its kernel, so the kernel runs once a
block, as in the JAX package.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.checkpoint import checkpoint

from vitgan_tpu_torch.ops.policy import RECOMPUTING, remat_mode


def _no_batch_product(func, args) -> bool:
    if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return True
    return func is torch.ops.aten.bmm.default and args[0].shape[0] == 1


def _keeps(mode: str):
    """(func, args) -> whether the block keeps this op's output under ``mode``.
    Products are kept where grad mode is on, so not inside an autograd
    Function's forward; the flash forward under 'attn' everywhere."""
    from vitgan_tpu_torch.ops.attention import FLASH_FORWARD_OP

    flash = FLASH_FORWARD_OP if mode == "attn" else None

    def keeps(func, args) -> bool:
        return func is flash or (torch.is_grad_enabled() and _no_batch_product(func, args))

    return keeps


def _detach(t):
    return t.detach() if isinstance(t, torch.Tensor) else t


class _Keep(TorchDispatchMode):
    """The forward's half: runs every op and keeps the outputs ``keeps`` names."""

    def __init__(self, keeps, kept: dict):
        super().__init__()
        self.keeps, self.kept = keeps, kept

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.keeps(func, args):
            self.kept[func].append(tree_map(_detach, out))
        return out


class _Replay(TorchDispatchMode):
    """The re-run's half: the ops ``keeps`` names return the forward's outputs
    in their order, the others run.  Every re-run replays from the start, so
    that a second backward through the block (R1's and WGAN-GP's double
    backward re-run it once more) finds them too."""

    def __init__(self, keeps, kept: dict):
        super().__init__()
        self.keeps, self.kept = keeps, kept

    def __enter__(self):
        self.taken = defaultdict(int)
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.keeps(func, args):
            return func(*args, **(kwargs or {}))
        i = self.taken[func]
        self.taken[func] += 1
        return tree_map(_detach, self.kept[func][i])


def remat_block(fn, *args):
    """``fn(*args)`` under the policy's remat mode; as it is under 'never'
    and outside grad mode."""
    mode = remat_mode()
    if mode == "never" or not torch.is_grad_enabled():
        return fn(*args)
    calls = [0]

    def run(*a):
        calls[0] += 1
        token = RECOMPUTING.set(calls[0] > 1)
        try:
            return fn(*a)
        finally:
            RECOMPUTING.reset(token)

    kw = {}
    if mode != "full":
        keeps, kept = _keeps(mode), defaultdict(list)
        kw["context_fn"] = lambda: (_Keep(keeps, kept), _Replay(keeps, kept))
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False, **kw)
