"""Weight-only int8 quantization for serving.

Counterpart of vitgan_tpu/utils/quantize.py, with its arithmetic: each
floating leaf of rank >= 2 and at least ``min_elems`` elements becomes int8
``q`` with one f32 scale per slice of its last axis (symmetric, +-127, never
-128, so negation is exact; an all-zero channel gets scale 1), computed in
numpy on the host, so that the values and scales are bit-equal to the JAX
package's on the same f32 tree.  Biases, LayerNorm and BatchNorm vectors,
small and integer leaves pass through.

A tree is a ``state_dict`` (name -> tensor) or nested dicts and lists, as
the JAX trees are.  ``serve.SamplerService(quantize="int8")`` keeps the int8
leaves and their scales on the card and dequantizes them into the
generator's compute dtype inside each device call, as the JAX sampler does
at trace time (vitgan_tpu/serve.py:123-134); the generator then runs its
usual serving kernels.  Those kernels read bf16 weights, so the int8 copy
saves the bytes stored on the card and uploaded to it (4x under f32), not
the bytes a kernel reads: the dequantized bf16 weights are formed on the
card for each call.  The JAX package's XLA fuses the dequantizing multiply
into each consumer instead; the port's kernels take no int8 operand.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

# int8 symmetric range: +-127 (never -128, so negation is exact).
_QMAX = 127.0


class QuantLeaf:
    """One quantized leaf: ``w ~= q * scale``; ``q`` int8 of the leaf's shape,
    ``scale`` f32 (1, ..., 1, C); ``dtype`` the source leaf's dtype name."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor, dtype: str):
        self.q, self.scale, self.dtype = q, scale, dtype

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """q * scale in f32, cast to ``dtype`` (default: the source's)."""
        # int8 * f32 promotes to f32 in one product: q converted exactly, as
        # the JAX q.astype(f32) * scale
        return (self.q * self.scale).to(dtype or getattr(torch, self.dtype))

    def to(self, device) -> "QuantLeaf":
        return QuantLeaf(self.q.to(device), self.scale.to(device), self.dtype)

    def __repr__(self):
        return f"QuantLeaf(shape={tuple(self.q.shape)}, dtype={self.dtype})"


def _is_quant(x) -> bool:
    return isinstance(x, QuantLeaf)


def _numpy_f32(w) -> Tuple[np.ndarray, str]:
    if isinstance(w, torch.Tensor):
        return w.detach().cpu().float().numpy(), str(w.dtype).replace("torch.", "")
    arr = np.asarray(w)
    return arr.astype(np.float32), str(arr.dtype)


def quantize_leaf(w) -> QuantLeaf:
    """Per-output-channel symmetric int8 of one array (a tensor or numpy),
    the last axis the channel axis (kernels are (..., in, out)); each
    channel's scale is its max |w| over the other axes / 127, so the error is
    at most amax_c / 254 (quantize.py:81-101)."""
    wf, dtype = _numpy_f32(w)
    axes = tuple(range(wf.ndim - 1))
    amax = np.max(np.abs(wf), axis=axes, keepdims=True)
    scale = np.where(amax > 0, amax / _QMAX, 1.0).astype(np.float32)
    q = np.clip(np.round(wf / scale), -_QMAX, _QMAX).astype(np.int8)
    return QuantLeaf(torch.from_numpy(q), torch.from_numpy(scale), dtype)


def _floating(w) -> bool:
    if isinstance(w, torch.Tensor):
        return w.is_floating_point()
    return np.issubdtype(np.asarray(w).dtype, np.floating)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def quantize_tree(params: Any, min_elems: int = 1024) -> Any:
    """The tree with int8 ``QuantLeaf``s where it pays: floating leaves of
    rank >= 2 with at least ``min_elems`` elements (quantize.py:104-122).
    Idempotent; other leaves are passed through as they are."""

    def one(w):
        if _is_quant(w) or not hasattr(w, "ndim"):
            return w
        size = w.numel() if isinstance(w, torch.Tensor) else np.asarray(w).size
        if w.ndim >= 2 and size >= min_elems and _floating(w):
            return quantize_leaf(w)
        return w

    return _map(one, params)


def dequantize_tree(params: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """Inverse of :func:`quantize_tree`: each QuantLeaf dequantized (into
    ``dtype``, default its source's); identity on other leaves."""
    return _map(lambda x: x.dequantize(dtype) if _is_quant(x) else x, params)


def tree_to(params: Any, device) -> Any:
    """Every leaf (QuantLeafs too) on ``device``."""
    return _map(lambda x: x.to(device) if hasattr(x, "to") else x, params)


def quantized_bytes(params: Any) -> Tuple[int, int]:
    """(bytes as stored, bytes if every leaf were f32) (quantize.py:136-149)."""
    stored = dense = 0
    for leaf in _leaves(params):
        if _is_quant(leaf):
            stored += leaf.q.numel() + leaf.scale.numel() * 4
            dense += leaf.q.numel() * 4
        elif isinstance(leaf, torch.Tensor):
            stored += leaf.numel() * leaf.element_size()
            dense += leaf.numel() * 4
        else:
            arr = np.asarray(leaf)
            stored += arr.size * arr.dtype.itemsize
            dense += arr.size * 4
    return stored, dense


def maybe_quantize(params: Any, mode: Optional[str], min_elems: int = 1024) -> Any:
    """CLI entry: ``mode`` None/'none' -> unchanged, 'int8' -> quantized."""
    if mode in (None, "none", ""):
        return params
    if mode != "int8":
        raise ValueError(f"unknown quantization mode {mode!r} (have: int8)")
    return quantize_tree(params, min_elems=min_elems)
