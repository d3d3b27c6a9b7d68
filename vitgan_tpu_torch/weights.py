"""Carrying weights from the JAX package into the port.

The port's modules keep the JAX tree's leaf names and layouts, so a JAX
parameter tree maps onto a ``state_dict`` by joining its path with '.': the
v2 generator tree {mapping, pos, blocks[i].{ln1, ln2, msha.{qkv, qkv_b, out},
fc1, fc2}, ln, to_pixels} becomes the keys of models/vitgan_v2.Generator.
No transposes: dense weights are (in, out) on both sides.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def _flatten(tree: Any, prefix: str, out: Dict[str, Any]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = tree


def from_jax_tree(tree: Any) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree of numpy arrays (nested dicts and lists; a
    {'params': ..., 'state': {}} variables dict is unwrapped) -> state_dict."""
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    flat: Dict[str, Any] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """An ``.npz`` whose keys are the JAX tree paths joined by '/' -> state_dict."""
    with np.load(path) as f:
        return {k.replace("/", "."): torch.from_numpy(f[k].copy()) for k in f.files}


def load_into(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
              assign: bool = False) -> None:
    """Load a state_dict, every leaf required, cast to each parameter's dtype
    and device.  With ``assign`` the cast tensors replace the module's own
    and keep their device: for a module built on the meta device."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    extra = sorted(set(state_dict) - set(own))
    if missing or extra:
        raise KeyError(f"state_dict does not match the module: missing {missing}, "
                       f"unexpected {extra}")
    for k, v in state_dict.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != module's {tuple(own[k].shape)}")
    module.load_state_dict({k: v.to(dtype=own[k].dtype,
                                    device=v.device if assign else own[k].device)
                            for k, v in state_dict.items()}, assign=assign)
