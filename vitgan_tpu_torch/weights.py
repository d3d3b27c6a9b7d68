"""Carrying weights from the JAX package into the port.

The port's modules keep the JAX tree's leaf names and layouts, so a JAX
parameter tree maps onto a ``state_dict`` by joining its path with '.': the
v2 generator tree {mapping, pos, blocks[i].{ln1, ln2, msha.{qkv, qkv_b, out},
fc1, fc2}, ln, to_pixels} becomes the keys of models/vitgan_v2.Generator, and
the discriminator tree {embed, pos, cls, blocks[i], ln, head_fc1, head_fc2}
those of models/vitgan_v2.Discriminator.  A v1 variables dict
{'params': ..., 'state': ...} maps whole: the discriminator's state leaves
blocks[i].msha.isr.{sigma0, u} become the buffers of the same names in
models/vitgan_v1.Discriminator.
No transposes: dense weights are (in, out) on both sides.  The FID
extractors' convolutions are the exception: the JAX trees hold HWIO kernels,
the port's modules OIHW, so ``random_conv_from_jax`` and
``inception_from_jax`` transpose them once.
"""

from __future__ import annotations

from typing import Any, Dict, List

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
    """A JAX parameter tree of numpy arrays (nested dicts and lists), or a
    {'params': ..., 'state': ...} variables dict, whose parameter and state
    leaves share one namespace -> state_dict (parameters and buffers)."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict) and "params" in tree:
        _flatten(tree["params"], "", flat)
        state: Dict[str, Any] = {}
        _flatten(tree.get("state", {}), "", state)
        clash = sorted(set(flat) & set(state))
        if clash:
            raise ValueError(f"state leaves {clash} clash with parameters")
        flat.update(state)
    else:
        _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def load_npz(path: str) -> Dict[str, torch.Tensor]:
    """An ``.npz`` whose keys are the JAX tree paths joined by '/' -> state_dict."""
    with np.load(path) as f:
        return {k.replace("/", "."): torch.from_numpy(f[k].copy()) for k in f.files}


def load_into(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor],
              assign: bool = False) -> None:
    """Load a state_dict, every leaf required (parameters and buffers alike),
    each checked for shape and cast to the module's dtype and device.  With
    ``assign`` the cast tensors replace the module's own and keep their
    device: for a module built on the meta device."""
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


def _oihw(w_hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(w_hwio), (3, 2, 0, 1))))


def random_conv_from_jax(params) -> List[torch.Tensor]:
    """The random-conv FID extractor's kernels, a list of HWIO arrays (the
    JAX package's ``_random_conv_params``) -> OIHW float32 tensors."""
    return [_oihw(w).float() for w in params]


def inception_from_jax(params: Dict[str, Dict[str, Any]]) -> Dict[str, torch.Tensor]:
    """A folded Inception tree ``{name: {"w": HWIO, "b"}}`` (plus ``fc``:
    ``{"w": (2048, classes), "b"}``, kept as it is) -> the state_dict of
    models/inception.InceptionV3."""
    out: Dict[str, torch.Tensor] = {}
    for name, leaf in params.items():
        w = np.asarray(leaf["w"], np.float32)
        out[f"{name}.w"] = torch.from_numpy(w.copy()) if name == "fc" else _oihw(w)
        out[f"{name}.b"] = torch.from_numpy(np.array(leaf["b"], np.float32))
    return out
