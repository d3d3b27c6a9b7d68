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
The baselines map the same way: a conv's ``w`` stays HWIO and a BatchNorm's
state leaves {mean, var} become its buffers.  ``to_jax_tree`` is the
inverse: a module's parameters and buffers as the {'params', 'state'} tree
(what utils/torch_export writes a reference checkpoint from).
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


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    """'a.0.b' keys -> nested dicts, a level whose keys are all digits a list."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def to_jax_tree(module: torch.nn.Module, state_dict: Dict[str, torch.Tensor] = None) -> dict:
    """A module's weights (or ``state_dict``, a state_dict of that module) ->
    {'params': tree, 'state': tree} of f32 numpy arrays in the JAX layouts;
    the module's buffers are the state."""
    sd = module.state_dict() if state_dict is None else state_dict
    buffers = {name for name, _ in module.named_buffers()}
    as_np = lambda t: t.detach().float().cpu().numpy()  # noqa: E731
    return {"params": _unflatten({k: as_np(v) for k, v in sd.items() if k not in buffers}),
            "state": _unflatten({k: as_np(v) for k, v in sd.items() if k in buffers})}


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
