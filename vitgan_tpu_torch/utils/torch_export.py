"""The port's weights -> reference torch checkpoints.

Counterpart of vitgan_tpu/utils/torch_export.py, whose mappings it copies:
the inverse of utils/torch_port, from the JAX package's {'params', 'state'}
tree (weights.to_jax_tree of a port module) to a ``state_dict`` under the
reference's module names, so that ``convert_*(export_*(tree)) == tree`` bit
for bit and an exported dict loads into the reference's modules with
``strict=True``.  Covered: the v2 ViT discriminator (under the
VisionTransformer, ViTDiscriminator or ViTGAN prefixes), the v2 CNNGAN's G
and D and the notebook DCGAN's G and D; the v2 generator and v1 are refused
with the reason.  Host-side numpy; ``save_torch_checkpoint`` writes the
tensors with ``torch.save``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from vitgan_tpu_torch.utils.torch_port import (_CNN_D_BNS, _CNN_D_CONVS, _CNN_G_BNS,
                                         _CNN_G_CONVS, _CNN_G_DECONVS,
                                         _DCGAN_D_BNS, _DCGAN_D_CONVS,
                                         _DCGAN_G_BNS, _DCGAN_G_DECONVS)


def _np(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _linear(sd, name, p) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).T)
    if "b" in p:
        sd[f"{name}.bias"] = _np(p["b"])


def _conv(sd, name, p) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).transpose(3, 2, 0, 1))


def _conv_transpose(sd, name, p) -> None:
    sd[f"{name}.weight"] = np.ascontiguousarray(_np(p["w"]).transpose(2, 3, 0, 1))


def _layer_norm(sd, name, p) -> None:
    sd[f"{name}.weight"] = _np(p["scale"])
    sd[f"{name}.bias"] = _np(p["bias"])


def _batch_norm(sd, name, params, state) -> None:
    sd[f"{name}.weight"] = _np(params["scale"])
    sd[f"{name}.bias"] = _np(params["bias"])
    sd[f"{name}.running_mean"] = _np(state["mean"])
    sd[f"{name}.running_var"] = _np(state["var"])
    # load_state_dict(strict=True) requires every registered buffer
    sd[f"{name}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def export_vit(params: Dict[str, Any], prefix: str = "",
               channels: int = 3) -> Dict[str, np.ndarray]:
    """vitgan_v2.vit_init tree -> reference VisionTransformer state_dict."""
    sd: Dict[str, np.ndarray] = {}
    w = _np(params["embed"]["w"])                     # (P*P*C, E)
    e = w.shape[1]
    cls = _np(params["cls"])
    pos = _np(params["pos"])
    # (P*P*C, E) -> (E, C, P, P)
    ppc, c = w.shape[0], channels
    p_side = int(round((ppc // c) ** 0.5))
    if c * p_side * p_side != ppc:
        raise ValueError(f"embed rows {ppc} != channels {c} x square patch")
    sd["embedding.conv1.weight"] = np.ascontiguousarray(
        w.reshape(p_side, p_side, c, e).transpose(3, 2, 0, 1))
    if "b" in params["embed"]:
        sd["embedding.conv1.bias"] = _np(params["embed"]["b"])
    sd["embedding.pos_embedding"] = pos[None]
    sd["embedding.cls_token"] = cls
    for i, blk in enumerate(params["blocks"]):
        b = f"encoder.{i}."
        _layer_norm(sd, b + "norm1", blk["ln1"])
        _layer_norm(sd, b + "norm2", blk["ln2"])
        qkv, qkv_b = _np(blk["msha"]["qkv"]), _np(blk["msha"]["qkv_b"])
        h, dh = qkv.shape[1], qkv.shape[3]
        for j, nm in enumerate(("queries", "keys", "values")):
            # (H, E, Dh) -> (E, H*Dh) -> torch (H*Dh, E)
            sd[b + f"attention.{nm}.weight"] = np.ascontiguousarray(
                qkv[j].transpose(1, 0, 2).reshape(e, h * dh).T)
            sd[b + f"attention.{nm}.bias"] = qkv_b[j].reshape(h * dh)
        _linear(sd, b + "attention.out_projection", blk["msha"]["out"])
        _linear(sd, b + "fc1", blk["fc1"])
        _linear(sd, b + "fc2", blk["fc2"])
    _layer_norm(sd, "norm", params["ln"])
    _linear(sd, "classifier.fc1", params["head_fc1"])
    _linear(sd, "classifier.fc2", params["head_fc2"])
    return {prefix + k: v for k, v in sd.items()}


def _export_sequential(variables, convs, deconvs, bns, prefix: str):
    sd: Dict[str, np.ndarray] = {}
    p, s = variables["params"], variables.get("state", {})
    for idx, name in convs.items():
        _conv(sd, f"main.{idx}", p[name])
    for idx, name in deconvs.items():
        _conv_transpose(sd, f"main.{idx}", p[name])
    for idx, name in bns.items():
        _batch_norm(sd, f"main.{idx}", p[name], s[name])
    return {prefix + k: v for k, v in sd.items()}


def export_cnn_generator(variables, prefix: str = "generator."):
    return _export_sequential(variables, _CNN_G_CONVS, _CNN_G_DECONVS,
                              _CNN_G_BNS, prefix)


def export_cnn_discriminator(variables, prefix: str = "discriminator."):
    return _export_sequential(variables, _CNN_D_CONVS, {}, _CNN_D_BNS, prefix)


def export_dcgan_generator(variables, prefix: str = ""):
    return _export_sequential(variables, {}, _DCGAN_G_DECONVS, _DCGAN_G_BNS, prefix)


def export_dcgan_discriminator(variables, prefix: str = ""):
    return _export_sequential(variables, _DCGAN_D_CONVS, {}, _DCGAN_D_BNS, prefix)


def export_checkpoint(variables, family: str, role: str = "discriminator",
                      prefix: str = None, channels: int = 3) -> Dict[str, np.ndarray]:
    """variables (or a bare params tree for v2) -> reference state_dict."""
    if family == "v2":
        if role != "discriminator":
            raise ValueError("the reference v2 generator is dimensionally "
                             "broken (SURVEY §2.4.8) — nothing to export to")
        params = variables.get("params", variables)
        return export_vit(params, "vit." if prefix is None else prefix, channels)
    if family == "cnn":
        fn = export_cnn_generator if role == "generator" else export_cnn_discriminator
        return fn(variables) if prefix is None else fn(variables, prefix)
    if family == "dcgan":
        fn = (export_dcgan_generator if role == "generator"
              else export_dcgan_discriminator)
        return fn(variables) if prefix is None else fn(variables, prefix)
    raise ValueError(f"no torch exporter for family '{family}' (the reference "
                     "v1 modules are unconstructable; utils/torch_port docstring)")


def save_torch_checkpoint(path: str, variables, family: str,
                          role: str = "discriminator", prefix: str = None,
                          channels: int = 3) -> None:
    """Export and torch.save a reference-format .pth."""
    import torch

    sd = export_checkpoint(variables, family, role, prefix, channels)
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
               path)
