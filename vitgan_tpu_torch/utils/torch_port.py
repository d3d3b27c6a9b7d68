"""Reference torch checkpoints -> the port's weights.

Counterpart of vitgan_tpu/utils/torch_port.py, whose mappings it copies: the
reference's ``state_dict`` keys (its v2 ViT discriminator, the v2 CNNGAN and
the notebook DCGAN) become the JAX package's {'params', 'state'} tree, which
the port's modules hold leaf for leaf (weights.from_jax_tree; BatchNorm's
running statistics are buffers).  The reference saves plain ``state_dict``s
(v2: the raw GAN's, the notebook: G and D apart); its v1 trainer wraps them
as ``{"lr", "epoch", "state_dict"}``, which ``load_torch_state_dict``
unwraps.

Layouts (torch -> the JAX tree):

- ``nn.Linear``            weight (out, in)         -> {"w": (in, out), "b"}
- ``nn.Conv2d``            weight OIHW              -> {"w": HWIO}
- ``nn.ConvTranspose2d``   weight (in, out, kH, kW) -> {"w": (kH, kW, in, out)}
- ``nn.BatchNorm2d``       weight/bias, running stats -> params {scale, bias},
  state {mean, var}
- ``nn.LayerNorm``         weight/bias              -> {"scale", "bias"}
- the reference SelfAttention's q/k/v Linears -> qkv (3, H, E, Dh), qkv_b (3, H, Dh)
- its EmbedLayer conv patchify (E, C, P, P) -> the patchify matmul weight
  ((P*P*C), E), rows in (ph, pw, c) order as models/vitgan_v2.patchify.

The reference v2 generator is dimensionally broken, so family v2 imports
its discriminator only, and v1's modules carry spectral-norm hook tensors
with no counterpart: both are refused with the reason, as in the JAX
package.  A checkpoint is read from a local path only (``torch.load`` with
``weights_only=True``); nothing is downloaded.  Host-side numpy, as in the
JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

TORCH_SUFFIXES = (".pth", ".pt", ".ckpt")


# ---------------------------------------------------------------------------
# state_dict plumbing
# ---------------------------------------------------------------------------


def to_numpy_state_dict(sd: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Coerce a (possibly torch-tensor-valued) state_dict to float32 numpy."""
    out = {}
    for k, v in sd.items():
        if hasattr(v, "detach"):  # torch tensor
            v = v.detach().cpu().numpy()
        arr = np.asarray(v)
        out[k] = arr.astype(np.float32) if arr.dtype.kind == "f" else arr
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """torch.load a reference checkpoint and unwrap to a numpy state_dict.

    Accepts the raw ``state_dict`` form (v2/notebook) and the v1 trainer's
    ``{"lr", "epoch", "state_dict"}`` wrapper (ref:src/v1/gan.py:179-191).
    """
    import torch

    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj and not hasattr(
            obj["state_dict"], "detach"):
        obj = obj["state_dict"]
    if not isinstance(obj, dict):
        raise ValueError(f"{path} does not contain a state_dict")
    return to_numpy_state_dict(obj)


def strip_prefix(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Sub-dict of keys under ``prefix``, with the prefix removed."""
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _req(sd: Dict[str, np.ndarray], key: str) -> np.ndarray:
    if key not in sd:
        raise KeyError(f"state_dict is missing '{key}' — wrong model family or "
                       f"prefix? (has e.g. {sorted(sd)[:4]})")
    return sd[key]


# ---------------------------------------------------------------------------
# layer converters
# ---------------------------------------------------------------------------


def _linear(sd, name) -> Dict[str, np.ndarray]:
    p = {"w": np.ascontiguousarray(_req(sd, f"{name}.weight").T)}
    if f"{name}.bias" in sd:
        p["b"] = sd[f"{name}.bias"]
    return p


def _conv(sd, name) -> Dict[str, np.ndarray]:
    # OIHW -> HWIO
    return {"w": np.ascontiguousarray(_req(sd, f"{name}.weight").transpose(2, 3, 1, 0))}


def _conv_transpose(sd, name) -> Dict[str, np.ndarray]:
    # torch ConvTranspose2d weight is (in, out, kH, kW) -> (kH, kW, in, out)
    return {"w": np.ascontiguousarray(_req(sd, f"{name}.weight").transpose(2, 3, 0, 1))}


def _layer_norm(sd, name) -> Dict[str, np.ndarray]:
    return {"scale": _req(sd, f"{name}.weight"), "bias": _req(sd, f"{name}.bias")}


def _batch_norm(sd, name) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    params = {"scale": _req(sd, f"{name}.weight"), "bias": _req(sd, f"{name}.bias")}
    state = {"mean": _req(sd, f"{name}.running_mean"),
             "var": _req(sd, f"{name}.running_var")}
    return params, state


def _fused_qkv(sd, prefix, num_heads: int):
    """Reference per-projection q/k/v Linears (ref:src/v2/modules.py:110-118)
    -> fused (3, H, E, Dh) weights + (3, H, Dh) biases."""
    ws, bs = [], []
    for nm in ("queries", "keys", "values"):
        w = _req(sd, f"{prefix}{nm}.weight")          # (H*Dh, E)
        b = _req(sd, f"{prefix}{nm}.bias")            # (H*Dh,)
        hd, e = w.shape
        if hd % num_heads:
            raise ValueError(f"{prefix}{nm}: width {hd} not divisible by "
                             f"num_heads={num_heads}")
        dh = hd // num_heads
        ws.append(w.T.reshape(e, num_heads, dh).transpose(1, 0, 2))
        bs.append(b.reshape(num_heads, dh))
    return np.stack(ws), np.stack(bs)


# ---------------------------------------------------------------------------
# v2 ViT family (ref:src/v2/modules.py:67-238, 375-395)
# ---------------------------------------------------------------------------


def convert_encoder_block(sd, num_heads: int, prefix: str = "") -> Dict[str, Any]:
    """One reference Encoder (ref:src/v2/modules.py:165-176) -> our
    vitgan_v2._encoder_init tree."""
    qkv, qkv_b = _fused_qkv(sd, f"{prefix}attention.", num_heads)
    return {
        "ln1": _layer_norm(sd, f"{prefix}norm1"),
        "ln2": _layer_norm(sd, f"{prefix}norm2"),
        "msha": {"qkv": qkv, "qkv_b": qkv_b,
                 "out": _linear(sd, f"{prefix}attention.out_projection")},
        "fc1": _linear(sd, f"{prefix}fc1"),
        "fc2": _linear(sd, f"{prefix}fc2"),
    }


def convert_vit(sd: Dict[str, np.ndarray], num_heads: int,
                prefix: str = "") -> Dict[str, Any]:
    """Reference VisionTransformer state_dict -> vitgan_v2.vit_init tree.

    ``num_heads`` cannot be recovered from the fused q/k/v widths and must be
    supplied (the reference default is 4, ref:src/v2/utils.py:26).
    """
    sd = strip_prefix(sd, prefix) if prefix else sd
    conv_w = _req(sd, "embedding.conv1.weight")       # (E, C, P, P)
    e, c, p, _ = conv_w.shape
    embed = {"w": np.ascontiguousarray(
        conv_w.transpose(2, 3, 1, 0).reshape(p * p * c, e))}
    if "embedding.conv1.bias" in sd:
        embed["b"] = sd["embedding.conv1.bias"]
    depth = 0
    while f"encoder.{depth}.norm1.weight" in sd:
        depth += 1
    if depth == 0:
        raise KeyError("no encoder blocks found (encoder.0.norm1.weight missing)")
    return {
        "embed": embed,
        "pos": _req(sd, "embedding.pos_embedding")[0],   # (1, N, E) -> (N, E)
        "cls": _req(sd, "embedding.cls_token"),          # (1, 1, E)
        "blocks": [convert_encoder_block(sd, num_heads, f"encoder.{i}.")
                   for i in range(depth)],
        "ln": _layer_norm(sd, "norm"),
        "head_fc1": _linear(sd, "classifier.fc1"),
        "head_fc2": _linear(sd, "classifier.fc2"),
    }


def _detect_vit_prefix(sd) -> str:
    """Accept VisionTransformer, ViTDiscriminator ('vit.'), or full ViTGAN
    ('discriminator.vit.') state_dicts."""
    for pfx in ("", "vit.", "discriminator.vit."):
        if f"{pfx}embedding.conv1.weight" in sd:
            return pfx
    raise KeyError("no VisionTransformer found under '', 'vit.' or "
                   "'discriminator.vit.' prefixes")


def convert_vit_discriminator(sd: Dict[str, np.ndarray], num_heads: int,
                              prefix: Optional[str] = None,
                              slice_head: bool = True) -> Dict[str, Any]:
    """ViT discriminator variables from any reference v2 ViT state_dict.

    The reference D head is ``classes_count``-wide (default 10,
    ref:src/v2/utils.py:28); our GAN-coherent D is single-logit (§2.4.9) and
    ``discriminator_apply`` scores logit 0 — so by default a wider imported
    head is SLICED to its first logit, making the tree drop into
    ``discriminator_init`` templates leaf-for-leaf (the scored function is
    unchanged).  Pass ``slice_head=False`` to keep the full classifier head
    (e.g. when targeting ``vit_init`` with the checkpoint's class count).
    """
    pfx = _detect_vit_prefix(sd) if prefix is None else prefix
    params = convert_vit(sd, num_heads, pfx)
    hf2 = params["head_fc2"]
    if slice_head and hf2["w"].shape[-1] > 1:
        params["head_fc2"] = {"w": np.ascontiguousarray(hf2["w"][:, :1]),
                              "b": hf2["b"][:1]}
    return {"params": params, "state": {}}


# ---------------------------------------------------------------------------
# v2 CNNGAN family (ref:src/v2/modules.py:256-341): Sequential index -> name
# ---------------------------------------------------------------------------

_CNN_G_CONVS = {0: "conv1", 3: "conv2", 6: "conv3"}
_CNN_G_DECONVS = {9: "deconv1", 12: "deconv2", 15: "deconv3"}
_CNN_G_BNS = {1: "bn1", 4: "bn2", 7: "bn3", 10: "bn4", 13: "bn5"}
_CNN_D_CONVS = {0: "conv1", 2: "conv2", 5: "conv3", 8: "conv4", 11: "conv5"}
_CNN_D_BNS = {3: "bn2", 6: "bn3", 9: "bn4"}

_DCGAN_G_DECONVS = {0: "deconv1", 2: "deconv2", 5: "deconv3", 7: "deconv4"}
_DCGAN_G_BNS = {3: "bn2"}
_DCGAN_D_CONVS = {0: "conv1", 3: "conv2", 6: "conv3", 9: "conv4"}
_DCGAN_D_BNS = {1: "bn1", 4: "bn2", 7: "bn3"}


def _convert_sequential(sd, convs, deconvs, bns, prefix: str) -> Dict[str, Any]:
    sd = strip_prefix(sd, prefix) if prefix else sd
    params, state = {}, {}
    for idx, name in convs.items():
        params[name] = _conv(sd, f"main.{idx}")
    for idx, name in deconvs.items():
        params[name] = _conv_transpose(sd, f"main.{idx}")
    for idx, name in bns.items():
        params[name], state[name] = _batch_norm(sd, f"main.{idx}")
    return {"params": params, "state": state}


def convert_cnn_generator(sd, prefix: str = "generator.") -> Dict[str, Any]:
    """Reference v2 conv Generator (ref:src/v2/modules.py:256-304) -> family
    'cnn' generator variables."""
    return _convert_sequential(sd, _CNN_G_CONVS, _CNN_G_DECONVS, _CNN_G_BNS, prefix)


def convert_cnn_discriminator(sd, prefix: str = "discriminator.") -> Dict[str, Any]:
    """Reference v2 conv Discriminator (ref:src/v2/modules.py:307-341) ->
    family 'cnn' discriminator variables (sigmoid dropped: we emit the logit)."""
    return _convert_sequential(sd, _CNN_D_CONVS, {}, _CNN_D_BNS, prefix)


def convert_dcgan_generator(sd, prefix: str = "") -> Dict[str, Any]:
    """Notebook DCGAN Generator (ref:cnn/cnn-gan.ipynb) -> family 'dcgan'."""
    return _convert_sequential(sd, {}, _DCGAN_G_DECONVS, _DCGAN_G_BNS, prefix)


def convert_dcgan_discriminator(sd, prefix: str = "") -> Dict[str, Any]:
    """Notebook DCGAN Discriminator (ref:cnn/cnn-gan.ipynb) -> family 'dcgan'."""
    return _convert_sequential(sd, _DCGAN_D_CONVS, {}, _DCGAN_D_BNS, prefix)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def import_checkpoint(path_or_sd, family: str, role: str = "discriminator",
                      num_heads: int = 4) -> Dict[str, Any]:
    """Reference torch checkpoint -> variables for (family, role).

    ``path_or_sd`` is a .pth/.pt/.ckpt path or an already-loaded state_dict.
    Raises ValueError for (v2, generator): the reference generator is
    dimensionally broken (SURVEY §2.4.8) and has no mappable counterpart here.
    """
    sd = (load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, (str, os.PathLike))
          else to_numpy_state_dict(path_or_sd))
    if family == "v2":
        if role != "discriminator":
            raise ValueError(
                "the reference v2 ViTGenerator is dimensionally broken "
                "(SURVEY §2.4.8) — only its discriminator is importable")
        return convert_vit_discriminator(sd, num_heads)
    if family == "cnn":
        conv = convert_cnn_generator if role == "generator" else convert_cnn_discriminator
        pfx = f"{role}." if any(k.startswith(f"{role}.") for k in sd) else ""
        return conv(sd, pfx)
    if family == "dcgan":
        conv = (convert_dcgan_generator if role == "generator"
                else convert_dcgan_discriminator)
        pfx = f"{role}." if any(k.startswith(f"{role}.") for k in sd) else ""
        return conv(sd, pfx)
    raise ValueError(f"no torch importer for family '{family}' "
                     "(v1 reference checkpoints carry spectral-norm hook "
                     "tensors; see ROADMAP)")
