"""InceptionV3 pool3 feature extractor of the port, for Inception-FID on the card.

Counterpart of vitgan_tpu/models/inception.py.  Parity target: the FID
InceptionV3 of torchmetrics/pytorch-fid that the reference computes FID with
every epoch (ref:src/v2/utils.py:155-175): torchvision's InceptionV3
architecture with three FID-specific quirks,

- every in-block 3x3 stride-1 average pool leaves the padding out of its
  divisor (``count_include_pad=False``),
- ``Mixed_7c``'s pool branch is a 3x3 stride-1 **max** pool,
- the input is scaled by 1/255, resized bilinearly to 299x299 (half-pixel
  centres, no antialias) and mapped to [-1, 1].

Weights are not bundled: ``convert_torch_state_dict`` folds each eval-mode
BatchNorm of a torchvision/pytorch-fid ``state_dict`` into its convolution,
giving the JAX package's flat tree ``{name: {"w": HWIO, "b": (c_out,)}}``
(plus ``fc`` when the source has the classifier); ``save_params`` /
``load_params`` keep that tree as the JAX package's ``.npz``.  The network is
an ``nn.Module`` in NCHW with OIHW weights: weights.inception_from_jax maps
the tree onto its ``state_dict`` (the HWIO kernels transposed once, at load).

The convolutions are cuDNN's (``F.conv2d``), as the JAX package computes them
with ``lax.conv_general_dilated`` outside any Pallas kernel, and in full f32
(``full_f32``): the JAX convolutions run at Precision.HIGHEST, and TF32,
which PyTorch lets cuDNN use for f32 convolutions by default, drifts far past
the parity bar over 94 layers.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3  # torchvision BasicConv2d BatchNorm eps
FEATURE_DIM = 2048
INPUT_SIZE = 299


# ---------------------------------------------------------------------------
# Architecture table: every BasicConv2d as (name, c_in, c_out, kh, kw), the
# torchvision module paths (the port's copy of the JAX table)
# ---------------------------------------------------------------------------


def _inception_a(name: str, c_in: int, pool: int) -> List[Tuple[str, int, int, int, int]]:
    return [
        (f"{name}.branch1x1", c_in, 64, 1, 1),
        (f"{name}.branch5x5_1", c_in, 48, 1, 1),
        (f"{name}.branch5x5_2", 48, 64, 5, 5),
        (f"{name}.branch3x3dbl_1", c_in, 64, 1, 1),
        (f"{name}.branch3x3dbl_2", 64, 96, 3, 3),
        (f"{name}.branch3x3dbl_3", 96, 96, 3, 3),
        (f"{name}.branch_pool", c_in, pool, 1, 1),
    ]


def _inception_b(name: str, c_in: int) -> List[Tuple[str, int, int, int, int]]:
    return [
        (f"{name}.branch3x3", c_in, 384, 3, 3),
        (f"{name}.branch3x3dbl_1", c_in, 64, 1, 1),
        (f"{name}.branch3x3dbl_2", 64, 96, 3, 3),
        (f"{name}.branch3x3dbl_3", 96, 96, 3, 3),
    ]


def _inception_c(name: str, c_in: int, c7: int) -> List[Tuple[str, int, int, int, int]]:
    return [
        (f"{name}.branch1x1", c_in, 192, 1, 1),
        (f"{name}.branch7x7_1", c_in, c7, 1, 1),
        (f"{name}.branch7x7_2", c7, c7, 1, 7),
        (f"{name}.branch7x7_3", c7, 192, 7, 1),
        (f"{name}.branch7x7dbl_1", c_in, c7, 1, 1),
        (f"{name}.branch7x7dbl_2", c7, c7, 7, 1),
        (f"{name}.branch7x7dbl_3", c7, c7, 1, 7),
        (f"{name}.branch7x7dbl_4", c7, c7, 7, 1),
        (f"{name}.branch7x7dbl_5", c7, 192, 1, 7),
        (f"{name}.branch_pool", c_in, 192, 1, 1),
    ]


def _inception_d(name: str, c_in: int) -> List[Tuple[str, int, int, int, int]]:
    return [
        (f"{name}.branch3x3_1", c_in, 192, 1, 1),
        (f"{name}.branch3x3_2", 192, 320, 3, 3),
        (f"{name}.branch7x7x3_1", c_in, 192, 1, 1),
        (f"{name}.branch7x7x3_2", 192, 192, 1, 7),
        (f"{name}.branch7x7x3_3", 192, 192, 7, 1),
        (f"{name}.branch7x7x3_4", 192, 192, 3, 3),
    ]


def _inception_e(name: str, c_in: int) -> List[Tuple[str, int, int, int, int]]:
    return [
        (f"{name}.branch1x1", c_in, 320, 1, 1),
        (f"{name}.branch3x3_1", c_in, 384, 1, 1),
        (f"{name}.branch3x3_2a", 384, 384, 1, 3),
        (f"{name}.branch3x3_2b", 384, 384, 3, 1),
        (f"{name}.branch3x3dbl_1", c_in, 448, 1, 1),
        (f"{name}.branch3x3dbl_2", 448, 384, 3, 3),
        (f"{name}.branch3x3dbl_3a", 384, 384, 1, 3),
        (f"{name}.branch3x3dbl_3b", 384, 384, 3, 1),
        (f"{name}.branch_pool", c_in, 192, 1, 1),
    ]


def conv_specs() -> List[Tuple[str, int, int, int, int]]:
    """All 94 BasicConv2d layers of the FID InceptionV3, in forward order."""
    specs: List[Tuple[str, int, int, int, int]] = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]
    specs += _inception_a("Mixed_5b", 192, 32)
    specs += _inception_a("Mixed_5c", 256, 64)
    specs += _inception_a("Mixed_5d", 288, 64)
    specs += _inception_b("Mixed_6a", 288)
    specs += _inception_c("Mixed_6b", 768, 128)
    specs += _inception_c("Mixed_6c", 768, 160)
    specs += _inception_c("Mixed_6d", 768, 160)
    specs += _inception_c("Mixed_6e", 768, 192)
    specs += _inception_d("Mixed_7a", 768)
    specs += _inception_e("Mixed_7b", 1280)
    specs += _inception_e("Mixed_7c", 2048)
    return specs


# ---------------------------------------------------------------------------
# Weight conversion: torch state_dict (OIHW conv + BN stats) -> folded HWIO,
# the JAX package's tree and .npz
# ---------------------------------------------------------------------------


def convert_torch_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, Dict[str, np.ndarray]]:
    """Fold each BasicConv2d's eval-mode BatchNorm into its conv.

    Accepts torchvision ``inception_v3`` or pytorch-fid ``InceptionV3``
    state_dicts (tensors or ndarrays); ``AuxLogits`` entries are ignored.
    Returns ``{name: {"w": HWIO float32, "b": (c_out,) float32}}``; a source
    with the classifier head (torchvision's ``fc.weight``/``fc.bias``) keeps
    it under ``"fc"`` as ``{"w": (2048, classes), "b": (classes,)}`` for the
    Inception Score.
    """
    def arr(key):
        v = sd[key]
        return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                          np.float64)

    params = {}
    if "fc.weight" in sd:
        params["fc"] = {"w": arr("fc.weight").T.astype(np.float32),
                        "b": arr("fc.bias").astype(np.float32)}
    for name, c_in, c_out, kh, kw in conv_specs():
        w = arr(f"{name}.conv.weight")          # (c_out, c_in, kh, kw)
        if w.shape != (c_out, c_in, kh, kw):
            raise ValueError(f"{name}: weight shape {w.shape} != "
                             f"{(c_out, c_in, kh, kw)}")
        gamma = arr(f"{name}.bn.weight")
        beta = arr(f"{name}.bn.bias")
        mean = arr(f"{name}.bn.running_mean")
        var = arr(f"{name}.bn.running_var")
        scale = gamma / np.sqrt(var + BN_EPS)
        w_hwio = np.transpose(w, (2, 3, 1, 0)) * scale  # scale broadcasts on O
        params[name] = {
            "w": np.ascontiguousarray(w_hwio, dtype=np.float32),
            "b": (beta - mean * scale).astype(np.float32),
        }
    return params


def save_params(path: str, params: Dict[str, Dict[str, np.ndarray]]) -> None:
    flat = {}
    for name, p in params.items():
        flat[f"{name}/w"] = p["w"]
        flat[f"{name}/b"] = p["b"]
    np.savez_compressed(path, **flat)


def load_params(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    with np.load(path) as z:
        params: Dict[str, Dict[str, np.ndarray]] = {}
        for key in z.files:
            name, leaf = key.rsplit("/", 1)
            params.setdefault(name, {})[leaf] = z[key]
    return params


def random_torch_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """A full random-weights state_dict in torchvision's key schema, the same
    numpy stream as the JAX package's (so the arrays are bit-equal), for the
    parity tests and the card's check without pretrained weights.

    BN stats stay near identity: He-init conv + relu is roughly variance
    preserving, and a net gain of ~1.2 a layer would compound to ~1e7 over
    the 94 layers and drown an f32 comparison in amplified rounding.
    """
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, c_in, c_out, kh, kw in conv_specs():
        fan_in = c_in * kh * kw
        sd[f"{name}.conv.weight"] = rng.normal(
            0.0, np.sqrt(2.0 / fan_in), (c_out, c_in, kh, kw)).astype(np.float32)
        sd[f"{name}.bn.weight"] = (1.0 + rng.normal(0.0, 0.05, c_out)).astype(np.float32)
        sd[f"{name}.bn.bias"] = rng.normal(0.0, 0.05, c_out).astype(np.float32)
        sd[f"{name}.bn.running_mean"] = rng.normal(0.0, 0.05, c_out).astype(np.float32)
        sd[f"{name}.bn.running_var"] = (1.0 + rng.uniform(-0.1, 0.1, c_out)).astype(np.float32)
    # Classifier head (torchvision schema) so the fc conversion is exercised.
    sd["fc.weight"] = rng.normal(0.0, np.sqrt(1.0 / 2048), (1000, 2048)).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


# ---------------------------------------------------------------------------
# The network
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def full_f32():
    """True f32 for cuDNN convolutions and matrix products inside the scope
    (no TF32), restoring the process's settings after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


class FoldedConv(nn.Module):
    """BasicConv2d with its BatchNorm folded in: conv + bias + relu.  ``w``
    is OIHW, ``b`` (c_out,)."""

    def __init__(self, c_in: int, c_out: int, kh: int, kw: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_out, c_in, kh, kw), requires_grad=False)
        self.b = nn.Parameter(torch.empty(c_out), requires_grad=False)

    def forward(self, x: torch.Tensor, stride: int = 1, padding=0) -> torch.Tensor:
        # The JAX package puts an optimization barrier before a strided conv
        # (inception.py:240-241) against an XLA miscompilation; torch has no
        # such fusion and needs no counterpart.
        return F.relu(F.conv2d(x, self.w, self.b, stride=stride, padding=padding))


class InceptionV3(nn.Module):
    """The FID InceptionV3 backbone in NCHW: (N, 3, H, W) in [-1, 1] ->
    (N, 2048) pool3 features.  Its ``state_dict`` keys are the conv names of
    ``conv_specs`` with ``.w`` and ``.b`` (``Mixed_5b.branch1x1.w``), and
    ``fc.w`` (2048, classes), ``fc.b`` when built with ``num_classes``.
    Built with uninitialised weights: load them (``from_params``)."""

    def __init__(self, num_classes: Optional[int] = None, device="cuda"):
        super().__init__()
        for name, c_in, c_out, kh, kw in conv_specs():
            parent, _, leaf = name.rpartition(".")
            if parent and not hasattr(self, parent):
                self.add_module(parent, nn.Module())
            owner = self.get_submodule(parent) if parent else self
            owner.add_module(leaf, FoldedConv(c_in, c_out, kh, kw))
        if num_classes:
            self.fc = nn.Module()
            self.fc.w = nn.Parameter(torch.empty(FEATURE_DIM, num_classes), requires_grad=False)
            self.fc.b = nn.Parameter(torch.empty(num_classes), requires_grad=False)
        self.to(device)

    @classmethod
    def from_params(cls, params: Dict[str, Dict[str, np.ndarray]], device="cuda"):
        """The network on ``device`` with a folded JAX tree's weights."""
        from vitgan_tpu_torch.weights import inception_from_jax, load_into

        with torch.device("meta"):
            net = cls(params["fc"]["b"].shape[0] if "fc" in params else None, device="meta")
        load_into(net, inception_from_jax(params), assign=True)
        return net.to(device).eval()

    @property
    def has_fc(self) -> bool:
        return hasattr(self, "fc")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return inception_backbone(self, x)


def _max_pool(x, k=3, stride=2, padding=0):
    return F.max_pool2d(x, k, stride=stride, padding=padding)


def _avg_pool_nocount(x):
    """3x3 stride-1 SAME average pool dividing by the in-bounds elements."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _stem(net, x):
    c = net.get_submodule
    x = c("Conv2d_1a_3x3")(x, stride=2)
    x = c("Conv2d_2a_3x3")(x)
    x = c("Conv2d_2b_3x3")(x, padding=1)
    x = _max_pool(x)
    x = c("Conv2d_3b_1x1")(x)
    x = c("Conv2d_4a_3x3")(x)
    return _max_pool(x)


def _block_a(net, name, x):
    c = net.get_submodule(name).get_submodule
    b1 = c("branch1x1")(x)
    b5 = c("branch5x5_2")(c("branch5x5_1")(x), padding=2)
    b3 = c("branch3x3dbl_1")(x)
    b3 = c("branch3x3dbl_2")(b3, padding=1)
    b3 = c("branch3x3dbl_3")(b3, padding=1)
    bp = c("branch_pool")(_avg_pool_nocount(x))
    return torch.cat([b1, b5, b3, bp], 1)


def _block_b(net, name, x):
    c = net.get_submodule(name).get_submodule
    b3 = c("branch3x3")(x, stride=2)
    bd = c("branch3x3dbl_1")(x)
    bd = c("branch3x3dbl_2")(bd, padding=1)
    bd = c("branch3x3dbl_3")(bd, stride=2)
    return torch.cat([b3, bd, _max_pool(x)], 1)


def _block_c(net, name, x):
    c = net.get_submodule(name).get_submodule
    b1 = c("branch1x1")(x)
    b7 = c("branch7x7_1")(x)
    b7 = c("branch7x7_2")(b7, padding=(0, 3))
    b7 = c("branch7x7_3")(b7, padding=(3, 0))
    bd = c("branch7x7dbl_1")(x)
    bd = c("branch7x7dbl_2")(bd, padding=(3, 0))
    bd = c("branch7x7dbl_3")(bd, padding=(0, 3))
    bd = c("branch7x7dbl_4")(bd, padding=(3, 0))
    bd = c("branch7x7dbl_5")(bd, padding=(0, 3))
    bp = c("branch_pool")(_avg_pool_nocount(x))
    return torch.cat([b1, b7, bd, bp], 1)


def _block_d(net, name, x):
    c = net.get_submodule(name).get_submodule
    b3 = c("branch3x3_2")(c("branch3x3_1")(x), stride=2)
    b7 = c("branch7x7x3_1")(x)
    b7 = c("branch7x7x3_2")(b7, padding=(0, 3))
    b7 = c("branch7x7x3_3")(b7, padding=(3, 0))
    b7 = c("branch7x7x3_4")(b7, stride=2)
    return torch.cat([b3, b7, _max_pool(x)], 1)


def _block_e(net, name, x, pool_branch: str):
    c = net.get_submodule(name).get_submodule
    b1 = c("branch1x1")(x)
    b3 = c("branch3x3_1")(x)
    b3 = torch.cat([c("branch3x3_2a")(b3, padding=(0, 1)),
                    c("branch3x3_2b")(b3, padding=(1, 0))], 1)
    bd = c("branch3x3dbl_1")(x)
    bd = c("branch3x3dbl_2")(bd, padding=1)
    bd = torch.cat([c("branch3x3dbl_3a")(bd, padding=(0, 1)),
                    c("branch3x3dbl_3b")(bd, padding=(1, 0))], 1)
    if pool_branch == "max":  # FIDInceptionE_2 (Mixed_7c)
        pooled = _max_pool(x, k=3, stride=1, padding=1)
    else:
        pooled = _avg_pool_nocount(x)
    return torch.cat([b1, b3, bd, c("branch_pool")(pooled)], 1)


def inception_backbone(net: InceptionV3, x: torch.Tensor) -> torch.Tensor:
    """(N, 3, 299, 299) in [-1, 1] -> (N, 2048) pool3 features."""
    x = _stem(net, x)
    x = _block_a(net, "Mixed_5b", x)
    x = _block_a(net, "Mixed_5c", x)
    x = _block_a(net, "Mixed_5d", x)
    x = _block_b(net, "Mixed_6a", x)
    x = _block_c(net, "Mixed_6b", x)
    x = _block_c(net, "Mixed_6c", x)
    x = _block_c(net, "Mixed_6d", x)
    x = _block_c(net, "Mixed_6e", x)
    x = _block_d(net, "Mixed_7a", x)
    x = _block_e(net, "Mixed_7b", x, pool_branch="avg")
    x = _block_e(net, "Mixed_7c", x, pool_branch="max")
    return x.mean(dim=(2, 3))


def preprocess(x_u8: torch.Tensor, resize_to: int = INPUT_SIZE) -> torch.Tensor:
    """uint8 NHWC images (any H, W) -> NCHW f32 in [-1, 1] at resize_to:
    x/255, bilinear resize (half-pixel centres, no antialias), then 2x - 1."""
    x = x_u8.permute(0, 3, 1, 2).float() / 255.0
    x = F.interpolate(x, size=(resize_to, resize_to), mode="bilinear", align_corners=False,
                      antialias=False)
    return x * 2.0 - 1.0


@torch.inference_mode()
def inception_features(net: InceptionV3, x_u8: torch.Tensor,
                       resize_to: int = INPUT_SIZE) -> torch.Tensor:
    """uint8 NHWC images on the network's device -> (N, 2048) f32 FID
    features, in full f32."""
    with full_f32():
        return net(preprocess(x_u8, resize_to)).float()


def apply_fc(net: InceptionV3, feats: torch.Tensor) -> torch.Tensor:
    """(N, 2048) pool3 features -> (N, classes) logits by the classifier head
    (torchvision checkpoints carry it; pytorch-fid ones do not)."""
    if not net.has_fc:
        raise KeyError("the network has no 'fc' head (pytorch-fid checkpoints don't include "
                       "the classifier; port torchvision weights for the Inception Score)")
    with full_f32():
        return feats @ net.fc.w + net.fc.b


@torch.inference_mode()
def inception_logits(net: InceptionV3, x_u8: torch.Tensor,
                     resize_to: int = INPUT_SIZE) -> torch.Tensor:
    """uint8 NHWC images -> (N, classes) classifier logits (the Inception
    Score's; the same preprocessing as ``inception_features``)."""
    return apply_fc(net, inception_features(net, x_u8, resize_to))
