"""Differentiable augmentations (DiffAugment), (B, H, W, C) in [-1, 1].

Counterpart of vitgan_tpu/ops/augment.py:21-107.  Each augmentation is split
into a draw from a ``torch.Generator`` on the tensor's device and a
deterministic apply on explicit draws, so that a test can hand the port the
JAX package's draws.  Every apply is differentiable in x: the generator
update back-propagates through the augmented fakes.  The JAX package draws
from its own keys; the port's draws follow the same distributions, not the
same stream.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from vitgan_tpu_torch.ops import draws as draws_
from vitgan_tpu_torch.ops.policy import same_device


def _uniform(gen: torch.Generator, x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    u = draws_.rand((x.shape[0], 1, 1, 1), gen, x.device)
    return (lo + (hi - lo) * u).to(x.dtype)


def _randint(gen: torch.Generator, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return draws_.randint(lo, hi, (x.shape[0],), gen, x.device)


def _translation_max(x: torch.Tensor, ratio: float = 0.125) -> Tuple[int, int]:
    return max(1, int(x.shape[1] * ratio)), max(1, int(x.shape[2] * ratio))


def _cutout_size(x: torch.Tensor, ratio: float = 0.5) -> Tuple[int, int]:
    return max(1, int(x.shape[1] * ratio)), max(1, int(x.shape[2] * ratio))


def draw_flip(gen, x):
    """(B, 1, 1, 1) bool: flip with p = 0.5."""
    return draws_.rand((x.shape[0], 1, 1, 1), gen, x.device) < 0.5


def apply_flip(x, flip):
    return torch.where(flip, x.flip(2), x)


def draw_brightness(gen, x):
    return _uniform(gen, x, -0.5, 0.5)


def apply_brightness(x, b):
    """x + U(-0.5, 0.5) per sample."""
    return x + b


def draw_saturation(gen, x):
    return _uniform(gen, x, 0.0, 2.0)


def apply_saturation(x, s):
    """Scale the deviation from the per-pixel channel mean by U(0, 2)."""
    mean = x.mean(dim=-1, keepdim=True)
    return (x - mean) * s + mean


def draw_contrast(gen, x):
    return _uniform(gen, x, 0.5, 1.5)


def apply_contrast(x, c):
    """Scale the deviation from the per-sample mean by U(0.5, 1.5)."""
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * c + mean


def draw_translation(gen, x):
    """(dy, dx), each (B,) int in [-max, max], max = max(1, int(size / 8))."""
    my, mx = _translation_max(x)
    return _randint(gen, x, -my, my + 1), _randint(gen, x, -mx, mx + 1)


def apply_translation(x, shift):
    """Shift by (dy, dx) with zero padding, by gather (differentiable in x)."""
    dy, dx = shift
    b, h, w, _ = x.shape
    my, mx = _translation_max(x)
    pad = F.pad(x, (0, 0, mx, mx, my, my))
    rows = torch.arange(h, device=x.device)[None, :] + my - dy[:, None]  # (B, H)
    cols = torch.arange(w, device=x.device)[None, :] + mx - dx[:, None]  # (B, W)
    bi = torch.arange(b, device=x.device)[:, None, None]
    return pad[bi, rows[:, :, None], cols[:, None, :]]


def draw_cutout(gen, x):
    """(y0, x0), each (B,) int: the top-left corner of the zeroed window."""
    ch, cw = _cutout_size(x)
    return _randint(gen, x, 0, x.shape[1] - ch + 1), _randint(gen, x, 0, x.shape[2] - cw + 1)


def apply_cutout(x, corner):
    """Zero a (H/2, W/2) window per sample."""
    y0, x0 = (c[:, None, None] for c in corner)
    ch, cw = _cutout_size(x)
    yy = torch.arange(x.shape[1], device=x.device)[None, :, None]
    xx = torch.arange(x.shape[2], device=x.device)[None, None, :]
    mask = (yy >= y0) & (yy < y0 + ch) & (xx >= x0) & (xx < x0 + cw)
    return torch.where(mask[..., None], torch.zeros_like(x), x)


_AUGMENTS: Dict[str, Tuple[Callable, Callable]] = {
    "flip": (draw_flip, apply_flip),
    "brightness": (draw_brightness, apply_brightness),
    "saturation": (draw_saturation, apply_saturation),
    "contrast": (draw_contrast, apply_contrast),
    "translation": (draw_translation, apply_translation),
    "cutout": (draw_cutout, apply_cutout),
}
# 'color' = the DiffAugment color group.
_GROUPS: Dict[str, Sequence[str]] = {"color": ("brightness", "saturation", "contrast")}


def parse_augment_spec(spec: str) -> Tuple[str, ...]:
    names: List[str] = []
    for tok in (t.strip() for t in spec.split(",") if t.strip()):
        names.extend(_GROUPS.get(tok, (tok,)))
    unknown = [n for n in names if n not in _AUGMENTS]
    if unknown:
        raise ValueError(f"unknown augmentations: {unknown}")
    return tuple(names)


def draw_augment(gen: torch.Generator, x: torch.Tensor, spec: str) -> list:
    """[(name, draws)] for the spec, in its order, drawn on x's device."""
    if not same_device(gen, x):
        raise ValueError(f"augment draws on x's device {x.device}, the generator is on "
                         f"{gen.device}")
    return [(name, _AUGMENTS[name][0](gen, x)) for name in parse_augment_spec(spec)]


def apply_draws(x: torch.Tensor, draws: list) -> torch.Tensor:
    """Apply [(name, draws)] in order (deterministic given the draws)."""
    for name, d in draws:
        x = _AUGMENTS[name][1](x, d)
    return x


def apply_augment(gen: torch.Generator, x: torch.Tensor, spec: str) -> torch.Tensor:
    """Apply the comma-separated spec (e.g. 'color,translation,cutout')."""
    return apply_draws(x, draw_augment(gen, x, spec))
