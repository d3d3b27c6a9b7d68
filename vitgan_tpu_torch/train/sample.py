"""Samplers over a generator module (train/step.py:376-421 in the JAX package).

Latents.  The JAX package draws batch ``call`` of seed ``s`` from
fold_in(PRNGKey(s), call); that stream cannot be reproduced in PyTorch.  The
port draws it on the host from numpy's Philox generator keyed with
((s mod 2**32) << 32) | call.  The key is one-to-one over seeds in
[-2**31, 2**31) and calls in [0, 2**32), so a seeded request is reproducible
within the port, on any device, and the serving pool's negative seed
(serve.py) never shares a stream with a client's seed in [0, 2**31).  A
``torch.Generator`` cannot carry this: its CPU generator keeps 32 bits of its
seed, so (s, call) and (s + 1, call) would collide.  The same seed gives
other latents here than in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


def compute_dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.runtime.compute_dtype)


def latent_rng(seed: int, call: int) -> np.random.Generator:
    """The host generator of batch ``call`` of ``seed`` (module docstring)."""
    if not -2 ** 31 <= seed < 2 ** 31 or not 0 <= call < 2 ** 32:
        raise ValueError(f"(seed, call) = ({seed}, {call}) is outside "
                         "[-2**31, 2**31) x [0, 2**32)")
    return np.random.Generator(np.random.Philox(key=((int(seed) % 2 ** 32) << 32) | int(call)))


def latent_block(gan, seed: int, step0: int, n: int, batch: int,
                 draws_per_step: int = 1) -> np.ndarray:
    """The host latents of ``n`` consecutive train steps from ``step0``,
    (n, draws_per_step, batch, latent_dim) float32.  Row i is what the eager
    step draws from ``latent_rng(seed, step0 + i)``, in its order: the step's
    z, then one batch for each extra critic update (disc_steps > 1)."""
    out = np.empty((n, draws_per_step, batch, gan.latent_dim), np.float32)
    for i in range(n):
        rng = latent_rng(seed, step0 + i)
        for j in range(draws_per_step):
            out[i, j] = gan.sample_latent(rng, batch).numpy()
    return out


def _device_of(module: torch.nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_sample_fn(gan, cfg):
    """Eval-mode batched sampler: (generator module, z) -> float32 images."""
    dtype = compute_dtype(cfg)

    @torch.inference_mode()
    def sample(g, z):
        imgs = g(z.to(device=_device_of(g), dtype=dtype))
        return imgs.float()

    return sample


def make_serve_sample_fn(gan, cfg, batch: int, weights=None, device=None):
    """One-call serving sampler: (generator module, seed, call) -> uint8 images.

    Latents, the generator forward, clip, round((x + 1) * 127.5) and the
    readback to host memory run in one call (step.py:412-419).  With
    ``weights``, a function returning the generator's whole state_dict on
    ``device`` (the int8 route's dequantized weights, serve.py), the module
    runs on those tensors in place of its own (``torch.func.functional_call``)."""
    dtype = compute_dtype(cfg)

    @torch.inference_mode()
    def sample_u8(g, seed: int, call: int) -> np.ndarray:
        z = gan.sample_latent(latent_rng(seed, call), batch)
        if weights is None:
            imgs = g(z.to(device=_device_of(g), dtype=dtype))
        else:
            imgs = torch.func.functional_call(g, weights(), (z.to(device=device, dtype=dtype),),
                                              strict=True)
        imgs = torch.clamp(imgs.float(), -1.0, 1.0)
        return torch.round((imgs + 1.0) * 127.5).to(torch.uint8).cpu().numpy()

    return sample_u8
