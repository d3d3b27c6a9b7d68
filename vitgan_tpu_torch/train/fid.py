"""Frechet Inception Distance on the card.

Counterpart of vitgan_tpu/train/fid.py.  Parity target: torchmetrics
FrechetInceptionDistance as both reference trainers use it every epoch
(ref:src/v1/gan.py:207-208,254-283; ref:src/v2/utils.py:155-175): images are
converted to uint8, featurized, and the Frechet distance between Gaussian fits
of the real and fake features is reported.

The Frechet math is host numpy in float64, as in the JAX package.  The
extractors, under the JAX package's choice names so that a config or a
command line works in both packages:

- ``inception`` / ``inception_jax``: the port's own InceptionV3
  (models/inception.py) on the device, from local weights (``.npz`` in the
  JAX package's layout, or a torchvision/pytorch-fid ``.pth``) found through
  ``$INCEPTION_WEIGHTS``; ``inception`` falls back to ``inception_torch``;
- ``inception_torch``: torchvision's InceptionV3 when torchvision imports and
  its weights are in the local torch hub cache (nothing is downloaded), on
  the caller's device;
- ``random_conv``: a fixed-seed untrained conv net (a Frechet Random-Feature
  Distance).  Relative comparisons hold; absolute values are not comparable
  to Inception-FID numbers.  The JAX package draws its weights from
  ``jax.random.normal(PRNGKey(42))``, a stream PyTorch cannot reproduce, so
  the port draws its own He-normal weights from numpy's generator seeded 42
  (the same shapes): the two packages' ``random_conv`` FIDs of the same
  images differ unless the JAX weights are carried across
  (``make_random_conv_extractor(params=...)``);
- ``auto``: the first of inception, inception_torch and random_conv that has
  what it needs, logged.

Every extractor runs on the device, in full f32 (models/inception.full_f32),
so the trainer takes the on-device route (``make_on_device_fid``): features
and moment sums stay on the device, and one host pull feeds the Frechet math.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vitgan_tpu_torch.models import inception as I
from vitgan_tpu_torch.models.inception import full_f32
from vitgan_tpu_torch.train.sample import compute_dtype, latent_rng

log = logging.getLogger(__name__)

EXTRACTORS = ("auto", "inception", "inception_jax", "inception_torch", "random_conv")


# ---------------------------------------------------------------------------
# Frechet distance math
# ---------------------------------------------------------------------------


class FeatureStats:
    """Streaming Gaussian moment accumulator."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros((dim,), np.float64)
        self.sum_outer = np.zeros((dim, dim), np.float64)

    def update(self, feats: np.ndarray) -> None:
        f = np.asarray(feats, np.float64)
        self.n += f.shape[0]
        self.sum += f.sum(0)
        self.sum_outer += f.T @ f

    def moments(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError("need >=2 samples for covariance")
        mu = self.sum / self.n
        cov = (self.sum_outer - self.n * np.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def _sqrt_psd(mat: np.ndarray) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, cov1, mu2, cov2) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrtm(C1 C2)), via the PSD-stable form."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    cov1, cov2 = np.asarray(cov1, np.float64), np.asarray(cov2, np.float64)
    a = _sqrt_psd(cov1)
    m = a @ cov2 @ a
    eigs = np.clip(np.linalg.eigvalsh(m), 0.0, None)
    tr_sqrt = float(np.sqrt(eigs).sum())
    diff = mu1 - mu2
    return float(diff @ diff + np.trace(cov1) + np.trace(cov2) - 2.0 * tr_sqrt)


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------


class Extractor:
    """A feature extractor on ``device``: ``feature_fn`` maps a uint8 NHWC
    tensor on the device to (N, feature_dim) f32 features there (the role of
    the JAX extractors' ``jax_feature_fn``); calling it on a host uint8 array
    gives float32 numpy features, ``batch`` images a device call;
    ``logits_fn`` (host array -> classifier logits) is set when the network
    has a classifier head, for the Inception Score."""

    def __init__(self, name: str, feature_fn: Callable, feature_dim: int, device,
                 logits: Optional[Callable] = None, batch: int = 64):
        self.name, self.feature_fn, self.feature_dim = name, feature_fn, feature_dim
        self.device, self.batch = torch.device(device), batch
        self.logits_fn = (lambda imgs: self._host(logits, imgs)) if logits else None

    def _host(self, fn: Callable, imgs) -> np.ndarray:
        imgs = np.asarray(imgs)
        out = [fn(torch.from_numpy(imgs[i:i + self.batch]).to(self.device)).cpu().numpy()
               for i in range(0, len(imgs), self.batch)]
        return np.concatenate(out, 0)

    def __call__(self, imgs) -> np.ndarray:
        return self._host(self.feature_fn, imgs)


def random_conv_params(channels: int = 3, seed: int = 42,
                       widths=(64, 128, 256, 512)) -> list:
    """The port's random-conv kernels, HWIO float32 (the JAX shapes),
    He-normal from numpy's generator (module docstring)."""
    rng = np.random.default_rng(seed)
    params, c_in = [], channels
    for c_out in widths:
        w = rng.standard_normal((3, 3, c_in, c_out)) * np.sqrt(2.0 / (9 * c_in))
        params.append(w.astype(np.float32))
        c_in = c_out
    return params


def _same_pad(size: int, k: int = 3, stride: int = 2) -> Tuple[int, int]:
    """TF/XLA "SAME" padding (before, after): asymmetric on even sizes, e.g.
    (0, 1) at 32 px, (1, 1) at 17 px."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def random_conv_features(weights, x_u8: torch.Tensor, feature_dim: int = 512) -> torch.Tensor:
    """uint8 NHWC -> (N, feature_dim) features of the fixed random conv net:
    4 convs 3x3 stride 2 with SAME padding, each followed by the tanh GELU
    (jax.nn.gelu's default), then the spatial mean.  ``weights`` are OIHW."""
    x = x_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
    with full_f32():
        for w in weights:
            (top, bottom), (left, right) = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=2)
            x = F.gelu(x, approximate="tanh")
    return x.mean(dim=(2, 3))[:, :feature_dim]


def make_random_conv_extractor(channels: int = 3, seed: int = 42, feature_dim: int = 512,
                               device="cuda", params=None) -> Extractor:
    """The random-conv proxy on ``device``; ``params`` (a list of HWIO
    arrays, e.g. the JAX package's ``_random_conv_params``) replaces the
    port's own draw."""
    from vitgan_tpu_torch.weights import random_conv_from_jax

    if params is None:
        params = random_conv_params(channels, seed)
    weights = [w.to(device) for w in random_conv_from_jax(params)]
    features = torch.inference_mode()(lambda x: random_conv_features(weights, x, feature_dim))
    return Extractor("random_conv", features, feature_dim, device)


def inception_weights_path() -> Optional[str]:
    """Local InceptionV3 weights: $INCEPTION_WEIGHTS, else
    $SCRATCH/inception/fid_inception.npz (the JAX package's places)."""
    p = os.environ.get("INCEPTION_WEIGHTS")
    if p and os.path.exists(p):
        return p
    scratch = os.environ.get("SCRATCH", ".")
    p = os.path.join(scratch, "inception", "fid_inception.npz")
    return p if os.path.exists(p) else None


def make_inception_extractor(weights_path: Optional[str] = None, batch: int = 64,
                             device="cuda") -> Extractor:
    """The port's InceptionV3 pool3 features (2048-d) on ``device``, from
    local weights (``.npz``, or a torch ``.pth`` converted on the fly);
    FileNotFoundError when there are none (nothing is downloaded)."""
    path = weights_path or inception_weights_path()
    if path is None:
        raise FileNotFoundError("no InceptionV3 weights found (set $INCEPTION_WEIGHTS to a "
                                ".npz of models/inception.save_params or a torchvision .pth)")
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        params = I.convert_torch_state_dict(sd.get("state_dict", sd))
    else:
        params = I.load_params(path)
    net = I.InceptionV3.from_params(params, device)
    logits = (lambda x: I.inception_logits(net, x)) if net.has_fc else None
    return Extractor("inception", lambda x: I.inception_features(net, x), I.FEATURE_DIM,
                     device, logits=logits, batch=batch)


def make_torchvision_extractor(batch: int = 64, device="cuda") -> Extractor:
    """torchvision's InceptionV3 pool3 (2048-d) on ``device``, with the
    ImageNet normalisation of the JAX package's torch extractor.  Its weights
    are read from the local torch hub cache only: ImportError without
    torchvision, FileNotFoundError without the cached file."""
    from torchvision.models import Inception_V3_Weights, inception_v3

    url = Inception_V3_Weights.DEFAULT.url
    path = os.path.join(torch.hub.get_dir(), "checkpoints", os.path.basename(url))
    if not os.path.exists(path):
        raise FileNotFoundError(f"torchvision's InceptionV3 weights are not cached at {path}")
    net = inception_v3(weights=None, aux_logits=True, transform_input=True, init_weights=False)
    net.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
    net.fc = torch.nn.Identity()
    net = net.eval().to(device)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device).view(1, 3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225], device=device).view(1, 3, 1, 1)

    @torch.inference_mode()
    def features(x_u8):
        x = x_u8.permute(0, 3, 1, 2).float() / 255.0
        x = F.interpolate(x, size=(I.INPUT_SIZE, I.INPUT_SIZE), mode="bilinear",
                          align_corners=False)
        with full_f32():
            return net((x - mean) / std).float()

    return Extractor("inception_torch", features, I.FEATURE_DIM, device, batch=batch)


def make_feature_extractor(name: str = "auto", channels: int = 3, device="cuda") -> Extractor:
    """An extractor by the JAX package's name (module docstring)."""
    if name in ("inception_jax", "inception"):
        try:
            return make_inception_extractor(device=device)
        except FileNotFoundError:
            if name == "inception_jax":
                raise
            return make_torchvision_extractor(device=device)
    if name == "inception_torch":
        return make_torchvision_extractor(device=device)
    if name == "random_conv":
        return make_random_conv_extractor(channels, device=device)
    if name == "auto":
        for make in (make_inception_extractor, make_torchvision_extractor):
            try:
                ex = make(device=device)
                break
            except (FileNotFoundError, ImportError) as e:
                log.info("FID extractor auto: %s unavailable (%s)", make.__name__, e)
        else:
            ex = make_random_conv_extractor(channels, device=device)
        log.info("FID extractor auto: took %s", ex.name)
        return ex
    raise ValueError(f"unknown extractor {name!r}; choose from {EXTRACTORS}")


# ---------------------------------------------------------------------------
# On-device FID: features and moment sums on the device, ONE host pull
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _span(spans: Optional[dict], name: str, device: torch.device):
    """Add the seconds of the block to spans[name], the device synchronised
    at both ends; nothing when ``spans`` is None."""
    if spans is None:
        yield
        return
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    yield
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    spans[name] = spans.get(name, 0.0) + time.perf_counter() - t0


def make_on_device_fid(gan, cfg, feature_fn: Callable, batch_size: int, n_batches: int,
                       feature_dim: int):
    """(generator module, dataset_u8 (N, H, W, C) on the device, real_idx
    (n_batches, batch_size), seed, spans=None) -> FID.

    Real batches are gathered from the device-resident uint8 dataset; fake
    batch i is the generator's forward on latents from latent_rng(seed, i)
    (the role of fold_in(PRNGKey(seed), i)), quantised to uint8 on the
    device like the host path.  ``feature_fn`` (uint8 NHWC -> (N,
    feature_dim) f32, e.g. an Extractor's) featurizes; the sums s and f.T @ f
    accumulate on the device in f32; one host pull, then the Frechet math in
    f64.  Everything runs under inference_mode on the caller's stream, and
    nothing draws from a torch generator.  ``spans`` collects the seconds of
    the generator, the features and the host's Frechet math (the device
    synchronised around each)."""
    dtype = compute_dtype(cfg)

    def compute(g, dataset_u8: torch.Tensor, real_idx, seed: int,
                spans: Optional[dict] = None) -> float:
        device = dataset_u8.device
        idx = torch.as_tensor(np.asarray(real_idx, np.int64))
        if tuple(idx.shape) != (n_batches, batch_size):
            raise ValueError(f"real_idx {tuple(idx.shape)}, expected {(n_batches, batch_size)}")
        idx = idx.to(device)
        with torch.inference_mode():
            # acc[side, 0] holds the feature sum, acc[side, 1:] the sum of f.T @ f
            acc = torch.zeros((2, feature_dim + 1, feature_dim), device=device)

            def add(side: int, u8: torch.Tensor) -> None:
                with _span(spans, "features", device):
                    f = feature_fn(u8).float()
                    with full_f32():
                        acc[side, 0] += f.sum(0)
                        acc[side, 1:] += f.T @ f

            for i in range(n_batches):
                add(0, dataset_u8.index_select(0, idx[i]))
            for i in range(n_batches):
                with _span(spans, "generator", device):
                    z = gan.sample_latent(latent_rng(seed, i), batch_size)
                    imgs = g(z.to(device=device, dtype=dtype)).float()
                    u8 = torch.clamp(torch.round((imgs + 1.0) * 127.5), 0, 255).to(torch.uint8)
                add(1, u8)
            with _span(spans, "frechet", device):
                host = acc.cpu().numpy().astype(np.float64)
                n = n_batches * batch_size
                out = []
                for side in host:
                    mu = side[0] / n
                    cov = (side[1:] - n * np.outer(mu, mu)) / (n - 1)
                    out.append((mu, cov))
                (mu_r, cov_r), (mu_f, cov_f) = out
                return frechet_distance(mu_r, cov_r, mu_f, cov_f)

    return compute


# ---------------------------------------------------------------------------
# End-to-end FID evaluation on the host route
# ---------------------------------------------------------------------------


def to_uint8(images) -> np.ndarray:
    """[-1,1] floats -> uint8, matching the reference's pre-FID conversion
    (ref:src/v2/utils.py:165-173 convert_to_uint8 role)."""
    x = np.asarray(images, np.float32)
    return np.clip(np.rint((x + 1.0) * 127.5), 0, 255).astype(np.uint8)


def compute_fid(
    sample_batch: Callable[[np.random.Generator, int], np.ndarray],
    real_batches: Iterator[np.ndarray],
    extractor: Callable[[np.ndarray], np.ndarray],
    seed: int,
    num_samples: int,
    batch_size: int,
    spans: Optional[dict] = None,
) -> float:
    """FID between generated samples and real batches.

    ``sample_batch(rng, n)`` returns n generated images in [-1,1], fake batch
    i drawing from ``rng = latent_rng(seed, i)`` (fresh noise per batch,
    ref:src/v2/utils.py:160-164); ``real_batches`` yields uint8 or [-1,1]
    real image batches on the host.  ``spans`` collects the seconds of the
    generator, the features and the Frechet math, the extractor's device
    synchronised around each (make_on_device_fid's split).
    """
    device = getattr(extractor, "device", torch.device("cpu"))
    real_stats = fake_stats = None
    seen = 0
    for rb in real_batches:
        rb = np.asarray(rb)
        if rb.dtype != np.uint8:
            rb = to_uint8(rb)
        take = min(len(rb), num_samples - seen)
        if take <= 0:
            break
        with _span(spans, "features", device):
            feats = extractor(rb[:take])
        if real_stats is None:
            dim = feats.shape[-1]
            real_stats, fake_stats = FeatureStats(dim), FeatureStats(dim)
        real_stats.update(feats)
        seen += take
        if seen >= num_samples:
            break
    if real_stats is None:
        raise ValueError("no real batches provided")
    generated, call = 0, 0
    while generated < seen:
        n = min(batch_size, seen - generated)
        with _span(spans, "generator", device):
            fakes = to_uint8(sample_batch(latent_rng(seed, call), n))
        with _span(spans, "features", device):
            fake_stats.update(extractor(fakes))
        generated += n
        call += 1
    with _span(spans, "frechet", device):
        mu_r, cov_r = real_stats.moments()
        mu_f, cov_f = fake_stats.moments()
        return frechet_distance(mu_r, cov_r, mu_f, cov_f)
