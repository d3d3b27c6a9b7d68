"""Feature-space generative metrics beyond FID: KID, precision/recall and IS.

The port's copy of vitgan_tpu/train/metrics.py (host numpy, no JAX).  The
reference evaluates sample quality with FID only (ref:src/v2/utils.py:155-175,
ref:src/v1/gan.py:254-283).  Two standard companions share the same feature
extractor plumbing (train/fid.py) and are extractor-agnostic, so they work
with the random-conv proxy and with InceptionV3 when weights are staged:

- **KID** (Kernel Inception Distance, Binkowski et al. 2018): unbiased MMD^2
  with the cubic polynomial kernel k(x,y) = (x.y/d + 1)^3, averaged over
  random subsets — torchmetrics KernelInceptionDistance semantics
  (subset_size/subsets, sampling without replacement).  Unlike FID it is
  unbiased at small sample counts and comes with a standard error.
- **Improved precision/recall** (Kynkaanniemi et al. 2019): k-NN manifold
  estimates.  Precision = fraction of fake samples inside the real manifold
  (fidelity); recall = fraction of real samples inside the fake manifold
  (coverage/diversity).  Separates the two failure modes FID conflates.

All math runs on host NumPy over (N, D) feature arrays — at the sample budgets
involved (<= tens of thousands) the pairwise blocks are small; distance
computations are chunked so memory stays O(N * chunk).
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Tuple

import numpy as np

from vitgan_tpu_torch.train.fid import FeatureStats, frechet_distance, to_uint8


# ---------------------------------------------------------------------------
# KID: polynomial-kernel MMD^2 over subsets
# ---------------------------------------------------------------------------


def polynomial_kernel(x: np.ndarray, y: np.ndarray, degree: int = 3,
                      gamma: Optional[float] = None, coef: float = 1.0) -> np.ndarray:
    """k(x, y) = (gamma x.y + coef)^degree, gamma defaulting to 1/feature_dim."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if gamma is None:
        gamma = 1.0 / x.shape[1]
    return (gamma * (x @ y.T) + coef) ** degree


def mmd2_unbiased(k_xx: np.ndarray, k_yy: np.ndarray, k_xy: np.ndarray) -> float:
    """Unbiased MMD^2 estimator (diagonal terms excluded from k_xx/k_yy)."""
    m = k_xx.shape[0]
    n = k_yy.shape[0]
    if m < 2 or n < 2:
        raise ValueError("need >=2 samples per side for the unbiased estimator")
    sum_xx = (k_xx.sum() - np.trace(k_xx)) / (m * (m - 1))
    sum_yy = (k_yy.sum() - np.trace(k_yy)) / (n * (n - 1))
    return float(sum_xx + sum_yy - 2.0 * k_xy.mean())


def kernel_distance(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    subset_size: int = 1000,
    n_subsets: int = 100,
    seed: int = 0,
    degree: int = 3,
    gamma: Optional[float] = None,
    coef: float = 1.0,
) -> Tuple[float, float]:
    """KID mean and standard deviation over random equal-size subsets.

    Subsets are drawn without replacement (torchmetrics semantics);
    ``subset_size`` is clamped to the smaller side so small evaluation budgets
    still work (then with fewer effectively-distinct subsets).
    """
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"feature shapes mismatch: {real.shape} vs {fake.shape}")
    m = min(subset_size, len(real), len(fake))
    rng = np.random.default_rng(seed)
    vals = np.empty(n_subsets, np.float64)
    for i in range(n_subsets):
        r = real[rng.choice(len(real), m, replace=False)]
        f = fake[rng.choice(len(fake), m, replace=False)]
        vals[i] = mmd2_unbiased(
            polynomial_kernel(r, r, degree, gamma, coef),
            polynomial_kernel(f, f, degree, gamma, coef),
            polynomial_kernel(r, f, degree, gamma, coef),
        )
    return float(vals.mean()), float(vals.std())


# ---------------------------------------------------------------------------
# Inception Score
# ---------------------------------------------------------------------------


def inception_score(logits: np.ndarray, splits: int = 10) -> Tuple[float, float]:
    """IS = exp(E_x KL(p(y|x) || p(y))) from classifier logits (Salimans et
    al. 2016), mean/std over ``splits`` chunks.  Needs a classifier head —
    the InceptionV3 port keeps torchvision's ``fc`` (models/inception.py:
    apply_fc); the reference never computes IS, this is a beyond-reference
    metric.  Bounds: 1 (all samples one class, or uniform p(y|x)) to
    #classes (confident AND uniformly diverse)."""
    logits = np.asarray(logits, np.float64)
    if logits.ndim != 2:
        raise ValueError(f"expected (N, classes) logits, got {logits.shape}")
    # Stable softmax.
    z = logits - logits.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    scores = []
    for chunk in np.array_split(p, min(splits, len(p))):
        marginal = chunk.mean(axis=0, keepdims=True)
        kl = (chunk * (np.log(chunk + 1e-16) - np.log(marginal + 1e-16))).sum(axis=1)
        scores.append(float(np.exp(kl.mean())))
    return float(np.mean(scores)), float(np.std(scores))


# ---------------------------------------------------------------------------
# Improved precision / recall (k-NN manifold estimate)
# ---------------------------------------------------------------------------


def _sq_dists_chunked(a: np.ndarray, b: np.ndarray, chunk: int) -> Iterator[np.ndarray]:
    """Yield rows of the (len(a), len(b)) squared-distance matrix, ``chunk``
    a-rows at a time — memory stays O(chunk * len(b))."""
    bb = np.sum(b * b, axis=1)[None, :]
    for i in range(0, len(a), chunk):
        ac = a[i:i + chunk]
        aa = np.sum(ac * ac, axis=1)[:, None]
        yield np.maximum(aa + bb - 2.0 * (ac @ b.T), 0.0)


def _knn_radii(feats: np.ndarray, k: int, chunk: int) -> np.ndarray:
    """Squared distance to each point's k-th nearest OTHER point."""
    n = len(feats)
    if k >= n:
        raise ValueError(f"k={k} needs more than k+1 samples, got {n}")
    radii = np.empty(n, np.float64)
    row0 = 0
    for d2 in _sq_dists_chunked(feats, feats, chunk):
        rows = d2.shape[0]
        # Self-distance is 0 and occupies sort position 0; the k-th neighbour
        # (excluding self) is therefore sort position k.
        part = np.partition(d2, k, axis=1)[:, k]
        radii[row0:row0 + rows] = part
        row0 += rows
    return radii


def _fraction_covered(points: np.ndarray, manifold: np.ndarray,
                      radii: np.ndarray, chunk: int) -> float:
    """Fraction of ``points`` lying within at least one manifold ball."""
    covered = 0
    for d2 in _sq_dists_chunked(points, manifold, chunk):
        covered += int(np.any(d2 <= radii[None, :], axis=1).sum())
    return covered / len(points)


def precision_recall(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    k: int = 3,
    chunk: int = 1024,
) -> Tuple[float, float]:
    """Improved precision/recall (Kynkaanniemi et al. 2019), k-NN manifolds.

    precision: fraction of fake features within the real manifold (union of
    balls around each real point with radius = its k-th-NN distance);
    recall: fraction of real features within the fake manifold.
    """
    real = np.asarray(real_feats, np.float64)
    fake = np.asarray(fake_feats, np.float64)
    if real.ndim != 2 or fake.ndim != 2 or real.shape[1] != fake.shape[1]:
        raise ValueError(f"feature shapes mismatch: {real.shape} vs {fake.shape}")
    real_radii = _knn_radii(real, k, chunk)
    fake_radii = _knn_radii(fake, k, chunk)
    precision = _fraction_covered(fake, real, real_radii, chunk)
    recall = _fraction_covered(real, fake, fake_radii, chunk)
    return precision, recall


# ---------------------------------------------------------------------------
# Feature collection + one-call evaluation summary
# ---------------------------------------------------------------------------


def collect_features(
    extractor: Callable[[np.ndarray], np.ndarray],
    batches: Iterator[np.ndarray],
    num_samples: int,
) -> np.ndarray:
    """Run ``extractor`` over uint8 (or [-1,1] float) batches, up to
    ``num_samples`` rows.  Returns (n, D) float64."""
    feats = []
    seen = 0
    for b in batches:
        b = np.asarray(b)
        if b.dtype != np.uint8:
            b = to_uint8(b)
        take = min(len(b), num_samples - seen)
        if take <= 0:
            break
        feats.append(np.asarray(extractor(b[:take]), np.float64))
        seen += take
        if seen >= num_samples:
            break
    if not feats:
        raise ValueError("no batches provided")
    return np.concatenate(feats, 0)


def evaluate_generative_metrics(
    real_feats: np.ndarray,
    fake_feats: np.ndarray,
    kid_subset_size: int = 1000,
    kid_subsets: int = 100,
    pr_k: int = 3,
    seed: int = 0,
) -> dict:
    """FID + KID + precision/recall from two feature arrays — the full
    standard evaluation triple in one call."""
    rs = FeatureStats(real_feats.shape[1])
    fs = FeatureStats(fake_feats.shape[1])
    rs.update(real_feats)
    fs.update(fake_feats)
    fid = frechet_distance(*rs.moments(), *fs.moments())
    kid_mean, kid_std = kernel_distance(real_feats, fake_feats,
                                        subset_size=kid_subset_size,
                                        n_subsets=kid_subsets, seed=seed)
    precision, recall = precision_recall(real_feats, fake_feats, k=pr_k)
    return {
        "fid": fid,
        "kid_mean": kid_mean,
        "kid_std": kid_std,
        "precision": precision,
        "recall": recall,
        "num_real": int(len(real_feats)),
        "num_fake": int(len(fake_feats)),
    }
