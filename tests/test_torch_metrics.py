"""The port's KID, precision/recall, Inception Score, collect_features and
evaluate_generative_metrics (vitgan_tpu_torch/train/metrics.py) against the
JAX package's (vitgan_tpu/train/metrics.py) on the same float64 features,
each within 1e-9 relative: both are host numpy."""

import numpy as np
import pytest

from vitgan_tpu.train import metrics as JM
from vitgan_tpu_torch.train import metrics as M

RTOL = 1e-9


@pytest.fixture(scope="module")
def feats():
    rng = np.random.default_rng(0)
    real = rng.normal(size=(96, 16))
    fake = rng.normal(0.3, 1.2, size=(80, 16))
    return real, fake


def test_polynomial_kernel_and_mmd_match_jax(feats):
    real, fake = feats
    for gamma in (None, 0.5):
        np.testing.assert_allclose(M.polynomial_kernel(real, fake, 3, gamma),
                                   JM.polynomial_kernel(real, fake, 3, gamma), rtol=RTOL)
    k = [M.polynomial_kernel(a, b) for a, b in ((real, real), (fake, fake), (real, fake))]
    assert M.mmd2_unbiased(*k) == pytest.approx(JM.mmd2_unbiased(*k), rel=RTOL)


@pytest.mark.parametrize("subset_size,n_subsets", [(32, 5), (1000, 3)])
def test_kid_matches_jax(feats, subset_size, n_subsets):
    real, fake = feats
    got = M.kernel_distance(real, fake, subset_size=subset_size, n_subsets=n_subsets, seed=3)
    want = JM.kernel_distance(real, fake, subset_size=subset_size, n_subsets=n_subsets, seed=3)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    with pytest.raises(ValueError):
        M.kernel_distance(real, fake[:, :8])


@pytest.mark.parametrize("chunk", [7, 1024])  # chunked and in one block
@pytest.mark.parametrize("k", [1, 3])
def test_precision_recall_match_jax(feats, chunk, k):
    real, fake = feats
    got = M.precision_recall(real, fake, k=k, chunk=chunk)
    assert got == JM.precision_recall(real, fake, k=k, chunk=chunk)
    assert got == M.precision_recall(real, fake, k=k, chunk=10_000)
    np.testing.assert_allclose(M._knn_radii(real, k, chunk), JM._knn_radii(real, k, chunk),
                               rtol=RTOL)


@pytest.mark.parametrize("splits", [1, 4, 10])
def test_inception_score_matches_jax(splits):
    logits = np.random.default_rng(1).normal(0, 3, size=(60, 10))
    np.testing.assert_allclose(M.inception_score(logits, splits),
                               JM.inception_score(logits, splits), rtol=RTOL)
    assert M.inception_score(np.zeros((20, 10)), 2)[0] == pytest.approx(1.0, abs=1e-9)


def test_collect_features_matches_jax():
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, (8, 4, 4, 3), dtype=np.uint8) for _ in range(3)]
    batches.append(rng.uniform(-1, 1, (8, 4, 4, 3)).astype(np.float32))  # [-1, 1] floats

    def extractor(u8):
        assert u8.dtype == np.uint8
        return u8.reshape(len(u8), -1)[:, :5].astype(np.float32) / 7.0

    for n in (5, 20, 32):
        got = M.collect_features(extractor, iter(batches), n)
        np.testing.assert_allclose(got, JM.collect_features(extractor, iter(batches), n),
                                   rtol=RTOL)
        assert got.shape == (n, 5) and got.dtype == np.float64
    with pytest.raises(ValueError):
        M.collect_features(extractor, iter([]), 4)


def test_evaluate_generative_metrics_matches_jax(feats):
    real, fake = feats
    kw = dict(kid_subset_size=40, kid_subsets=6, pr_k=3, seed=1)
    got = M.evaluate_generative_metrics(real, fake, **kw)
    want = JM.evaluate_generative_metrics(real, fake, **kw)
    assert list(got) == list(want)
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=RTOL, abs=1e-12), key
