"""The port's FID (vitgan_tpu_torch/train/fid.py) against the JAX package's
(vitgan_tpu/train/fid.py) on the CPU: the analytic Frechet cases, the
streaming moments, the random-conv features with the JAX weights carried
across (at 32 px, where "SAME" pads 0 before and 1 after, and at 17 px, where
it pads 1 and 1), to_uint8, make_on_device_fid with a fake generator on the
same pixels, compute_fid with one deterministic sampler, and the extractor
choices.

Tolerances: Frechet and moments 1e-9 relative (both f64 numpy); random-conv
features within 1e-4 * max(max|JAX|, 1) (f32 on both sides); the FIDs
rtol 1e-3, atol 1e-4 (tests/test_on_device_fid.py:27-54)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import inception as JI
from vitgan_tpu.train import fid as JF
from vitgan_tpu_torch import cli
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import inception as I
from vitgan_tpu_torch.train import fid as F
from vitgan_tpu_torch.weights import random_conv_from_jax

torch.set_num_threads(1)

CONV_TOL = 1e-4


@pytest.fixture(scope="module")
def jax_conv_params():
    return [np.asarray(w) for w in JF._random_conv_params(jax.random.PRNGKey(42), 3)]


# (mu1, cov1, mu2, cov2, want): tests/test_fid_and_ckpt.py's analytic cases
FRECHET = {
    "identical": ([1.0, 2.0], [[2.0, 0.3], [0.3, 1.0]], [1.0, 2.0], [[2.0, 0.3], [0.3, 1.0]],
                  0.0),
    "mean_shift": (np.zeros(3), np.eye(3), [1.0, 2.0, 2.0], np.eye(3), 9.0),
    "diagonal": ([0.0], [[4.0]], [1.0], [[1.0]], 1.0 + (2.0 - 1.0) ** 2),
}


@pytest.mark.parametrize("case", sorted(FRECHET))
def test_frechet_analytic(case):
    mu1, cov1, mu2, cov2, want = FRECHET[case]
    got = F.frechet_distance(mu1, cov1, mu2, cov2)
    assert got == pytest.approx(want, rel=1e-9, abs=1e-8)
    assert got == pytest.approx(JF.frechet_distance(mu1, cov1, mu2, cov2), rel=1e-9, abs=1e-12)


def test_feature_stats_match_jax():
    data = np.random.default_rng(0).normal(size=(100, 6))
    ours, theirs = F.FeatureStats(6), JF.FeatureStats(6)
    for chunk in np.array_split(data, 7):
        ours.update(chunk)
        theirs.update(chunk)
    for a, b in zip(ours.moments(), theirs.moments()):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    np.testing.assert_allclose(ours.moments()[1], np.cov(data, rowvar=False), rtol=1e-8)
    with pytest.raises(ValueError):
        F.FeatureStats(2).moments()


@pytest.mark.parametrize("size,pad", [(32, (0, 1)), (17, (1, 1))])
def test_random_conv_matches_jax_with_carried_weights(jax_conv_params, size, pad):
    assert F._same_pad(size) == pad
    imgs = np.random.default_rng(size).integers(0, 256, (4, size, size, 3), dtype=np.uint8)
    want = np.asarray(JF.random_conv_features(jax_conv_params, jnp.asarray(imgs), 512))
    got = F.make_random_conv_extractor(device="cpu", params=jax_conv_params)(imgs)
    assert got.shape == want.shape == (4, 512) and got.dtype == np.float32
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= CONV_TOL * max(scale, 1.0), (err, scale)


def test_random_conv_weights_are_the_ports_own_draw(jax_conv_params):
    ours = F.random_conv_params(3, 42)
    assert [w.shape for w in ours] == [w.shape for w in jax_conv_params]
    np.testing.assert_array_equal(ours[2], F.random_conv_params(3, 42)[2])  # seeded
    for w, c_in in zip(ours, (3, 64, 128, 256)):  # He-normal
        assert abs(float(w.std()) / np.sqrt(2.0 / (9 * c_in)) - 1.0) < 0.1
    oihw = random_conv_from_jax(ours)
    assert [tuple(w.shape) for w in oihw] == [(64, 3, 3, 3), (128, 64, 3, 3), (256, 128, 3, 3),
                                              (512, 256, 3, 3)]


def test_to_uint8_is_bit_equal():
    x = np.random.default_rng(5).uniform(-1.2, 1.2, (3, 8, 8, 3)).astype(np.float32)
    x[0, 0, 0] = [-1.0, 0.0, 1.0]
    x[0, 0, 1] = [127.5 / 127.5 - 1.0, 0.5 / 127.5 - 1.0, 2.5 / 127.5 - 1.0]  # ties
    np.testing.assert_array_equal(F.to_uint8(x), JF.to_uint8(x))
    np.testing.assert_array_equal(F.to_uint8(x)[0, 0, 0], [0, 128, 255])


class _FixedGenerator(torch.nn.Module):
    """Always the same images (B, H, W, C) in [-1, 1], whatever z."""

    def __init__(self, imgs):
        super().__init__()
        self.imgs = torch.from_numpy(imgs)

    def forward(self, z):
        return self.imgs[: z.shape[0]]


class _PortBundle:
    latent_dim = 4

    def sample_latent(self, rng, n):
        return torch.from_numpy(rng.standard_normal((n, 4), np.float32))


class _JaxBundle:
    def __init__(self, imgs):
        self.fixed = jnp.asarray(imgs)

    def sample_latent(self, rng, n):
        return jnp.zeros((n, 4), jnp.float32)

    def generator_apply(self, g_vars, z, **kw):
        return self.fixed[: z.shape[0]], {}


def test_on_device_fid_matches_jax(jax_conv_params):
    b, n_batches, dim = 8, 2, 64
    rng = np.random.default_rng(0)
    dataset = rng.integers(0, 256, (64, 16, 16, 3), dtype=np.uint8)
    fake = rng.uniform(-1, 1, (b, 16, 16, 3)).astype(np.float32)
    real_idx = rng.choice(64, size=(n_batches, b), replace=False)
    cfg = C.replace(C.smoke_config(), **{"runtime.compute_dtype": "float32"})
    ex = F.make_random_conv_extractor(device="cpu", params=jax_conv_params, feature_dim=dim)
    fid_fn = F.make_on_device_fid(_PortBundle(), cfg, ex.feature_fn, b, n_batches, dim)
    spans = {}
    got = fid_fn(_FixedGenerator(fake), torch.from_numpy(dataset), real_idx, 0, spans)
    assert set(spans) == {"features", "generator", "frechet"}
    jfid = JF.make_on_device_fid(_JaxBundle(fake), JC.smoke_config("mlp"), jax_conv_params, b,
                                 n_batches, feature_dim=dim)
    want = jfid({}, jax.device_put(dataset), jnp.asarray(real_idx.astype(np.int32)),
                jax.random.PRNGKey(0))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError):
        fid_fn(_FixedGenerator(fake), torch.from_numpy(dataset), real_idx[:1], 0)


def test_compute_fid_matches_jax(jax_conv_params):
    rng = np.random.default_rng(1)
    real = rng.integers(60, 200, (3, 8, 16, 16, 3), dtype=np.uint8)
    fake = rng.uniform(-1, 1, (8, 16, 16, 3)).astype(np.float32)
    ex = F.make_random_conv_extractor(device="cpu", params=jax_conv_params)
    calls = []

    def sample(r, n):  # deterministic: the same pixels whatever the generator
        calls.append(r)
        return fake[:n]

    got = F.compute_fid(sample, iter(real), ex, 0, num_samples=20, batch_size=8)
    jex = JF.make_random_conv_extractor(3, seed=42)
    want = JF.compute_fid(lambda k, n: fake[:n], iter(real), jex, jax.random.PRNGKey(0),
                          num_samples=20, batch_size=8)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    assert len(calls) == 3 and all(isinstance(r, np.random.Generator) for r in calls)


def test_extractor_choices(tmp_path, monkeypatch, caplog):
    assert F.EXTRACTORS == cli.EXTRACTORS
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    monkeypatch.setenv("SCRATCH", str(tmp_path / "no_weights_here"))
    assert F.inception_weights_path() is None
    with caplog.at_level(logging.INFO, logger=F.__name__):
        ex = F.make_feature_extractor("auto", device="cpu")
    assert ex.name == "random_conv" and ex.feature_dim == 512 and ex.logits_fn is None
    assert "took random_conv" in caplog.text
    with pytest.raises(FileNotFoundError):
        F.make_feature_extractor("inception_jax", device="cpu")
    with pytest.raises(ValueError):
        F.make_feature_extractor("nope", device="cpu")
    # the JAX package's .npz through $INCEPTION_WEIGHTS: the port's Inception
    path = str(tmp_path / "fid_inception.npz")
    JI.save_params(path, JI.convert_torch_state_dict(JI.random_torch_state_dict(2)))
    monkeypatch.setenv("INCEPTION_WEIGHTS", path)
    assert F.inception_weights_path() == path
    for name in ("auto", "inception", "inception_jax"):
        ex = F.make_feature_extractor(name, device="cpu")
        assert ex.name == "inception" and ex.feature_dim == I.FEATURE_DIM
        assert ex.logits_fn is not None


def test_inception_torch_needs_torchvision_and_its_cached_weights(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    try:
        import torchvision  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            F.make_feature_extractor("inception_torch", device="cpu")
    else:
        with pytest.raises(FileNotFoundError):  # nothing is downloaded
            F.make_feature_extractor("inception_torch", device="cpu")


def test_inception_extractor_reads_a_torch_pth(tmp_path):
    sd = {k: torch.from_numpy(v) for k, v in I.random_torch_state_dict(4).items()}
    path = str(tmp_path / "inception.pth")
    torch.save(sd, path)
    ex = F.make_inception_extractor(path, device="cpu")
    imgs = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    jp = JI.convert_torch_state_dict(JI.random_torch_state_dict(4))
    net = I.InceptionV3.from_params(jp, "cpu")
    np.testing.assert_array_equal(ex(imgs), I.inception_features(net, torch.from_numpy(imgs)))
    np.testing.assert_array_equal(ex.logits_fn(imgs),
                                  I.inception_logits(net, torch.from_numpy(imgs)).numpy())
