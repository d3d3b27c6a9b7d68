"""The evaluation slice on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is False):

- the port's InceptionV3 at 299 px on the card against the same module on
  the CPU, features and logits within 1e-3 * max(max|CPU|, 1);
- the TF32 guard: with the process's TF32 switches on, inception_features
  still holds to the CPU within 1e-4 * max(max|CPU|, 1)
  (models/inception.full_f32), and the same forward with TF32 left on
  misses that bar, so it tells the two apart (on an H100, TF32 drifts to
  ~5e-4 of max|CPU| over the 94 layers, within the parity bar of 1e-3;
  true f32 to ~4e-7);
- the random-conv extractor on the card against the CPU within 1e-4;
- the on-device FID (make_on_device_fid) against the host's FeatureStats on
  the same features, rtol 1e-3, atol 1e-4, with a captured train step
  replayed before and after it: the captured step's tensors and the next
  replay are as without the FID.

    python -m pytest --noconftest tests/test_torch_eval_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.data.datasets import synthetic_dataset
from vitgan_tpu_torch.models import inception as I
from vitgan_tpu_torch.train import fid as F

TOL, GUARD_TOL = 1e-3, 1e-4


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="module")
def nets():
    params = I.convert_torch_state_dict(I.random_torch_state_dict(0))
    return I.InceptionV3.from_params(params, "cpu"), params


def _err(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()), tol * max(1.0, float(np.abs(want).max()))


def _images(n=4, size=128, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.mark.cuda
def test_inception_on_card_matches_cpu(nets):
    _cuda_or_skip()
    cpu, params = nets
    card = I.InceptionV3.from_params(params, "cuda")
    x = torch.from_numpy(_images())
    for fn in (I.inception_features, I.inception_logits):
        err, bar = _err(fn(card, x.cuda()).cpu(), fn(cpu, x))
        assert err <= bar, (fn.__name__, err, bar)


@pytest.mark.cuda
def test_tf32_guard(nets):
    _cuda_or_skip()
    cpu, params = nets
    card = I.InceptionV3.from_params(params, "cuda")
    x = torch.from_numpy(_images(seed=1))
    want = I.inception_features(cpu, x)
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        guarded, bar = _err(I.inception_features(card, x.cuda()).cpu(), want, GUARD_TOL)
        with torch.inference_mode():
            tf32, _ = _err(card(I.preprocess(x.cuda())).cpu(), want)
        assert torch.backends.cudnn.allow_tf32  # the guard restored the switch
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert guarded <= bar < tf32, (guarded, bar, tf32)


@pytest.mark.cuda
def test_random_conv_on_card_matches_cpu():
    _cuda_or_skip()
    imgs = _images(16, 32)
    want = F.make_random_conv_extractor(device="cpu")(imgs)
    got = F.make_random_conv_extractor(device="cuda")(imgs)
    err = float(np.abs(got - want).max())
    assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err


class _Fixed(torch.nn.Module):
    def __init__(self, imgs):
        super().__init__()
        self.imgs = imgs

    def forward(self, z):
        return self.imgs[: z.shape[0]]


class _Bundle:
    def sample_latent(self, rng, n):
        return torch.from_numpy(rng.standard_normal((n, 4), np.float32))


@pytest.mark.cuda
def test_on_device_moments_match_the_host_between_replays(tmp_path):
    _cuda_or_skip()
    from vitgan_tpu_torch.train.trainer import Trainer

    b, n_batches = 16, 3
    dataset, _ = synthetic_dataset(64, 32, 3, seed=0)
    fake = np.random.default_rng(2).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    real_idx = np.random.default_rng(3).choice(64, size=(n_batches, b), replace=False)
    ex = F.make_random_conv_extractor(device="cuda")
    fid_fn = F.make_on_device_fid(_Bundle(), C.smoke_config(), ex.feature_fn, b, n_batches,
                                  ex.feature_dim)
    rs, fs = F.FeatureStats(512), F.FeatureStats(512)
    for row in real_idx:
        rs.update(ex(dataset[row]))
        fs.update(ex(F.to_uint8(fake)))
    want = F.frechet_distance(*rs.moments(), *fs.moments())

    # the FID between the replays of a captured step leaves the training alone
    cfg = C.replace(C.smoke_config(), **{"data.synthetic_samples": 64, "run.ema_decay": 0.9,
                                         "run.steps_per_epoch": 2, "run.fid_every_epochs": 0,
                                         "run.sample_grid_every_epochs": 0})
    runs = []
    for with_fid in (True, False):
        t = Trainer(cfg, run_dir=str(tmp_path / str(with_fid)), device="cuda")
        t.fit(epochs=1)  # the capture
        if with_fid:
            got = fid_fn(_Fixed(torch.from_numpy(fake).cuda()),
                         torch.from_numpy(dataset).cuda(), real_idx, 0)
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
            t.evaluate_fid()
        t.fit(epochs=2)  # replays
        runs.append(t.state.state_dict())
    a, b_ = runs
    for net in ("g", "d"):
        for k in a[net]:
            assert torch.equal(a[net][k], b_[net][k]), (net, k)
    assert all(torch.equal(x, y) for x, y in zip(a["g_ema"], b_["g_ema"]))
