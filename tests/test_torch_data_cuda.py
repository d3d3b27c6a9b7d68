"""The host pipeline on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is False):

- the pinned, side-stream prefetch delivers batches on ``cuda`` bit-equal to
  the CPU pipeline's of the same seed, flips and a partial batch included,
  each batch still intact after its pinned buffer was reused;
- the host route's captured step trains to the state the device route's
  captured step trains to from the same start (augment_flip=False).

    python -m pytest --noconftest tests/test_torch_data_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.data.pipeline import HostDataPipeline
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pipeline's pinned copies and the captured step")


@pytest.mark.cuda
def test_pinned_prefetch_delivers_bit_equal_batches():
    _cuda_or_skip()
    images = np.random.default_rng(0).integers(0, 256, (100, 16, 12, 3), dtype=np.uint8)
    labels = np.arange(100, dtype=np.int32)
    kw = dict(batch_size=16, drop_last=False, augment_flip=True, seed=4, prefetch=2)
    card = HostDataPipeline(images, labels, device="cuda", **kw)
    host = HostDataPipeline(images, labels, device="cpu", **kw)
    for _ in range(3):
        got = list(card.epoch())  # every batch kept: 7 batches through 4 pinned buffers
        want = list(host.epoch())
        torch.cuda.synchronize()
        assert len(got) == len(want) == 7 and card.stats.batches == 7
        for (gx, gy), (wx, wy) in zip(got, want):
            assert gx.device.type == "cuda" and gy.device.type == "cuda"
            assert torch.equal(gx.cpu(), wx) and torch.equal(gy.cpu(), wy)
    assert card.stats.assemble_s > 0 and card.stats.issue_s > 0
    assert len(card._slots) == 4
    assert all(s.x.is_pinned() and s.y.is_pinned() for s in card._slots)


def _tensors(trainer):
    sd = trainer.state.state_dict()
    out = {"rng": sd["rng"], **{f"g.{k}": v for k, v in sd["g"].items()},
           **{f"d.{k}": v for k, v in sd["d"].items()}}
    for opt in ("g_opt", "d_opt"):
        for i, entry in sd[opt]["state"].items():
            out.update({f"{opt}.{i}.{k}": v for k, v in entry.items()})
    return out


@pytest.mark.cuda
def test_host_route_captured_step_equals_the_device_routes(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.smoke_config(), **{
        "data.synthetic_samples": 48, "run.steps_per_epoch": None, "data.augment_flip": False,
        "run.diff_augment": "color,translation", "run.fid_every_epochs": 0,
        "run.sample_grid_every_epochs": 0})
    dev = Trainer(cfg, run_dir=str(tmp_path / "dev"), device="cuda")
    host = Trainer(C.replace(cfg, **{"data.on_device": False}), run_dir=str(tmp_path / "host"),
                   device="cuda")
    assert (dev.route, host.route) == ("device", "host")
    for t in (dev, host):
        t.fit(epochs=2)  # the first step of each function eager, then captured replays
    assert dev.state.step == host.state.step == 12
    assert dev._device_train_fn.graphs and host._host_step_fns[8].graphs
    a, b = _tensors(dev), _tensors(host)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), k
