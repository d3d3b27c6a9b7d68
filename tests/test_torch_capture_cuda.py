"""The captured multi-step on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is False, as tests/test_torch_kernels_cuda.py's):

- n captured steps of make_device_data_train_fn bit-equal to n eager
  make_train_step calls from one state, batch order, latent block and
  generator state (smoke width, dropout, DiffAugment and flips);
- a resume after a capture: the checkpoint restored in place, the next
  epoch bit-equal to an uninterrupted run's;
- the kernel launches of a replay equal an eager step's (v1 at its head
  widths, depth 1, under use_pallas=always: every attention on a flash
  kernel);
- the capturable optimizer against the CPU's;
- a step that cannot be captured raises; nothing runs eagerly in its place.

    python -m pytest --noconftest tests/test_torch_capture_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.train import step as S
from vitgan_tpu_torch.train.sample import latent_block
from vitgan_tpu_torch.train.trainer import Trainer

# The graph of a step without R1 whose G and D calls apply (no grad_accum):
# train/step.StepPlan.kind
NO_R1 = (False, True, (True,))
SMOKE = {"data.synthetic_samples": 64, "run.steps_per_epoch": None,
         "run.diff_augment": "color,translation", "data.augment_flip": True,
         "run.ema_decay": 0.9, "run.sample_grid_every_epochs": 0}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the step is captured as a CUDA graph")


def _state_tensors(st):
    sd = st.state_dict()
    out = [sd["rng"], *sd["g"].values(), *sd["d"].values(), *(sd["g_ema"] or ())]
    for opt in ("g_opt", "d_opt"):
        for entry in sd[opt]["state"].values():
            out.extend(entry.values())
    return out


@pytest.mark.cuda
def test_captured_steps_equal_eager_steps(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.smoke_config(), **SMOKE)
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cuda")
    st, n = t.state, 3
    order = t.batches()
    t.train_step(st, t.real_batch(order[0]))  # the optimizer's state exists
    idx = order[1:1 + n]
    lat = latent_block(t.gan, st.seed, st.step, n, 8, 1)
    start = st.state_dict()
    fn = S.make_device_data_train_fn(t.gan, cfg, n)
    fn(st, t.dataset, idx, lat)  # the first step eager, its capture, 2 replays
    st.load_state_dict(start)
    eager = [t.train_step(st, t.real_batch(idx[i]), z=torch.from_numpy(lat[i, 0]))
             for i in range(n)]
    want = [x.clone() for x in _state_tensors(st)]
    st.load_state_dict(start)
    got = fn(st, t.dataset, idx, lat)  # 3 replays
    for k in got:
        assert torch.equal(got[k], torch.stack([e[k] for e in eager])), k
    for x, y in zip(_state_tensors(st), want):
        assert torch.equal(x, y)
    assert list(fn.graphs) == [NO_R1]


@pytest.mark.cuda
def test_resume_after_a_capture(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.smoke_config(), **{**SMOKE, "run.steps_per_epoch": 2,
                                         "run.checkpoint_every_epochs": 1})
    a = Trainer(cfg, run_dir=str(tmp_path / "a"), device="cuda")
    a.fit(epochs=3)
    b = Trainer(cfg, run_dir=str(tmp_path / "b"), device="cuda")
    b.fit(epochs=2)
    b.resume(step=2)  # back one epoch, in place, over the captured state
    assert b.epoch == 1 and b.state.step == 2
    b.fit(epochs=3)
    for x, y in zip(_state_tensors(a.state), _state_tensors(b.state)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_replay_launches_equal_an_eager_steps(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.ExperimentConfig(family="v1"), **{  # v1's head widths, depth 1
        "data.dataset": "synthetic", "data.synthetic_samples": 128, "v1.batch_size": 16,
        "v1.generator.depth": 1, "v1.discriminator.depth": 1, "runtime.use_pallas": "always"})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cuda")
    order = t.batches()
    t.train_step(t.state, t.real_batch(order[0]))
    build.reset_launches()
    t.train_step(t.state, t.real_batch(order[1]))
    eager = {k: v for k, v in build.LAUNCHES.items() if v}
    assert eager.get("flash_attn_fwd[l2]", 0) > 0
    fn = S.make_device_data_train_fn(t.gan, cfg, 3)
    build.reset_launches()
    fn(t.state, t.dataset, order[2:5])  # one eager step, its capture, 2 replays
    assert fn.graphs[NO_R1][1] == eager
    got = {k: v for k, v in build.LAUNCHES.items() if v}
    assert got == {k: 3 * v for k, v in eager.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_capturable_optimizer_matches_the_cpu_one(name):
    """The card's update (device rate, foreach clip; fused AdamW or foreach
    SGD) against the CPU's over 3 updates that clip on some and not others."""
    _cuda_or_skip()
    from vitgan_tpu_torch.train.state import Optimizer

    cfg = C.OptimConfig(name=name, learning_rate=1e-2, grad_clip=1.0, weight_decay=1e-2)
    rng = np.random.default_rng(0)
    init = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    params = {dev: [torch.nn.Parameter(torch.from_numpy(p.copy()).to(dev)) for p in init]
              for dev in ("cpu", "cuda")}
    opts = {dev: Optimizer(cfg, ps) for dev, ps in params.items()}
    assert opts["cuda"].rate is not None and opts["cpu"].rate is None
    for scale in (0.05, 1.0, 0.2):
        grads = [(scale * rng.standard_normal(p.shape)).astype(np.float32) for p in init]
        for dev, ps in params.items():
            for p, g in zip(ps, grads):
                p.grad = torch.from_numpy(g).to(dev)
            opts[dev].step()
        for a, b in zip(params["cpu"], params["cuda"]):
            torch.testing.assert_close(b.detach().cpu(), a.detach(), rtol=1e-6, atol=1e-6)


# A failed capture leaves the process's CUDA generators mid-capture (torch
# runs their capture epilogue only on a capture that ends well), so the
# failing capture runs in a process of its own.
_UNCAPTURABLE = r"""
import numpy as np, torch
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.train import step as S
from vitgan_tpu_torch.train.trainer import Trainer
real_core = S._make_core

def syncing_core(gan, cfg, mesh=None):
    core = real_core(gan, cfg, mesh)

    def run(state, real, *a):
        real.sum().item()  # a host sync: refused inside a capture
        return core(state, real, *a)
    return run

S._make_core = syncing_core
cfg = C.replace(C.smoke_config(), **{"data.synthetic_samples": 64})
t = Trainer(cfg, run_dir=RUN_DIR, device="cuda")
fn = S.make_device_data_train_fn(t.gan, cfg, 2)
try:
    fn(t.state, t.dataset, np.stack([np.arange(8), np.arange(8, 16)]))
except RuntimeError as e:
    print("RAISED", "could not be captured" in str(e), len(fn.graphs), t.state.step)
"""


@pytest.mark.cuda
def test_a_step_that_cannot_be_captured_raises(tmp_path):
    _cuda_or_skip()
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = _UNCAPTURABLE.replace("RUN_DIR", repr(str(tmp_path / "run")))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    # the first step ran eagerly (the warm-up), then its capture raised
    assert out.stdout.strip().splitlines()[-1] == "RAISED True 0 0"
