"""The mesh and the vectorized trials on the card (marked ``cuda``; each test
skips where torch.cuda.is_available() is False):

- a world-1 NCCL group (FileStore under tmp_path): three captured steps of
  make_device_data_train_fn under the mesh bit-equal to three without it,
  the group's all-reduces inside the graph;
- a vectorized group of two trials: each slot within 1e-5 of its own
  one-trial group (no slot reads another's stream).

    python -m pytest --noconftest tests/test_torch_parallel_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train import step as S
from vitgan_tpu_torch.train.sample import latent_block
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.trainer import Trainer
from vitgan_tpu_torch.train.vstep import TrialGroup


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL and the captured step run there")


def _tensors(st):
    sd = st.state_dict()
    out = [*sd["g"].values(), *sd["d"].values()]
    for opt in ("g_opt", "d_opt"):
        for entry in sd[opt]["state"].values():
            out.extend(entry.values())
    return out


@pytest.mark.cuda
def test_a_world_one_nccl_mesh_captures_the_same_steps(tmp_path):
    _cuda_or_skip()
    import torch.distributed as dist

    from vitgan_tpu_torch.parallel.mesh import make_mesh

    cfg = C.replace(C.smoke_config(), **{"data.synthetic_samples": 64,
                                         "run.steps_per_epoch": None,
                                         "run.diff_augment": "color,translation"})

    def run(name, mesh):
        t = Trainer(cfg, run_dir=str(tmp_path / name), device="cuda", mesh=mesh)
        idx = t.batches()[:3]
        lat = latent_block(t.gan, t.state.seed, 0, 3, 8, 1)
        fn = S.make_device_data_train_fn(t.gan, cfg, 3, **({"mesh": mesh} if mesh else {}))
        m = fn(t.state, t.dataset, idx, lat)  # the first step eager, its capture, 2 replays
        return [x.clone() for x in _tensors(t.state)], {k: v.clone() for k, v in m.items()}

    want, want_m = run("none", None)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(cfg.mesh)
        assert mesh.distributed
        got, got_m = run("dp", mesh)
    finally:
        dist.destroy_process_group()
    for k in want_m:
        assert torch.equal(got_m[k], want_m[k]), k
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_a_vectorized_group_on_the_card():
    _cuda_or_skip()
    cfg = C.replace(C.smoke_config(), **{"v2.gen_optim.inject_lr": True,
                                         "v2.disc_optim.inject_lr": True,
                                         "runtime.compute_dtype": "float32"})
    policy.set_policy(mode="never")
    gan = build_gan(cfg)

    def state(stream):
        st = create_train_state(gan, cfg, device="cuda")
        st.rng.manual_seed(stream)
        return st

    real = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3))
                            .astype(np.float32))
    pair = TrialGroup(gan, cfg, [state(5), state(6)], [3e-4, 1e-4], [2e-4, 2e-4])
    m2 = pair.step(real)
    for slot, (stream, lr) in enumerate(((5, 3e-4), (6, 1e-4))):
        one = TrialGroup(gan, cfg, [state(stream)], [lr], [2e-4])
        m1 = one.step(real)
        for k in m1:
            np.testing.assert_allclose(m2[k][slot].item(), m1[k][0].item(), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        got = dict(pair.states[slot].g.named_parameters())
        for n, t in one.states[0].g.named_parameters():
            np.testing.assert_allclose(got[n].detach().cpu().numpy(), t.detach().cpu().numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=n)
