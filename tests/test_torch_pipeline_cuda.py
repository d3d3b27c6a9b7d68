"""The pipelined stacks on the card (marked ``cuda``; each test skips where
torch.cuda.is_available() is False), chip_smoke.py's ``[pipeline]`` checks at
depth 2:

- a one-stage pipe (parallel/pipeline.pp_bundle) at M = 2 through the
  trainer's step at highres128's widths: the G and D forwards bit-equal to
  the unpipelined ones; one eager step's gradients within GRAD_RTOL of each
  leaf's largest magnitude (the microbatches' parameter gradients sum in
  another order; chip_smoke.py read 1.64e-2 and 1.37e-2 at depth 12, M = 2
  and 4) and its metrics at chip_smoke.py's LOSS_TOL and NORM_RTOL; then the
  trainer's captured step, every kernel launched twice a step at half the
  rows, its epoch's mean metrics at the same bounds.  The parameters' drift
  after the epoch is printed beside twice Adam's reach, a reading and not a
  check: two Adam runs from one start stay within that reach whatever their
  gradients;
- the megablock's in-kernel dropout bits of each microbatch equal to the
  whole batch's rows.

    python -m pytest --noconftest tests/test_torch_pipeline_cuda.py -q -s
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.ops import build, draws, policy
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.parallel.mesh import Mesh
from vitgan_tpu_torch.train.step import host_metrics
from vitgan_tpu_torch.train.trainer import Trainer


LOSS_TOL, NORM_RTOL = 2e-2, 5e-2  # chip_smoke.py's route bounds
GRAD_RTOL = 5e-2


def _held_metrics(got: dict, want: dict, what: str):
    for k, v in want.items():
        bound = NORM_RTOL * abs(v) if k.endswith("grad_norm") else LOSS_TOL
        assert abs(got[k] - v) <= bound, (what, k, got[k], v)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels and the captured step run there")


def _one_stage():
    return Mesh({"data": 1, "model": 1, "pipe": 1}, axis_names=("data", "model", "pipe"),
                pipe_axis="pipe")


@pytest.mark.cuda
def test_a_microbatch_keys_its_dropout_bits_by_the_batch_rows():
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, e, b, m = 256, 384, 8, 4
    x = torch.randn((b * n, e), device="cuda", generator=gen).to(torch.bfloat16)
    w = torch.randn((e, e), device="cuda", generator=gen) * e ** -0.5
    bias = torch.zeros(e, device="cuda")
    seed = torch.tensor([42], dtype=torch.int64, device="cuda")
    _, whole = FM.linear_stage(x, w, bias, x, seed, 0.1, 1)
    mb = b // m
    for j in range(m):
        rows = slice(j * mb * n, (j + 1) * mb * n)
        with draws.microbatch(j * mb, b):
            key = FB.mask_rows(mb, n)
        _, mine = FM.linear_stage(x[rows], w, bias, x[rows], seed, 0.1, 1, key)
        assert torch.equal(mine, whole[rows])


@pytest.mark.cuda
def test_a_one_stage_pipe_launches_every_kernel_per_microbatch(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.highres_config(128), **{
        "v2.depth": 2, "data.dataset": "synthetic", "data.synthetic_samples": 64,
        "run.steps_per_epoch": 2, "run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
        "run.checkpoint_every_epochs": 0, "run.log_every_steps": 0})

    def run(name, mesh):
        t = Trainer(cfg, run_dir=str(tmp_path / name), device="cuda", mesh=mesh)
        z = t.gan.sample_latent(np.random.default_rng(5), cfg.model.batch_size)
        with torch.inference_mode():
            imgs = t.state.g(z.to("cuda", torch.bfloat16))
            fwd = (imgs.float().cpu(), t.gan.discriminator_apply(t.state.d, imgs).float().cpu())
        # one eager step on the first batch: each parameter's gradient (G's
        # from the G update, D's from the D update); the start state restored
        start = t.state.state_dict()
        one = host_metrics(t.train_step(t.state, t.real_batch(np.arange(cfg.model.batch_size))))
        grads = {f"{net}.{k}": p.grad.detach().float().cpu().clone()
                 for net in ("g", "d") for k, p in getattr(t.state, net).named_parameters()}
        t.state.load_state_dict(start)
        means = t.fit(epochs=1)  # the capture
        fn, idx = t._device_train_fn, t._local(t.batches())
        build.reset_launches()
        host_metrics({"d": fn(t.state, t.dataset, idx)["d_loss"].mean()})
        per_step = {k: v // len(idx) for k, v in build.LAUNCHES.items() if v}
        return fwd, grads, one, means, per_step, t.state.state_dict()

    fwd0, grads0, one0, means0, launches0, sd0 = run("none", None)
    fwd2, grads2, one2, means2, launches2, sd2 = run("pipe", _one_stage())
    assert launches0 and set(launches2) == set(launches0)
    for k, v in launches0.items():
        assert launches2[k] == 2 * v, k
    for a, b in zip(fwd2, fwd0):
        assert torch.equal(a, b)
    rel = {}
    for k, w in grads0.items():
        scale = w.abs().max().item()
        rel[k] = (grads2[k] - w).abs().max().item() / scale if scale else 0.0
    print(f"one eager step's gradients within {max(rel.values()):.3e} of each leaf's max")
    # the drift: a reading beside twice Adam's reach (about a learning rate
    # a step at beta1 0.9, chip_smoke._adam_reach)
    steps = sd0["step"]
    for net, opt in (("g", cfg.model.gen_optim), ("d", cfg.model.disc_optim)):
        d = max((sd2[net][k].double() - v.double()).abs().max().item()
                for k, v in sd0[net].items() if v.is_floating_point())
        print(f"{net}: parameters' max |d| after {steps} steps {d:.3e}; 2 lr a step "
              f"{2 * opt.learning_rate * steps:.3e}")
    for k, r in rel.items():
        assert r <= GRAD_RTOL, (k, r)
    _held_metrics(one2, one0, "the eager step")
    epoch = list(one0)  # the step's metrics (the fit's means add images_per_sec)
    _held_metrics({k: means2[k] for k in epoch}, {k: means0[k] for k in epoch},
                  "the epoch's means")
