"""The second derivative, int8 serving and the baselines on the card (marked
``cuda``; each test skips where torch.cuda.is_available() is False):

- the repaired recompute Functions (the LN->MLP and the megablock, with and
  without its dropout masks) differentiate twice on the card: an R1-style
  second derivative through each (its forward the kernels) against the same
  through its plain version on the same bf16 inputs; the saved megablock
  still raises;
- int8 serving launches the float route's kernels, no others, and its
  seeded uint8 output stays within the JAX package's drift bounds;
- a captured DCGAN step (cuDNN convolutions, BatchNorm statistics updated in
  place inside the graph) against eager steps from one state.

    python -m pytest --noconftest tests/test_torch_interop_cuda.py -q
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.serve import SamplerService
from vitgan_tpu_torch.train import step as S
from vitgan_tpu_torch.train.sample import latent_block
from vitgan_tpu_torch.train.trainer import Trainer

# second derivatives: each leaf within this share of its plain version's max
# (the Functions' backward products run in TF32 on the card, the plain
# version's in the process's f32)
RTOL = 2e-2


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the forward is the kernels")


def _r1(fn, x, params, c):
    x = x.detach().requires_grad_()
    (gx,) = torch.autograd.grad((fn(x).float() * c).sum(), x, create_graph=True)
    return torch.autograd.grad((gx.float() ** 2).sum(), [x, *params], materialize_grads=True)


def _close(got, want, names):
    for name, a, b in zip(names, got, want):
        err = (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(),
                                                               1e-30)
        assert err <= RTOL, f"{name}: {err:.3g} of max|plain|"


@pytest.mark.cuda
def test_ln_mlp_differentiates_twice_on_card():
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(0)
    m, e, hidden = 2048, 384, 1536
    x = torch.randn((m, e), device="cuda", generator=g).to(torch.bfloat16)
    c = torch.randn((m, e), device="cuda", generator=g)
    shapes = ((e,), (e,), (e, hidden), (hidden,), (hidden, e), (e,))
    p = [(torch.randn(s, device="cuda", generator=g) * (0.05 if len(s) == 2 else 0.1)
          + (1.0 if i == 0 else 0.0)).requires_grad_() for i, s in enumerate(shapes)]
    build.reset_launches()
    got = _r1(lambda x_: FM.fused_ln_mlp(x_, *p), x, p, c)
    assert build.LAUNCHES["ln_mlp_fwd"] == 1
    want = _r1(lambda x_: FM._reference(x_, *p), x, p, c)
    _close(got, want, ["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"])


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_recompute_megablock_differentiates_twice_on_card(rate):
    _cuda_or_skip()
    cfg = C.V2Config(embed_dim=384, num_heads=6, mlp_ratio=4)
    block = EncoderBlock(cfg, torch.Generator().manual_seed(0)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 65, 384), device="cuda", generator=gen).to(torch.bfloat16)
    c = torch.randn((2, 65, 384), device="cuda", generator=gen)
    params = FB.block_params(block)
    seed = torch.tensor([2 ** 40 + 7], dtype=torch.int64, device="cuda")
    build.reset_launches()
    if rate:
        got = _r1(lambda x_: FB.encoder_block_fused_dropout(x_, block, seed, rate, 6), x,
                  params, c)
        _, m1, m2 = FB.fused_encoder_block(x, block, num_heads=6, rate=rate, seed=seed)
        want = _r1(lambda x_: FB._block_reference_masked(x_, block, m1, m2, 6), x, params, c)
    else:
        got = _r1(lambda x_: FB.encoder_block_fused(x_, block, 6), x, params, c)
        want = _r1(lambda x_: FB._block_reference(x_, block, 6), x, params, c)
    assert build.LAUNCHES["ln_qkv_fwd"] >= 1 and not build.LAUNCHES["megablock_bwd_mlp"]
    _close(got, want, ("x",) + FB.BLOCK_PARAMS)
    out = FB.encoder_block_fused_saved(x.detach().requires_grad_(), block, 6)
    with pytest.raises(NotImplementedError, match="queue 2 item 2"):
        torch.autograd.grad(out.float().sum(), params[0], create_graph=True)


@pytest.mark.cuda
def test_int8_serving_launches_and_drift():
    _cuda_or_skip()
    cfg = C.replace(C.highres_config(128), **{"v2.image_size": 64, "v2.depth": 2})
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    svcs, outs, launches = {}, {}, {}
    for mode in (None, "int8"):
        g = gan.generator_init(torch.Generator().manual_seed(0), device="cuda")
        svcs[mode] = SamplerService(cfg, gan, g, batch=8, quantize=mode)
        build.reset_launches()
        outs[mode] = svcs[mode].sample_quantized(8, seed=4)
        launches[mode] = {k: v for k, v in build.LAUNCHES.items() if v}
    assert launches[None] == launches["int8"] and launches[None]["ln_qkv_fwd"] == 2
    assert all(p.device.type == "meta" for p in svcs["int8"].generator.parameters())
    assert svcs["int8"].info()["weight_bytes"] < svcs[None].info()["weight_bytes"] / 3
    diff = np.abs(outs["int8"].astype(np.int32) - outs[None].astype(np.int32))
    assert diff.mean() <= 4.0 and np.quantile(diff, 0.99) <= 24, (diff.mean(), diff.max())


@pytest.mark.cuda
def test_captured_dcgan_steps_against_eager(tmp_path):
    _cuda_or_skip()
    cfg = C.replace(C.ExperimentConfig(family="dcgan"), **{
        "dcgan.batch_size": 32, "data.dataset": "synthetic", "data.synthetic_samples": 128,
        "run.sample_grid_every_epochs": 0, "run.fid_every_epochs": 0})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cuda")
    st, n = t.state, 2
    order = t.batches()
    t.train_step(st, t.real_batch(order[0]))  # the optimizer's state exists
    idx = order[1:1 + n]
    lat = latent_block(t.gan, st.seed, st.step, n, 32, 1)
    start = st.state_dict()
    fn = S.make_device_data_train_fn(t.gan, cfg, n)
    fn(st, t.dataset, idx, lat)  # the first step eager, its capture, 1 replay
    st.load_state_dict(start)
    eager = [t.train_step(st, t.real_batch(idx[i]), z=torch.from_numpy(lat[i, 0]))
             for i in range(n)]
    want = {k: v.clone() for k, v in (*st.g.state_dict().items(),
                                      *(("d." + k, v) for k, v in st.d.state_dict().items()))}
    st.load_state_dict(start)
    got_m = fn(st, t.dataset, idx, lat)  # 2 replays
    got = {k: v for k, v in (*st.g.state_dict().items(),
                             *(("d." + k, v) for k, v in st.d.state_dict().items()))}
    for k in got_m:
        torch.testing.assert_close(got_m[k], torch.stack([e[k] for e in eager]), rtol=2e-2,
                                   atol=2e-2, msg=k)
    lr = cfg.dcgan.gen_optim.learning_rate
    for k, w in want.items():
        # a parameter moves by at most lr a step under Adam; running statistics by momentum
        torch.testing.assert_close(got[k], w, rtol=1e-3, atol=2 * n * lr + 1e-4, msg=k)
    assert any(k.endswith("bn2.mean") and not torch.equal(got[k], start["g"]["bn2.mean"].cuda())
               for k in got)
