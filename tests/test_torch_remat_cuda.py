"""Rematerialisation and the 4,096-token shapes on the card (marked ``cuda``;
each test skips where torch.cuda.is_available() is False, as
tests/test_torch_kernels_cuda.py's):

- a v2 D and G at a small size (2 blocks, 256 tokens and 257 in D, embed 64,
  bf16, dropout 0.1 from a CUDA generator) through the kernels, the
  standard path (flash forward, single pass, LN->MLP) and the megablock's
  saved dropout route: in each remat mode the output and every gradient
  bit-equal to 'never'; the launches per mode: the flash forward twice a
  block under full and dots on the standard path, once under attn and
  never, LN->MLP once a block in every mode, the megablock's training
  forward twice a block in every remat mode;
- the single-pass backward (#5) at highres256p4's G (8, 6, 4,096, 64) and D
  (16, 6, 4,097, 64) shapes against its plain version, bit-equal across two
  calls.

This file imports no JAX:

    python -m pytest --noconftest tests/test_torch_remat_cuda.py -q

Tolerance: the backward results within 2e-2 * max|plain| of each output's
own (tests/test_torch_kernels_cuda.py's).
"""

import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build, policy

MODES = ("never", "full", "dots", "attn")


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _run(net: str, route: str, mode: str):
    cfg = C.replace(C.smoke_config(), **{"v2.image_size": 64, "v2.embed_dim": 64,
                                          "v2.num_heads": 1, "v2.dropout": 0.1})
    megablock = "on" if route == "megablock" else "off"
    policy.set_policy(mode="always", min_mlp_rows=0, megablock=megablock,
                      megablock_bwd="saved", remat=mode)
    gan = build_gan(cfg)
    init = torch.Generator().manual_seed(0)
    g = gan.generator_init(init, device="cuda")
    d = gan.discriminator_init(init, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.synchronize()
    build.reset_launches()
    if net == "d":
        x = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(1)).cuda() * 2 - 1
        x = x.to(torch.bfloat16).requires_grad_()
        out = gan.discriminator_apply(d, x, train=True, generator=gen)
        params = list(d.parameters())
    else:
        x = torch.randn(4, cfg.v2.latent_dim, generator=torch.Generator().manual_seed(1))
        x = x.cuda().to(torch.bfloat16).requires_grad_()
        out = g(x, train=True, generator=gen)
        params = list(g.parameters())
    (out.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    return out.detach(), [x.grad, *(p.grad for p in params)], launches, cfg.v2.depth


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["standard", "megablock"])
@pytest.mark.parametrize("net", ["d", "g"])
def test_remat_modes_are_bit_equal_to_never_through_the_kernels(net, route):
    _cuda_or_skip()
    want_out, want, base, depth = _run(net, route, "never")
    for mode in MODES[1:]:
        out, got, launches, _ = _run(net, route, mode)
        assert torch.equal(out, want_out), mode
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), f"{net} {route} {mode}: gradient {i}"
        if route == "standard":
            again = 0 if mode == "attn" else depth
            assert launches["flash_attn_fwd"] == base["flash_attn_fwd"] + again == \
                depth * (1 if mode == "attn" else 2)
            assert launches["ln_mlp_fwd"] == base["ln_mlp_fwd"] == depth
        else:
            assert base["ln_mlp_train_fwd"] == depth
            for name in ("ln_qkv_fwd", "ln_mlp_train_fwd"):
                assert launches[name] == base[name] + depth, (mode, name)
            assert launches["megablock_bwd_mlp"] == base["megablock_bwd_mlp"] == depth


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 6, 4096, 64), (16, 6, 4097, 64)], ids=["G", "D"])
def test_single_pass_at_the_4096_token_shapes(shape):
    """The JAX route takes the single pass at both (K/V under 4 MiB)."""
    _cuda_or_skip()
    assert A.backward_route(shape[2], shape[3], 2) == "fused"
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = A.flash_forward(q, k, v, float(shape[3]))
    args = (q, k, v, o, lse, do, float(shape[3]))
    got = A.flash_backward_fused(*args)
    want = A.flash_bwd_fused_reference(*args)
    for g, w in zip(got, want):
        tol = 2e-2 * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol
    again = A.flash_backward_fused(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
