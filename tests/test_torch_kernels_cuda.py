"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the three flash backward kernels, autograd through the
flash attention on the JAX package's backward route, and the raises for what
the kernels do not take.

Marked ``cuda``; each test skips where torch.cuda.is_available() is False (the
kernels have no CPU mode; on the CPU the wrappers take the plain versions,
which tests/test_torch_ops.py holds to the JAX package).  This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: forward results within 2e-2 * max(1, max|plain|), backward results
(dq, dk, dv, whose values lie well under 1) within 2e-2 * max|plain| of each
output's own; the kernels round intermediate operands to bf16 where the plain
versions keep f32.
"""

import pytest
import torch

from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attn_fwd", "ln_mlp_fwd", "ln_qkv_fwd",
                                  "proj_ln_mlp_fwd"])
def test_kernel_matches_plain_on_card(name):
    """Each CUDA kernel against its plain version, bf16, ragged shape."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, n, e, h, hidden = 2, 65, 48, 2, 192
    dh = e // h

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    x, attn = rn(b, n, e), rn(b, n, e)
    ln_s, ln_b = 1 + rn(e, scale=0.1, dtype=torch.float32), rn(e, scale=0.1, dtype=torch.float32)
    w1, w2 = rn(e, hidden, scale=0.1), rn(hidden, e, scale=0.1)
    b1, b2 = rn(hidden, scale=0.1, dtype=torch.float32), rn(e, scale=0.1, dtype=torch.float32)
    before = build.LAUNCHES[name]
    if name == "flash_attn_fwd":
        q, k, v = rn(b, h, n, dh), rn(b, h, n, dh), rn(b, h, n, dh)
        got, want = A.flash_attention(q, k, v), A.attention_reference(q, k, v)
    elif name == "ln_mlp_fwd":
        got = FM.fused_ln_mlp(x, ln_s, ln_b, w1, b1, w2, b2)
        want = FM._reference(x, ln_s, ln_b, w1, b1, w2, b2)
    elif name == "ln_qkv_fwd":
        qkv_w, qkv_b = rn(3, h, e, dh, scale=0.1), rn(3 * h * dh, scale=0.1, dtype=torch.float32)
        got = FB.ln_qkv_forward(x, ln_s, ln_b, qkv_w, qkv_b)
        want = FB._ln_qkv_reference(x, ln_s, ln_b, qkv_w, qkv_b)
    else:
        wout, bout = rn(e, e, scale=0.1), rn(e, scale=0.1, dtype=torch.float32)
        got = FM.ln_mlp_forward(x, ln_s, ln_b, w1, b1, w2, b2, attn=attn, wout=wout, bout=bout)
        want = FB._proj_ln_mlp_reference(x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    tol = 2e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_auto_route_raises_on_card_for_unported_dtype_and_width():
    """Past the JAX package's gates, an f32 or too-wide CUDA tensor makes the
    kernel's wrapper raise, naming the ROADMAP.md item; nothing falls back to
    the plain version on the card."""
    _cuda_or_skip()
    saved = policy.get_policy()
    policy.set_policy(mode="auto", megablock="auto")
    try:
        q = torch.randn(1, 2, 256, 64, device="cuda")
        with pytest.raises(TypeError, match="ROADMAP"):
            A.dispatch_attention(q, q, q, "dot", 64.0)
        e, hidden = 512, 2048
        x = torch.randn(2, 1024, e, device="cuda", dtype=torch.bfloat16)
        w1 = torch.zeros(e, hidden, device="cuda")
        w2, b1, b = torch.zeros(hidden, e, device="cuda"), torch.zeros(hidden), torch.zeros(e)
        with pytest.raises(ValueError, match="ROADMAP"):
            FM.dispatch_ln_mlp(x, b, b, w1, b1, w2, b)
    finally:
        policy.set_policy(**saved)


def _bwd_inputs(shape, seed=0):
    """bf16 q, k, v, dO on the card and the forward kernel's o and LSE."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    o, lse = A.flash_forward(q, k, v, float(shape[-1]))
    return q, k, v, o, lse, do


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 257, 64), (1, 2, 65, 24), (2, 2, 128, 128)],
                         ids=["ragged_257_dh64", "ragged_65_dh24", "aligned_128_dh128"])
@pytest.mark.parametrize("name", ["flash_attn_bwd_fused", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv"])
def test_backward_kernel_matches_plain_on_card(name, shape):
    """Each backward kernel against its plain version, bf16, on the same q, k,
    v, o, LSE and dO; each output within 2e-2 * its own max|plain|."""
    _cuda_or_skip()
    args = (*_bwd_inputs(shape), float(shape[-1]))
    kern, plain = {
        "flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
        "flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference),
        "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference),
    }[name]
    before = build.LAUNCHES[name]
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        tol = 2e-2 * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 1025])
def test_flash_attention_autograd_takes_the_jax_route_on_card(n):
    """Autograd through flash_attention launches the fused kernel at 1,024
    tokens and dq + dk/dv at 1,025 (the JAX package's route), and its
    gradients agree with autograd through the plain attention."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v, do = (torch.randn((1, 2, n, 64), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    build.reset_launches()
    got = torch.autograd.grad(A.flash_attention(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(A.attention_reference(q, k, v), (q, k, v), do)
    torch.cuda.synchronize()
    fused = 1 if n == 1024 else 0
    assert build.LAUNCHES["flash_attn_bwd_fused"] == fused
    assert build.LAUNCHES["flash_attn_bwd_dq"] == build.LAUNCHES["flash_attn_bwd_dkv"] == 1 - fused
    for g, w in zip(got, want):
        tol = 2e-2 * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_training_block_under_megablock_auto_raises_on_card():
    """Under megablock='auto' the JAX package's gate routes highres128's
    training blocks (1,024 and 1,025 tokens) through the megablock's training
    kernels; on the card the port raises there naming ROADMAP.md, and
    megablock='off' takes the standard path."""
    _cuda_or_skip()
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock

    cfg = C.highres_config(128).v2
    with torch.device("meta"):
        block = EncoderBlock(cfg, None)
    saved = policy.get_policy()
    try:
        policy.set_policy(mode="auto", megablock="auto")
        for n in (1024, 1025):
            x = torch.empty(2, n, cfg.embed_dim, device="cuda", dtype=torch.bfloat16)
            with pytest.raises(NotImplementedError, match="ROADMAP.md queue 2 items 1 and 4"):
                FB.maybe_megablock(block, x, cfg, train=True)
        policy.set_policy(megablock="off")
        assert FB.maybe_megablock(block, x, cfg, train=True) is None
    finally:
        policy.set_policy(**saved)


@pytest.mark.cuda
def test_backward_wrappers_raise_for_unported_dtype_and_double_backward():
    """An f32 or Dh > 128 CUDA tensor makes each backward wrapper raise naming
    ROADMAP.md; a double backward through the kernels raises too."""
    _cuda_or_skip()
    q = torch.randn(1, 2, 256, 64, device="cuda")
    lse = torch.zeros(1, 2, 256, device="cuda")
    for fn in (A.flash_backward_fused, A.flash_backward_dq, A.flash_backward_dkv):
        with pytest.raises(TypeError, match="ROADMAP"):
            fn(q, q, q, q, lse, q, 64.0)
        w = torch.zeros(1, 2, 256, 136, device="cuda", dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="ROADMAP"):
            fn(w, w, w, w, lse, w, 136.0)
    x = torch.randn(1, 2, 256, 64, device="cuda", dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch.autograd.grad(A.flash_attention(x, x, x).float().sum(), x, create_graph=True)
