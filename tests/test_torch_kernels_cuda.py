"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips where torch.cuda.is_available() is False (the
kernels have no CPU mode; on the CPU the wrappers take the plain versions,
which tests/test_torch_ops.py holds to the JAX package).  This file imports
no JAX, so it runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: bf16 results within 2e-2 * max(1, max|plain|) (the kernels round
intermediate operands to bf16 where the plain versions keep f32).
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
