"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the three flash backward kernels, autograd through the
flash attention on the JAX package's backward route, the `l2` and `l2ref`
score modes (forward, the `l2` backward kernels, autograd, the v1 head width
108), the megablock's training forward and saved-residual backward (against
autograd of the plain block) and the weight-gradient kernel, the training
gate, and the raises for what the kernels do not take.

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
@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd_fused"])
def test_v1_generator_dot_kernels_match_plain_on_card(name):
    """The `dot` forward and single-pass backward as the v1 generator runs
    them: head width 96, softmax scale H * Dh = 384, 32 tokens.  o within
    2e-2 * max(1, max|plain|) and the LSE within 1e-2; each gradient within
    2e-2 * its own max|plain|."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    shape, scale = (4, 4, 32, 96), 384.0
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    build.reset_launches()
    o, lse = A.flash_forward(q, k, v, scale)
    if name == "flash_attn_fwd":
        po, plse = A.attention_forward_reference(q, k, v, scale, "dot")
        got, want = (o,), (po,)
        tol = 2e-2 * max(1.0, po.float().abs().max().item())
        assert (lse - plse).abs().max().item() <= 1e-2
    else:
        build.reset_launches()
        args = (q, k, v, o, lse, do, scale)
        got, want = A.flash_backward_fused(*args), A.flash_bwd_fused_reference(*args)
        tol = None
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == 1
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        limit = tol if tol is not None else 2e-2 * w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= limit


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


L2_SHAPES = [(2, 4, 50, 108), (1, 2, 257, 64), (1, 2, 65, 24)]
L2_IDS = ["v1_d_50_dh108", "ragged_257_dh64", "ragged_65_dh24"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_SHAPES, ids=L2_IDS)
@pytest.mark.parametrize("mode", ["l2", "l2ref"])
def test_score_mode_forward_matches_plain_on_card(mode, shape):
    """The `l2`/`l2ref` forward kernel (the head width padded to 8 by the
    wrapper) against its plain version: o within 2e-2 * max(1, max|plain|),
    the LSE within 1e-2; counted under its mode's key."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = float(shape[1] * shape[3])
    build.reset_launches()
    o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
    po, plse = A.attention_forward_reference(q, k, v, scale, mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"flash_attn_fwd[{mode}]"] == 1 and build.LAUNCHES["flash_attn_fwd"] == 0
    assert o.shape == q.shape and lse.shape == q.shape[:3]
    tol = 2e-2 * max(1.0, po.float().abs().max().item())
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_SHAPES, ids=L2_IDS)
@pytest.mark.parametrize("name", ["flash_attn_bwd_fused", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv"])
def test_l2_backward_kernel_matches_plain_on_card(name, shape):
    """Each `l2` backward kernel against its plain version on the same q, k,
    v, o, LSE and dO; each output within 2e-2 * its own max|plain|."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = float(shape[1] * shape[3])
    o, lse = A.flash_forward(q, k, v, scale, score_mode="l2")
    kern, plain = {
        "flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
        "flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference),
        "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference),
    }[name]
    build.reset_launches()
    args = (q, k, v, o, lse, do, scale)
    got, want = kern(*args, score_mode="l2"), plain(*args, score_mode="l2")
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"{name}[l2]"] == 1 and build.LAUNCHES[name] == 0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("fusion", ["auto", "fused"])
@pytest.mark.parametrize("mode", ["l2", "l2ref"])
def test_score_mode_autograd_on_card(mode, fusion):
    """Autograd through flash_attention at the v1 discriminator's head width:
    `l2` takes two passes under 'auto' and the single pass under 'fused';
    `l2ref` launches the forward kernel and no backward kernel (its backward
    is the plain chunked recompute, as in the JAX package).  Gradients within
    2e-2 * max|plain| of autograd through the plain attention."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v, do = (torch.randn((4, 4, 50, 108), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    saved = policy.get_policy()
    policy.set_policy(bwd_fusion=fusion)
    try:
        build.reset_launches()
        got = torch.autograd.grad(A.flash_attention(q, k, v, mode, 432.0), (q, k, v), do)
        torch.cuda.synchronize()
        launched = {n: c for n, c in build.LAUNCHES.items() if c}
    finally:
        policy.set_policy(**saved)
    if mode == "l2ref":
        assert launched == {"flash_attn_fwd[l2ref]": 1}
    elif fusion == "fused":
        assert launched == {"flash_attn_fwd[l2]": 1, "flash_attn_bwd_fused[l2]": 1}
    else:
        assert launched == {"flash_attn_fwd[l2]": 1, "flash_attn_bwd_dq[l2]": 1,
                            "flash_attn_bwd_dkv[l2]": 1}
    want = torch.autograd.grad(A.attention_reference(q, k, v, mode, 432.0), (q, k, v), do)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()


@pytest.mark.cuda
def test_training_block_under_megablock_auto_takes_the_saved_dropout_megablock_on_card():
    """Under megablock='auto' the JAX package's gate routes highres128's
    training blocks (1,024 and 1,025 tokens) through
    encoder_block_fused_dropout_saved; so does the port on the card, and
    megablock_bwd='recompute' and megablock='off' take the standard path."""
    _cuda_or_skip()
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock

    cfg = C.highres_config(128).v2
    block = EncoderBlock(cfg, torch.Generator().manual_seed(0)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    saved = policy.get_policy()
    try:
        policy.set_policy(mode="auto", megablock="auto", megablock_bwd="saved")
        for n in (1024, 1025):
            x = torch.randn(2, n, cfg.embed_dim, device="cuda").to(torch.bfloat16)
            build.reset_launches()
            out = FB.maybe_megablock(block, x.requires_grad_(), cfg, train=True, generator=gen)
            torch.autograd.grad(out.float().sum(), [x, *block.parameters()])
            torch.cuda.synchronize()
            assert type(out.grad_fn).__name__ == "_SavedBlockBackward"
            for name in ("ln_mlp_train_fwd", "megablock_bwd_mlp", "megablock_bwd_ln1"):
                assert build.LAUNCHES[name] == 1
            assert build.LAUNCHES["wgrad_gemm"] == 4 and build.LAUNCHES["ln_mlp_fwd"] == 0
        policy.set_policy(megablock_bwd="recompute")
        assert FB.maybe_megablock(block, x, cfg, train=True, generator=gen) is None
        policy.set_policy(megablock="off", megablock_bwd="saved")
        assert FB.maybe_megablock(block, x, cfg, train=True, generator=gen) is None
    finally:
        policy.set_policy(**saved)


def _mb_inputs(b, n, e, heads, hidden, seed=0):
    """bf16 activations and f32 parameters of one block on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")

    dh = e // heads
    params = [1 + rn(e, scale=0.1), rn(e, scale=0.1), rn(3, heads, e, dh, scale=0.05),
              rn(3, heads, dh, scale=0.1), rn(heads * dh, e, scale=0.05), rn(e, scale=0.1),
              1 + rn(e, scale=0.1), rn(e, scale=0.1), rn(e, hidden, scale=0.05),
              rn(hidden, scale=0.1), rn(hidden, e, scale=0.05), rn(e, scale=0.1)]
    x, g = rn(b, n, e).to(torch.bfloat16), rn(b, n, e).to(torch.bfloat16)
    seed_t = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
    return x, g, params, seed_t


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 65, 64, 2, 128), (2, 257, 192, 3, 768)],
                         ids=["ragged_65_e64", "ragged_257_e192"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_megablock_training_kernels_match_plain_on_card(shape, rate):
    """The training forward's masks are bit-equal to the plain Philox's and
    its output within 2e-2 * max(1, max|plain|); the saved-residual backward
    (megablock_bwd_mlp, the qkv recompute, the flash backward, megablock_bwd_ln1,
    wgrad_gemm, sum_partials) gives dx and each of the 12 parameter gradients
    within 2e-2 * its own max|plain| of autograd through the plain masked
    block in f32."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    x, g, params, seed = _mb_inputs(*shape)
    p = FB._block_view(params)
    build.reset_launches()
    if rate > 0:
        out, res = FB.fused_encoder_block(x, p, num_heads=heads, rate=rate, seed=seed,
                                          want_residuals=True)
        m = b * n
        for i, mk in ((0, res.m1), (1, res.m2)):
            assert torch.equal(mk.reshape(m, e), FB.dropout_mask(seed, i, (m, e), rate))
        m1, m2 = res.m1, res.m2
    else:
        out, res = FB.fused_encoder_block(x, p, num_heads=heads, want_residuals=True)
        m1 = m2 = torch.ones(b, n, e, device="cuda")
    dx, grads = FB.fused_encoder_block_bwd(params, g, res, num_heads=heads)
    torch.cuda.synchronize()
    assert build.LAUNCHES["ln_mlp_train_fwd"] == 1 and build.LAUNCHES["megablock_bwd_mlp"] == 1
    assert build.LAUNCHES["megablock_bwd_ln1"] == 1 and build.LAUNCHES["wgrad_gemm"] == 4
    # the two LN sums (each wgrad_gemm entry reduces its own partials)
    assert build.LAUNCHES["sum_partials"] == 2 and build.LAUNCHES["ln_qkv_fwd"] == 2
    leaves = [x.float().requires_grad_(), *(t.clone().requires_grad_() for t in params)]
    ref = FB._block_reference_masked(leaves[0], FB._block_view(leaves[1:]), m1, m2, heads)
    assert (out.float() - ref).abs().max().item() <= 2e-2 * max(1.0, ref.abs().max().item())
    want = torch.autograd.grad(ref, leaves, g.float())
    for got, w in zip((dx, *grads), want):
        assert got.shape == w.shape
        assert (got.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,ka,nb", [(1000, 72, 136), (4097, 384, 1536), (64, 8, 8),
                                        (777, 1152, 8), (65, 136, 1152), (32768, 1536, 384)])
def test_wgrad_gemm_matches_plain_on_card(rows, ka, nb):
    """dW = A^T . B and db over ragged rows and widths (8, 72, 136, 1152:
    TMA zero-fills past Ka, Nb and M) against the plain version, each within
    2e-2 * its own max|plain|."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(rows, ka, generator=gen, device="cuda").to(torch.bfloat16)
    bm = torch.randn(rows, nb, generator=gen, device="cuda").to(torch.bfloat16)
    (dw, db), (pw, pb) = WG.wgrad_gemm(a, bm), WG.wgrad_reference(a, bm)
    torch.cuda.synchronize()
    assert (dw - pw).abs().max().item() <= 2e-2 * pw.abs().max().item()
    assert (db - pb).abs().max().item() <= 2e-2 * pb.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,ka,nb", [(65600, 384, 1152), (1000, 72, 136)])
def test_wgrad_gemm_is_bit_deterministic_on_card(rows, ka, nb):
    """Two calls on the same inputs give bit-equal dW and db: the row splits'
    partials are summed in a fixed order, with no atomics."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(rows, ka, generator=gen, device="cuda").to(torch.bfloat16)
    bm = torch.randn(rows, nb, generator=gen, device="cuda").to(torch.bfloat16)
    (dw, db), (dw2, db2) = WG.wgrad_gemm(a, bm), WG.wgrad_gemm(a, bm)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 96, 112])
@pytest.mark.parametrize("name", ["flash_attn_bwd_fused", "flash_attn_bwd_dkv"])
def test_kblock_kernel_at_ragged_length_matches_plain_on_card(name, dh):
    """The wgmma k-block kernel through both entries at N 1,025 (a ragged
    last key block and query tile) and head widths 64, 96 and 112 (one and
    two 64-column boxes): each output within 2e-2 * its own max|plain|, and
    the two-pass dk/dv bit-equal across two calls."""
    _cuda_or_skip()
    args = (*_bwd_inputs((1, 2, 1025, dh), seed=6), float(dh))
    kern, plain = {"flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
                   "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference)}[name]
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    if name == "flash_attn_bwd_dkv":
        again = kern(*args)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, again))


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
