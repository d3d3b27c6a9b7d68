"""The port's CUDA kernels against their plain PyTorch versions, on the card:
the forward kernels, the three flash backward kernels, autograd through the
flash attention on the JAX package's backward route, the `l2` and `l2ref`
score modes (forward, the `l2` backward kernels, autograd, the v1 head width
108), the wgmma `dot` forward and dq at the edges of their tiles, the
forward's (B, N, H*D) output layout, the single pass bit-equal across two
calls (`dot` and `l2`, at G's grid and one head x 16,385 tokens too, on the
ticket's order), the persistent `l2` kernels (the `l2`/`l2ref` forward, the
single pass, dq and dk/dv) at the v1 discriminator's shape and the edges of
their tiles, contiguous at the unpadded head width, the backward ones
bit-equal across two calls, the megablock's training forward and saved-residual backward (against
autograd of the plain block) and the weight-gradient kernel, the training
gate, and the raises for what the kernels do not take; each stage of the
LN->MLP forward against its plain version, each stage of the megablock
backward's MLP half against its plain version, sum_partials bit-equal to
its order model, LN->qkv at shapes whose tiles straddle samples (heads of
64, 32 and 24) and the backward's LN1 half with its partials row for row,
each bit-equal across two calls; the wide variants (E > 384: the LN rows,
the streamed fc1 and qkv products, the dmlp rows, the streamed dz1 and dao
products, dy = a . w^T in f32 and the LN-backward rows) at E 520 and 768
against their plain versions, the backward ones bit-equal across two calls,
a whole wide block's saved backward against autograd of the plain block, and
each wide variant forced at E 384 against the resident kernel; the f32
flash kernels (forward in every score mode, the single pass, dq and dk/dv in
`dot` and `l2`) against their plain versions in full f32, the backward ones
bit-equal across two calls, with less error than the bf16 kernels on the
same inputs, and autograd through them; the LN->MLP's fc1 stage with each
activation; the saved backward's f32 entries (the dmlp rows, dz1, dy, the
dx1 and LN1 rows, dao with delta, wgrad_gemm_f32) against their plain
versions in full f32, bit-equal across two calls, and a whole f32 block's
saved backward against its plain composition.

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
    before = dict(build.LAUNCHES)
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
    # the LN->MLP forms launch their stage kernels: fc1, then one linear
    # launch for fc2 and one more for the out-projection
    stages = {"ln_mlp_fwd": {"ln_mlp_fc1": 1, "ln_mlp_linear": 1},
              "proj_ln_mlp_fwd": {"ln_mlp_fc1": 1, "ln_mlp_linear": 2}}.get(name, {})
    assert {k: c - before[k] for k, c in build.LAUNCHES.items() if c != before[k]} == {
        name: 1, **stages}
    tol = 2e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
def test_auto_route_raises_on_card_for_unported_dtype_and_width():
    """Past the JAX package's gates, an f16 CUDA tensor makes the attention
    kernel's wrapper raise, naming the ROADMAP.md item (bf16 and f32 have
    kernels).  A block of E 512 passes the
    'auto' gate as it passes the JAX one and launches the wide LN -> fc1
    variant (ln_rows, ln_mlp_fc1_wide) and fc2, within 2e-2 * max(1,
    max|plain|) of the plain version; in f32 the f32 stages (one kernel at
    every E, no LN rows), within the same bar; in f16 it raises.  A width that is
    no multiple of 8 raises under 'always', naming the ROADMAP.md item.
    Nothing falls back to the plain version in a wrapper on the card."""
    _cuda_or_skip()
    saved = policy.get_policy()
    policy.set_policy(mode="auto", megablock="auto")
    try:
        q = torch.randn(1, 2, 256, 64, device="cuda", dtype=torch.float16)
        with pytest.raises(TypeError, match="ROADMAP"):
            A.dispatch_attention(q, q, q, "dot", 64.0)
        e, hidden = 512, 2048
        gen = torch.Generator(device="cuda").manual_seed(1)
        x = torch.randn(2, 1024, e, device="cuda", generator=gen).to(torch.bfloat16)
        w1 = 0.05 * torch.randn(e, hidden, device="cuda", generator=gen)
        w2 = 0.05 * torch.randn(hidden, e, device="cuda", generator=gen)
        b1, b = torch.zeros(hidden, device="cuda"), torch.zeros(e, device="cuda")
        build.reset_launches()
        got = FM.dispatch_ln_mlp(x, b + 1, b, w1, b1, w2, b)
        want = FM._reference(x, b + 1, b, w1, b1, w2, b)
        torch.cuda.synchronize()
        assert {k: c for k, c in build.LAUNCHES.items() if c} == {
            "ln_mlp_fwd": 1, "ln_rows": 1, "ln_mlp_fc1_wide": 1, "ln_mlp_linear": 1}
        tol = 2e-2 * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol
        build.reset_launches()
        got = FM.dispatch_ln_mlp(x.float(), b + 1, b, w1, b1, w2, b)
        want = FM._reference(x.float(), b + 1, b, w1, b1, w2, b)
        torch.cuda.synchronize()
        assert {k: c for k, c in build.LAUNCHES.items() if c} == {
            "ln_mlp_fwd": 1, "ln_mlp_fc1_f32": 1, "ln_mlp_linear_f32": 1}
        assert got.dtype == torch.float32
        assert (got - want).abs().max().item() <= 2e-2 * max(1.0, want.abs().max().item())
        with pytest.raises(TypeError, match="ROADMAP"):
            FM.dispatch_ln_mlp(x.half(), b, b, w1, b1, w2, b)
        policy.set_policy(mode="always")
        xu = torch.zeros(2, 1024, 516, device="cuda", dtype=torch.bfloat16)
        bu = torch.zeros(516, device="cuda")
        with pytest.raises(ValueError, match="ROADMAP"):
            FM.dispatch_ln_mlp(xu, bu, bu, w1[:4].repeat(129, 1), b1, w2[:, :4].repeat(1, 129),
                               bu)
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
    """The `l2`/`l2ref` forward kernel (the head width where it lies) against
    its plain version: o within 2e-2 * max(1, max|plain|), the LSE within
    1e-2; counted under its mode's key."""
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
    for stage in ("megablock_bwd_mlp_dz1", "megablock_bwd_mlp_dx1", "megablock_bwd_mlp_dao"):
        assert build.LAUNCHES[stage] == 1
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


# the weight-gradient kernels' dtypes: wgrad_gemm.cu takes bf16, wgrad_gemm_f32.cu f32
WGRAD_DTYPES = pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                                       ids=["bf16", "f32"])


@pytest.mark.cuda
@WGRAD_DTYPES
@pytest.mark.parametrize("rows,ka,nb", [(1000, 72, 136), (4097, 384, 1536), (64, 8, 8),
                                        (777, 1152, 8), (65, 136, 1152), (32768, 1536, 384)])
def test_wgrad_gemm_matches_plain_on_card(rows, ka, nb, dtype):
    """dW = A^T . B and db over ragged rows and widths (8, 72, 136, 1152:
    TMA zero-fills past Ka, Nb and M) against the plain version in full f32,
    each within 2e-2 (bf16) or 5e-3 (f32: TF32 products, PERF.md's f32 bound)
    times its own max|plain|.  The f32 kernel's errors are also at most half
    the bf16 kernel's on the same inputs cast to bf16, so a kernel that lost
    the TF32 digits fails here too."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(3)
    a = torch.randn(rows, ka, generator=gen, device="cuda").to(dtype)
    bm = torch.randn(rows, nb, generator=gen, device="cuda").to(dtype)
    (dw, db), (pw, pb) = WG.wgrad_gemm(a, bm), WG.wgrad_reference(a, bm)
    torch.cuda.synchronize()
    tol = 2e-2 if dtype == torch.bfloat16 else 5e-3
    errs = [(dw - pw).abs().max().item(), (db - pb).abs().max().item()]
    assert errs[0] <= tol * pw.abs().max().item()
    assert errs[1] <= tol * pb.abs().max().item()
    if dtype == torch.float32:
        hw, hb = WG.wgrad_gemm(a.to(torch.bfloat16), bm.to(torch.bfloat16))
        torch.cuda.synchronize()
        half = [(hw - pw).abs().max().item(), (hb - pb).abs().max().item()]
        assert errs[0] <= 0.5 * half[0] and errs[1] <= 0.5 * half[1], (errs, half)


@pytest.mark.cuda
@WGRAD_DTYPES
@pytest.mark.parametrize("rows,ka,nb", [(65600, 384, 1152), (1000, 72, 136)])
def test_wgrad_gemm_is_bit_deterministic_on_card(rows, ka, nb, dtype):
    """Two calls on the same inputs give bit-equal dW and db: the row splits'
    partials are summed in a fixed order, with no atomics."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(5)
    a = torch.randn(rows, ka, generator=gen, device="cuda").to(dtype)
    bm = torch.randn(rows, nb, generator=gen, device="cuda").to(dtype)
    (dw, db), (dw2, db2) = WG.wgrad_gemm(a, bm), WG.wgrad_gemm(a, bm)
    torch.cuda.synchronize()
    assert torch.equal(dw, dw2) and torch.equal(db, db2)


L2_TWO_PASS_SHAPES = [(256, 4, 50, 108), (4, 4, 64, 108), (4, 4, 65, 108), (2, 2, 1025, 108),
                      (4, 4, 50, 64), (4, 4, 65, 64), (2, 2, 1025, 64)]
L2_TWO_PASS_IDS = ["D", "n64_dh108", "n65_dh108", "n1025_dh108", "n50_dh64", "n65_dh64",
                   "n1025_dh64"]


# chip_smoke.L2_SHAPES: the v1 discriminator's shape, one 64-row tile exactly
# and one row past it, a ragged length and a wide head count at Dh 64.
L2_CHIP_SHAPES = [(256, 4, 50, 108), (256, 4, 64, 108), (256, 4, 65, 108), (4, 4, 1025, 108),
                  (8, 6, 1024, 64)]
L2_CHIP_IDS = ["D", "D64", "D65", "ragged", "wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_CHIP_SHAPES, ids=L2_CHIP_IDS)
@pytest.mark.parametrize("mode", ["l2", "l2ref"])
def test_l2_persistent_forward_matches_plain_on_card(mode, shape):
    """The persistent `l2`/`l2ref` forward at chip_smoke's `l2` shapes
    (ping-pong at 50 and 64 tokens, lockstep past them): o within 2e-2 *
    max(1, max|plain|) and contiguous at the unpadded head width, the LSE
    within 1e-2, one launch counted under its mode's key."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    scale = float(shape[1] * shape[3])
    build.reset_launches()
    o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
    po, plse = A.attention_forward_reference(q, k, v, scale, mode)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"flash_attn_fwd[{mode}]"] == 1
    assert o.shape == shape and o.is_contiguous() and lse.shape == shape[:3]
    tol = 2e-2 * max(1.0, po.float().abs().max().item())
    assert (o.float() - po.float()).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_CHIP_SHAPES, ids=L2_CHIP_IDS)
def test_l2_persistent_single_pass_matches_plain_and_repeats_on_card(shape):
    """The persistent `l2` single pass at chip_smoke's `l2` shapes (dQ
    finished in one block a head at 50 and 64 tokens; past them added in
    key-block order on the ticket's flags): dq, dk and dv each within 2e-2 *
    its own max|plain|, contiguous at the unpadded head width, bit-equal
    across two calls, one launch a call."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = float(shape[1] * shape[3])
    o, lse = A.flash_forward(q, k, v, scale, score_mode="l2")
    args = (q, k, v, o, lse, do, scale)
    build.reset_launches()
    got = [t.clone() for t in A.flash_backward_fused(*args, score_mode="l2")]
    again = A.flash_backward_fused(*args, score_mode="l2")
    want = A.flash_bwd_fused_reference(*args, score_mode="l2")
    torch.cuda.synchronize()
    assert build.LAUNCHES["flash_attn_bwd_fused[l2]"] == 2
    for g, a, w in zip(got, again, want):
        assert g.shape == shape and g.dtype == torch.bfloat16 and a.is_contiguous()
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_TWO_PASS_SHAPES, ids=L2_TWO_PASS_IDS)
@pytest.mark.parametrize("name", ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
def test_l2_two_pass_kernel_matches_plain_on_card(name, shape):
    """The persistent `l2` dq and dk/dv kernels at the v1 discriminator's
    shape (256 x 4 heads, 50 tokens, Dh 108), at 64 and 65 tokens (one
    64-row tile exactly and one row past it), at 1,025, and at Dh 64 (one
    column box, 128 resident rows): each output within 2e-2 * its own
    max|plain|, contiguous at the unpadded head width, one launch a call
    counted under its `l2` key, and bit-equal across two calls."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = float(shape[1] * shape[3])
    o, lse = A.flash_forward(q, k, v, scale, score_mode="l2")
    kern, plain = {"flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference),
                   "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference)}[name]
    args = (q, k, v, o, lse, do, scale)
    build.reset_launches()
    got = kern(*args, score_mode="l2")
    got = [t.clone() for t in (got if isinstance(got, tuple) else (got,))]
    again = kern(*args, score_mode="l2")
    again = again if isinstance(again, tuple) else (again,)
    want = plain(*args, score_mode="l2")
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    assert build.LAUNCHES[f"{name}[l2]"] == 2 and build.LAUNCHES[name] == 0
    for g, a, w in zip(got, again, want):
        assert g.shape == shape and g.dtype == torch.bfloat16 and g.is_contiguous()
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [64, 96, 112])
@pytest.mark.parametrize("name", ["flash_attn_bwd_fused", "flash_attn_bwd_dkv"])
def test_kblock_kernel_at_ragged_length_matches_plain_on_card(name, dh):
    """The wgmma k-block kernel through both entries at N 1,025 (a ragged
    last key block and query tile) and head widths 64, 96 and 112 (one and
    two 64-column boxes): each output within 2e-2 * its own max|plain|, and
    every output bit-equal across two calls (the single pass's dq too)."""
    _cuda_or_skip()
    args = (*_bwd_inputs((1, 2, 1025, dh), seed=6), float(dh))
    kern, plain = {"flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
                   "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference)}[name]
    got, want = kern(*args), plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        assert (g.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()
    again = kern(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.cuda
def test_backward_wrappers_raise_for_unported_dtype_and_double_backward():
    """An f16 or Dh > 128 CUDA tensor makes each backward wrapper raise naming
    ROADMAP.md (bf16 and f32 have kernels); a double backward through the
    kernels raises too."""
    _cuda_or_skip()
    q = torch.randn(1, 2, 256, 64, device="cuda", dtype=torch.float16)
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


EDGE_N = [1, 32, 65, 1025]
EDGE_DH = [16, 24, 64, 96, 128]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", EDGE_DH)
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd_dq"])
def test_wgmma_dot_kernels_match_plain_at_edges_on_card(name, n, dh):
    """The wgmma `dot` forward and q-block dq at one row, the v1 generator's
    32 tokens, a ragged 65 and 1,025 (a last query block of one row), head
    widths 16 to 128 (one and two 64-column boxes, 128- and 64-key tiles):
    o within 2e-2 * max(1, max|plain|) and the LSE within 1e-2; dq within
    2e-2 * its own max|plain| plus 2**-20 and bit-equal across two calls.  (At
    N 1 the softmax has one key and dq is 0: the kernel's dP - delta cancels
    there only to f32 rounding, about 1e-7.)"""
    _cuda_or_skip()
    q, k, v, o, lse, do = _bwd_inputs((2, 2, n, dh), seed=7)
    scale = float(dh)
    before = build.LAUNCHES[name]
    if name == "flash_attn_fwd":
        o, lse = A.flash_forward(q, k, v, scale)
        po, plse = A.attention_forward_reference(q, k, v, scale)
        torch.cuda.synchronize()
        assert build.LAUNCHES[name] == before + 1
        assert o.shape == po.shape and o.dtype == torch.bfloat16
        assert (o.float() - po.float()).abs().max().item() <= 2e-2 * max(
            1.0, po.float().abs().max().item())
        assert (lse - plse).abs().max().item() <= 1e-2
        return
    got = A.flash_backward_dq(q, k, v, o, lse, do, scale)
    want = A.flash_bwd_dq_reference(q, k, v, o, lse, do, scale)
    again = A.flash_backward_dq(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 2
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    tol = 2e-2 * want.float().abs().max().item() + 2.0 ** -20
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dh", [(65, 64), (1025, 64), (32, 96)])
def test_forward_out_bnhd_matches_plain_on_card(n, dh):
    """With ``out`` given, the forward writes O in the (B, N, H*D) layout
    the megablock's out-projection reads."""
    _cuda_or_skip()
    b, h = 2, 3
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v = (torch.randn((b, h, n, dh), generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    out = torch.empty((b, n, h * dh), dtype=torch.bfloat16, device="cuda")
    o, _ = A.flash_forward(q, k, v, float(dh), out=out)
    want = A.attention_reference(q, k, v).permute(0, 2, 1, 3).reshape(b, n, h * dh)
    torch.cuda.synchronize()
    assert o is out
    assert (out.float() - want.float()).abs().max().item() <= 2e-2 * max(
        1.0, want.float().abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", [("dot", (2, 3, 257, 64)), ("dot", (1, 2, 1025, 96)),
                                        ("dot", (4, 4, 32, 96)), ("l2", (4, 4, 50, 108)),
                                        ("l2", (1, 2, 1025, 108)), ("dot", (32, 6, 1024, 64)),
                                        ("dot", (1, 1, 16385, 64)), ("l2", (32, 6, 1024, 64)),
                                        ("l2", (1, 1, 16385, 64))],
                         ids=["dot_257", "dot_1025_dh96", "dot_v1_g", "l2_v1_d", "l2_1025",
                              "dot_G", "dot_16385", "l2_G", "l2_16385"])
def test_single_pass_is_bit_equal_across_calls_on_card(mode, shape):
    """dq, dk and dv of the single pass, `dot` and `l2`, bit-equal across two
    calls: the k-blocks of a head add dq (and `l2`'s rowsum(dS)) in
    key-block order, each block's place in that order its ticket."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = float(shape[1] * shape[3]) if mode == "l2" else float(shape[3])
    o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
    first = [t.clone() for t in A.flash_backward_fused(q, k, v, o, lse, do, scale,
                                                      score_mode=mode)]
    again = A.flash_backward_fused(q, k, v, o, lse, do, scale, score_mode=mode)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))



@pytest.mark.cuda
@pytest.mark.parametrize("m,e,hidden", [(130, 48, 192), (514, 192, 768), (1000, 384, 1536)],
                         ids=["m130_e48", "m514_e192", "m1000_e384"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_ln_mlp_stage_kernels_match_plain_on_card(m, e, hidden, rate):
    """Each stage of ln_mlp_fwd.cu against its plain version on the same bf16
    rows: the linear stage as the out-projection (mask stream 0, residual x)
    and as fc2 (mask stream 1, residual x1, and without a residual), and
    LN -> fc1 -> GELU with z1; masks bit-equal to the plain Philox's; each
    output within 2e-2 * max(1, max|plain|); each stage call counts one
    launch of its kernel."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    f32 = torch.float32
    x, attn = rn(m, e), rn(m, e)
    ln_s, ln_b = 1 + rn(e, scale=0.1, dtype=f32), rn(e, scale=0.1, dtype=f32)
    wout, bout = rn(e, e, scale=0.05), rn(e, scale=0.1, dtype=f32)
    w1, b1 = rn(e, hidden, scale=0.05), rn(hidden, scale=0.1, dtype=f32)
    w2, b2 = rn(hidden, e, scale=0.05), rn(e, scale=0.1, dtype=f32)
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")

    def close(got, want):
        assert got.shape == want.shape and got.dtype == want.dtype
        tol = 2e-2 * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol

    build.reset_launches()
    x1, m1 = FM.linear_stage(attn, wout, bout, x, seed, rate, 0)
    want_m1 = FB.dropout_mask(seed, 0, (m, e), rate) if rate else None
    assert (m1 is None) == (rate == 0.0) and (m1 is None or torch.equal(m1, want_m1))
    close(x1, FM.linear_stage_reference(attn, wout, bout, x, want_m1))
    h, z1 = FM.ln_fc1_stage(x1, ln_s, ln_b, w1, b1, want_z1=True)
    want_h, want_z1 = FM.ln_fc1_stage_reference(x1, ln_s, ln_b, w1, b1)
    close(h, want_h)
    close(z1, want_z1)
    assert torch.equal(FM.ln_fc1_stage(x1, ln_s, ln_b, w1, b1)[0], h)
    out, m2 = FM.linear_stage(want_h, w2, b2, x1, seed, rate, 1)
    want_m2 = FB.dropout_mask(seed, 1, (m, e), rate) if rate else None
    assert (m2 is None) == (rate == 0.0) and (m2 is None or torch.equal(m2, want_m2))
    close(out, FM.linear_stage_reference(want_h, w2, b2, x1, want_m2))
    close(FM.linear_stage(want_h, w2, b2)[0], FM.linear_stage_reference(want_h, w2, b2))
    launched = {n: c for n, c in build.LAUNCHES.items() if c}
    assert launched == {"ln_mlp_linear": 3, "ln_mlp_fc1": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e,heads,hidden", [(2, 65, 48, 2, 192), (2, 257, 192, 3, 768),
                                                (1, 1000, 384, 6, 1536)],
                         ids=["m130_e48", "m514_e192", "m1000_e384"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_megablock_bwd_mlp_stage_kernels_match_plain_on_card(b, n, e, heads, hidden, rate):
    """Each stage of megablock_bwd_mlp.cu (dz1, dx1, dao) against its plain
    version on the same bf16 inputs, each output within 2e-2 * its own
    max|plain| (dln2 by the partials' column sums); the three stages
    composed against _bwd_mlp_reference; two calls bit-equal; one launch of
    each stage a call."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(13)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    m, f32 = b * n, torch.float32
    g, x1, z1, ao = rn(m, e), rn(m, e), rn(m, hidden), rn(m, e)
    w1, w2, wout = rn(e, hidden, scale=0.05), rn(hidden, e, scale=0.05), rn(e, e, scale=0.05)
    ln_s, ln_b = 1 + rn(e, scale=0.1, dtype=f32), rn(e, scale=0.1, dtype=f32)
    m1 = m2 = None
    if rate:
        m1, m2 = ((torch.rand((m, e), generator=gen, device="cuda") >= rate).to(f32) / (1 - rate)
                  for _ in range(2))

    def close(got, want):
        assert got.shape == want.shape and got.dtype == want.dtype
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        tol = 2e-2 * want.float().abs().max().item()
        assert (got.float() - want.float()).abs().max().item() <= tol

    build.reset_launches()
    got = FB.bwd_dz1_stage(g, m2, z1, w2)
    want = FB.bwd_dz1_stage_reference(g, m2, z1, w2)
    for a, w in zip(got, want):
        close(a, w)
    dz1 = want[1]
    got = FB.bwd_dx1_stage(dz1, g, m1, x1, w1, ln_s, ln_b)
    want = FB.bwd_dx1_stage_reference(dz1, g, m1, x1, w1, ln_s, ln_b)
    for a, w in zip(got[:3], want[:3]):
        close(a, w)
    assert got[3].shape == want[3].shape == (-(-m // 64), 2 * e)
    close(got[3].sum(0), want[3].sum(0))
    da = want[1]
    got = FB.bwd_dao_stage(da, ao, wout, b, n, heads)
    want = FB.bwd_dao_stage_reference(da, ao, wout, b, n, heads)
    for a, w in zip(got, want):
        close(a, w)
    launched = {k: c for k, c in build.LAUNCHES.items() if c}
    assert launched == {"megablock_bwd_mlp_dz1": 1, "megablock_bwd_mlp_dx1": 1,
                        "megablock_bwd_mlp_dao": 1}
    args = (g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, b, n, heads)
    first = FB.megablock_bwd_mlp(*args)
    again = FB.megablock_bwd_mlp(*args)
    want = FB._bwd_mlp_reference(*args)
    for k in first._fields:
        assert torch.equal(getattr(first, k), getattr(again, k)), k
        if k != "part":
            close(getattr(first, k), getattr(want, k).to(getattr(first, k).dtype))
    close(first.part.sum(0), want.part[0])
    assert build.LAUNCHES["megablock_bwd_mlp"] == 2 and build.LAUNCHES["megablock_bwd_mlp_dx1"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("splits,count", [(512, 768), (1025, 768), (9, 96), (1, 16)])
def test_sum_partials_is_bit_equal_to_its_order_model_on_card(splits, count):
    """The sum_partials kernel gives the bits of sum_partials_reference (the
    same f32 adds in the same order) and the same bits on a second call."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(splits)
    part = torch.randn((splits, count), generator=gen, device="cuda")
    got, again = WG.sum_partials(part), WG.sum_partials(part)
    torch.cuda.synchronize()
    assert torch.equal(got, WG.sum_partials_reference(part)) and torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,e,heads,dh", [(2, 1025, 384, 6, 64), (3, 257, 192, 3, 64),
                                            (2, 1025, 384, 3, 128), (2, 1025, 384, 12, 32),
                                            (4, 257, 192, 6, 32), (2, 65, 48, 2, 24)],
                         ids=["n1025_e384_dh64", "n257_e192_dh64", "n1025_e384_dh128",
                              "n1025_e384_dh32", "n257_e192_dh32", "n65_e48_dh24"])
def test_ln_qkv_kernel_at_straddling_shapes_matches_plain_on_card(b, n, e, heads, dh):
    """LN->qkv where many 64-row slices straddle two samples (N 1,025 and
    257; rows past M in the last tile), at E 192 and 384 and with heads of
    64 and 128 (slices in one sample leave by TMA stores, the others by the
    copy-out) and of 32 and 24 (the copy-out only; an 8-column group always
    lies in one head): within 2e-2 * max(1, max|plain|) of the plain
    version, two calls bit-equal, one launch a call."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(n + dh)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    x = rn(b, n, e)
    ln_s, ln_b = 1 + rn(e, scale=0.1, dtype=torch.float32), rn(e, scale=0.1, dtype=torch.float32)
    qkv_w, qkv_b = rn(3, heads, e, dh, scale=0.05), rn(3 * heads * dh, scale=0.1,
                                                       dtype=torch.float32)
    build.reset_launches()
    got = FB.ln_qkv_forward(x, ln_s, ln_b, qkv_w, qkv_b)
    again = FB.ln_qkv_forward(x, ln_s, ln_b, qkv_w, qkv_b)
    want = FB._ln_qkv_reference(x, ln_s, ln_b, qkv_w, qkv_b)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (3, b, heads, n, dh) and torch.isfinite(got.float()).all()
    assert torch.equal(got, again)
    tol = 2e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert {k: c for k, c in build.LAUNCHES.items() if c} == {"ln_qkv_fwd": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("m,e,heads,dh", [(2050, 384, 6, 64), (514, 192, 3, 64), (130, 48, 2, 24)],
                         ids=["m2050_e384", "m514_e192", "m130_e48"])
def test_megablock_bwd_ln1_matches_plain_row_for_row_on_card(m, e, heads, dh):
    """The backward's LN1 half against its plain version on the same bf16
    inputs: dx, its LN1^T(dy1) term (dx - dx1), y1 and the dln1 partials of
    each 64-row tile row for row, each within 2e-2 * its own max|plain|;
    sum_partials of the kernel's partials against the plain sum; two calls
    bit-equal; one launch a call."""
    _cuda_or_skip()
    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(m)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    dqkv, x, dx1 = rn(m, 3 * heads * dh), rn(m, e), rn(m, e, dtype=torch.float32)
    qkv_w = rn(3, heads, e, dh, scale=0.05, dtype=torch.float32)
    ln_s, ln_b = 1 + rn(e, scale=0.1, dtype=torch.float32), rn(e, scale=0.1, dtype=torch.float32)
    args = (dqkv, qkv_w, x, dx1, ln_s, ln_b)
    build.reset_launches()
    got, again = FB.megablock_bwd_ln1(*args), FB.megablock_bwd_ln1(*args)
    want = FB._bwd_ln1_reference(*args)
    torch.cuda.synchronize()
    assert build.LAUNCHES["megablock_bwd_ln1"] == 2
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    assert got[2].shape == want[2].shape == (-(-m // 64), 2 * e)

    def close(a, w):
        assert a.shape == w.shape and torch.isfinite(a.float()).all()
        assert (a.float() - w.float()).abs().max().item() <= 2e-2 * w.float().abs().max().item()

    close(got[0], want[0])
    close(got[0].float() - dx1, want[0].float() - dx1)
    close(got[1], want[1])
    close(got[2], want[2])
    close(WG.sum_partials(got[2]), want[2].sum(0))


# --- the wide variants (E > 384) ---------------------------------------------------------


def _wide_inputs(b, n, e, heads, hidden, rate, seed):
    """One block's bf16 rows, f32 parameters and masks (or None) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    m, f32 = b * n, torch.float32
    c = dict(x=rn(m, e), g=rn(m, e), x1=rn(m, e), z1=rn(m, hidden), ao=rn(m, e),
             dqkv=rn(m, 3 * e), dx1=rn(m, e, dtype=f32),
             ln_s=1 + rn(e, scale=0.1, dtype=f32), ln_b=rn(e, scale=0.1, dtype=f32),
             w1=rn(e, hidden, scale=0.05), b1=rn(hidden, scale=0.1, dtype=f32),
             w2=rn(hidden, e, scale=0.05), wout=rn(e, e, scale=0.05),
             qkv_w=rn(3, heads, e, e // heads, scale=0.05, dtype=f32),
             qkv_b=rn(3 * e, scale=0.1, dtype=f32), m1=None, m2=None)
    if rate:
        c["m1"], c["m2"] = ((torch.rand((m, e), generator=gen, device="cuda") >= rate).to(f32)
                            / (1 - rate) for _ in range(2))
    return c


def _fwd_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got.float()).all()
    tol = 2e-2 * max(1.0, want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _bwd_close(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape and torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() <= 2e-2 * want.float().abs().max().item()


WIDE_SHAPES = [(2, 257, 520, 5, 1040), (2, 257, 768, 12, 3072)]
WIDE_IDS = ["n257_e520", "n257_e768"]


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=WIDE_IDS)
def test_wide_kernels_match_plain_on_card(shape, rate):
    """Each wide launch against its plain version on the same bf16 inputs:
    the LN rows, the streamed fc1 (h, z1) and qkv ((3, B, H, N, Dh), rows
    that straddle samples) within 2e-2 * max(1, max|plain|); the dmlp rows
    bit-equal to theirs; the streamed dz1, dy in f32, the dx1 rows (dln2 by
    the partials' column sums), the streamed dao and the LN1 half (its
    partials row for row) within 2e-2 * each output's own max|plain|, each
    bit-equal across two calls; the launches counted under the wide names."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    c = _wide_inputs(*shape, rate, seed=e)
    m = b * n
    build.reset_launches()
    y = FM.ln_rows(c["x"], c["ln_s"], c["ln_b"])
    _fwd_close(y, FM.ln_rows_reference(c["x"], c["ln_s"], c["ln_b"]))
    for got, want in zip(FM.fc1_stage(y, c["w1"], c["b1"], want_z1=True),
                         FM.fc1_stage_reference(y, c["w1"], c["b1"])):
        _fwd_close(got, want)
    x3 = c["x"].reshape(b, n, e)
    qkv = FB.ln_qkv_forward(x3, c["ln_s"], c["ln_b"], c["qkv_w"], c["qkv_b"])
    _fwd_close(qkv, FB._ln_qkv_reference(x3, c["ln_s"], c["ln_b"], c["qkv_w"], c["qkv_b"]))
    assert {k: v for k, v in build.LAUNCHES.items() if v} == {
        "ln_rows": 2, "ln_mlp_fc1_wide": 1, "ln_qkv_fwd_wide": 1}
    build.reset_launches()
    if rate:
        dmlp = FB.bwd_dmlp_rows(c["g"], c["m2"])
        torch.cuda.synchronize()
        assert torch.equal(dmlp, FB.bwd_dmlp_rows_reference(c["g"], c["m2"]))
    stages = {
        "dz1": (lambda: FB.bwd_dz1_stage(c["g"], c["m2"], c["z1"], c["w2"]),
                lambda: FB.bwd_dz1_stage_reference(c["g"], c["m2"], c["z1"], c["w2"])),
        "dy": (lambda: FB.bwd_dy(c["z1"], c["w1"]),
               lambda: FB.bwd_dy_reference(c["z1"], c["w1"])),
        "dx1": (lambda: FB.bwd_dx1_rows(FB.bwd_dy_reference(c["z1"], c["w1"]), c["g"], c["m1"],
                                        c["x1"], c["ln_s"], c["ln_b"]),
                lambda: FB.bwd_dx1_rows_reference(FB.bwd_dy_reference(c["z1"], c["w1"]), c["g"],
                                                  c["m1"], c["x1"], c["ln_s"], c["ln_b"])),
        "dao": (lambda: FB.bwd_dao_stage(c["g"], c["ao"], c["wout"], b, n, heads),
                lambda: FB.bwd_dao_stage_reference(c["g"], c["ao"], c["wout"], b, n, heads)),
        "ln1": (lambda: FB.megablock_bwd_ln1(c["dqkv"], c["qkv_w"], c["x"], c["dx1"], c["ln_s"],
                                             c["ln_b"]),
                lambda: FB._bwd_ln1_reference(c["dqkv"], c["qkv_w"], c["x"], c["dx1"], c["ln_s"],
                                              c["ln_b"]))}
    for name, (kern, plain) in stages.items():
        got, again, want = kern(), kern(), plain()
        got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
        for a, a2, w in zip(got, again, want):
            assert torch.equal(a, a2), name
            _bwd_close(a, w)
        if name in ("dx1", "ln1"):
            assert got[-1].shape == want[-1].shape == (-(-m // 64), 2 * e)
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    assert launched == {"megablock_bwd_mlp_dz1_wide": 2, "megablock_bwd_dy": 4,
                        "megablock_bwd_mlp_dx1_rows": 2, "megablock_bwd_mlp_dao_wide": 2,
                        "megablock_bwd_ln1_rows": 2,
                        **({"megablock_bwd_mask_rows": 3} if rate else {})}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=WIDE_IDS)
def test_wide_megablock_block_matches_autograd_of_the_plain_block_on_card(shape, rate):
    """A whole block at E 520 and 768 through the wide variants: the training
    forward's masks bit-equal to the plain Philox's, its output within 2e-2
    * max(1, max|plain|); the saved backward's dx and 12 parameter gradients
    within 2e-2 * their own max|plain| of autograd through the plain masked
    block in f32; no resident LN kernel launched."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    x, g, params, seed = _mb_inputs(b, n, e, heads, hidden, seed=e)
    p = FB._block_view(params)
    build.reset_launches()
    out, res = FB.fused_encoder_block(x, p, num_heads=heads, rate=rate, seed=seed,
                                      want_residuals=True)
    m1, m2 = ((res.m1, res.m2) if rate else (torch.ones(b, n, e, device="cuda"),) * 2)
    dx, grads = FB.fused_encoder_block_bwd(params, g, res, num_heads=heads)
    torch.cuda.synchronize()
    for resident in ("ln_qkv_fwd", "ln_mlp_fc1", "megablock_bwd_mlp_dz1", "megablock_bwd_mlp_dx1",
                     "megablock_bwd_mlp_dao", "megablock_bwd_ln1"):
        assert build.LAUNCHES[resident] == 0, resident
    assert build.LAUNCHES["ln_rows"] == 3 and build.LAUNCHES["ln_qkv_fwd_wide"] == 2
    assert build.LAUNCHES["megablock_bwd_mlp_dx1_rows"] == build.LAUNCHES["megablock_bwd_ln1_rows"]
    leaves = [x.float().requires_grad_(), *(t.clone().requires_grad_() for t in params)]
    ref = FB._block_reference_masked(leaves[0], FB._block_view(leaves[1:]), m1, m2, heads)
    _fwd_close(out.float(), ref.detach())
    want = torch.autograd.grad(ref, leaves, g.float())
    for got, w in zip((dx, *grads), want):
        _bwd_close(got, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_wide_variants_forced_at_384_match_the_resident_kernels_on_card(rate):
    """At E 384 ``wide=True`` runs the wide variants where the resident
    kernels run by default: LN -> fc1, LN -> qkv, the MLP half and the LN1
    half each within 2e-2 of the resident kernel's result (forwards of
    max(1, max|resident|), backward outputs of their own max|resident|);
    the two read the same statistics."""
    _cuda_or_skip()
    b, n, e, heads, hidden = 2, 1025, 384, 6, 1536
    c = _wide_inputs(b, n, e, heads, hidden, rate, seed=384)
    for wide in (True, False):
        build.reset_launches()
        got = FM.ln_fc1_stage(c["x1"], c["ln_s"], c["ln_b"], c["w1"], c["b1"], want_z1=True,
                              wide=wide)
        if wide:
            forced = got
            assert build.LAUNCHES["ln_rows"] == 1 and build.LAUNCHES["ln_mlp_fc1"] == 0
    for a, w in zip(forced, got):
        _fwd_close(a, w)
    x3 = c["x"].reshape(b, n, e)
    qkv = [FB.ln_qkv_forward(x3, c["ln_s"], c["ln_b"], c["qkv_w"], c["qkv_b"], wide=w)
           for w in (True, False)]
    _fwd_close(*qkv)
    args = (c["g"], c["m1"], c["m2"], c["x1"], c["z1"], c["ao"], c["w1"], c["w2"], c["wout"],
            c["ln_s"], c["ln_b"], b, n, heads)
    build.reset_launches()
    forced, resident = FB.megablock_bwd_mlp(*args, wide=True), FB.megablock_bwd_mlp(*args)
    assert build.LAUNCHES["megablock_bwd_mlp_dz1_wide"] == build.LAUNCHES["megablock_bwd_mlp_dz1"]
    for k in forced._fields:
        if k != "part":
            _bwd_close(getattr(forced, k), getattr(resident, k))
    _bwd_close(forced.part.sum(0), resident.part.sum(0))
    ln1 = (c["dqkv"], c["qkv_w"], c["x"], c["dx1"], c["ln_s"], c["ln_b"])
    for a, w in zip(FB.megablock_bwd_ln1(*ln1, wide=True), FB.megablock_bwd_ln1(*ln1)):
        _bwd_close(a, w)


# --- the f32 flash kernels (csrc/flash_f32.cuh, flash_f32_bwd.cuh) ---------------------

F32_SHAPES = [(2, 3, 257, 64), (4, 4, 50, 108), (2, 4, 32, 96), (1, 2, 65, 24), (1, 1, 1025, 128),
              (32, 6, 1024, 64)]
F32_IDS = ["n257_dh64", "n50_dh108", "n32_dh96", "n65_dh24", "n1025_dh128", "highres128_g"]
# The f32 kernels round their operands to TF32 (2**-11 relative); the plain
# versions run in full f32 (no TF32 in torch.matmul: allow_tf32 False here).
F32_RTOL = 5e-3


@pytest.fixture
def _full_f32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _f32_inputs(shape, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda") for _ in range(4)]


def _worst(got, want, own: bool):
    """max |got - want| over max(1, max|want|) (forwards) or max|want| (own)."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert torch.isfinite(got).all()
    peak = want.abs().max().item()
    return (got - want).abs().max().item() / (peak if own else max(1.0, peak))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_SHAPES, ids=F32_IDS)
@pytest.mark.parametrize("mode", ["dot", "l2", "l2ref"])
def test_f32_forward_matches_plain_on_card(mode, shape, _full_f32):
    """The f32 forward kernel in each score mode against the plain f32
    forward: o within F32_RTOL * max(1, max|plain|), the LSE within 2.5e-3,
    o in f32 and contiguous at the unpadded width, launched under
    flash_attn_fwd_f32[mode]; its error under half the bf16 kernel's."""
    _cuda_or_skip()
    q, k, v, _ = _f32_inputs(shape)
    scale = float(shape[1] * shape[3])
    build.reset_launches()
    o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
    assert build.LAUNCHES[f"flash_attn_fwd_f32[{mode}]"] == 1
    po, plse = A.attention_forward_reference(q, k, v, scale, mode)
    err = _worst(o, po, own=False)
    assert err <= F32_RTOL and o.is_contiguous()
    assert (lse - plse).abs().max().item() <= 2.5e-3
    ob, _ = A.flash_forward(q.bfloat16(), k.bfloat16(), v.bfloat16(), scale, score_mode=mode)
    assert err <= 0.5 * _worst(ob.float(), po, own=False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_SHAPES, ids=F32_IDS)
@pytest.mark.parametrize("mode", ["dot", "l2"])
@pytest.mark.parametrize("name", ["flash_attn_bwd_fused", "flash_attn_bwd_dq",
                                  "flash_attn_bwd_dkv"])
def test_f32_backward_kernel_matches_plain_on_card(name, mode, shape, _full_f32):
    """Each f32 backward kernel in `dot` and `l2` against its plain version in
    f32 on the f32 forward's o and LSE: every output within F32_RTOL * its
    own max|plain|, bit-equal across two calls, its error under half the
    bf16 kernel's on the same inputs."""
    _cuda_or_skip()
    q, k, v, do = _f32_inputs(shape, seed=1)
    scale = float(shape[1] * shape[3])
    o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
    kern = {"flash_attn_bwd_fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
            "flash_attn_bwd_dq": (A.flash_backward_dq, A.flash_bwd_dq_reference),
            "flash_attn_bwd_dkv": (A.flash_backward_dkv, A.flash_bwd_dkv_reference)}[name]

    def outs(fn, *args):
        r = fn(*args, scale, score_mode=mode)
        return r if isinstance(r, tuple) else (r,)

    args = (q, k, v, o, lse, do)
    build.reset_launches()
    got = outs(kern[0], *args)
    assert build.LAUNCHES[f"{name}_f32[{mode}]"] == 1
    again = outs(kern[0], *args)
    want = outs(kern[1], *args)
    bf = [t.bfloat16() for t in (q, k, v, o)]
    got_bf = outs(kern[0], *bf, lse, do.bfloat16())
    for g, a, w, b in zip(got, again, want, got_bf):
        assert torch.equal(g, a)
        err = _worst(g, w, own=True)
        assert err <= F32_RTOL and g.is_contiguous()
        assert err <= 0.5 * _worst(b.float(), w, own=True)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1, 64, 64), (1, 1, 65, 64), (1, 1, 16385, 64),
                                   (40, 1, 1024, 64)], ids=["64", "65", "16385", "40x1024"])
def test_f32_single_pass_is_bit_equal_at_many_key_blocks_on_card(shape, _full_f32):
    """Past one key block the f32 single pass adds dQ in key-block order:
    bit-equal across two calls at one head x 16,385 tokens too, and at 40
    heads of 1,024 tokens (the ticket's groups of 32 heads, a ragged last
    group of 8)."""
    _cuda_or_skip()
    q, k, v, do = _f32_inputs(shape, seed=2)
    o, lse = A.flash_forward(q, k, v, 64.0)
    first = A.flash_backward_fused(q, k, v, o, lse, do, 64.0)
    again = A.flash_backward_fused(q, k, v, o, lse, do, 64.0)
    want = A.flash_bwd_fused_reference(q, k, v, o, lse, do, 64.0)
    for a, b, w in zip(first, again, want):
        assert torch.equal(a, b)
        assert _worst(a, w, own=True) <= F32_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("fusion", ["auto", "fused", "two_pass"])
@pytest.mark.parametrize("mode", ["dot", "l2"])
def test_f32_flash_attention_autograd_on_card(mode, fusion, _full_f32):
    """Autograd through the f32 kernels on each backward route against
    autograd of the plain attention in f32: gradients within F32_RTOL * their
    own max|plain|, only f32 kernels launched."""
    _cuda_or_skip()
    saved = policy.get_policy()
    policy.set_policy(bwd_fusion=fusion)
    try:
        q, k, v, g = _f32_inputs((4, 4, 50, 108), seed=3)
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        build.reset_launches()
        got = torch.autograd.grad(A.flash_attention(*xs, mode, 432.0), xs, g)
        launched = {key for key, c in build.LAUNCHES.items() if c}
        assert launched and all("_f32[" in key for key in launched)
        ys = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(A.attention_reference(*ys, mode, 432.0), ys, g)
        for a, w in zip(got, want):
            assert _worst(a, w, own=True) <= F32_RTOL
    finally:
        policy.set_policy(**saved)


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ["gelu", "relu", "tanh", "sigmoid"])
@pytest.mark.parametrize("wide", [False, True], ids=["resident", "wide"])
def test_ln_fc1_stage_takes_each_activation_on_card(activation, wide):
    """The LN -> fc1 -> act stage (resident and wide) with each activation
    against its plain version: h and z1 within 2e-2 * max(1, max|plain|),
    bit-equal across two calls; the whole LN->MLP through fused_ln_mlp."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    m, e, hidden = 514, 192, 768
    a = torch.randn(m, e, device="cuda", generator=gen).to(torch.bfloat16)
    ln_s = 1.0 + 0.1 * torch.randn(e, device="cuda", generator=gen)
    ln_b = 0.1 * torch.randn(e, device="cuda", generator=gen)
    w1 = (0.05 * torch.randn(e, hidden, device="cuda", generator=gen)).to(torch.bfloat16)
    b1 = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    h, z1 = FM.ln_fc1_stage(a, ln_s, ln_b, w1, b1, want_z1=True, wide=wide, activation=activation)
    again, _ = FM.ln_fc1_stage(a, ln_s, ln_b, w1, b1, wide=wide, activation=activation)
    want_h, want_z1 = FM.ln_fc1_stage_reference(a, ln_s, ln_b, w1, b1, activation=activation)
    torch.cuda.synchronize()
    assert torch.equal(h, again)
    for got, want in ((h, want_h), (z1, want_z1)):
        tol = 2e-2 * max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol
    w2 = (0.05 * torch.randn(hidden, e, device="cuda", generator=gen)).to(torch.bfloat16)
    out = FM.fused_ln_mlp(a, ln_s, ln_b, w1, b1, w2, ln_b, activation)
    want = FM._reference(a, ln_s, ln_b, w1, b1, w2, ln_b, activation)
    torch.cuda.synchronize()
    tol = 2e-2 * max(1.0, (want.float() - a.float()).abs().max().item()) + 2 ** -7 * want.float(
        ).abs().max().item()
    assert (out.float() - want.float()).abs().max().item() <= tol


# --- the LayerNorm family's f32 forward (csrc/ln_f32.cuh on tile_f32.cuh's tile) ---------

# (batch, tokens, E, heads, hidden): tiles straddling samples and the 128-row
# edge at E 64 and 192 (the bf16 route's resident kernels), 520 and 768 (its
# wide variants).
F32_LN_SHAPES = [(2, 65, 64, 2, 128), (2, 257, 192, 3, 768), (3, 43, 520, 5, 1040),
                 (2, 64, 768, 12, 3072)]
F32_LN_IDS = ["n65_e64", "n257_e192", "n43_e520", "n64_e768"]


def _f32_ln_close(got, want, bf16_got, what: str) -> None:
    """An f32 output within F32_RTOL * max(1, max|plain|) of its plain
    version, under half the bf16 kernel's error on the same inputs."""
    assert got.dtype == torch.float32, what
    err = _worst(got, want, own=False)
    assert err <= F32_RTOL, f"{what}: {err:.4g}"
    assert err <= 0.5 * _worst(bf16_got.float(), want, own=False), what


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_LN_SHAPES, ids=F32_LN_IDS)
def test_f32_ln_stages_match_plain_on_card(shape, _full_f32):
    """The f32 entries (the A . W^T tile's kFc1, kLinear and kQkv epilogues)
    against their plain versions in full f32: LN -> fc1 (h and z1, and h
    alone) with each activation, the linear stage with and without a
    residual and a 0.1 dropout mask, LN1 -> qkv into (3, B, H, N, Dh); each
    output within F32_RTOL * max(1, max|plain|), under half the bf16
    kernel's error, bit-equal across two calls; one entry at every E (no
    bf16 LN rows launch), each launch counted under its _f32 name; the f32
    mask bit-equal to the plain mask and to the bf16 stage's, at one rank
    and under a data-parallel row map."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    x, _, params, seed = _mb_inputs(b, n, e, heads, hidden)
    x = x.float()
    ln1s, ln1b, qkv_w, qkv_b, _, _, ln_s, ln_b, w1, b1, w2, b2 = params
    rows = x.reshape(-1, e)
    m = rows.shape[0]
    a = 0.5 * torch.randn(m, hidden, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(5))
    build.reset_launches()
    h, z1 = FM.ln_fc1_stage(rows, ln_s, ln_b, w1, b1, want_z1=True)
    h2, z12 = FM.ln_fc1_stage(rows, ln_s, ln_b, w1, b1, want_z1=True, wide=True)
    want = FM.ln_fc1_stage_reference(rows, ln_s, ln_b, w1, b1, dtype=torch.float32)
    bf16 = FM.ln_fc1_stage(rows.bfloat16(), ln_s, ln_b, w1, b1, want_z1=True)
    for got, again, w_, b_, what in ((h, h2, want[0], bf16[0], "h"), (z1, z12, want[1], bf16[1],
                                                                        "z1")):
        _f32_ln_close(got, w_, b_, f"fc1 {what}")
        assert torch.equal(got, again)
    for act in ("relu", "tanh", "sigmoid"):  # h alone: no z1 stored
        h, z1 = FM.ln_fc1_stage(rows, ln_s, ln_b, w1, b1, activation=act)
        again, _ = FM.ln_fc1_stage(rows, ln_s, ln_b, w1, b1, activation=act)
        want = FM.ln_fc1_stage_reference(rows, ln_s, ln_b, w1, b1, dtype=torch.float32,
                                         activation=act)[0]
        bf16 = FM.ln_fc1_stage(rows.bfloat16(), ln_s, ln_b, w1, b1, activation=act)[0]
        assert z1 is None
        _f32_ln_close(h, want, bf16, f"fc1 {act} h")
        assert torch.equal(h, again)
    out, mask = FM.linear_stage(a, w2, b2, rows, seed, 0.1, 1)
    again, _ = FM.linear_stage(a, w2, b2, rows, seed, 0.1, 1)
    plain_mask = FB.dropout_mask(seed, 1, (m, e), 0.1)
    bout, bmask = FM.linear_stage(a.bfloat16(), w2, b2, rows.bfloat16(), seed, 0.1, 1)
    _f32_ln_close(out, FM.linear_stage_reference(a, w2, b2, rows, plain_mask, torch.float32),
                  bout, "linear")
    assert torch.equal(out, again) and torch.equal(mask, plain_mask) and torch.equal(mask, bmask)
    for res, rate in ((None, 0.1), (rows, 0.0), (None, 0.0)):  # the epilogue's other forms
        out, mask = FM.linear_stage(a, w2, b2, res, seed, rate, 1)
        again, _ = FM.linear_stage(a, w2, b2, res, seed, rate, 1)
        bout, _ = FM.linear_stage(a.bfloat16(), w2, b2, None if res is None else res.bfloat16(),
                                  seed, rate, 1)
        pm = plain_mask if rate else None
        _f32_ln_close(out, FM.linear_stage_reference(a, w2, b2, res, pm, torch.float32), bout,
                      f"linear res {res is not None} rate {rate}")
        assert torch.equal(out, again) and (mask is None if not rate else torch.equal(mask, pm))
    mapped = (n, b, 4 * b, b)  # this rank's samples are samples b.. of a global batch of 4 b
    _, m32 = FM.linear_stage(a, w2, b2, rows, seed, 0.1, 1, mapped)
    _, m16 = FM.linear_stage(a.bfloat16(), w2, b2, rows.bfloat16(), seed, 0.1, 1, mapped)
    assert torch.equal(m32, m16) and torch.equal(m32, FB.row_mask(seed, 1, (m, e), 0.1, mapped))
    qkv = FB.ln_qkv_forward(x, ln1s, ln1b, qkv_w, qkv_b.reshape(-1))
    again = FB.ln_qkv_forward(x, ln1s, ln1b, qkv_w, qkv_b.reshape(-1), wide=True)
    bqkv = FB.ln_qkv_forward(x.bfloat16(), ln1s, ln1b, qkv_w, qkv_b.reshape(-1))
    _f32_ln_close(qkv, FB._ln_qkv_reference(x, ln1s, ln1b, qkv_w, qkv_b.reshape(-1)), bqkv, "qkv")
    assert torch.equal(qkv, again)
    f32_launches = {k: v for k, v in build.LAUNCHES.items() if v and k.endswith("_f32")}
    assert f32_launches == {"ln_mlp_fc1_f32": 8, "ln_mlp_linear_f32": 9, "ln_qkv_fwd_f32": 2}


@pytest.mark.cuda
def test_f32_ln_fc1_captured_reads_the_weight_of_each_replay(_full_f32):
    """The f32 LN -> fc1 entry captured in a CUDA graph: w1 updated in place
    after the capture, the replay gives the eager result on the new weight
    bit for bit (its K-major copy is made inside the call, so the graph
    copies w1 anew on each replay); so does the linear stage on w2."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(12)
    m, e, hidden = 2 * 257, 192, 768
    x = torch.randn(m, e, device="cuda", generator=gen)
    ln_s = 1.0 + 0.1 * torch.randn(e, device="cuda", generator=gen)
    ln_b = 0.1 * torch.randn(e, device="cuda", generator=gen)
    w1 = torch.randn(e, hidden, device="cuda", generator=gen) * e ** -0.5
    b1 = 0.1 * torch.randn(hidden, device="cuda", generator=gen)
    w2 = torch.randn(hidden, e, device="cuda", generator=gen) * hidden ** -0.5

    def step():
        h, z1 = FM.ln_fc1_stage(x, ln_s, ln_b, w1, b1, want_z1=True)
        out, _ = FM.linear_stage(h, w2, ln_b, x)
        return h, z1, out

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # the libraries built and loaded before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = step()
    for i in range(2):
        with torch.no_grad():
            w1.add_(0.01 * torch.randn(e, hidden, device="cuda", generator=gen))
            w2.mul_(1.0 + 0.1 * (i + 1))
        graph.replay()
        eager = step()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    want = FM.ln_fc1_stage_reference(x, ln_s, ln_b, w1, b1, dtype=torch.float32)
    assert _worst(captured[0], want[0], own=False) <= F32_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", F32_LN_SHAPES, ids=F32_LN_IDS)
def test_f32_megablock_forward_matches_plain_on_card(shape, rate, _full_f32):
    """The megablock's f32 forward (LN1 -> qkv, the f32 flash forward into
    (B, N, H*Dh), the out-projection and LN2 -> MLP stages) against the plain
    block in full f32 within F32_RTOL * max(1, max|plain|), its masks
    bit-equal to the plain Philox's, its residuals in f32, every launch an
    f32 kernel's; bit-equal across two calls."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    x, _, params, seed = _mb_inputs(b, n, e, heads, hidden)
    x, p = x.float(), FB._block_view(params)
    build.reset_launches()
    if rate == 0.0:
        out = FB.fused_encoder_block(x, p, num_heads=heads)
        again = FB.fused_encoder_block(x, p, num_heads=heads)
        want = FB._block_reference(x, p, heads)
    else:
        out, res = FB.fused_encoder_block(x, p, num_heads=heads, rate=rate, seed=seed,
                                          want_residuals=True)
        again, _, _ = FB.fused_encoder_block(x, p, num_heads=heads, rate=rate, seed=seed)
        assert all(t.dtype == torch.float32 for t in (res.x1, res.z1, res.ao, res.lse))
        for i, mask in enumerate((res.m1, res.m2)):
            assert torch.equal(mask, FB.dropout_mask(seed, i, x.shape, rate))
        want = FB._block_reference_masked(x, p, res.m1, res.m2, heads)
    assert _worst(out, want, own=False) <= F32_RTOL
    assert torch.equal(out, again)
    launched = {k for k, v in build.LAUNCHES.items() if v}
    assert launched <= {"ln_qkv_fwd_f32", "flash_attn_fwd_f32[dot]", "ln_mlp_fc1_f32",
                        "ln_mlp_linear_f32", "proj_ln_mlp_fwd", "ln_mlp_train_fwd"}
    assert "ln_qkv_fwd_f32" in launched and "ln_mlp_fc1_f32" in launched


@pytest.mark.cuda
def test_f32_flash_forward_writes_the_megablock_layout_on_card(_full_f32):
    """``out=`` in f32 (`dot`): the (B, N, H*Dh) rows bit-equal to the (B, H,
    N, Dh) output transposed, the same LSE."""
    _cuda_or_skip()
    q, k, v, _ = _f32_inputs((2, 3, 257, 64))
    attn = torch.empty(2, 257, 3 * 64, device="cuda")
    o_bnhd, lse = A.flash_forward(q, k, v, 64.0, out=attn)
    o, lse2 = A.flash_forward(q, k, v, 64.0)
    torch.cuda.synchronize()
    assert o_bnhd is attn
    assert torch.equal(attn, o.transpose(1, 2).reshape(2, 257, 3 * 64)) and torch.equal(lse, lse2)


# --- the saved backward in f32 (csrc/tile_f32.cuh, ln_rows.cuh) --------------------------

# (B, N, E, heads, hidden): deit64's ragged rows (E 192, Dh 64), a wide E 520
# with Dh 104 (blocks of one head), one head of 64 over 130 rows.
F32_BWD_SHAPES = [(2, 257, 192, 3, 768), (3, 65, 520, 5, 1040), (2, 130, 64, 1, 128)]
F32_BWD_IDS = ["n257_e192_dh64", "n65_e520_dh104", "n130_e64_dh64"]


def _f32_bwd_inputs(b, n, e, heads, hidden, rate, seed):
    """One block's f32 rows, parameters and masks (or None) on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")

    m = b * n
    c = dict(x=rn(m, e), g=rn(m, e), x1=rn(m, e), z1=rn(m, hidden), ao=rn(m, e),
             dqkv=rn(m, 3 * e), dx1=rn(m, e), ln_s=1 + rn(e, scale=0.1), ln_b=rn(e, scale=0.1),
             w1=rn(e, hidden, scale=0.05), w2=rn(hidden, e, scale=0.05),
             wout=rn(e, e, scale=0.05), qkv_w=rn(3, heads, e, e // heads, scale=0.05),
             m1=None, m2=None)
    if rate:
        c["m1"], c["m2"] = ((torch.rand((m, e), generator=gen, device="cuda") >= rate).float()
                            / (1 - rate) for _ in range(2))
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", F32_BWD_SHAPES, ids=F32_BWD_IDS)
def test_f32_bwd_entries_match_plain_on_card(shape, rate, _full_f32):
    """Each f32 entry of the saved backward against its plain version in full
    f32 on the same f32 inputs, every output f32 within F32_RTOL * max(1,
    max|plain|) and bit-equal across two calls: the dz1 stage (the dmlp rows
    bit-equal to g * m2, then dz1 and h1), dy = a . w^T, the dx1 rows, dao
    with delta, the LN1 half (dy1, then the LN1 rows) and wgrad_gemm; the LN
    partials (a row a 64-row tile) through sum_partials bit-equal to its
    order model; each launch counted under its f32 name."""
    from vitgan_tpu_torch.ops import wgrad as WG

    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    c = _f32_bwd_inputs(*shape, rate, seed=e + n)
    m, f32 = b * n, torch.float32
    dy2 = FB.bwd_dy_reference(c["z1"], c["w1"])
    build.reset_launches()
    stages = {
        "dz1": (lambda: FB.bwd_dz1_stage(c["g"], c["m2"], c["z1"], c["w2"]),
                lambda: FB.bwd_dz1_stage_reference(c["g"], c["m2"], c["z1"], c["w2"], f32)),
        "dy": (lambda: FB.bwd_dy(c["z1"], c["w1"]),
               lambda: FB.bwd_dy_reference(c["z1"], c["w1"])),
        "dx1": (lambda: FB.bwd_dx1_rows(dy2, c["g"], c["m1"], c["x1"], c["ln_s"], c["ln_b"]),
                lambda: FB.bwd_dx1_rows_reference(dy2, c["g"], c["m1"], c["x1"], c["ln_s"],
                                                  c["ln_b"], dtype=f32)),
        "dao": (lambda: FB.bwd_dao_stage(c["g"], c["ao"], c["wout"], b, n, heads),
                lambda: FB.bwd_dao_stage_reference(c["g"], c["ao"], c["wout"], b, n, heads, f32)),
        "ln1": (lambda: FB.megablock_bwd_ln1(c["dqkv"], c["qkv_w"], c["x"], c["dx1"], c["ln_s"],
                                             c["ln_b"]),
                lambda: FB._bwd_ln1_reference(c["dqkv"], c["qkv_w"], c["x"], c["dx1"], c["ln_s"],
                                              c["ln_b"])),
        "wgrad": (lambda: WG.wgrad_gemm(c["z1"], c["g"]),
                  lambda: WG.wgrad_reference(c["z1"], c["g"])),
    }
    for name, (kern, plain) in stages.items():
        got, again, want = kern(), kern(), plain()
        got, again, want = ((t,) if torch.is_tensor(t) else t for t in (got, again, want))
        for i, (a, a2, w) in enumerate(zip(got, again, want)):
            assert a.dtype == f32, (name, i)
            assert torch.equal(a, a2), (name, i)
            assert _worst(a, w.float(), own=False) <= F32_RTOL, (name, i)
        if name == "dz1" and rate:
            assert torch.equal(got[0], c["g"] * c["m2"])
        if name in ("dx1", "ln1"):
            part = got[-1]
            assert part.shape == (-(-m // 64), 2 * e)
            assert torch.equal(WG.sum_partials(part), WG.sum_partials_reference(part))
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    assert launched == {"megablock_bwd_mlp_dz1_f32": 2, "megablock_bwd_dy_f32": 4,
                        "megablock_bwd_mlp_dx1_rows_f32": 2, "megablock_bwd_mlp_dao_f32": 2,
                        "megablock_bwd_ln1_rows_f32": 2, "wgrad_gemm_f32": 2, "sum_partials": 2,
                        **({"megablock_bwd_mask_rows_f32": 2} if rate else {})}


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("shape", [(2, 257, 192, 3, 768), (3, 65, 128, 2, 256)],
                         ids=["n257_e192", "n65_e128"])
def test_f32_saved_backward_matches_its_plain_composition_on_card(shape, rate, _full_f32):
    """A whole f32 block on the saved route: the training forward's
    residuals, then fused_encoder_block_bwd on the card (the f32 entries,
    the qkv recompute and the flash backward in f32, wgrad_gemm_f32 four
    times, sum_partials twice) against the same function on CPU copies (its
    plain composition, in full f32): dx and the 12 parameter gradients f32,
    each within F32_RTOL of its own max|plain|, bit-equal across two calls;
    no bf16 LayerNorm, flash or megablock-backward kernel launched."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    x, g, params, seed = _mb_inputs(b, n, e, heads, hidden, seed=e)
    x, g = x.float(), g.float()
    _, res = FB.fused_encoder_block(x, FB._block_view(params), num_heads=heads, rate=rate,
                                    seed=seed, want_residuals=True)
    build.reset_launches()
    dx, grads = FB.fused_encoder_block_bwd(params, g, res, num_heads=heads)
    dx2, grads2 = FB.fused_encoder_block_bwd(params, g, res, num_heads=heads)
    torch.cuda.synchronize()
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    cpu = lambda t: None if t is None else t.cpu()  # noqa: E731
    want_dx, want = FB.fused_encoder_block_bwd([p.cpu() for p in params], g.cpu(),
                                               FB.Residuals(*map(cpu, res)), num_heads=heads)
    for got, again, w in zip((dx, *grads), (dx2, *grads2), (want_dx, *want)):
        assert got.dtype == torch.float32 and torch.equal(got, again)
        assert _worst(got, w.cuda(), own=True) <= F32_RTOL
    assert {"megablock_bwd_mlp_dz1_f32": 2, "megablock_bwd_dy_f32": 4,
            "megablock_bwd_mlp_dx1_rows_f32": 2, "megablock_bwd_mlp_dao_f32": 2,
            "megablock_bwd_ln1_rows_f32": 2, "wgrad_gemm_f32": 8, "sum_partials": 4,
            "ln_qkv_fwd_f32": 2, "megablock_bwd_mlp": 2}.items() <= launched.items()
    assert launched.get("megablock_bwd_mask_rows_f32", 0) == (2 if rate else 0)
    assert all("f32" in k or k in ("megablock_bwd_mlp", "sum_partials") for k in launched), \
        launched


# --- the f32 A . W^T tile on TF32 wgmma (csrc/tile_f32.cuh) -------------------------------

# (B, N, E, heads, hidden): chip_smoke.F32_BWD_SHAPES (highres128's G and D
# rows, deit64's ragged batch, DeiT-B's G), then a summed width that is not a
# multiple of 32 (E 520: the K tail TMA zero-fills, Dh 104: tiles of one
# head and a column remainder).
F32_TILE_SHAPES = [(32, 1024, 384, 6, 1536), (32, 1025, 384, 6, 1536), (128, 257, 192, 3, 768),
                   (64, 256, 768, 12, 3072), (3, 65, 520, 5, 1040)]
F32_TILE_IDS = ["highres128_G", "highres128_D", "deit64", "deit_b_G", "e520"]


def _tile_inputs(b, n, e, heads, hidden, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*s, scale=1.0):
        return scale * torch.randn(s, generator=gen, device="cuda")

    m = b * n
    return dict(dmlp=rn(m, e), z1=rn(m, hidden), w2=rn(hidden, e, scale=e ** -0.5),
                w1=rn(e, hidden, scale=hidden ** -0.5), dqkv=rn(m, 3 * e, scale=0.1),
                wqkv=rn(e, 3 * e, scale=e ** -0.5), da=rn(m, e), ao=rn(m, e),
                wout=rn(e, e, scale=e ** -0.5))


def _held(name, kern, plain):
    """kern() against plain() in full f32 within F32_RTOL * max(1, max|plain|)
    per output, every output f32 and bit-equal across two calls."""
    got, again, want = kern(), kern(), plain()
    got, again, want = ((t,) if torch.is_tensor(t) else tuple(t) for t in (got, again, want))
    for i, (a, a2, w) in enumerate(zip(got, again, want)):
        assert a.dtype == torch.float32 and a.shape == w.shape, (name, i)
        assert torch.equal(a, a2), (name, i)
        assert _worst(a, w.float(), own=False) <= F32_RTOL, (name, i)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_TILE_SHAPES, ids=F32_TILE_IDS)
def test_f32_tile_entries_match_plain_and_repeat_on_card(shape, _full_f32):
    """The A . W^T tile's three entries at the presets' shapes and E 520:
    dz1 with h1, dy2 = dz1 . w1^T and dy1 = dqkv . wqkv^T, dao with delta,
    each within F32_RTOL of its plain version in full f32, bit-equal across
    two calls, each launch counted under its f32 name."""
    _cuda_or_skip()
    b, n, e, heads, hidden = shape
    c = _tile_inputs(b, n, e, heads, hidden, seed=e + n)
    f32 = torch.float32
    build.reset_launches()
    _held("dz1", lambda: FB.bwd_dz1_stage(c["dmlp"], None, c["z1"], c["w2"])[1:],
          lambda: FB.bwd_dz1_stage_reference(c["dmlp"], None, c["z1"], c["w2"], f32)[1:])
    _held("dy2", lambda: FB.bwd_dy(c["z1"], c["w1"]), lambda: FB.bwd_dy_reference(c["z1"], c["w1"]))
    _held("dy1", lambda: FB.bwd_dy(c["dqkv"], c["wqkv"]),
          lambda: FB.bwd_dy_reference(c["dqkv"], c["wqkv"]))
    _held("dao", lambda: FB.bwd_dao_stage(c["da"], c["ao"], c["wout"], b, n, heads),
          lambda: FB.bwd_dao_stage_reference(c["da"], c["ao"], c["wout"], b, n, heads, f32))
    launched = {k: v for k, v in build.LAUNCHES.items() if v}
    assert launched == {"megablock_bwd_mlp_dz1_f32": 2, "megablock_bwd_dy_f32": 4,
                        "megablock_bwd_mlp_dao_f32": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [8, 64, 128])
@pytest.mark.parametrize("b,n", [(2, 257), (3, 65)])
def test_f32_dao_whole_heads_match_plain_on_card(dh, b, n, _full_f32):
    """kDao's tiles own floor(128 / Dh) whole heads (16 of Dh 8, 2 of 64, one
    of 128): dao in (B, H, N, Dh) and delta against the plain version in full
    f32 at 3 heads (E 3 Dh) over rows whose 128-row tiles straddle samples,
    bit-equal across two calls."""
    _cuda_or_skip()
    heads = 3
    e = heads * dh
    gen = torch.Generator(device="cuda").manual_seed(dh + n)
    da, ao = (torch.randn(b * n, e, generator=gen, device="cuda") for _ in range(2))
    wout = torch.randn(e, e, generator=gen, device="cuda") * e ** -0.5
    _held("dao", lambda: FB.bwd_dao_stage(da, ao, wout, b, n, heads),
          lambda: FB.bwd_dao_stage_reference(da, ao, wout, b, n, heads, torch.float32))
