"""The `l2` and `l2ref` score modes of the port's flash attention against the
JAX package, on the CPU.

- the plain forward (output and LSE) against the JAX `_flash_forward` run
  with interpret=True;
- the plain `l2` backward kernels' versions against the JAX `_flash_backward`
  under bwd_fusion 'fused' and 'two_pass', on unpadded inputs, at the v1
  head width 108 also at N 64 and 65 (one 64-row tile exactly, and one row
  past it);
- the units each persistent `l2` kernel walks (forward, single pass, dq and
  dk/dv; ops/attention.l2_grid, l2_units): every (batch*head, resident rows)
  unit exactly once, at N in {32, 50, 64, 65, 1,025} and B*H in {1, 1,024},
  the single pass past 64 keys in the order of its ticket;
- autograd through the port's flash_attention against jax.grad of the JAX
  flash_attention in interpret mode, for `l2` on both backward routes and
  for `l2ref` (whose JAX backward is the chunked recompute), at the v1
  discriminator's head width 108 and at a ragged N;
- the `l2` backward route against the JAX package's own decision, read from
  the jaxpr of its VJP (traced only): two-pass under 'auto';
- the plain and dispatch routes, the wrappers' head widths (`dot` padded to
  a multiple of 8, `l2`/`l2ref` passed where they lie), the launch keys, and
  the refusals on tensors that are neither on the CPU nor on CUDA, and of an
  `l2` head width the kernels do not take.

Tolerance: 1e-5 absolute and relative, f32 on both sides (JAX at 'highest'
matmul precision, tests/conftest.py); the sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.ops.attention import _flash_backward, _flash_forward
from vitgan_tpu.ops.attention import flash_attention as jax_flash_attention
from vitgan_tpu.ops.policy import set_policy as jax_set_policy
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build, policy

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
# (B, H, N, Dh): the v1 discriminator's head width at its 50 tokens (CLS + 49
# patches), and a ragged N with a narrow head.
SHAPES = [(1, 2, 50, 108), (2, 1, 65, 24)]
IDS = ["n50_dh108", "n65_dh24"]
# The backward's plain versions also at the edges of the two-pass kernels'
# 64-row tiles, at the v1 head width.
BWD_SHAPES = SHAPES + [(1, 2, 64, 108), (2, 1, 65, 108)]
BWD_IDS = IDS + ["n64_dh108", "n65_dh108"]
SMS = 132  # an H100's streaming multiprocessors


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)
    jax_set_policy(bwd_fusion="auto")


def _qkv(shape, seed=0, k=4):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("mode", ["l2", "l2ref"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_forward_and_lse_match_jax_kernel(mode, shape):
    q, k, v = _qkv(shape, k=3)
    scale = float(shape[1] * shape[3])
    jo, jlse = _flash_forward(*map(jnp.asarray, (q, k, v)), mode, scale, 128, 128, True,
                              with_lse=True)
    o, lse = A.attention_forward_reference(*map(torch.from_numpy, (q, k, v)), scale, mode)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)
    ref = A.attention_reference(*map(torch.from_numpy, (q, k, v)), mode, scale)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jo), **TOL)


@pytest.mark.parametrize("fusion", ["fused", "two_pass"])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=BWD_IDS)
def test_plain_l2_backward_matches_jax_kernels(fusion, shape):
    """Each plain `l2` backward against the JAX kernels of the same route (the
    dq rowsum and dk colsum terms), on the JAX forward's o and LSE."""
    q, k, v, g = _qkv(shape, seed=1)
    scale = float(shape[1] * shape[3])
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = _flash_forward(jq, jk, jv, "l2", scale, 128, 128, True, with_lse=True)
    jax_set_policy(bwd_fusion=fusion)
    want = _flash_backward(jq, jk, jv, o, lse, jg, "l2", scale, 128, 128, True)
    args = (*map(torch.from_numpy, (q, k, v, np.array(o), np.array(lse), g)), scale)
    if fusion == "fused":
        got = A.flash_bwd_fused_reference(*args, score_mode="l2")
    else:
        got = (A.flash_bwd_dq_reference(*args, score_mode="l2"),
               *A.flash_bwd_dkv_reference(*args, score_mode="l2"))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("route", [("l2", "fused"), ("l2", "two_pass"), ("l2ref", "auto")],
                         ids=["l2-fused", "l2-two_pass", "l2ref"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_attention_autograd_matches_jax(route, shape):
    """Output and gradients through the port's flash_attention against
    jax.grad of the JAX flash_attention in interpret mode, on each route."""
    mode, fusion = route
    q, k, v, g = _qkv(shape, seed=2)
    scale = float(shape[1] * shape[3])
    jax_set_policy(bwd_fusion=fusion)
    policy.set_policy(bwd_fusion=fusion)

    def jout(q, k, v):
        return jax_flash_attention(q, k, v, mode, scale, interpret=True)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o = jout(jq, jk, jv)
    want = jax.grad(lambda *a: jnp.sum(jout(*a) * jnp.asarray(g)), argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, mode, scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), **TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("entry", A.L2_KERNELS)
@pytest.mark.parametrize("d", [108, 64])
@pytest.mark.parametrize("bh", [1, 1024])
@pytest.mark.parametrize("n", [32, 50, 64, 65, 1025])
def test_l2_persistent_grid_visits_every_unit_once(n, bh, d, entry):
    """The persistent grid of each `l2` kernel and the units its blocks walk
    (blockIdx.x, + gridDim.x, ...; the single pass past 64 keys in ticket
    order, its blocks asking in blockIdx order and in reverse): every
    (batch*head, resident rows) unit exactly once, the grid never above the
    units or the SMs, the resident rows 64 at Dh 108 (two column boxes) and
    128 at Dh 64; a ticketed walk gives each block its units in ticket order."""
    rows = A.l2_unit_rows(d)
    assert rows == (64 if d == 108 else 128)
    units = bh * -(-n // rows)
    grid = A.l2_grid(n, d, bh, SMS)
    assert grid == min(units, SMS * A.L2_BLOCKS_PER_SM)
    assert A.l2_ticketed(entry, n) == (entry == "flash_attn_bwd_fused" and n > 64)
    every = [(h, r) for h in range(bh) for r in range(0, n, rows)]
    for order in (None, list(reversed(range(grid)))):
        walks = A.l2_units(entry, n, d, bh, grid, order)
        assert len(walks) == grid
        walked = [u for walk in walks for u in walk]
        assert len(walked) == units and sorted(walked) == every
        assert all(walk == sorted(walk) for walk in walks)


def _jax_pallas_calls(jaxpr) -> int:
    count = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            count += 1
            continue
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else [val]:
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    count += _jax_pallas_calls(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    count += _jax_pallas_calls(sub)
    return count


@pytest.mark.parametrize("fusion", ["auto", "fused", "two_pass"])
def test_l2_backward_route_is_the_jax_decision(fusion):
    """The JAX VJP holds the forward pallas_call plus one backward (fused) or
    two (dq, dk/dv); traced only.  Under 'auto' `l2` takes two passes at
    every length (attention.py:656-662)."""
    jax_set_policy(bwd_fusion=fusion)
    policy.set_policy(bwd_fusion=fusion)
    for n in (50, 65, 1024):
        s = jax.ShapeDtypeStruct((1, 2, n, 108), jnp.bfloat16)

        def vjp(q, k, v, g):
            f = lambda q, k, v: jax_flash_attention(q, k, v, "l2", 216.0, interpret=True)  # noqa
            return jax.vjp(f, q, k, v)[1](g)

        calls = _jax_pallas_calls(jax.make_jaxpr(vjp)(s, s, s, s).jaxpr)
        assert A.backward_route(n, 108, 2, "l2") == {2: "fused", 3: "two_pass"}[calls], n
    if fusion == "auto":
        assert A.backward_route(50, 108, 2, "l2") == "two_pass"
        assert A.backward_route(50, 108, 2, "dot") == "fused"


def test_l2ref_has_no_backward_kernel_and_double_backward_works_on_cpu():
    """As in the JAX package, `l2ref` has no backward kernel: the backward
    wrappers refuse it; its backward is autograd of the chunked recompute,
    which stays differentiable (a gradient penalty's double backward)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 9, 8), seed=3, k=3))
    lse = torch.zeros(1, 2, 9)
    for fn in (A.flash_backward, A.flash_bwd_dq_reference, A.flash_backward_dq):
        with pytest.raises(ValueError, match="l2ref"):
            fn(q, k, v, q, lse, q, 16.0, score_mode="l2ref")
    x = q.clone().requires_grad_()
    (gx,) = torch.autograd.grad(A.flash_attention(x, k, v, "l2ref", 16.0).sum(), x,
                                create_graph=True)
    (gg,) = torch.autograd.grad((gx ** 2).sum(), x)
    xr = q.clone().requires_grad_()
    (rx,) = torch.autograd.grad(A.attention_reference(xr, k, v, "l2ref", 16.0).sum(), xr,
                                create_graph=True)
    (rg,) = torch.autograd.grad((rx ** 2).sum(), xr)
    torch.testing.assert_close(gx, rx)
    torch.testing.assert_close(gg, rg)


def test_dispatch_and_head_padding(monkeypatch):
    """'auto' keeps CPU `l2` attention on the plain route, 'always' takes the
    flash Function; the `l2`/`l2ref` wrappers hand their kernels the head
    width 108 where it lies and return contiguous (B, H, N, 108) outputs,
    while the `dot` wrappers pad a width that is not a multiple of 8 (108 ->
    112) with zeros, which leaves the `dot` scores as they are, and slice the
    outputs back; unknown modes raise.  (The kernels are stood in for by an
    entry that records the head width it is given; nothing is launched.)"""
    q, k, v = (torch.from_numpy(x) for x in _qkv((1, 2, 50, 108), seed=4, k=3))
    (qp, kp), = [A._pad_head(q, k)]
    assert qp.shape[-1] == 112 and torch.equal(qp[..., :108], q) and not qp[..., 108:].any()
    assert A._pad_head(q[..., :104])[0].shape[-1] == 104
    torch.testing.assert_close(A._scores(qp, kp, 216.0, "dot"), A._scores(q, k, 216.0, "dot"))
    widths, pads = [], []
    pad_head = A._pad_head

    def counted_pad(*ts):
        pads.append(ts[0].shape[-1])
        return pad_head(*ts)

    def fake_entry(name):
        # the head width: after q, k, v, o, lse (forward) or the pointers and
        # B*H, N (backward)
        at = {"flash_attn_fwd": 7, "flash_attn_bwd_fused": 13, "flash_attn_bwd_dq": 9,
              "flash_attn_bwd_dkv": 10}[name]

        def fn(*args):
            widths.append((name, args[at]))
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(A, "_pad_head", counted_pad)
    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(A, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(build, "entry", fake_entry)
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    lse = torch.zeros(1, 2, 50)
    for mode in ("l2", "l2ref", "dot"):
        o, _ = A.flash_forward(qb, kb, vb, 216.0, score_mode=mode)
        assert o.shape == qb.shape and o.is_contiguous() == (mode != "dot")
        if mode == "dot":
            continue
        assert widths.pop() == ("flash_attn_fwd", 108) and not pads
        if mode == "l2":
            for fn in (A.flash_backward_fused, A.flash_backward_dq, A.flash_backward_dkv):
                outs = fn(qb, kb, vb, qb, lse, qb, 216.0, score_mode="l2")
                outs = outs if isinstance(outs, tuple) else (outs,)
                assert all(t.shape == qb.shape and t.is_contiguous() for t in outs)
                assert widths.pop()[1] == 108 and not pads
    assert widths.pop() == ("flash_attn_fwd", 112) and pads == [108]
    outs = A.flash_backward_fused(qb, kb, vb, qb, lse, qb, 216.0)
    assert all(t.shape == qb.shape for t in outs)
    assert widths.pop() == ("flash_attn_bwd_fused", 112) and pads == [108, 108]
    monkeypatch.undo()
    assert A.kernel_fits(108, 1024) and not A.kernel_fits(136, 4) and not A.kernel_fits(64, 65536)
    policy.set_policy(mode="auto")
    assert not A.use_flash_attention(q, 50)
    policy.set_policy(mode="always")
    x = q.clone().requires_grad_()
    out = A.dispatch_attention(x, k, v, "l2", 216.0)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.testing.assert_close(out, A.attention_reference(q, k, v, "l2", 216.0))
    with pytest.raises(ValueError, match="score_mode"):
        A.flash_attention(q, k, v, "cosine")


def test_l2_launch_keys_are_counted_apart():
    """`dot` launches count under the kernel's name, the other modes apart."""
    assert A.launch_key("flash_attn_fwd", "dot") == "flash_attn_fwd"
    for name, modes in (("flash_attn_fwd", ("l2", "l2ref")), ("flash_attn_bwd_dq", ("l2",)),
                        ("flash_attn_bwd_dkv", ("l2",)), ("flash_attn_bwd_fused", ("l2",))):
        for mode in modes:
            assert A.launch_key(name, mode) == f"{name}[{mode}]" in build.LAUNCHES
    assert "flash_attn_bwd_dq[l2ref]" not in build.LAUNCHES


def test_l2_wrappers_refuse_rather_than_fall_back(monkeypatch):
    """On tensors that are not on the CPU (meta tensors stand in for CUDA
    ones), the `l2`/`l2ref` forward and every `l2` backward wrapper raise
    naming CUDA, at the v1 head width too; no plain version is reached."""
    def plain(*a, **k):
        raise AssertionError("a plain version was reached off the CPU")

    for name in ("attention_forward_reference", "flash_bwd_fused_reference",
                 "flash_bwd_dq_reference", "flash_bwd_dkv_reference", "attention_chunked"):
        monkeypatch.setattr(A, name, plain)
    q = torch.empty(4, 4, 50, 108, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(4, 4, 50, device="meta")
    for mode in ("l2", "l2ref"):
        with pytest.raises(ValueError, match="CUDA"):
            A.flash_attention(q, q, q, mode)
    for fusion in ("fused", "two_pass"):
        policy.set_policy(bwd_fusion=fusion)
        with pytest.raises(ValueError, match="CUDA"):
            A.flash_backward(q, q, q, q, lse, q, 432.0, score_mode="l2")
    for fn in (A.flash_backward_fused, A.flash_backward_dq, A.flash_backward_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, q, 432.0, score_mode="l2")


@pytest.mark.parametrize("wrapper", ["flash_forward", "flash_backward_fused", "flash_backward_dq",
                                     "flash_backward_dkv"])
def test_l2_two_pass_wrappers_refuse_a_width_not_a_multiple_of_4(wrapper):
    """The `l2` kernels (forward, `l2ref` too, single pass, dq, dk/dv) read
    8-byte row granules where the rows lie: a head width that is not a
    multiple of 4 raises naming ROADMAP.md; it is neither padded nor sent to
    a plain version."""
    q = torch.empty(4, 4, 50, 110, device="meta", dtype=torch.bfloat16)
    lse = torch.empty(4, 4, 50, device="meta")
    fn = getattr(A, wrapper)
    if wrapper == "flash_forward":
        for mode in ("l2", "l2ref"):
            with pytest.raises(ValueError, match="multiple of 4.*ROADMAP"):
                fn(q, q, q, 440.0, score_mode=mode)
        return
    with pytest.raises(ValueError, match="multiple of 4.*ROADMAP"):
        fn(q, q, q, q, lse, q, 440.0, score_mode="l2")
