"""The flash-attention kernels' f32 route of the port, on the CPU.

- the dtype gate (ops/attention.kernel_dtype): bf16 and f32, one dtype for
  all; f16, f64 and mixed dtypes raise naming ROADMAP.md queue 1 item 7;
- the f32 backward route (backward_route at itemsize 4) against the JAX
  package's own decision, read from the jaxpr of its VJP on f32 inputs
  (traced only): `dot` at 32, 1,025, 4,096 (fused) and 4,097 (two-pass)
  tokens, `l2` at 50 and 65;
- the plain `dot` and `l2` forward and backward in f32 at ragged N (50, 65)
  and the v1 discriminator's Dh 108, through the port's flash_attention
  against jax.vjp of the JAX flash_attention in interpret mode, on both
  backward routes;
- the f32 single pass's dQ order (fused_dq_schedule at f32: 128-key blocks
  and 64-query tiles at Dh <= 64, 64 and 32 above; 32 heads a group, key
  block slowest) against the kernel's decode of its ticket, finishing in
  any dispatch order in key-block order;
- the f32 wrappers: each launches its `_f32` entry with the argument count of
  its C signature, the head width where it lies, counted under
  ``name_f32[mode]``; ``out=`` is refused;
- one v1 bce train step at smoke widths with compute_dtype=float32 and
  use_pallas=always (every attention through the flash Function: its plain
  versions on CPU tensors) from the JAX state against the JAX step with its
  flash kernels in interpret mode, with test_torch_v1's bounds; and the
  serving sampler's images against the JAX generator's on the same latents.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py): 1e-5 absolute and relative for attention (the sums run
in another order); the train step as tests/test_torch_v1.py holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_flash_edges import simulate, units_of
from test_torch_l2_attention import _jax_pallas_calls
from test_torch_v1 import NO_DROPOUT, TOL, _jax_adam_mu, _np_tree, _v1_cfgs
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.models import vitgan_v1 as JV1
from vitgan_tpu.ops.attention import flash_attention as jax_flash_attention
from vitgan_tpu.ops.policy import _POLICY as JAX_POLICY
from vitgan_tpu.ops.policy import set_policy as jax_set_policy
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.train.sample import latent_rng, make_serve_sample_fn
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
# (B, H, N, Dh): the v1 discriminator's head width at its 50 tokens and one
# row past a 64-row tile.
SHAPES = [(1, 2, 50, 108), (2, 1, 65, 108)]
IDS = ["n50", "n65"]


@pytest.fixture(autouse=True)
def _restore_policy():
    saved, jsaved = policy.get_policy(), dict(JAX_POLICY)
    yield
    policy.set_policy(**saved)
    JAX_POLICY.update(jsaved)


def _qkv(shape, seed=0, k=4):
    rng = np.random.default_rng(seed)
    return [(0.5 * rng.standard_normal(shape)).astype(np.float32) for _ in range(k)]


# --- the dtype gate ---------------------------------------------------------------------


def test_kernel_dtype_takes_bf16_and_f32_and_names_the_item_otherwise():
    x = torch.zeros(1, 1, 2, 8)
    for dt in (torch.bfloat16, torch.float32):
        assert A.kernel_dtype("flash", x.to(dt), x.to(dt), x.to(dt)) == dt
    for ts in ((x.half(),) * 3, (x.double(),) * 3, (x, x.bfloat16(), x),
               (x.bfloat16(), x.bfloat16(), x.half())):
        with pytest.raises(TypeError, match="queue 1 item 7"):
            A.kernel_dtype("flash", *ts)


def test_f32_wrappers_refuse_off_the_cpu_and_the_megablock_layout(monkeypatch):
    """f32 tensors that are neither on the CPU nor on CUDA (meta tensors) raise
    naming CUDA; the (B, N, H*D) layout of ``out=`` is the `dot` forward's,
    in f32 as in bf16, and only at its own shape."""
    q = torch.empty(2, 4, 50, 108, device="meta")
    lse = torch.empty(2, 4, 50, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_forward(q, q, q, 432.0, score_mode="l2")
    for fn in (A.flash_backward_fused, A.flash_backward_dq, A.flash_backward_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, q, q, q, lse, q, 432.0, score_mode="l2")
    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="`dot` forward's"):
        A.flash_forward(x, x, x, 8.0, out=torch.zeros(1, 4, 16), score_mode="l2")
    with pytest.raises(ValueError, match="out must be"):
        A.flash_forward(x, x, x, 8.0, out=torch.zeros(1, 4, 8))


# --- the backward route ------------------------------------------------------------------


@pytest.mark.parametrize("case", [("dot", 32, 96), ("dot", 1025, 64), ("dot", 4096, 64),
                                  ("dot", 4097, 64), ("l2", 50, 108), ("l2", 65, 108)],
                         ids=["dot32", "dot1025", "dot4096", "dot4097", "l2_50", "l2_65"])
def test_f32_backward_route_is_the_jax_decision(case):
    """The JAX VJP on f32 inputs holds the forward pallas_call plus one
    backward (fused) or two (dq, dk/dv); traced only.  f32 doubles the K/V
    bytes the JAX rule reads: `dot` at 4,096 tokens is fused at bf16 and f32,
    at 4,097 two-pass in f32 (highres256p4's discriminator)."""
    mode, n, dh = case
    s = jax.ShapeDtypeStruct((1, 2, n, dh), jnp.float32)

    def vjp(q, k, v, g):
        def f(q, k, v):
            return jax_flash_attention(q, k, v, mode, float(2 * dh), interpret=True)

        return jax.vjp(f, q, k, v)[1](g)

    calls = _jax_pallas_calls(jax.make_jaxpr(vjp)(s, s, s, s).jaxpr)
    want = {2: "fused", 3: "two_pass"}[calls]
    assert A.backward_route(n, dh, 4, mode) == want, n
    if case == ("dot", 4097, 64):
        assert want == "two_pass" and A.backward_route(n, dh, 2, mode) == "fused"
    if case == ("dot", 4096, 64):
        assert want == "fused"


# --- the plain f32 forward and backward against the JAX kernels --------------------------


@pytest.mark.parametrize("fusion", ["fused", "two_pass"])
@pytest.mark.parametrize("mode", ["dot", "l2"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_flash_attention_matches_jax(shape, mode, fusion):
    """Output and the three gradients through the port's flash_attention on f32
    CPU tensors (the kernels' plain versions) against jax.vjp of the JAX
    flash_attention in interpret mode on the same f32 inputs, on each route."""
    q, k, v, g = _qkv(shape, seed=3)
    scale = float(shape[1] * shape[3])
    jax_set_policy(bwd_fusion=fusion)
    policy.set_policy(bwd_fusion=fusion)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    want_o, vjp = jax.vjp(lambda *a: jax_flash_attention(*a, mode, scale, interpret=True),
                          jq, jk, jv)
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, mode, scale)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), **ATTN_TOL)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **ATTN_TOL, err_msg=f"d{name}")


# --- the f32 single pass's dQ order ------------------------------------------------------


@pytest.mark.parametrize("dispatch", ["in_order", "reversed", "random"])
@pytest.mark.parametrize("grid", [(65, 8, 108), (1025, 6, 64), (4096, 3, 64)],
                         ids=["n65", "n1025", "n4096"])
def test_f32_single_pass_order_finishes_in_key_block_order(grid, dispatch):
    """The f32 kernel (csrc/flash_f32_bwd.cuh) decodes its ticket t in groups
    of 32 heads, key block slowest within a group: group t // (32 K), then
    key block r // heads and head r % heads of the rest r (heads: the group's,
    fewer in a last group), and waits on the same head's previous key block,
    `heads` indices back: the schedule's index, coords and waits_on, with
    128 keys a block and 64-query tiles at Dh <= 64, 64 and 32 at Dh 108.
    With the place taken from the ticket every dispatch order finishes onto
    fewer slots than a head's key blocks and adds every tile in key-block
    order."""
    n, bh, d = grid
    keys, tile = (128, 64) if d <= 64 else (64, 32)
    kbs, tiles = -(-n // keys), -(-n // tile)
    for mode in ("dot", "l2"):
        plan = A.fused_dq_schedule(n, bh, mode, d, torch.float32)
        assert (plan.k_blocks, plan.q_tiles, plan.group_heads, plan.unit_blocks) == (
            kbs, tiles, 32, 1)
        assert plan.flags == (bh * tiles + 1,) and plan.ticket == bh * tiles
        for t in range(plan.k_blocks * bh):
            group, r = divmod(t, 32 * kbs)
            heads = min(32, bh - 32 * group)
            assert plan.coords(t) == (r // heads, 32 * group + r % heads)
            assert plan.waits_on(t) == (None if r < heads else t - heads)
    units = len(units_of(plan))
    order = {"in_order": range(units), "reversed": reversed(range(units)),
             "random": np.random.default_rng(13).permutation(units)}[dispatch]
    res = simulate(plan, plan.k_blocks - 1, order=order)
    assert not res["deadlock"] and res["finished"] == plan.k_blocks * bh
    assert all(kb == list(range(plan.k_blocks)) for kb in res["adds"].values())
    one = A.fused_dq_schedule(50, 1024, "l2", 108, torch.float32)  # v1 D: one key block
    assert (one.k_blocks, one.flags, one.ticket) == (1, (0,), None)


# --- the f32 wrappers --------------------------------------------------------------------


def test_f32_wrappers_launch_the_f32_entries(monkeypatch):
    """With the device check lifted, f32 CPU tensors reach the `_f32` entries
    (build.entry faked): each call with its C signature's argument count, the
    head width where it lies in every mode (108; the bf16 `dot` wrappers pad
    it to 112), outputs contiguous, the single pass's scratch past one 64-key
    block, each launch counted under name_f32[mode]; a `dot` width that is no
    multiple of 4 padded to a multiple of 8; bf16 still reaches the bf16
    entries."""
    calls = []

    def fake_entry(name):
        def fn(*args):
            assert len(args) == len(build.SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(A, "_sm_count", lambda index: 132)
    monkeypatch.setattr(build, "entry", fake_entry)
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    build.reset_launches()
    x = torch.zeros(1, 2, 65, 108)
    lse = torch.zeros(1, 2, 65)
    for mode in ("dot", "l2", "l2ref"):
        o, got_lse = A.flash_forward(x, x, x, 216.0, score_mode=mode)
        assert o.shape == x.shape and o.dtype == torch.float32 and got_lse.shape == lse.shape
        assert o.is_contiguous()
        name, args = calls.pop()
        assert name == "flash_attn_fwd_f32" and args[7] == 108
        assert args[9] == A.MODE_ID[mode]
    for mode in ("dot", "l2"):
        dq, dk, dv = A.flash_backward_fused(x, x, x, x, lse, x, 216.0, score_mode=mode)
        name, args = calls.pop()
        assert name == "flash_attn_bwd_fused_f32" and args[13] == 108
        assert args[9].value is not None and args[10].value is not None  # dq_acc, flags
        assert dq.shape == dk.shape == dv.shape == x.shape
        assert dq.is_contiguous() and dk.is_contiguous() and dv.is_contiguous()
        assert A.flash_backward_dq(x, x, x, x, lse, x, 216.0, score_mode=mode).shape == x.shape
        assert calls.pop()[0] == "flash_attn_bwd_dq_f32"
        dk, dv = A.flash_backward_dkv(x, x, x, x, lse, x, 216.0, score_mode=mode)
        assert dk.shape == dv.shape == x.shape and calls.pop()[0] == "flash_attn_bwd_dkv_f32"
    launched = {k: n for k, n in build.LAUNCHES.items() if n}
    assert launched == {A.launch_key(name, mode, torch.float32): 1
                        for name, modes in (("flash_attn_fwd", ("dot", "l2", "l2ref")),
                                            ("flash_attn_bwd_fused", ("dot", "l2")),
                                            ("flash_attn_bwd_dq", ("dot", "l2")),
                                            ("flash_attn_bwd_dkv", ("dot", "l2")))
                        for mode in modes}
    assert all(k.endswith("]") and "_f32[" in k for k in launched)
    o, _ = A.flash_forward(*(x[..., :6].contiguous(),) * 3, 12.0)
    name, args = calls.pop()
    assert name == "flash_attn_fwd_f32" and args[7] == 8 and o.shape == x[..., :6].shape
    A.flash_forward(*(x.bfloat16(),) * 3, 216.0)
    name, args = calls.pop()
    assert name == "flash_attn_fwd" and args[7] == 112
    build.reset_launches()


# --- the slice: a v1 train step and a serving call in f32 under 'always' -----------------


def test_v1_f32_train_step_under_always_matches_jax(monkeypatch):
    """One bce step (the v1 default recipe) at smoke widths in f32 with every
    attention through the flash route on both sides (the JAX kernels in
    interpret mode), from the JAX state: every metric, Adam's first moments,
    the updated parameters and D's ISR buffers, as test_torch_v1 holds the
    plain step."""
    over = {**NO_DROPOUT, "runtime.use_pallas": "always"}
    jcfg, cfg = _v1_cfgs(**over)
    assert cfg.runtime.compute_dtype == "float32"
    jax_set_policy(mode="always")
    policy.set_policy(mode="always")
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(6).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    (_, k_noise, *_rest) = jax.random.split(jst.rng, 11)
    z = np.array(jax.random.normal(k_noise, (8, jcfg.v1.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree({"params": _np_tree(jst.g_params),
                                      "state": _np_tree(jst.g_state)}))
    load_into(state.d, from_jax_tree({"params": _np_tree(jst.d_params),
                                      "state": _np_tree(jst.d_state)}))
    flash = []
    apply = A._FlashAttention.apply
    monkeypatch.setattr(A._FlashAttention, "apply",
                        lambda *a: flash.append((a[0].dtype, a[4])) or apply(*a))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    assert {dt for dt, _ in flash} == {torch.float32}
    assert {mode for _, mode in flash} == {"dot", "l2"}
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jopt, jparams in ((state.g, state.g_opt, jnew.g_opt, jnew.g_params),
                                    (state.d, state.d_opt, jnew.d_opt, jnew.d_params)):
        names = [n for n, _ in net.named_parameters()]
        mu = _jax_adam_mu(jopt)
        for name, got in zip(names, (opt.opt.state[p]["exp_avg"] for p in net.parameters())):
            np.testing.assert_allclose(got.numpy(), mu[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        want = from_jax_tree(_np_tree(jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)
    new_state = from_jax_tree({"params": {}, "state": _np_tree(jnew.d_state)})
    for name, buf in state.d.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new_state[name].numpy(), **TOL, err_msg=name)


def test_v1_f32_serving_call_under_always_matches_jax(monkeypatch):
    """The serving sampler (make_serve_sample_fn: latents, G, clip, uint8) in
    f32 under use_pallas='always' against the JAX generator under 'always'
    (interpret mode) on the same latents, with the same weights: images
    within 1e-4 before the rounding, uint8 within one level."""
    jcfg, cfg = _v1_cfgs(**{"runtime.use_pallas": "always", "runtime.compute_dtype": "float32"})
    jax_set_policy(mode="always")
    policy.set_policy(mode="always")
    jv = JV1.generator_init(jax.random.PRNGKey(4), jcfg.v1)
    gan = build_gan(cfg)
    g = gan.generator_init(None, device="cpu")
    load_into(g, from_jax_tree(_np_tree(jv)))
    sample = make_serve_sample_fn(gan, cfg, batch=3)
    flash = []
    apply = A._FlashAttention.apply
    monkeypatch.setattr(A._FlashAttention, "apply",
                        lambda *a: flash.append(a[0].dtype) or apply(*a))
    got = sample(g, 7, 0)
    assert flash and set(flash) == {torch.float32}
    z = gan.sample_latent(latent_rng(7, 0), 3).numpy()
    want, _ = JV1.generator_apply(jv, jnp.asarray(z), jcfg.v1)
    with torch.no_grad():
        imgs = g(torch.from_numpy(z))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_u8 = np.round((np.clip(np.asarray(want), -1, 1) + 1) * 127.5).astype(np.int32)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int32) - want_u8).max() <= 1
