"""The megablock's saved-residual backward in f32 (#8's MLP and LN1 halves,
wgrad_gemm), on the CPU.

- the card's f32 composition: the MLP half's stage plain versions at f32
  (the resident and the wide compositions), then dy1 = dqkv . wqkv^T, the LN1
  rows, the four weight-gradient products and the two LN partial sums in the
  kernel's order, against the JAX `fused_encoder_block_bwd` in interpret mode
  on f32 inputs, with and without dropout, at E 32, 128 and 520, ragged N;
- the dtype gate of each backward wrapper and of wgrad_gemm: bf16 and f32,
  one dtype; f16, f64 and mixes raise naming the item;
- the wrappers on meta tensors with the C entries replaced by a recorder:
  f32 calls launch the `_f32` entries with f32 weights and f32 outputs at
  every E (the resident and the wide routes alike), wgrad_gemm_f32's scratch
  of the plan's size; bf16 calls launch today's entries;
- the slice: one v2 step in f32 under megablock=on, megablock_bwd=saved (every
  block of G and D on encoder_block_fused_saved, its backward the f32
  composition) against the JAX step.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py): every gradient leaf within GRAD_RTOL of max|JAX leaf|
(tests/test_torch_megablock_train.py), the step within
tests/test_torch_v2_train.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_f32_layernorm import SHAPES, _jax_adam_mu
from test_torch_megablock_train import (TOL, _assert_leaves, _block, _data, _jax_leaves,
                                        _jax_padded)
from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.ops import wgrad as WG
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
f32, bf16 = torch.float32, torch.bfloat16

# (batch, tokens, embed, heads), mlp_ratio 2: E 32 and 128 (the bf16 route's
# resident kernels) and 520 (its wide variants), N 17, 65 and 16.
IDS = ["n17_e32", "n65_e128", "n16_e520"]


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def composed_bwd(params, g, res, *, num_heads: int, eps: float = 1e-5, need_params: bool = True,
                 wide: bool = True):
    """fused_encoder_block_bwd as the card composes it in f32, from the plain
    versions of its launches: the MLP half's stages with every hand-off in
    f32 (``wide``: the dmlp rows, dz1, dy2 and the dx1 rows, the route the f32
    entries take; else the resident stages' composition), the qkv recompute
    and the flash backward, dy1 = dqkv . wqkv^T and the LN1 rows, the four
    weight-gradient products and the LN partials summed in sum_partials'
    order."""
    ln1s, ln1b, qkv_w, qkv_b, wout, bout, ln2s, ln2b, w1, b1, w2, b2 = params
    b, n, e = res.x.shape
    _, h, _, dh = qkv_w.shape
    m, hd, hidden = b * n, h * dh, w1.shape[-1]
    x2, ao2 = res.x.reshape(m, e), res.ao.reshape(m, hd)
    masks = [None if t is None else t.reshape(m, e) for t in (res.m1, res.m2)]
    mlp = FB.bwd_mlp_stages_reference(g.reshape(m, e), *masks, res.x1.reshape(m, e),
                                      res.z1.reshape(m, hidden), ao2, w1, w2, wout, ln2s, ln2b,
                                      b, n, h, eps, dtype=f32, wide=wide)
    qkv = FB._ln_qkv_reference(res.x, ln1s, ln1b, qkv_w, qkv_b.reshape(-1), eps)
    dq, dk, dv = FB.flash_backward(qkv[0], qkv[1], qkv[2], None, res.lse, mlp.dao, float(dh),
                                   delta=mlp.delta)
    dqkv = torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).reshape(m, 3 * hd)
    dy1 = FB.bwd_dy_reference(dqkv, FB._qkv_weight(qkv_w, f32))
    dx, y1, ln1_part = FB.bwd_ln1_rows_reference(dy1, x2, mlp.dx1, ln1s, ln1b, eps)
    dx = dx.reshape(b, n, e)
    if not need_params:
        return dx, [None] * len(FB.BLOCK_PARAMS)
    dw2, db2 = WG.wgrad_reference(mlp.h1, mlp.dmlp)
    dw1, db1 = WG.wgrad_reference(mlp.y2, mlp.dz1)
    dwout, dbout = WG.wgrad_reference(ao2, mlp.da)
    dwqkv, dbqkv = WG.wgrad_reference(y1, dqkv)
    dln1 = WG.sum_partials_reference(ln1_part)
    dln2 = WG.sum_partials_reference(mlp.part)
    grads = [dln1[:e], dln1[e:], dwqkv.reshape(e, 3, h, dh).permute(1, 2, 0, 3),
             dbqkv.reshape(3, h, dh), dwout, dbout, dln2[:e], dln2[e:], dw1, db1, dw2, db2]
    return dx, [gr.to(p.dtype) for gr, p in zip(grads, params)]


# --- the f32 composition against the JAX package ------------------------------------------


@pytest.mark.parametrize("wide", [False, True], ids=["resident", "wide"])
@pytest.mark.parametrize("has_drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_stage_composition_matches_jax(shape, has_drop, wide, monkeypatch):
    """The saved backward composed from the f32 stage plain versions (the
    card's f32 hand-offs) on the port's f32 residuals, against the JAX
    fused_encoder_block_bwd in interpret mode on the same residuals: dx and
    the 12 parameter gradients, every leaf within GRAD_RTOL of max|JAX
    leaf|; the MLP half's outputs all f32."""
    tree, block = _block(shape)
    x, g, m1, m2 = _data(shape)
    h = shape["heads"]
    if not has_drop:
        m1 = m2 = np.ones_like(x)
    masks = {0: torch.from_numpy(m1), 1: torch.from_numpy(m2)}
    monkeypatch.setattr(FB, "dropout_mask", lambda seed, i, s, rate: masks[i].reshape(s))
    with torch.no_grad():
        _, res = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=h,
                                        rate=0.1 if has_drop else 0.0,
                                        seed=torch.zeros(1, dtype=torch.int64),
                                        want_residuals=True)
        dx, grads = composed_bwd(FB.block_params(block), torch.from_numpy(g), res, num_heads=h,
                                 wide=wide)
    assert all(t.dtype == f32 for t in (dx, *grads))
    jdx, jdp = JFB.fused_encoder_block_bwd(jax.tree.map(jnp.asarray, tree), jnp.asarray(g),
                                           _jax_padded(res, shape, 2 * shape["e"]), num_heads=h,
                                           eps=1e-5, group=1, interpret=True, n_real=shape["n"],
                                           has_drop=has_drop)
    _assert_leaves([dx, *grads], _jax_leaves(jdx, jdp))


# --- the dtype gate ------------------------------------------------------------------------


def _recorder(calls):
    """A build.entry that records (name, args) with the tensors themselves
    (build.ptr is the identity), each call with its C signature's argument
    count, and launches nothing."""
    def entry(name):
        def fn(*args):
            assert len(args) == len(build.SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn
    return entry


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors through the backward wrappers: the CUDA checks lifted,
    the C entries replaced by a recorder of (name, tensors and scalars), the
    launch counts fresh, the card's 132 SMs for wgrad's plan.  Returns
    (calls, the dtypes of every operand the wrappers hand a kernel through
    _operands: weights, LN parameters, masks)."""
    calls, operand_dtypes = [], []
    operands = FM._operands

    def recording_operands(dev, *pairs):
        got = operands(dev, *pairs)
        operand_dtypes.extend(t.dtype for t in got if t is not None)
        return got

    monkeypatch.setattr(FB, "_operands", recording_operands)
    for mod in (FM, FB, WG):
        monkeypatch.setattr(mod, "_on_card", lambda what, *ts: None)
    monkeypatch.setattr(build, "entry", _recorder(calls))
    monkeypatch.setattr(build, "ptr", lambda t: t)
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(build, "LAUNCHES", {k: 0 for k in build.LAUNCHES})
    monkeypatch.setattr(WG, "_sm_count", lambda device: 132)
    return calls, operand_dtypes


def _launched():
    return {k: n for k, n in build.LAUNCHES.items() if n}


def _half(m, e, hidden, dtype):
    """Meta rows g, x1, z1, ao of the MLP half in ``dtype``, f32 masks, and
    the weights (f32 parameters, as the model keeps them)."""
    rows = lambda *s: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    g, x1, ao, z1 = rows(m, e), rows(m, e), rows(m, e), rows(m, hidden)
    m1 = m2 = torch.empty(m, e, device="meta")
    return g, m1, m2, x1, z1, ao, torch.zeros(e, hidden), torch.zeros(hidden, e), \
        torch.zeros(e, e), torch.ones(e), torch.zeros(e)


def _bwd_calls(dtype, e=32, heads=4):
    """Every backward wrapper once, and wgrad_gemm, on meta rows of ``dtype``
    (34 rows: 2 samples of 17)."""
    m, hidden = 34, 2 * e
    g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b = _half(m, e, hidden, dtype)
    dqkv = torch.empty(m, 3 * e, device="meta", dtype=dtype)
    qkv_w = torch.zeros(3, heads, e, e // heads)
    dx1 = torch.empty(m, e, device="meta")
    return {
        "megablock_bwd_mask_rows": lambda: FB.bwd_dmlp_rows(g, m2),
        "megablock_bwd_dy": lambda: FB.bwd_dy(z1, w1),
        "megablock_bwd_mlp_dx1_rows": lambda: FB.bwd_dx1_rows(dx1, g, m1, x1, ln_s, ln_b),
        "megablock_bwd_ln1_rows": lambda: FB.bwd_ln1_rows(dx1, x1, dx1, ln_s, ln_b),
        "megablock_bwd_mlp_dz1": lambda: FB.bwd_dz1_stage(g, m2, z1, w2),
        "megablock_bwd_mlp_dx1": lambda: FB.bwd_dx1_stage(z1, g, m1, x1, w1, ln_s, ln_b),
        "megablock_bwd_mlp_dao": lambda: FB.bwd_dao_stage(g, ao, wout, 2, 17, heads),
        "megablock_bwd_mlp": lambda: FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout,
                                                          ln_s, ln_b, 2, 17, heads),
        "megablock_bwd_ln1": lambda: FB.megablock_bwd_ln1(dqkv, qkv_w, x1, dx1, ln_s, ln_b),
        "wgrad_gemm": lambda: WG.wgrad_gemm(x1, g),
    }


@pytest.mark.parametrize("dtype", [bf16, f32], ids=["bf16", "f32"])
def test_bwd_wrappers_take_bf16_and_f32(recorded, dtype):
    """Each backward wrapper and wgrad_gemm take bf16 and f32 activations:
    every one launches (records) an entry."""
    calls, _ = recorded
    for name, call in _bwd_calls(dtype).items():
        calls.clear()
        call()
        assert calls, name


@pytest.mark.parametrize("kind", ["f16", "f64", "mixed"])
def test_bwd_wrappers_refuse_other_dtypes_naming_the_item(recorded, kind):
    """f16, f64 and a mix of bf16 and f32 activations raise TypeError in each
    backward wrapper and in wgrad_gemm, naming ROADMAP.md queue 1 item 7,
    before any launch."""
    calls, _ = recorded
    if kind == "mixed":
        m, e = 34, 32
        g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b = _half(m, e, 2 * e, bf16)
        x1, z1, ao = x1.float(), z1.float(), ao.float()  # g stays bf16
        dx1 = torch.empty(m, e, device="meta")
        mixed = {
            "megablock_bwd_mlp_dx1_rows": lambda: FB.bwd_dx1_rows(dx1, g, m1, x1, ln_s, ln_b),
            "megablock_bwd_mlp_dz1": lambda: FB.bwd_dz1_stage(g, m2, z1, w2),
            "megablock_bwd_mlp_dx1": lambda: FB.bwd_dx1_stage(z1, g, m1, x1, w1, ln_s, ln_b),
            "megablock_bwd_mlp_dao": lambda: FB.bwd_dao_stage(g, ao, wout, 2, 17, 4),
            "megablock_bwd_mlp": lambda: FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2,
                                                              wout, ln_s, ln_b, 2, 17, 4),
            "megablock_bwd_ln1": lambda: FB.megablock_bwd_ln1(
                torch.empty(m, 3 * e, device="meta", dtype=bf16), torch.zeros(3, 4, e, 8), x1,
                dx1, ln_s, ln_b),
            "wgrad_gemm": lambda: WG.wgrad_gemm(x1, g),
        }
        cases = mixed.items()
    else:
        cases = _bwd_calls(torch.float16 if kind == "f16" else torch.float64).items()
    for name, call in cases:
        with pytest.raises(TypeError, match="queue 1 item 7") as err:
            call()
        assert "f16, f64 and mixed dtypes" in str(err.value), name
    assert calls == [] and not _launched()


# --- the wrappers reach the f32 entries ----------------------------------------------------


def _tensors(args):
    return [a for a in args if isinstance(a, torch.Tensor)]


@pytest.mark.parametrize("e", [128, 520])
def test_f32_wrappers_launch_the_f32_entries(recorded, e):
    """At E 128 and 520 alike (``wide`` True or False: no wide variant in
    f32), the MLP half launches the dmlp rows (with dropout), dz1, dy2, the
    dx1 rows and dao as their `_f32` entries and counts one
    megablock_bwd_mlp call; the LN1 half launches dy1 and the LN1 rows;
    wgrad_gemm launches wgrad_gemm_f32 with a scratch of the plan's size;
    every tensor a kernel is handed (weights, outputs, scratch) is f32."""
    calls, dtypes = recorded
    heads, m, hidden = (4 if e == 128 else 5), 34, 2 * e
    g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b = _half(m, e, hidden, f32)
    stages = ["megablock_bwd_mask_rows_f32", "megablock_bwd_mlp_dz1_f32", "megablock_bwd_dy_f32",
              "megablock_bwd_mlp_dx1_rows_f32", "megablock_bwd_mlp_dao_f32"]
    for wide in (False, True):
        calls.clear()
        out = FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, 2, 17, heads,
                                   wide=wide)
        assert [c[0] for c in calls] == stages
        assert all(t.dtype == f32 for t in out)
        assert out.dao.shape == (2, heads, 17, e // heads) and out.part.shape == (1, 2 * e)
        assert all(t.dtype == f32 for c in calls for t in _tensors(c[1])), calls
        calls.clear()
        out = FB.megablock_bwd_mlp(g, None, None, x1, z1, ao, w1, w2, wout, ln_s, ln_b, 2, 17,
                                   heads, wide=wide)
        assert [c[0] for c in calls] == stages[1:] and out.dmlp is g
        calls.clear()
        dqkv = torch.empty(m, 3 * e, device="meta")
        dx, y1, part = FB.megablock_bwd_ln1(dqkv, torch.zeros(3, heads, e, e // heads), x1,
                                            out.dx1, ln_s, ln_b, wide=wide)
        assert [c[0] for c in calls] == ["megablock_bwd_dy_f32", "megablock_bwd_ln1_rows_f32"]
        assert dx.dtype == y1.dtype == f32 and part.shape == (1, 2 * e)
        assert all(t.dtype == f32 for c in calls for t in _tensors(c[1]))
    calls.clear()
    dw, db = WG.wgrad_gemm(x1, z1)
    (name, args), = calls
    assert name == "wgrad_gemm_f32" and dw.dtype == db.dtype == f32
    rps = WG.plan(m, e, hidden, 132)
    assert args[8] == rps and args[4].numel() == WG.scratch_floats(m, e, hidden, rps)
    assert all(t.dtype == f32 for t in _tensors(args)) and set(dtypes) == {f32}
    assert _launched() == {"megablock_bwd_mask_rows_f32": 2, "megablock_bwd_mlp_dz1_f32": 4,
                           "megablock_bwd_dy_f32": 6, "megablock_bwd_mlp_dx1_rows_f32": 4,
                           "megablock_bwd_mlp_dao_f32": 4, "megablock_bwd_ln1_rows_f32": 2,
                           "megablock_bwd_mlp": 4, "wgrad_gemm_f32": 1}


@pytest.mark.parametrize("e", [128, 520])
def test_bf16_wrappers_launch_the_bf16_entries(recorded, e):
    """The same calls on bf16 rows launch today's entries with bf16 weights
    and outputs: the resident stages at E 128, the wide route at E 520, and
    wgrad_gemm."""
    calls, dtypes = recorded
    heads, m, hidden = (4 if e == 128 else 5), 34, 2 * e
    g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b = _half(m, e, hidden, bf16)
    out = FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, 2, 17, heads)
    dqkv = torch.empty(m, 3 * e, device="meta", dtype=bf16)
    FB.megablock_bwd_ln1(dqkv, torch.zeros(3, heads, e, e // heads), x1, out.dx1, ln_s, ln_b)
    WG.wgrad_gemm(x1, z1)
    if e == 128:
        want = ["megablock_bwd_mlp_dz1", "megablock_bwd_mlp_dx1", "megablock_bwd_mlp_dao",
                "megablock_bwd_ln1"]
    else:
        want = ["megablock_bwd_mask_rows", "megablock_bwd_mlp_dz1_wide", "megablock_bwd_dy",
                "megablock_bwd_mlp_dx1_rows", "megablock_bwd_mlp_dao_wide", "megablock_bwd_dy",
                "megablock_bwd_ln1_rows"]
    assert [c[0] for c in calls] == want + ["wgrad_gemm"]
    assert out.dmlp.dtype == out.dz1.dtype == out.da.dtype == out.dao.dtype == bf16
    assert out.dx1.dtype == out.delta.dtype == f32
    weights = [d for d in dtypes if d != f32]  # LN parameters and masks stay f32
    assert weights and set(weights) == {bf16}


# --- the slice -----------------------------------------------------------------------------


def test_f32_train_step_megablock_saved_matches_jax(monkeypatch):
    """One bce step at smoke widths in f32, dropout 0, under megablock=on and
    megablock_bwd=saved (every block of G and D through
    encoder_block_fused_saved, its backward the card's f32 composition of
    plain versions), from the JAX state, against the JAX make_train_step:
    every metric, Adam's first moments, the updated parameters
    (test_torch_v2_train.test_train_step_matches_jax's bounds)."""
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    k_noise = jax.random.split(jst.rng, 11)[1]  # the JAX step's latents (step.py:66-73)
    z = np.array(jax.random.normal(k_noise, (8, jcfg.v2.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    routes, backwards = [], []
    apply = FB.megablock_apply
    monkeypatch.setattr(FB, "megablock_apply", lambda route, *a, **k: routes.append(route)
                        or apply(route, *a, **k))

    def card_bwd(params, g, res, **kw):
        backwards.append(g.dtype)
        return composed_bwd(params, g, res, **kw)

    monkeypatch.setattr(FB, "fused_encoder_block_bwd", card_bwd)
    cfg = C.replace(C.smoke_config(), **over, **{
        "runtime.use_pallas": "auto", "runtime.megablock": "on",
        "runtime.megablock_bwd": "saved"})
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    assert routes and set(routes) == {"encoder_block_fused_saved"}
    assert backwards and set(backwards) == {f32}
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jopt, jparams in ((state.g, state.g_opt, jnew.g_opt, jnew.g_params),
                                    (state.d, state.d_opt, jnew.d_opt, jnew.d_params)):
        mu = _jax_adam_mu(jopt)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(opt.opt.state[p]["exp_avg"].numpy(), mu[name].numpy(),
                                       **TOL, err_msg=name)
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)
