"""Second derivatives through the port's recompute Functions, against the JAX
package, on the CPU.

- The LN->MLP Function (`fused_ln_mlp`) and the recompute megablock
  (`encoder_block_fused`) against the JAX `fused_ln_mlp` and
  `encoder_block_fused` in interpret mode: an R1-style penalty
  sum((grad_x sum(f(x) * c))**2), differentiated with respect to x and every
  parameter.  Each JAX Function's backward is `jax.vjp` of its XLA reference,
  so JAX differentiates it twice; the port's backward under create_graph is
  autograd of its plain version on the saved tensors.
- The masked recompute (`encoder_block_fused_dropout`) against autograd of
  `_block_reference_masked` on the masks its forward drew, under create_graph.
- The saved-residual Functions still raise, naming ROADMAP.md queue 2 item 2;
  the JAX package's `flash_attention` and `encoder_block_fused_saved` fail a
  second derivative too ("Linearization failed"): this guard fails if the
  JAX package ever gains it.
- One v2 smoke train step with R1 under megablock=on, megablock_bwd=recompute
  (every block through the recompute Function) against the JAX step.

Tolerances: f32 on both sides.  Second-derivative leaves within 1e-4 *
max|JAX leaf| (sums over rows in another order; the JAX package at 'highest'
matmul precision, tests/conftest.py); the step at tests/test_torch_v2_train.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops import attention as JA
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.ops import fused_mlp as JFM
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
GRAD_RTOL = 1e-4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _assert_leaves(names, got, want):
    for name, a, b in zip(names, got, want):
        a, b = a.detach().numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        scale = np.abs(b).max()
        err = np.abs(a - b).max() / scale if scale > 0 else np.abs(a).max()
        assert err <= GRAD_RTOL, f"{name}: {err:.3g} of max|JAX|"


def _r1_port(fn, xt, params, c):
    """d/d(x, params) of sum((grad_x sum(fn(x) * c))**2), through autograd."""
    (gx,) = torch.autograd.grad((fn(xt) * c).sum(), xt, create_graph=True)
    # a bias that x's gradient does not depend on has a zero second derivative
    return torch.autograd.grad((gx ** 2).sum(), [xt, *params], materialize_grads=True)


def _r1_jax(fn, x, params, c):
    def penalty(x, p):
        gx = jax.grad(lambda x_: jnp.sum(fn(x_, p) * c))(x)
        return jnp.sum(gx ** 2)

    return jax.grad(penalty, argnums=(0, 1))(x, params)


# --- LN -> MLP -------------------------------------------------------------------


@pytest.mark.parametrize("residual", [True, False])
def test_ln_mlp_second_derivative_matches_jax(residual):
    rng = np.random.default_rng(0)
    m, e, hidden = 40, 32, 64
    x = rng.standard_normal((2, m // 2, e)).astype(np.float32)
    c = rng.standard_normal((2, m // 2, e)).astype(np.float32)
    p = [(1 + 0.1 * rng.standard_normal(e)), 0.1 * rng.standard_normal(e),
         0.2 * rng.standard_normal((e, hidden)), 0.05 * rng.standard_normal(hidden),
         0.2 * rng.standard_normal((hidden, e)), 0.05 * rng.standard_normal(e)]
    p = [a.astype(np.float32) for a in p]
    jx, jp = _r1_jax(lambda x_, p_: JFM.fused_ln_mlp(x_, *p_, "gelu", 1e-5, residual, 256, True),
                     jnp.asarray(x), [jnp.asarray(a) for a in p], jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_()
    pt = [torch.from_numpy(a).requires_grad_() for a in p]
    got = _r1_port(lambda x_: FM.fused_ln_mlp(x_, *pt, "gelu", 1e-5, residual), xt, pt,
                   torch.from_numpy(c))
    _assert_leaves(["x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2"], got, [jx, *jp])


def test_ln_mlp_once_differentiable_path_is_unchanged():
    """Without create_graph the backward's gradients equal autograd of the
    plain version and carry no graph (the path before the repair)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32)).requires_grad_()
    p = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
         for s in ((16,), (16,), (16, 24), (24,), (24, 16), (16,))]
    g = torch.from_numpy(rng.standard_normal((6, 16)).astype(np.float32))
    got = torch.autograd.grad(FM.fused_ln_mlp(x, *p), [x, *p], g)
    want = torch.autograd.grad(FM._reference(x, *p), [x, *p], g)
    for a, b in zip(got, want):
        assert not a.requires_grad
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# --- the megablock -------------------------------------------------------------------

SHAPE = dict(b=2, n=17, e=32, heads=2)


def _block(seed=0):
    cfg = JaxV2Config(embed_dim=SHAPE["e"], num_heads=SHAPE["heads"], mlp_ratio=2)
    tree = jax.tree.map(np.asarray, _encoder_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        tree[k]["scale"] = (1 + 0.1 * rng.standard_normal(tree[k]["scale"].shape)
                            ).astype(np.float32)
        tree[k]["bias"] = (0.1 * rng.standard_normal(tree[k]["bias"].shape)).astype(np.float32)
    for sub in (tree["fc1"], tree["fc2"], tree["msha"]["out"]):
        sub["b"] = (0.05 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
    tree["msha"]["qkv_b"] = (0.05 * rng.standard_normal(tree["msha"]["qkv_b"].shape)
                             ).astype(np.float32)
    block = EncoderBlock(C.V2Config(embed_dim=SHAPE["e"], num_heads=SHAPE["heads"],
                                    mlp_ratio=2), torch.Generator().manual_seed(seed))
    load_into(block, from_jax_tree(tree))
    return tree, block


def _jax_leaves(d):
    return [d["ln1"]["scale"], d["ln1"]["bias"], d["msha"]["qkv"], d["msha"]["qkv_b"],
            d["msha"]["out"]["w"], d["msha"]["out"]["b"], d["ln2"]["scale"], d["ln2"]["bias"],
            d["fc1"]["w"], d["fc1"]["b"], d["fc2"]["w"], d["fc2"]["b"]]


def _xc(seed=1):
    rng = np.random.default_rng(seed)
    s = (SHAPE["b"], SHAPE["n"], SHAPE["e"])
    return rng.standard_normal(s).astype(np.float32), rng.standard_normal(s).astype(np.float32)


def test_megablock_second_derivative_matches_jax():
    tree, block = _block()
    x, c = _xc()
    h = SHAPE["heads"]
    jtree = jax.tree.map(jnp.asarray, tree)
    jx, jp = _r1_jax(lambda x_, p_: JFB.encoder_block_fused(x_, p_, h, 1e-5, 8, True),
                     jnp.asarray(x), jtree, jnp.asarray(c))
    xt = torch.from_numpy(x).requires_grad_()
    params = FB.block_params(block)
    got = _r1_port(lambda x_: FB.encoder_block_fused(x_, block, h), xt, params,
                   torch.from_numpy(c))
    _assert_leaves(("x",) + FB.BLOCK_PARAMS, got, [jx, *_jax_leaves(jp)])


def test_masked_recompute_second_derivative_matches_its_plain_version():
    _, block = _block()
    x, c = _xc()
    h = SHAPE["heads"]
    seed = torch.tensor([2 ** 40 + 7], dtype=torch.int64)
    _, m1, m2 = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=h, rate=0.1,
                                       seed=seed)
    assert 0.8 < (m1 > 0).float().mean() < 1.0
    params = FB.block_params(block)
    ct = torch.from_numpy(c)
    xt = torch.from_numpy(x).requires_grad_()
    got = _r1_port(lambda x_: FB.encoder_block_fused_dropout(x_, block, seed, 0.1, h), xt,
                   params, ct)
    xt2 = torch.from_numpy(x).requires_grad_()
    want = _r1_port(lambda x_: FB._block_reference_masked(x_, block, m1, m2, h), xt2, params, ct)
    for name, a, b in zip(("x",) + FB.BLOCK_PARAMS, got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * float(b.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("variant", ["encoder_block_fused_saved",
                                     "encoder_block_fused_dropout_saved"])
def test_saved_functions_still_raise(variant):
    _, block = _block()
    x, c = _xc()
    h = SHAPE["heads"]
    xt = torch.from_numpy(x).requires_grad_()
    fn = getattr(FB, variant)
    seed = torch.tensor([5], dtype=torch.int64)
    out = fn(xt, block, seed, 0.1, h) if "dropout" in variant else fn(xt, block, h)
    with pytest.raises(NotImplementedError, match="queue 2 item 2"):
        torch.autograd.grad((out * torch.from_numpy(c)).sum(), xt, create_graph=True)
    for msg in (FB.DOUBLE_BACKWARD, A.DOUBLE_BACKWARD):
        assert "queue 2 item 2" in msg and "JAX package" in msg


def test_jax_flash_and_saved_megablock_are_once_differentiable():
    """The JAX package's own kernels fail a second derivative, so the port's
    raise departs from nothing; this fails if the JAX package gains one."""
    rng = np.random.default_rng(2)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 64, 32)).astype(np.float32))
               for _ in range(3))

    def flash_r1(q_):
        gq = jax.grad(lambda a: jnp.sum(JA.flash_attention(a, k, v, interpret=True)))(q_)
        return jnp.sum(gq ** 2)

    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(flash_r1)(q)
    tree, _ = _block()
    x, _ = _xc()
    jtree = jax.tree.map(jnp.asarray, tree)

    def saved_r1(x_):
        gx = jax.grad(lambda a: jnp.sum(JFB.encoder_block_fused_saved(
            a, jtree, SHAPE["heads"], 1e-5, 8, True)))(x_)
        return jnp.sum(gx ** 2)

    with pytest.raises(ValueError, match="Linearization failed"):
        jax.grad(saved_r1)(jnp.asarray(x))


# --- a train step --------------------------------------------------------------------


def test_r1_step_through_the_recompute_megablock_matches_jax(monkeypatch):
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0, "v2.r1_gamma": 10.0,
            "v2.r1_interval": 2, "runtime.use_pallas": "auto", "runtime.megablock": "on",
            "runtime.megablock_bwd": "recompute"}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    (_, k_noise, *_rest) = jax.random.split(jst.rng, 11)
    z = np.array(jax.random.normal(k_noise, (8, jcfg.v2.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    cfg = C.replace(C.smoke_config(), **over)
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    calls = []
    real_fn = FB.encoder_block_fused
    monkeypatch.setattr(FB, "encoder_block_fused",
                        lambda *a, **k: calls.append(1) or real_fn(*a, **k))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    # G forward, D forward, R1 forward, G-update D forward: 2 blocks each
    assert len(calls) == 4 * cfg.v2.depth
    assert set(m) == set(jm) and "d_r1" in m
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jparams in ((state.g, state.g_opt, jnew.g_params),
                              (state.d, state.d_opt, jnew.d_params)):
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)
