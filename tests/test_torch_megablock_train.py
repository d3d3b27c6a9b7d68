"""The megablock's training forms against the JAX package, on the CPU.

- the plain saved-residual forward (out, x1, z1, ao, LSE) against the JAX
  `fused_encoder_block(..., want_residuals=True)` in interpret mode;
- the plain masked forward against the JAX `_block_reference_masked`, on
  masks made with numpy;
- the plain saved-residual backward, without and with masks, against the JAX
  `fused_encoder_block_bwd` in interpret mode and against `jax.vjp` of
  `_block_reference_masked`;
- each of the four autograd Functions against autograd of the plain block;
- the plain Philox4x32-10: Random123's known-answer vectors, the keep rate,
  and bits that depend only on (seed, mask id, index);
- one CPU train step with runtime.megablock=on against the same step with
  megablock=off from one state;
- one CPU train step at E 520 (past the resident kernels' 384, so the
  wide variants' route on the card) with runtime.megablock=on against the
  JAX step from the JAX state: metrics, Adam's first moments, parameters;
- the repaired runtime.megablock_bwd: a JAX config that sets 'recompute'
  keeps it in the port, whose gate then takes the standard path.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py).  Forwards 1e-5 absolute and relative.  Gradients: every
leaf within 1e-4 * max|JAX leaf|, since the weight and LayerNorm gradients
are sums over all rows, taken in another order on each side, and the TPU
kernels differentiate their erf polynomial where the port differentiates the
exact erf (the two differ by less than 1e-6).
"""

import json

import jax
import optax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models import layers as L
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_RTOL = 1e-4

# (batch, tokens, embed, heads), mlp_ratio 2: ragged 17 tokens at E 32, and
# 65 tokens at E 128 (the TPU kernel pads neither E nor hidden there).
SHAPES = [dict(b=2, n=17, e=32, heads=2), dict(b=3, n=65, e=128, heads=4)]
IDS = ["n17_e32_h2", "n65_e128_h4"]


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _block(shape, seed=0):
    """A JAX encoder block tree with every parameter perturbed, and the port's
    EncoderBlock holding the same values."""
    cfg = JaxV2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=2)
    tree = jax.tree.map(np.asarray, _encoder_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        tree[k]["scale"] = (1 + 0.1 * rng.standard_normal(tree[k]["scale"].shape)).astype(np.float32)
        tree[k]["bias"] = (0.1 * rng.standard_normal(tree[k]["bias"].shape)).astype(np.float32)
    for sub in (tree["fc1"], tree["fc2"], tree["msha"]["out"]):
        sub["b"] = (0.05 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
    tree["msha"]["qkv_b"] = (0.05 * rng.standard_normal(tree["msha"]["qkv_b"].shape)
                             ).astype(np.float32)
    block = EncoderBlock(C.V2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=2),
                         torch.Generator().manual_seed(seed))
    load_into(block, from_jax_tree(tree))
    return tree, block


def _data(shape, seed=1, rate=0.1):
    """x, the output cotangent g, and numpy inverted-dropout masks m1, m2."""
    rng = np.random.default_rng(seed)
    s = (shape["b"], shape["n"], shape["e"])
    x, g = (rng.standard_normal(s).astype(np.float32) for _ in range(2))
    m1, m2 = ((rng.random(s) >= rate).astype(np.float32) / np.float32(1 - rate)
              for _ in range(2))
    return x, g, m1, m2


def _pad(a, shape):
    """Zero-pad ``a`` up to ``shape`` (the TPU kernels' padded layouts)."""
    return np.pad(a, [(0, t - s) for s, t in zip(a.shape, shape)])


def _ceil(x, m):
    return (x + m - 1) // m * m


def _jax_padded(res, shape, hidden):
    """The port's Residuals in the JAX saved backward's padded layout:
    (xp[, m1p, m2p], x1p, z1p, aop, lsep)."""
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    npad, epad = _ceil(n, 8), _ceil(e, 128)
    t = lambda a, s: jnp.asarray(_pad(a.detach().numpy(), s))  # noqa: E731
    out = [t(res.x, (b, npad, epad))]
    if res.m1 is not None:
        out += [t(res.m1, (b, npad, epad)), t(res.m2, (b, npad, epad))]
    return tuple(out + [t(res.x1, (b, npad, epad)), t(res.z1, (b, npad, _ceil(hidden, 128))),
                        t(res.ao, (b, npad, _ceil(e, 128))),
                        t(res.lse, (b, _ceil(h, 8), npad))])


def _jax_leaves(dx, dparams):
    """JAX's (dx, dparams tree) in the port's order: x, then BLOCK_PARAMS."""
    d = dparams
    return [dx, d["ln1"]["scale"], d["ln1"]["bias"], d["msha"]["qkv"], d["msha"]["qkv_b"],
            d["msha"]["out"]["w"], d["msha"]["out"]["b"], d["ln2"]["scale"], d["ln2"]["bias"],
            d["fc1"]["w"], d["fc1"]["b"], d["fc2"]["w"], d["fc2"]["b"]]


def _assert_leaves(got, want):
    names = ("x",) + FB.BLOCK_PARAMS
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        a = a.detach().numpy()
        assert a.shape == b.shape, name
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= GRAD_RTOL, f"d{name}: {err:.3g} of max|JAX|"


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_saved_forward_matches_jax(shape):
    """out, x1, z1, ao and the per-head LSE against the JAX saved-residual
    forward in interpret mode (its padded residuals sliced)."""
    tree, block = _block(shape)
    x, _, _, _ = _data(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    want, (_, x1p, z1p, aop, lsep) = JFB.fused_encoder_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, tree), num_heads=h, group=1, interpret=True,
        want_residuals=True)
    with torch.no_grad():
        out, res = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=h,
                                          want_residuals=True)
    assert res.m1 is None and res.m2 is None
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(res.x1.numpy(), np.asarray(x1p)[:b, :n, :e], **TOL)
    np.testing.assert_allclose(res.z1.numpy(), np.asarray(z1p)[:b, :n, :2 * e], **TOL)
    np.testing.assert_allclose(res.ao.numpy(), np.asarray(aop)[:b, :n, :e], **TOL)
    np.testing.assert_allclose(res.lse.numpy(), np.asarray(lsep)[:b, :h, :n], **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_masked_forward_matches_jax(shape, monkeypatch):
    """The port's _block_reference_masked against the JAX one on the same
    numpy masks, and the plain dropout forward (its masks replaced by the
    same numpy masks) against both."""
    tree, block = _block(shape)
    x, _, m1, m2 = _data(shape)
    want = JFB._block_reference_masked(jnp.asarray(x), jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(m1), jnp.asarray(m2), shape["heads"], 1e-5)
    with torch.no_grad():
        got = FB._block_reference_masked(torch.from_numpy(x), block, torch.from_numpy(m1),
                                         torch.from_numpy(m2), shape["heads"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        masks = {0: torch.from_numpy(m1), 1: torch.from_numpy(m2)}
        monkeypatch.setattr(FB, "dropout_mask",
                            lambda seed, i, s, rate: masks[i].reshape(s))
        out, f1, f2 = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=shape["heads"],
                                             rate=0.1, seed=torch.zeros(1, dtype=torch.int64))
    assert torch.equal(f1, masks[0]) and torch.equal(f2, masks[1])
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("has_drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_saved_backward_matches_jax(shape, has_drop, monkeypatch):
    """The port's saved-residual backward (plain versions of its kernels,
    composed as on the card) against the JAX `fused_encoder_block_bwd` in
    interpret mode on the same residuals, and against jax.vjp of
    `_block_reference_masked`; every leaf within 1e-4 * max|JAX leaf|."""
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
        dx, grads = FB.fused_encoder_block_bwd(FB.block_params(block), torch.from_numpy(g), res,
                                               num_heads=h)
    jtree = jax.tree.map(jnp.asarray, tree)
    jdx, jdp = JFB.fused_encoder_block_bwd(jtree, jnp.asarray(g), _jax_padded(res, shape, 2 *
                                                                             shape["e"]),
                                           num_heads=h, eps=1e-5, group=1, interpret=True,
                                           n_real=shape["n"], has_drop=has_drop)
    _assert_leaves([dx, *grads], _jax_leaves(jdx, jdp))
    _, vjp = jax.vjp(lambda x_, p_: JFB._block_reference_masked(
        x_, p_, jnp.asarray(m1), jnp.asarray(m2), h, 1e-5), jnp.asarray(x), jtree)
    _assert_leaves([dx, *grads], _jax_leaves(*vjp(jnp.asarray(g))))


@pytest.mark.parametrize("variant", ["encoder_block_fused", "encoder_block_fused_saved",
                                     "encoder_block_fused_dropout",
                                     "encoder_block_fused_dropout_saved"])
def test_autograd_functions_match_autograd_of_the_plain_block(variant):
    """Each Function's output and gradients (x and the 12 parameters) against
    autograd through the plain block on the masks its forward drew."""
    _, block = _block(SHAPES[0])
    x, g, _, _ = _data(SHAPES[0])
    h = SHAPES[0]["heads"]
    seed = torch.tensor([2 ** 40 + 7], dtype=torch.int64)
    xt = torch.from_numpy(x).requires_grad_()
    params = FB.block_params(block)
    fn = getattr(FB, variant)
    if "dropout" in variant:
        out = fn(xt, block, seed, 0.1, h)
        _, m1, m2 = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=h, rate=0.1,
                                           seed=seed)
        assert 0.8 < (m1 > 0).float().mean() < 1.0
        ref = FB._block_reference_masked(xt, block, m1, m2, h)
    else:
        out = fn(xt, block, h)
        ref = FB._block_reference(xt, block, h)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    gt = torch.from_numpy(g)
    got = torch.autograd.grad(out, [xt, *params], gt)
    want = torch.autograd.grad(ref, [xt, *params], gt)
    _assert_leaves(got, [w.numpy() for w in want])
    if variant.endswith("_saved"):
        out = fn(xt, block, seed, 0.1, h) if "dropout" in variant else fn(xt, block, h)
        with pytest.raises(NotImplementedError, match="queue 2 item 2"):
            torch.autograd.grad(out, xt, gt, create_graph=True)  # a double backward


# --- the plain Philox ------------------------------------------------------------


def test_philox_known_answers():
    """Random123's known-answer vectors of philox4x32-10 (kat_vectors)."""
    t = lambda *v: [torch.tensor([w], dtype=torch.int64) for w in v]  # noqa: E731
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    for ctr, key, want in cases:
        got = FB.philox4x32_10(*t(*ctr), *t(*key))
        assert tuple(int(w) for w in got) == want


def test_dropout_masks_keep_rate_and_counter_based_bits():
    """Keep share within 3 sigma of 1 - rate on 10^6 draws; other seeds and
    other mask ids give other masks; element i's bits are word i % 4 of the
    Philox block of counter (i // 4, mask id), whatever the draw's length."""
    rate, count = 0.1, 10 ** 6
    seed = torch.tensor([123456789012345], dtype=torch.int64)
    m = FB.dropout_mask(seed, 0, (count,), rate)
    keep = (m > 0).double().mean().item()
    assert abs(keep - (1 - rate)) <= 3 * (rate * (1 - rate) / count) ** 0.5
    assert set(m.unique().tolist()) == {0.0, float(np.float32(1 / (1 - rate)))}
    other = FB.dropout_mask(seed + 1, 0, (count,), rate)
    assert not torch.equal(m, other) and not torch.equal(m, FB.dropout_mask(seed, 1, (count,),
                                                                            rate))
    bits = FB.dropout_bits(seed, 0, 5003)
    assert torch.equal(bits[:1001], FB.dropout_bits(seed, 0, 1001))
    s = int(seed)
    for i in (0, 3, 4, 1001, 5002):
        q = torch.tensor([i // 4], dtype=torch.int64)
        words = FB.philox4x32_10(q, q * 0, q * 0, q * 0, q * 0 + (s & 0xFFFFFFFF),
                                 q * 0 + (s >> 32))
        assert int(bits[i]) == int(words[i % 4])
    assert 0 <= int(bits.min()) and int(bits.max()) < 2 ** 32


# --- the train step ---------------------------------------------------------------


def test_cpu_train_step_megablock_on_matches_megablock_off(monkeypatch):
    """One smoke-size step at dropout 0 with runtime.megablock=on (every
    block through encoder_block_fused_saved and the plain saved backward)
    against the same step with megablock=off from one state: every metric
    and every gradient leaf.  The off step is held to the JAX step by
    tests/test_torch_v2_train.py::test_train_step_matches_jax."""
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    calls = []
    bwd = FB.fused_encoder_block_bwd
    monkeypatch.setattr(FB, "fused_encoder_block_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    real = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3))
                            .astype(np.float32))
    results = {}
    for mode in ("on", "off"):
        cfg = C.replace(C.smoke_config(), **{"v2.dropout": 0.0, "runtime.use_pallas": "auto",
                                             "runtime.compute_dtype": "float32",
                                             "runtime.megablock": mode})
        policy.apply_from_runtime(cfg.runtime)
        gan = build_gan(cfg)
        state = create_train_state(gan, cfg, device="cpu")
        before = dict(build.LAUNCHES)
        m = make_train_step(gan, cfg)(state, real)
        assert build.LAUNCHES == before
        grads = [p.grad.clone() for p in (*state.g.parameters(), *state.d.parameters())]
        results[mode] = (m, grads)
    # D's blocks in D's update (the fake batch is detached), D's and G's in G's
    assert len(calls) == 3 * cfg.v2.depth
    (mon, gon), (moff, goff) = results["on"], results["off"]
    for k in moff:
        np.testing.assert_allclose(mon[k].item(), moff[k].item(), **TOL, err_msg=k)
    for a, b in zip(gon, goff):
        assert (a - b).abs().max() <= GRAD_RTOL * b.abs().max() + 1e-9


def test_wide_train_step_megablock_on_matches_jax(monkeypatch):
    """One step at E 520 (5 heads of 104, hidden 1,040, 2 blocks, 16 tokens,
    dropout 0, f32) with runtime.megablock=on, every block of G and D through
    encoder_block_fused_saved and its plain saved backward, against the JAX
    make_train_step from the same state on the same batch and latents (the
    JAX step on the CPU takes its standard path): every metric and Adam's
    first moments within 1e-5, the parameters within 2 * lr + 1e-6 (AdamW's
    first step, tests/test_torch_v2_train.py)."""
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0, "v2.embed_dim": 520,
            "v2.num_heads": 5, "v2.image_size": 16, "v2.batch_size": 4}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(0).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    k_noise = jax.random.split(jst.rng, 11)[1]  # the JAX step's latents (step.py:66-73)
    z = np.array(jax.random.normal(k_noise, (4, jcfg.v2.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    calls = []
    bwd = FB.fused_encoder_block_bwd
    monkeypatch.setattr(FB, "fused_encoder_block_bwd",
                        lambda *a, **k: calls.append(1) or bwd(*a, **k))
    cfg = C.replace(C.smoke_config(), **over, **{"runtime.use_pallas": "auto",
                                                  "runtime.megablock": "on"})
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    assert len(calls) == 3 * cfg.v2.depth  # D's blocks in D's update, D's and G's in G's
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jopt, jparams in ((state.g, state.g_opt, jnew.g_opt, jnew.g_params),
                                    (state.d, state.d_opt, jnew.d_opt, jnew.d_params)):
        adam = [t for t in jax.tree.leaves(jopt, is_leaf=lambda t: isinstance(
            t, optax.ScaleByAdamState)) if isinstance(t, optax.ScaleByAdamState)]
        mu = from_jax_tree(jax.tree.map(np.asarray, adam[0].mu))
        for name, p in net.named_parameters():
            np.testing.assert_allclose(opt.opt.state[p]["exp_avg"].numpy(), mu[name].numpy(),
                                       **TOL, err_msg=name)
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)


# --- the repaired runtime.megablock_bwd ------------------------------------------------


def test_megablock_bwd_from_a_jax_config_reaches_the_gate(monkeypatch):
    """A JAX config.json with runtime.megablock_bwd='recompute' keeps it in
    the port (it used to load as 'saved'); under 'auto' a highres128 training
    block on the card (meta tensors stand in) then takes the standard path,
    as the JAX gate does, and with 'saved' the dropout megablock."""
    jcfg = JC.replace(JC.highres_config(128), **{"runtime.megablock_bwd": "recompute",
                                                 "runtime.megablock_group": 4})
    cfg = C.from_dict(json.loads(json.dumps(JC.to_dict(jcfg))))
    assert cfg.runtime.megablock_bwd == "recompute" and cfg.runtime.megablock_group == 4
    policy.apply_from_runtime(cfg.runtime)
    assert policy.get_policy()["megablock_bwd"] == "recompute"
    monkeypatch.setattr(FB, "on_cuda", lambda t: True)
    block = EncoderBlock(cfg.v2, None)
    x = torch.empty(2, 1024, cfg.v2.embed_dim, device="meta", dtype=torch.bfloat16)
    assert FB.megablock_route(block, x, cfg.v2, True, True) is None
    assert FB.maybe_megablock(block, x, cfg.v2, True, torch.Generator()) is None
    policy.set_policy(megablock_bwd="saved")
    assert FB.megablock_route(block, x, cfg.v2, True, True) == "encoder_block_fused_dropout_saved"
    # dropout without the step's generator takes the standard path, whose
    # dropout raises for want of it (the JAX gate: no rng, no megablock)
    assert FB.maybe_megablock(block, x, cfg.v2, True, None) is None
    with pytest.raises(ValueError, match="Generator"):
        L.dropout(torch.ones(2), cfg.v2.dropout, True, None)
    with pytest.raises(ValueError):
        policy.set_policy(megablock_bwd="fast")
