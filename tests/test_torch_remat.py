"""Rematerialisation of the v2 encoder blocks (runtime.remat) against the
JAX package, on the CPU.

- in each mode (full, dots, attn) the forward and every gradient of D and G
  bit-equal to 'never' in f32, with dropout 0.1 drawn from an explicit
  generator (a port that drew its masks inside the re-run block would draw
  new ones there and fail), on the standard path (the flash and LN->MLP
  Functions, use_pallas=always), the plain route (use_pallas=never) and the
  megablock's two training Functions (dropout 0: the megablock's dropout
  forms need the card); a train step with R1 every step (a double backward
  through the re-run blocks) bit-equal too;
- the port's gradients under each mode against the JAX package's under the
  same mode, 1e-5;
- per mode the forward calls of the flash, LN->MLP and megablock Functions
  against the pallas_calls of the same kind in the jaxpr of the JAX
  gradient (traced only, interpret mode): flash twice a block under full
  and dots, once under attn and never; LN->MLP once a block in every mode;
  the megablock's saved forward twice a block in every remat mode;
- v1 does not rematerialise; 'True' reads as 'full'.

Tolerances: bit-equal within the port; 1e-5 relative and absolute against
the JAX package (f32, 'highest' matmul precision, tests/conftest.py).
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.ops import policy as JP
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("full", "dots", "attn")


@pytest.fixture(autouse=True)
def _restore_policy():
    saved, jsaved = policy.get_policy(), JP.get_policy()
    yield
    policy.set_policy(**saved)
    JP.set_policy(**{k: jsaved[k] for k in ("mode", "min_mlp_rows", "remat", "megablock",
                                            "megablock_bwd")})


# route -> (port policy, dropout)
ROUTES = {"standard": (dict(mode="always", min_mlp_rows=0, megablock="off"), 0.1),
          "plain": (dict(mode="never", megablock="off"), 0.1),
          # patch 1: 1,024 tokens, 1,025 in D, whose plain attention is then the
          # chunked one, a checkpoint of its own inside the block's
          "plain_chunked": (dict(mode="never", megablock="off"), 0.1),
          "megablock_saved": (dict(mode="always", megablock="on", megablock_bwd="saved"), 0.0),
          "megablock_recompute": (dict(mode="always", megablock="on",
                                       megablock_bwd="recompute"), 0.0)}


def _cfg(dropout, route=""):
    over = {"v2.patch_size": 1, "v2.depth": 1} if route == "plain_chunked" else {}
    return C.replace(C.smoke_config(), **{"runtime.compute_dtype": "float32",
                                          "v2.dropout": dropout, **over})


def _grads(net: str, route: str, mode: str):
    """(output, [input grad, parameter grads]) of D (or G) at smoke size on a
    fixed input, dropout drawn from an explicit generator."""
    pol, dropout = ROUTES[route]
    cfg = _cfg(dropout, route)
    policy.set_policy(**pol, remat=mode)
    gan = build_gan(cfg)
    init = torch.Generator().manual_seed(0)
    g = gan.generator_init(init, device="cpu")
    d = gan.discriminator_init(init, device="cpu")
    gen = torch.Generator().manual_seed(5)
    if net == "d":
        x = (torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1)
        x.requires_grad_()
        out = gan.discriminator_apply(d, x, train=True, generator=gen)
        params = list(d.parameters())
    else:
        x = torch.randn(4, cfg.v2.latent_dim, generator=torch.Generator().manual_seed(1))
        x.requires_grad_()
        out = g(x, train=True, generator=gen)
        params = list(g.parameters())
    (out.float() ** 2).sum().backward()
    return out.detach(), [x.grad, *(p.grad for p in params)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("net", ["d", "g"])
def test_remat_is_bit_equal_to_never(net, route, mode):
    want_out, want = _grads(net, route, "never")
    got_out, got = _grads(net, route, mode)
    assert torch.equal(got_out, want_out)
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), f"{net} {route} {mode}: gradient {i} differs"


@pytest.mark.parametrize("route", ["standard", "megablock_recompute"])
def test_train_step_with_r1_under_remat_is_bit_equal(route):
    """Two train steps with R1 every step (its double backward re-runs each
    block of D's R1 forward twice), dropout where the route takes it."""
    pol, dropout = ROUTES[route]
    states = {}
    for mode in ("never", *MODES):
        cfg = C.replace(_cfg(dropout), **{"v2.r1_gamma": 1.0, "v2.r1_interval": 1,
                                          "run.diff_augment": "color"})
        gan = build_gan(cfg)
        st = create_train_state(gan, cfg, device="cpu")
        policy.set_policy(**pol, remat=mode)
        step = make_train_step(gan, cfg)
        for i in range(2):
            m = step(st, torch.rand(8, 32, 32, 3, generator=torch.Generator().manual_seed(i))
                     * 2 - 1)
        assert float(m["d_r1"]) > 0
        states[mode] = [p.detach().clone() for p in (*st.g.parameters(), *st.d.parameters())]
    for mode in MODES:
        assert all(torch.equal(a, b) for a, b in zip(states[mode], states["never"])), mode


# --- against the JAX package ---------------------------------------------------------


def _jax_weights(cfg_j):
    gan = jax_build_gan(cfg_j)
    gv = gan.generator_init(jax.random.PRNGKey(0))
    dv = gan.discriminator_init(jax.random.PRNGKey(1))
    return gan, gv, dv


@pytest.mark.parametrize("mode", MODES)
def test_gradients_match_jax_under_the_same_mode(mode):
    """D's and G's parameter gradients under ``mode`` on both sides (the
    plain routes, dropout 0), from the same weights and inputs."""
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan, gv, dv = _jax_weights(jcfg)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    z = rng.standard_normal((4, jcfg.v2.latent_dim)).astype(np.float32)
    JP.set_policy(mode="never", remat=mode)

    def d_loss(p):
        out, _ = jgan.discriminator_apply({"params": p, "state": dv["state"]}, jnp.asarray(x),
                                          rng=jax.random.PRNGKey(2), train=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    def g_loss(p):
        out, _ = jgan.generator_apply({"params": p, "state": gv["state"]}, jnp.asarray(z),
                                      rng=jax.random.PRNGKey(2), train=True)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    jd = from_jax_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(d_loss))(dv["params"])))
    jg = from_jax_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(g_loss))(gv["params"])))
    cfg = C.replace(C.smoke_config(), **over)
    gan = build_gan(cfg)
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    d = gan.discriminator_init(torch.Generator().manual_seed(0), device="cpu")
    load_into(g, from_jax_tree(jax.tree.map(np.asarray, gv["params"])))
    load_into(d, from_jax_tree(jax.tree.map(np.asarray, dv["params"])))
    policy.set_policy(mode="never", remat=mode)
    gen = torch.Generator().manual_seed(0)
    (gan.discriminator_apply(d, torch.from_numpy(x), train=True, generator=gen).float() ** 2
     ).sum().backward()
    (g(torch.from_numpy(z), train=True, generator=gen).float() ** 2).sum().backward()
    for net, want in ((d, jd), (g, jg)):
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL,
                                       err_msg=f"{mode} {name}")


def _jax_kinds(jaxpr, acc):
    """The kind of every pallas_call in a jaxpr (sub-jaxprs included), by its
    outputs: 1 the LN->MLP forward, 2 the flash forward (out, lse), 3 the flash
    single-pass backward (dq, dk, dv), 5 the megablock's saved forward (out,
    x1, z1, ao, lse), 13 its saved backward."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            acc[{1: "ln_mlp", 2: "flash", 3: "flash_bwd", 5: "megablock",
                 13: "megablock_bwd"}[len(eqn.outvars)]] += 1
            continue
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else [val]:
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    _jax_kinds(sub.jaxpr, acc)
                elif hasattr(sub, "eqns"):
                    _jax_kinds(sub, acc)
    return acc


def _port_forward_calls(monkeypatch):
    """Counts of the three Functions' forward calls on the CPU: their plain
    versions called with grad off (a Function's forward; the LN->MLP and
    megablock backwards rerun plain versions with grad on)."""
    calls = Counter()

    def counted(mod, name, key):
        f = getattr(mod, name)

        def g(*a, **k):
            if not torch.is_grad_enabled():
                calls[key] += 1
            return f(*a, **k)

        monkeypatch.setattr(mod, name, g)

    counted(A, "attention_forward_reference", "flash")
    counted(FM, "_reference", "ln_mlp")
    counted(FB, "fused_encoder_block", "megablock")
    return calls


@pytest.mark.parametrize("mode", ("never", *MODES))
@pytest.mark.parametrize("megablock", ["off", "on"])
def test_forward_calls_per_mode_equal_the_jax_pallas_calls(megablock, mode, monkeypatch):
    """D's gradient at smoke size (2 blocks, 65 tokens), every kernel route
    forced, dropout 0: the port's forward Function calls against the JAX
    gradient jaxpr's forward pallas_calls, kind by kind."""
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan, _, dv = _jax_weights(jcfg)
    JP.set_policy(mode="always", min_mlp_rows=0, remat=mode, megablock=megablock,
                  megablock_bwd="saved")

    def loss(p):
        out, _ = jgan.discriminator_apply({"params": p, "state": dv["state"]},
                                          jnp.zeros((2, 32, 32, 3)), rng=jax.random.PRNGKey(1),
                                          train=True)
        return out.astype(jnp.float32).sum()

    want = _jax_kinds(jax.make_jaxpr(jax.grad(loss))(dv["params"]).jaxpr, Counter())
    calls = _port_forward_calls(monkeypatch)
    cfg = C.replace(C.smoke_config(), **over)
    gan = build_gan(cfg)
    d = gan.discriminator_init(torch.Generator().manual_seed(0), device="cpu")
    policy.set_policy(mode="always", min_mlp_rows=0, remat=mode, megablock=megablock,
                      megablock_bwd="saved")
    x = torch.zeros(2, 32, 32, 3)
    gan.discriminator_apply(d, x, train=True, generator=torch.Generator()).float().sum().backward()
    depth = cfg.v2.depth
    assert {k: calls[k] for k in ("flash", "ln_mlp", "megablock")} == \
        {k: want[k] for k in ("flash", "ln_mlp", "megablock")}
    # the expectations spelled out, per block
    if megablock == "off":
        assert calls["flash"] == depth * (1 if mode in ("never", "attn") else 2)
        assert calls["ln_mlp"] == depth and want["flash_bwd"] == depth
    else:
        assert calls["megablock"] == depth * (1 if mode == "never" else 2)
        assert want["megablock_bwd"] == depth


def test_v1_does_not_rematerialise_and_true_reads_as_full(monkeypatch):
    """The v1 family's blocks are never checkpointed (the JAX `_maybe_remat`
    wraps the v2 blocks only): its forward calls and gradients are those of
    'never'; remat=True is 'full', False 'never'."""
    cfg = C.replace(C.smoke_config("v1"), **{"runtime.compute_dtype": "float32"})
    gan = build_gan(cfg)
    out = {}
    for mode in ("never", "full"):
        calls = _port_forward_calls(monkeypatch)
        policy.set_policy(mode="always", remat=mode)
        d = gan.discriminator_init(torch.Generator().manual_seed(0), device="cpu")
        x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
        gan.discriminator_apply(d, x, train=True, generator=torch.Generator().manual_seed(2)
                                ).float().sum().backward()
        out[mode] = (dict(calls), [p.grad for p in d.parameters()])
    assert out["full"][0] == out["never"][0] and out["never"][0]["flash"] > 0
    assert all(torch.equal(a, b) for a, b in zip(out["full"][1], out["never"][1]))
    policy.set_policy(remat=True)
    assert policy.remat_mode() == "full"
    policy.set_policy(remat=False)
    assert policy.remat_mode() == "never"
    with pytest.raises(ValueError, match="remat"):
        policy.set_policy(remat="sometimes")
    policy.apply_from_runtime(C.highres256p4_config().runtime)
    assert policy.remat_mode() == "attn"
