"""The vectorized trials (vitgan_tpu_torch/train/vstep.py): K train states,
one call a step on a shared batch.

- Against the JAX package: ``jax.vmap(make_raw_train_step(...))`` over two
  stacked states with per-trial injected rates (vitgan_tpu/hpo/sweep.py:
  293-330), the port's group carried from the same parameters and handed
  the JAX step's own draws (latents, instance noise, WGAN-GP's mixing
  weights; dropout 0).  Metrics and parameters to 1e-5 in f32 (parameters
  absolutely, at 1e-5 plus 2 learning rates, as Adam's sign can turn on a
  near-zero gradient), Adam's first moments (the clipped gradients summed
  into them) to rtol 1e-4.
- A one-trial group against the in-place step from the same state and
  stream, three steps, on recipes with dropout, DiffAugment, EMA, WGAN-GP,
  lazy R1 and two critic updates: metrics and parameters to 1e-6.
- Two slots holding one state that differ only by their stream: each
  equals its own one-trial group (no slot reads another's stream), and
  the two differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_raw_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.train.vstep import TrialGroup
from vitgan_tpu_torch.weights import from_jax_tree, load_into

B = 8


@pytest.fixture
def threefry():
    """JAX's default PRNG pinned to threefry2x32, whose split under vmap is
    the unbatched split; the JAX package's apply_from_runtime switches a
    process to rbg (RuntimeConfig.prng_impl), whose vmapped draws differ."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


@pytest.fixture(autouse=True)
def _plain_route():
    saved = policy.get_policy()
    policy.set_policy(mode="never")
    yield
    policy.set_policy(**saved)


def _adam_mu(opt_state, slot):
    states = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    return from_jax_tree(jax.tree.map(lambda x: np.asarray(x)[slot], states[0].mu))


def _set_lr(opt_state, lrs):
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = lrs
    return opt_state._replace(hyperparams=hp)


@pytest.mark.parametrize("loss", ["bce", "wgan-gp"])
def test_vmapped_step_matches_jax_vmap(loss, threefry):
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0, "v2.loss": loss,
            "v2.gen_optim.inject_lr": True, "v2.disc_optim.inject_lr": True}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    keys = jnp.stack([jax.random.PRNGKey(1000 + i) for i in range(2)])
    jst = jax.vmap(lambda k: jax_create_train_state(k, jgan, jcfg))(keys)
    g_lrs, d_lrs = [3e-4, 1e-4], [2e-4, 5e-4]
    jst = jst.replace(g_opt=_set_lr(jst.g_opt, jnp.asarray(g_lrs, jnp.float32)),
                      d_opt=_set_lr(jst.d_opt, jnp.asarray(d_lrs, jnp.float32)))
    real = np.random.default_rng(0).uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32)
    # each slot's own draws, as the JAX step splits its key (step.py:66-73)
    zs, nr, nf, eps = [], [], [], []
    for i in range(2):
        (_, k_noise, _, _, _, _, k_gp, k_in, _, _, _) = jax.random.split(jst.rng[i], 11)
        zs.append(np.array(jax.random.normal(k_noise, (B, jcfg.v2.latent_dim), jnp.float32)))
        n1, n2 = jax.random.split(k_in)
        nr.append(np.array(jax.random.normal(n1, real.shape, jnp.float32)))
        nf.append(np.array(jax.random.normal(n2, real.shape, jnp.float32)))
        eps.append(np.array(jax.random.uniform(jax.random.split(k_gp)[0], (B, 1, 1, 1),
                                               jnp.float32)))
    jnew, jm = jax.jit(jax.vmap(make_raw_train_step(jgan, jcfg), in_axes=(0, None)))(
        jst, jnp.asarray(real))

    cfg = C.replace(C.smoke_config(), **over)
    gan = build_gan(cfg)
    states = []
    for i in range(2):
        st = create_train_state(gan, cfg, device="cpu")
        load_into(st.g, from_jax_tree(jax.tree.map(lambda x: np.asarray(x)[i], jst.g_params)))
        load_into(st.d, from_jax_tree(jax.tree.map(lambda x: np.asarray(x)[i], jst.d_params)))
        states.append(st)
    group = TrialGroup(gan, cfg, states, g_lrs, d_lrs)
    draws = (None if loss == "bce" else
             [{"noise_real": torch.from_numpy(nr[i]), "noise_fake": torch.from_numpy(nf[i]),
               "gp_eps": torch.from_numpy(eps[i])} for i in range(2)])
    m = group.step(torch.from_numpy(real), zs=torch.from_numpy(np.stack(zs)), draws=draws)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for net, jparams, jopt, lrs in (("g", jnew.g_params, jnew.g_opt, g_lrs),
                                    ("d", jnew.d_params, jnew.d_opt, d_lrs)):
        for slot, st in enumerate(group.states):
            want = from_jax_tree(jax.tree.map(lambda x: np.asarray(x)[slot], jparams))
            mu = _adam_mu(jopt, slot)
            opt = getattr(st, f"{net}_opt").opt
            for name, t in getattr(st, net).named_parameters():
                np.testing.assert_allclose(t.detach().numpy(), want[name].numpy(), rtol=0,
                                           atol=2 * lrs[slot] + 1e-5, err_msg=name)
                np.testing.assert_allclose(opt.state[t]["exp_avg"].numpy(), mu[name].numpy(),
                                           rtol=1e-4, atol=1e-8, err_msg=name)


RECIPES = [
    {},
    {"v2.loss": "wgan-gp", "run.diff_augment": "color,translation,cutout",
     "run.ema_decay": 0.9},
    {"v2.r1_gamma": 1.0, "v2.r1_interval": 2, "v2.disc_steps": 2, "v2.g_diversity": True},
]


def _cfg(**over):
    return C.replace(C.smoke_config(), **{"runtime.compute_dtype": "float32",
                                          "v2.gen_optim.inject_lr": True,
                                          "v2.disc_optim.inject_lr": True, **over})


@pytest.mark.parametrize("recipe", range(len(RECIPES)))
def test_one_trial_group_equals_the_in_place_step(recipe):
    cfg = _cfg(**RECIPES[recipe])
    gan = build_gan(cfg)
    lr_cfg = C.replace(cfg, **{"v2.seed": 7, "v2.gen_optim.learning_rate": 3e-4,
                               "v2.disc_optim.learning_rate": 2e-4})
    group = TrialGroup(gan, cfg, [create_train_state(gan, lr_cfg, device="cpu")], [3e-4],
                       [2e-4])
    ref = create_train_state(gan, lr_cfg, device="cpu")
    step = make_train_step(gan, lr_cfg)
    rng = np.random.default_rng(1)
    for _ in range(3):
        real = torch.from_numpy(rng.uniform(-1, 1, (B, 32, 32, 3)).astype(np.float32))
        m, want = group.step(real), step(ref, real)
        for k in want:
            np.testing.assert_allclose(m[k][0].item(), want[k].item(), rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    mine = group.states[0]
    for net in ("g", "d"):
        got = dict(getattr(mine, net).named_parameters())
        for name, p in getattr(ref, net).named_parameters():
            np.testing.assert_allclose(got[name].detach().numpy(), p.detach().numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
    if ref.g_ema is not None:
        for a, e in zip(mine.g_ema, ref.g_ema):
            np.testing.assert_allclose(a.numpy(), e.numpy(), atol=1e-6)


def test_slots_read_only_their_own_stream():
    """One state in two slots, streams seeded 5 and 6: each slot equals the
    one-trial group of its stream; the slots differ (dropout 0.1,
    DiffAugment)."""
    cfg = _cfg(**{"run.diff_augment": "color,translation"})
    gan = build_gan(cfg)

    def state(stream):
        st = create_train_state(gan, cfg, device="cpu")
        st.rng.manual_seed(stream)
        return st

    real = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (B, 32, 32, 3))
                            .astype(np.float32))
    pair = TrialGroup(gan, cfg, [state(5), state(6)], [3e-4, 3e-4], [2e-4, 2e-4])
    m2 = pair.step(real)
    for slot, stream in enumerate((5, 6)):
        one = TrialGroup(gan, cfg, [state(stream)], [3e-4], [2e-4])
        m1 = one.step(real)
        for k in m1:
            np.testing.assert_allclose(m2[k][slot].item(), m1[k][0].item(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
    w = [dict(st.g.named_parameters())["mapping.w"] for st in pair.states]
    assert not torch.equal(w[0], w[1])
