"""Gradient accumulation and the injected rate of the port, against the JAX
package, on the CPU.

- the optimizer under grad_accum 2 and 3 (adam, adamw, sgd; with and without
  the clip; constant and warmup-cosine) against the JAX make_optimizer
  (optax.MultiSteps around the chain) on the same gradients: parameters,
  the accumulator and the mini step after every call;
- inject_lr: the rate a state leaf, set per state, against
  optax.inject_hyperparams with the same rate set; its two ValueErrors;
- a v2 train step over 2k calls against the JAX step (f32, dropout 0, the
  JAX step's own latents): parameters frozen on accumulating calls and
  moved on applying ones, the EMA gated on effective updates, metrics and
  parameters within the step-parity bounds of tests/test_torch_v2_train.py;
- the captured step's plan (plan_steps: rates and applying calls) against
  per-step eager updates, with disc_steps 2 (each critic update one D
  call): bit-equal states;
- a resume in the middle of an accumulation (the state dict, and through
  the checkpoint files) bit-equal to an uninterrupted run.

Tolerances: optimizer calls 1e-6 (f32 on both sides, as
tests/test_torch_train_ops.py's optimizer test); the train step's metrics
1e-5 and parameters 2 * lr + 1e-6 (tests/test_torch_v2_train.py's reasons).
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
from vitgan_tpu.train.state import make_optimizer as jax_make_optimizer
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import Optimizer, create_train_state
from vitgan_tpu_torch.train.step import make_multi_train_step, make_train_step, plan_steps
from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


ACCUM_OPTIMS = [
    dict(name="adam", learning_rate=1e-2, beta1=0.5),
    dict(name="adam", learning_rate=1e-2, beta1=0.5, grad_clip=0.5),
    dict(name="adamw", learning_rate=5e-3, beta1=0.9, weight_decay=1e-2),
    dict(name="adamw", learning_rate=5e-3, beta1=0.9, weight_decay=1e-2, grad_clip=0.5),
    dict(name="sgd", learning_rate=0.1),
    dict(name="sgd", learning_rate=0.1, grad_clip=1.0),
    dict(name="adamw", learning_rate=1e-2, schedule="warmup_cosine", warmup_steps=1,
         decay_steps=4, min_lr_ratio=0.2, weight_decay=1e-2, grad_clip=0.5),
    dict(name="adam", learning_rate=1e-2, schedule="warmup_cosine", warmup_steps=2,
         decay_steps=5, min_lr_ratio=0.1),
]


def _ids(kw):
    return (f"{kw['name']}_{kw.get('schedule', 'constant')}_"
            f"{'clip' if kw.get('grad_clip') else 'noclip'}")


def _params_and_grads(n_calls, seed=10):
    rng = np.random.default_rng(seed)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    scales = (0.05, 1.0, 0.2, 0.7, 0.01, 2.0, 0.3, 0.5, 1.5)
    grads = [[(scales[i % len(scales)] * rng.standard_normal(p.shape)).astype(np.float32)
              for p in params] for i in range(n_calls)]
    return params, grads


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("kw", ACCUM_OPTIMS, ids=[_ids(o) for o in ACCUM_OPTIMS])
def test_optimizer_matches_optax_multisteps(kw, k):
    """3k calls: after each, the parameters, MultiSteps' accumulator and mini
    step within 1e-6; the returned norm is the call's own gradients'."""
    params, grads = _params_and_grads(3 * k)
    jcfg, cfg = JC.OptimConfig(grad_accum=k, **kw), C.OptimConfig(grad_accum=k, **kw)
    tx = jax_make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Optimizer(cfg, tp)
    for call, gs in enumerate(grads):
        before = [p.detach().clone() for p in tp]
        upd, jstate = tx.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(gs)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                       err_msg=f"call {call}")
        assert opt.mini_step == int(jstate.mini_step) == (call + 1) % k
        for a, b in zip(opt.acc, jstate.acc_grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        applied = call % k == k - 1
        assert opt.applies(call) == applied
        if not applied:  # the accumulating calls leave the parameters as they are
            assert all(torch.equal(a, b) for a, b in zip(before, tp))
    assert opt.count == 3 * k and int(jstate.gradient_step) == 3
    if cfg.name != "sgd":  # Adam's step counts applied updates
        assert all(int(opt.opt.state[p]["step"]) == 3 for p in tp)


def test_accumulated_mean_is_multisteps_arithmetic():
    """sgd at rate 1, k 3: zero updates twice, then minus the mean (JAX's
    test_grad_accum_sgd_semantics)."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    opt = Optimizer(C.OptimConfig(name="sgd", learning_rate=1.0, grad_accum=3), p)
    moves = []
    for g in (1.0, 2.0, 6.0):
        before = p[0].detach().clone()
        p[0].grad = torch.full((2,), g)
        opt.step()
        moves.append(float((p[0].detach() - before)[0]))
    assert moves[:2] == [0.0, 0.0]
    np.testing.assert_allclose(moves[2], -3.0, rtol=1e-6)
    assert opt.mini_step == 0 and all(float(a.abs().sum()) == 0.0 for a in opt.acc)


@pytest.mark.parametrize("name", ["adam", "adamw", "sgd"])
def test_inject_lr_is_a_state_leaf(name):
    """inject_lr: the rate lives in the state; set per state, it drives the
    next update as optax.inject_hyperparams' hyperparams leaf does, and the
    state dict carries it."""
    kw = dict(name=name, learning_rate=1e-2, beta1=0.5, weight_decay=1e-2 if name == "adamw"
              else 0.0, grad_clip=0.5, inject_lr=True)
    params, grads = _params_and_grads(4, seed=3)
    tx = jax_make_optimizer(JC.OptimConfig(**kw))
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Optimizer(C.OptimConfig(**kw), tp)
    assert opt.learning_rate == 1e-2 and opt.lr(5) == 1e-2
    for call, (gs, rate) in enumerate(zip(grads, (1e-2, 3e-2, 3e-2, 1e-3))):
        jstate.hyperparams["learning_rate"] = jnp.asarray(rate, jnp.float32)
        opt.learning_rate = rate
        upd, jstate = tx.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                       err_msg=f"call {call}")
    sd = opt.state_dict()
    assert sd["learning_rate"] == 1e-3
    other = Optimizer(C.OptimConfig(**kw), [torch.nn.Parameter(p.detach().clone()) for p in tp])
    other.load_state_dict(sd)
    assert other.learning_rate == 1e-3 and other.count == 4


@pytest.mark.parametrize("bad,msg", [
    (dict(inject_lr=True, grad_accum=2), "inject_lr is incompatible with grad_accum"),
    (dict(inject_lr=True, schedule="warmup_cosine", warmup_steps=1, decay_steps=4),
     "inject_lr supports constant lr only"),
    (dict(inject_lr=True, warmup_steps=3), "inject_lr supports constant lr only")])
def test_inject_lr_refuses_what_the_jax_package_refuses(bad, msg):
    with pytest.raises(ValueError, match=msg):
        jax_make_optimizer(JC.OptimConfig(**bad))
    with pytest.raises(ValueError, match=msg):
        Optimizer(C.OptimConfig(**bad), [torch.nn.Parameter(torch.zeros(2))])


# --- the train step ------------------------------------------------------------------


ACCUM = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0,
         "v2.gen_optim.grad_accum": 2, "v2.disc_optim.grad_accum": 2, "run.ema_decay": 0.9}


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def test_train_step_over_2k_calls_matches_jax():
    """grad_accum 2 on G and D, EMA 0.9: four calls of the port's step
    against four of the JAX step, from the same weights and latents.  After
    calls 1 and 3 (accumulating) both networks and the EMA are unchanged;
    after calls 2 and 4 (applying) they move; metrics and parameters after
    every call within the step-parity bounds."""
    jcfg = JC.replace(JC.smoke_config(), **ACCUM)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    jstep = jax_make_train_step(jgan, jcfg, donate=False)
    cfg = C.replace(C.smoke_config(), **ACCUM)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    with torch.no_grad():
        for e, p in zip(state.g_ema, state.g.parameters()):
            e.copy_(p)
    step = make_train_step(gan, cfg)
    rng = np.random.default_rng(0)
    for call in range(4):
        real = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
        k_noise = jax.random.split(jst.rng, 11)[1]  # the JAX step's latents (step.py:66-73)
        z = np.array(jax.random.normal(k_noise, (8, jcfg.v2.latent_dim), jnp.float32))
        g0, d0, e0 = _params(state.g), _params(state.d), [e.clone() for e in state.g_ema]
        jst, jm = jstep(jst, jnp.asarray(real))
        m = step(state, torch.from_numpy(real), z=torch.from_numpy(z))
        for k in jm:
            np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL,
                                       err_msg=f"call {call} {k}")
        applied = call % 2 == 1
        for new, old in ((_params(state.g), g0), (_params(state.d), d0),
                         (state.g_ema, e0)):
            same = all(torch.equal(a, b) for a, b in zip(new, old))
            assert same != applied, f"call {call}: applied={applied}, unchanged={same}"
        for net, jparams, opt in ((state.g, jst.g_params, state.g_opt),
                                  (state.d, jst.d_params, state.d_opt)):
            want = from_jax_tree(jax.tree.map(np.asarray, jparams))
            for name, p in net.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                           atol=2 * opt.cfg.learning_rate + 1e-6,
                                           err_msg=f"call {call} {name}")
        want_ema = from_jax_tree(jax.tree.map(np.asarray, jst.g_ema))
        for (name, _), e in zip(state.g.named_parameters(), state.g_ema):
            np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), rtol=0,
                                       atol=2 * state.g_opt.cfg.learning_rate + 1e-6,
                                       err_msg=f"call {call} ema {name}")
        assert state.g_opt.mini_step == int(jst.g_opt.mini_step)
        assert state.d_opt.mini_step == int(jst.d_opt.mini_step)


def _run_cfg(**extra):
    return C.replace(C.smoke_config(), **{"v2.dropout": 0.1, "run.diff_augment": "color",
                                          "run.ema_decay": 0.9, **extra})


def _state_leaves(st):
    sd = st.state_dict()
    out = [sd["rng"], *sd["g"].values(), *sd["d"].values(), *(sd["g_ema"] or ())]
    for opt in ("g_opt", "d_opt"):
        out.append(torch.tensor([sd[opt]["count"], sd[opt].get("mini_step", -1)]))
        out.extend(sd[opt].get("acc", ()))
        for entry in sd[opt]["state"].values():
            out.extend(entry.values())
    return out


def _assert_bit_equal(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert len(la) == len(lb)
    for i, (x, y) in enumerate(zip(la, lb)):
        assert torch.equal(x, y), f"leaf {i}"


@pytest.mark.parametrize("g_k,d_k,disc_steps", [(2, 2, 1), (3, 2, 2), (1, 3, 1)])
def test_plan_against_per_step_eager_updates(g_k, d_k, disc_steps):
    """The multi-step call's plan (each call's rate at its applied-update
    count, and which calls apply) against the single step called n times:
    bit-equal states.  With disc_steps 2 each critic update is one D call
    (the JAX step runs d_tx.update once per critic iteration)."""
    n = 5
    cfg = _run_cfg(**{"v2.gen_optim.grad_accum": g_k, "v2.disc_optim.grad_accum": d_k,
                      "v2.disc_steps": disc_steps, "v2.gen_optim.schedule": "warmup_cosine",
                      "v2.gen_optim.warmup_steps": 1, "v2.gen_optim.decay_steps": 4})
    gan = build_gan(cfg)
    reals = torch.rand(n, 8, 32, 32, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    a, b = create_train_state(gan, cfg, device="cpu"), create_train_state(gan, cfg, device="cpu")
    plan = plan_steps(gan, cfg, a, n, 8)
    np.testing.assert_array_equal(plan.g_apply, [(i % g_k) == g_k - 1 for i in range(n)])
    np.testing.assert_array_equal(
        plan.d_apply, [[((i * disc_steps + j) % d_k) == d_k - 1 for j in range(disc_steps)]
                       for i in range(n)])
    np.testing.assert_allclose(plan.g_rates, [a.g_opt.lr(i // g_k) for i in range(n)])
    make_multi_train_step(gan, cfg, n)(a, reals)
    step = make_train_step(gan, cfg)
    for i in range(n):
        step(b, reals[i])
    _assert_bit_equal(a, b)
    assert a.d_opt.count == b.d_opt.count == n * disc_steps
    assert a.g_opt.mini_step == n % g_k and a.d_opt.mini_step == (n * disc_steps) % d_k


def test_resume_in_the_middle_of_an_accumulation_is_bit_equal(tmp_path):
    """grad_accum 2 and 3: a state saved after 3 calls (G's accumulator
    half full, D's two thirds) and restored into a fresh state, directly and
    through the checkpoint files, then 3 more calls: bit-equal to 6
    uninterrupted calls."""
    cfg = _run_cfg(**{"v2.gen_optim.grad_accum": 2, "v2.disc_optim.grad_accum": 3})
    gan = build_gan(cfg)
    reals = torch.rand(6, 8, 32, 32, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    step = make_train_step(gan, cfg)
    whole = create_train_state(gan, cfg, device="cpu")
    for i in range(6):
        step(whole, reals[i])
    first = create_train_state(gan, cfg, device="cpu")
    for i in range(3):
        step(first, reals[i])
    sd = first.state_dict()
    assert sd["g_opt"]["mini_step"] == 1 and sd["d_opt"]["mini_step"] == 0
    assert any(float(a.abs().sum()) > 0 for a in sd["g_opt"]["acc"])
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, sd)
    mgr.wait()
    for source in (sd, mgr.restore(3)[0]):
        resumed = create_train_state(gan, cfg, device="cpu")
        resumed.load_state_dict(source)
        for i in range(3, 6):
            step(resumed, reals[i])
        _assert_bit_equal(resumed, whole)


def test_trainer_resumes_in_the_middle_of_an_accumulation(tmp_path):
    """Trainer: 3 steps with grad_accum 2, a checkpoint, `resume`, 3 more
    steps, against 6 uninterrupted (the device route's epochs of 3)."""
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = _run_cfg(**{"v2.gen_optim.grad_accum": 2, "v2.disc_optim.grad_accum": 2,
                      "run.steps_per_epoch": 3, "run.sample_grid_every_epochs": 0,
                      "run.fid_every_epochs": 0, "data.synthetic_samples": 64})
    whole = Trainer(cfg, run_dir=str(tmp_path / "whole"), device="cpu")
    whole.fit(epochs=2)
    part = Trainer(cfg, run_dir=str(tmp_path / "part"), device="cpu")
    part.fit(epochs=1)
    resumed = Trainer(cfg, run_dir=str(tmp_path / "part"), device="cpu")
    resumed.resume()
    assert resumed.state.g_opt.mini_step == 1
    resumed.fit(epochs=2)
    _assert_bit_equal(resumed.state, whole.state)
