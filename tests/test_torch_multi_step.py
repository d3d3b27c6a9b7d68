"""The port's multi-step train functions on the CPU.

- make_device_data_train_fn over 3 steps (the eager loop) against the JAX
  make_device_data_train_fn over the same 3 steps, at smoke size in f32,
  dropout 0, no augment, no flip, from the JAX state with the latents the
  JAX step draws from its own key splits (step.py:66-73), for v2 and v1;
  make_multi_train_step over stacked batches the same way;
- n steps of a multi-step function bit-equal to n eager steps, with dropout,
  DiffAugment, flips, two critic updates a step, lazy R1 and the EMA;
- latent_block row for row against latent_rng, the per-step rates against
  make_lr, the R1 pattern of a call that straddles r1_interval;
- the trainer's steps per call and remainder against the JAX trainer's rule,
  and the settings that take the host pipeline (once refused, naming
  ROADMAP.md queue 1 item 3) training.

Tolerances are test_train_step_matches_jax's (tests/test_torch_v2_train.py):
metrics 1e-5 relative and absolute; parameters within 2 * lr + 1e-6 a step,
so 3 * (2 * lr) + 1e-6 after 3 steps (on each step a near-zero gradient
coordinate can take either sign on the two sides).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_device_data_train_fn as jax_device_data_fn
from vitgan_tpu.train.step import make_multi_train_step as jax_multi_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.sample import latent_block, latent_rng
from vitgan_tpu_torch.train.state import create_train_state, make_lr
from vitgan_tpu_torch.train.step import (device_batch, make_device_data_train_fn,
                                         make_multi_train_step, make_train_step, plan_steps)
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
N = 3
NO_DROPOUT = {
    "v2": {"runtime.compute_dtype": "float32", "v2.dropout": 0.0},
    "v1": {"runtime.compute_dtype": "float32",
           **{f"v1.{net}.transformer.{k}": 0.0 for net in ("generator", "discriminator")
              for k in ("attn_dropout", "mlp_dropout")}},
}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_latents(jst, jgan, n, batch):
    """The latents of n JAX steps: step i's z from its key split, its
    successor's key the split's first (step.py:66-73)."""
    rng, out = jst.rng, []
    for _ in range(n):
        keys = jax.random.split(rng, 11)
        rng = keys[0]
        out.append(np.asarray(jgan.sample_latent(keys[1], batch), np.float32))
    return np.stack(out)[:, None]  # (n, disc_steps=1, B, L)


def _from_jax(family):
    """(jcfg, jgan, jst, cfg, gan, port state holding the JAX weights)."""
    over = NO_DROPOUT[family]
    jcfg = JC.replace(JC.smoke_config(family), **over)
    cfg = C.replace(C.smoke_config(family), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    for net, params, st in ((state.g, jst.g_params, jst.g_state),
                            (state.d, jst.d_params, jst.d_state)):
        load_into(net, from_jax_tree({"params": _np_tree(params), "state": _np_tree(st)}))
    return jcfg, jgan, jst, cfg, gan, state


def _hold_to_jax(m, jm, state, jnew, n):
    assert set(m) == set(jm)
    for k in jm:
        assert m[k].shape == (n,)
        np.testing.assert_allclose(m[k].numpy(), np.asarray(jm[k]), **TOL, err_msg=k)
    for net, opt, jparams, jstate in ((state.g, state.g_opt, jnew.g_params, jnew.g_state),
                                      (state.d, state.d_opt, jnew.d_params, jnew.d_state)):
        want = from_jax_tree({"params": _np_tree(jparams), "state": _np_tree(jstate)})
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=n * 2 * lr + 1e-6, err_msg=name)
        for name, buf in net.named_buffers():
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), **TOL, err_msg=name)
    assert state.step == n and state.g_opt.count == n and state.d_opt.count == n


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_device_data_fn_matches_jax(family):
    jcfg, jgan, jst, cfg, gan, state = _from_jax(family)
    b = cfg.model.batch_size
    data = np.random.default_rng(1).integers(0, 256, (40, 32, 32, 3), dtype=np.uint8)
    idx = np.random.default_rng(2).permutation(40)[: N * b].reshape(N, b).astype(np.int32)
    lat = _jax_latents(jst, jgan, N, b)
    jnew, jm = jax_device_data_fn(jgan, jcfg, N, donate=False)(jst, jnp.asarray(data),
                                                                 jnp.asarray(idx))
    m = make_device_data_train_fn(gan, cfg, N)(state, torch.from_numpy(data), idx, lat)
    _hold_to_jax(m, jm, state, jnew, N)


def test_multi_train_step_matches_jax():
    jcfg, jgan, jst, cfg, gan, state = _from_jax("v2")
    b = cfg.model.batch_size
    reals = np.random.default_rng(3).uniform(-1, 1, (N, b, 32, 32, 3)).astype(np.float32)
    lat = _jax_latents(jst, jgan, N, b)
    jnew, jm = jax_multi_step(jgan, jcfg, N, donate=False)(jst, jnp.asarray(reals))
    m = make_multi_train_step(gan, cfg, N)(state, torch.from_numpy(reals), lat)
    _hold_to_jax(m, jm, state, jnew, N)


def _leaves(state):
    out = [*state.g.state_dict().values(), *state.d.state_dict().values(), *state.g_ema]
    for opt in (state.g_opt, state.d_opt):
        for entry in opt.opt.state.values():
            out.extend(entry.values())
    return out


def test_multi_step_is_n_eager_steps_bit_for_bit():
    """Dropout, DiffAugment, flips, disc_steps 2, lazy R1 every 2nd step and
    the EMA: 3 steps of the device-data function from step 1 and 3 eager
    steps from the same state give the same bits."""
    cfg = C.replace(C.smoke_config(), **{
        "v2.disc_steps": 2, "v2.r1_gamma": 1.0, "v2.r1_interval": 2,
        "run.diff_augment": "color,translation", "run.ema_decay": 0.9,
        "data.augment_flip": True})
    gan = build_gan(cfg)
    data = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (32, 32, 32, 3),
                                                                dtype=np.uint8))
    idx = np.random.default_rng(5).permutation(32)[: 3 * 8].reshape(3, 8)
    step = make_train_step(gan, cfg)
    a, b = (create_train_state(gan, cfg, device="cpu") for _ in range(2))
    for st in (a, b):  # start off step 0, so that the call straddles the R1 steps
        step(st, device_batch(data, torch.from_numpy(idx[0]), True, st.rng))
    m = make_device_data_train_fn(gan, cfg, 3)(a, data, idx)
    eager = [step(b, device_batch(data, torch.from_numpy(i), True, b.rng)) for i in idx]
    for k in m:
        assert torch.equal(m[k], torch.stack([e[k] for e in eager])), k
    assert [bool(v) for v in m["d_r1"] != 0] == [False, True, False]  # steps 1, 2, 3
    assert a.step == b.step == 4 and a.d_opt.count == b.d_opt.count == 8
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)
    assert torch.equal(a.rng.get_state(), b.rng.get_state())


def test_latent_block_rows_are_the_eager_steps_draws():
    cfg = C.replace(C.smoke_config(), **{"v2.disc_steps": 2})
    gan = build_gan(cfg)
    block = latent_block(gan, 7, 5, 3, 4, 2)
    assert block.shape == (3, 2, 4, gan.latent_dim) and block.dtype == np.float32
    for i in range(3):
        rng = latent_rng(7, 5 + i)
        for j in range(2):  # z, then the extra critic update's
            np.testing.assert_array_equal(block[i, j], gan.sample_latent(rng, 4).numpy())


def test_rates_are_the_schedule_at_each_updates_count():
    cfg = C.replace(C.smoke_config(), **{
        "v2.disc_steps": 3, "v2.gen_optim.schedule": "warmup_cosine",
        "v2.gen_optim.warmup_steps": 2, "v2.gen_optim.decay_steps": 9,
        "v2.disc_optim.warmup_steps": 4})
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    state.g_opt.count, state.d_opt.count, state.step = 1, 3, 1
    plan = plan_steps(gan, cfg, state, 4, 8)
    g_lr, d_lr = make_lr(cfg.v2.gen_optim), make_lr(cfg.v2.disc_optim)
    assert list(plan.g_rates) == [g_lr(1 + i) for i in range(4)]
    assert plan.d_rates.shape == (4, 3)
    assert [list(r) for r in plan.d_rates] == [[d_lr(3 + 3 * i + j) for j in range(3)]
                                               for i in range(4)]


def test_r1_pattern_across_a_call():
    cfg = C.replace(C.smoke_config(), **{"v2.r1_gamma": 1.0, "v2.r1_interval": 4})
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    state.step = 2
    assert list(plan_steps(gan, cfg, state, 5, 8).with_r1) == [False, False, True, False, False]
    data = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (40, 32, 32, 3),
                                                                dtype=np.uint8))
    m = make_device_data_train_fn(gan, cfg, 5)(state, data, np.arange(40).reshape(5, 8))
    assert [bool(v) for v in m["d_r1"] != 0] == [False, False, True, False, False]
    wgan = C.replace(cfg, **{"v2.loss": "wgan-gp"})
    assert not plan_steps(gan, wgan, state, 8, 8).with_r1.any()


def test_multi_step_checks_its_inputs():
    cfg = C.smoke_config()
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    data = torch.zeros((16, 32, 32, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="indices"):
        make_device_data_train_fn(gan, cfg, 2)(state, data, np.zeros((3, 8), np.int64))
    with pytest.raises(ValueError, match="latents"):
        make_device_data_train_fn(gan, cfg, 2)(state, data, np.zeros((2, 8), np.int64),
                                               np.zeros((2, 1, 8, 3), np.float32))
    with pytest.raises(ValueError, match="reals"):
        make_multi_train_step(gan, cfg, 2)(state, torch.zeros((3, 8, 32, 32, 3)))


@pytest.mark.parametrize("samples,spe,spc", [(40, None, 1), (40, 3, 1), (40, None, 2),
                                             (24, 8, 1)])
def test_steps_per_call_and_remainder_follow_the_jax_trainer(tmp_path, monkeypatch, samples,
                                                            spe, spc):
    """k from the JAX Trainer's own __init__ on a one-device mesh (its train
    state, step factories and scalar sink stubbed, and the port's scalar sink:
    k reads none of them), the epoch's calls from its own
    _epoch_steps_on_device against the port's: n // k calls of k, then one of
    the remainder."""
    from vitgan_tpu.parallel import make_mesh
    from vitgan_tpu.train import step as JS
    from vitgan_tpu.train import trainer as JT
    from vitgan_tpu_torch.train import trainer as T

    def recorder(calls):
        def build(gan, cfg, n, **kw):
            def call(state, data, idx):
                calls.append((n, len(idx)))
                return state, {}
            return call
        return build

    jax_calls, calls = [], []
    monkeypatch.setattr(JT, "create_train_state",
                        lambda *a, **k: SimpleNamespace(g_params=None, d_params=None))
    monkeypatch.setattr(JT, "count_params", lambda *a, **k: 0)
    monkeypatch.setattr("vitgan_tpu.parallel.sharding.shard_train_state", lambda s, *a, **k: s)
    monkeypatch.setattr(JT, "MetricLogger", lambda *a, **k: None)
    monkeypatch.setattr(JT, "make_train_step", lambda *a, **k: None)
    monkeypatch.setattr(JS, "make_device_data_train_fn", recorder(jax_calls))
    over = {"data.synthetic_samples": samples, "run.steps_per_epoch": spe,
            "run.steps_per_call": spc}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jt = JT.Trainer(jcfg, mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
                    run_base=str(tmp_path / "jax"))
    jax_calls.clear()  # the epoch's call of k, built in __init__
    jt._device_train_fn = recorder(jax_calls)(None, None, jt._device_steps_per_call)
    list(jt._epoch_steps_on_device(jcfg.run))

    monkeypatch.setattr(T, "make_device_data_train_fn",
                        lambda gan, cfg, n: recorder(calls)(gan, cfg, n))
    monkeypatch.setattr(T, "MetricLogger", lambda *a, **k: None)  # k reads no scalar sink
    t = T.Trainer(C.replace(C.smoke_config(), **over), run_dir=str(tmp_path / "port"),
                  device="cpu")
    assert t.steps_per_call == jt._device_steps_per_call
    list(t._epoch_calls())
    k, n = t.steps_per_call, min(samples // 8, spe or samples)
    assert calls == jax_calls == [(k, k)] * (n // k) + ([(n % k, n % k)] if n % k else [])


def test_routes_the_trainer_cannot_run_name_queue_1_item_3(tmp_path):
    """The three settings the trainer once refused (naming ROADMAP.md queue 1
    item 3, the data layer) take the host pipeline, as the JAX trainer's
    route decision does, and train: a partial last batch included."""
    from vitgan_tpu_torch.train.trainer import Trainer

    cases = (({"data.on_device": False}, [8, 8]),
             ({"data.on_device_max_bytes": 1000}, [8, 8]),
             ({"data.drop_last": False, "data.synthetic_samples": 20,
               "run.steps_per_epoch": None}, [8, 8, 4]))
    for i, (over, sizes) in enumerate(cases):
        cfg = C.replace(C.smoke_config(), **{"run.fid_every_epochs": 0, **over})
        t = Trainer(cfg, run_dir=str(tmp_path / f"r{i}"), device="cpu")
        assert t.route == "host" and t.dataset is None, over
        seen = []
        for m, n_images in t._epoch_calls():
            seen.append(n_images)
            assert np.isfinite(m["d_loss"].numpy()).all()
        assert seen == sizes and t.state.step == len(sizes), over
