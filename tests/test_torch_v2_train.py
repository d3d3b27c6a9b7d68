"""The port's training slice against the JAX package, on the CPU.

- the port's presets equal the JAX presets on every field the port carries;
- one step of make_train_step against the JAX make_train_step at smoke size,
  f32, dropout 0, no augment, with the latents, instance noise and
  gradient-penalty weights the JAX step draws from its own key splits
  (step.py:66-73), for the bce and wgan-gp recipes: every metric, Adam's first
  moments leaf for leaf, and the updated parameters;
- the trainer and `cli train --device cpu`: a run directory restore_run reads,
  the NaN abort, dropout's device check.

Tolerances: metrics and first moments 1e-5 relative and absolute (f32 on both
sides; the sums run in another order).  Parameters within 2 * lr + 1e-6: on
AdamW's first step a coordinate moves by lr * (g / (|g| + eps) + wd * p), so a
gradient near 1e-8 can take either sign on the two sides and move the
parameter by up to 2 * lr apart; every other coordinate agrees to 1e-6.
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
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models import layers as L
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.utils.run_dirs import restore_run
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _same_fields(port: dict, jax_: dict, path=""):
    """Every field the port carries equals the JAX package's."""
    for k, v in port.items():
        assert k in jax_, f"{path}{k} is not in the JAX schema"
        if isinstance(v, dict):
            _same_fields(v, jax_[k], f"{path}{k}.")
        else:
            assert v == jax_[k], f"{path}{k}: port {v!r} != JAX {jax_[k]!r}"


@pytest.mark.parametrize("preset", ["highres128", "highres256", "highres256p4", "deit64",
                                    "smoke"])
def test_presets_equal_the_jax_presets(preset):
    port, jax_ = {"highres128": (C.highres_config(128), JC.highres_config(128)),
                  "highres256": (C.highres_config(256), JC.highres_config(256)),
                  "highres256p4": (C.highres256p4_config(), JC.highres256p4_config()),
                  "deit64": (C.deit64_config(), JC.deit64_config()),
                  "smoke": (C.smoke_config(), JC.smoke_config())}[preset]
    _same_fields(C.to_dict(port), JC.to_dict(jax_))
    for section in ("v2", "runtime", "data", "run"):
        assert section in C.to_dict(port)
    if preset in ("highres128", "highres256p4"):
        assert port.runtime.remat == "attn" and port.run.diff_augment == "color,translation"
    if preset == "highres256p4":
        m = port.v2
        assert (m.image_size // m.patch_size) ** 2 == 4096 and m.batch_size == 8


def _jax_adam_mu(opt_state):
    states = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    return from_jax_tree(jax.tree.map(np.asarray, states[0].mu))


@pytest.mark.parametrize("loss", ["bce", "wgan-gp"])
def test_train_step_matches_jax(loss):
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0, "v2.loss": loss}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    # The JAX step's own draws (step.py:66-73, 88-91, losses.py:68 via step.py:127)
    (_, k_noise, _, _, _, _, k_gp, k_in, _, _, _) = jax.random.split(jst.rng, 11)
    z = np.array(jax.random.normal(k_noise, (8, jcfg.v2.latent_dim), jnp.float32))
    n1, n2 = jax.random.split(k_in)
    draws = {"noise_real": np.array(jax.random.normal(n1, real.shape, jnp.float32)),
             "noise_fake": np.array(jax.random.normal(n2, real.shape, jnp.float32)),
             "gp_eps": np.array(jax.random.uniform(jax.random.split(k_gp)[0], (8, 1, 1, 1),
                                                     jnp.float32))}
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    cfg = C.replace(C.smoke_config(), **over)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    if loss == "bce":
        draws = {}
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z),
                                  draws={k: torch.from_numpy(v) for k, v in draws.items()})
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jopt, jparams in ((state.g, state.g_opt, jnew.g_opt, jnew.g_params),
                                    (state.d, state.d_opt, jnew.d_opt, jnew.d_params)):
        names = [n for n, _ in net.named_parameters()]
        mu = _jax_adam_mu(jopt)
        for name, got in zip(names, (opt.opt.state[p]["exp_avg"] for p in net.parameters())):
            np.testing.assert_allclose(got.numpy(), mu[name].numpy(), **TOL, err_msg=name)
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)
    assert state.step == 1


def test_train_step_recipes_run_on_the_plain_route():
    """R1 (lazy), disc_steps 2, DiffAugment, EMA and instance noise: one step
    each on the CPU, finite metrics under the JAX package's keys."""
    for over in ({"v2.r1_gamma": 1.0, "v2.r1_interval": 1},
                 {"v2.loss": "wgan-gp", "v2.disc_steps": 2, "run.diff_augment": "color,cutout"},
                 {"run.ema_decay": 0.9, "run.diff_augment": "translation", "v2.g_diversity": True}):
        cfg = C.replace(C.smoke_config(), **over)
        gan = build_gan(cfg)
        state = create_train_state(gan, cfg, device="cpu")
        g0 = [p.detach().clone() for p in state.g.parameters()]
        m = make_train_step(gan, cfg)(state, torch.rand(8, 32, 32, 3) * 2 - 1)
        assert all(torch.isfinite(v) for v in m.values()), (over, m)
        assert ("d_r1" in m) == ("v2.r1_gamma" in over)
        assert state.d_opt.count == cfg.v2.disc_steps and state.g_opt.count == 1
        if state.g_ema is not None:
            for e, p0, p in zip(state.g_ema, g0, state.g.parameters()):
                torch.testing.assert_close(e, 0.9 * p0 + 0.1 * p.detach())


def test_cli_train_writes_a_run_directory_restore_run_reads(tmp_path, monkeypatch):
    from vitgan_tpu_torch.cli import main

    monkeypatch.setenv("DEV", "1")
    run = tmp_path / "run"
    assert main(["train", "--device", "cpu", "--run-dir", str(run), "--run-name", "smoke",
                 "--set", "run.diff_augment=color,translation"]) == 0
    cfg, _, g, meta = restore_run(str(run), device="cpu")
    assert meta["step"] == 2 and cfg.run_name == "smoke" and cfg.run.steps_per_epoch == 2
    assert cfg.run.diff_augment == "color,translation"
    z = torch.zeros(2, cfg.v2.latent_dim)
    with torch.no_grad():
        assert torch.isfinite(g(z)).all()
    assert main(["generate", "--run-dir", str(run), "--num-images", "2", "--device",
                 "cpu"]) == 0
    # --dataset cifar10 reads data.data_dir (tests/test_torch_data_route.py
    # trains over files there); with none it raises, naming the files
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        main(["train", "--device", "cpu", "--dataset", "cifar10", "--run-dir", str(run),
              "--set", f"data.data_dir={tmp_path / 'no_cifar'}"])


def test_trainer_aborts_on_nan_without_writing(tmp_path):
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = C.replace(C.smoke_config(), **{"data.augment_flip": True})
    trainer = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    real = trainer.real_batch(trainer.batches()[0])
    assert real.shape == (8, 32, 32, 3) and real.min() >= -1 and real.max() <= 1
    nan = torch.tensor([float("nan")])
    trainer._device_train_fn = lambda state, data, idx: {"d_loss": nan,
                                                         "g_loss": torch.tensor([0.0])}
    means = trainer.fit()
    # neither the final checkpoint nor the generator that `cli serve` reads
    assert np.isnan(means["d_loss"]) and trainer.ckpts.latest_step() is None
    assert not (tmp_path / "run" / "generator.pt").exists()


def test_dropout_draws_on_the_activations_device():
    x = torch.ones(4, 8)
    out = L.dropout(x, 0.5, True, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) <= {0.0, 2.0}
    with pytest.raises(ValueError, match="device"):
        L.dropout(torch.ones(4, 8, device="meta"), 0.5, True, torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        L.dropout(x, 0.5, True, None)
