"""The baselines (dcgan, cnn, mlp) against the JAX package, on the CPU.

- Forward parity of each generator and discriminator with the JAX weights
  carried across by weights.from_jax_tree, BatchNorm running statistics
  included (perturbed from their init), in train mode (batch statistics;
  the refreshed running statistics against the state the JAX apply returns)
  and in eval mode (the running statistics);
- one smoke train step each against the JAX make_train_step, with the JAX
  step's own latents: every metric, the updated parameters and the running
  statistics after the step (D's refreshed by its real and then its fake
  forward, G's by its one forward);
- the registry: d_has_batch_stats read from D, the config sections through
  to_dict/from_dict and JAX's config.json.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision).  Forwards
and running statistics 1e-5 relative and absolute; the step's metrics 1e-5
and parameters within 2 * lr + 1e-6, as tests/test_torch_v2_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into, to_jax_tree

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
FAMILIES = ("dcgan", "cnn", "mlp")
F32 = {"runtime.compute_dtype": "float32"}


def _perturbed(variables, seed):
    """The JAX variables with BatchNorm's running statistics moved off their
    init (mean 0, var 1), so that eval mode reads something."""
    rng = np.random.default_rng(seed)
    v = jax.tree.map(np.asarray, variables)
    for bn in v["state"].values():
        bn["mean"] = (0.1 * rng.standard_normal(bn["mean"].shape)).astype(np.float32)
        bn["var"] = (1 + 0.5 * rng.random(bn["var"].shape)).astype(np.float32)
    return v


def _modules(family, seed=0):
    jcfg = JC.replace(JC.smoke_config(family), **F32)
    jgan = jax_build_gan(jcfg)
    kg, kd = jax.random.split(jax.random.PRNGKey(seed))
    jg, jd = _perturbed(jgan.generator_init(kg), 1), _perturbed(jgan.discriminator_init(kd), 2)
    cfg = C.replace(C.smoke_config(family), **F32)
    gan = build_gan(cfg)
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    d = gan.discriminator_init(torch.Generator().manual_seed(1), device="cpu")
    load_into(g, from_jax_tree(jg))
    load_into(d, from_jax_tree(jd))
    return jgan, jcfg, jg, jd, gan, cfg, g, d


def _assert_state(module, jstate, what):
    sd = module.state_dict()
    for name, want in from_jax_tree({"params": {}, "state": jstate}).items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(), **TOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_jax(family, train):
    jgan, jcfg, jg, jd, gan, cfg, g, d = _modules(family)
    b = cfg.model.batch_size
    z = np.random.default_rng(3).standard_normal((b, gan.latent_dim)).astype(np.float32)
    jimg, jgs = jgan.generator_apply(jg, jnp.asarray(z), train=train)
    img = gan.generator_apply(g, torch.from_numpy(z), train=train)
    assert img.shape == (b, 32, 32, 3)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), **TOL)
    x = np.random.default_rng(4).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    jlog, jds = jgan.discriminator_apply(jd, jnp.asarray(x), train=train, update_state=True)
    logits = gan.discriminator_apply(d, torch.from_numpy(x), train=train, update_state=True)
    assert logits.shape == (b,)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlog), **TOL)
    _assert_state(g, jax.tree.map(np.asarray, jgs), "G")
    _assert_state(d, jax.tree.map(np.asarray, jds), "D")


@pytest.mark.parametrize("family", FAMILIES)
def test_train_step_matches_jax(family):
    jcfg = JC.replace(JC.smoke_config(family), **F32)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    b = jcfg.model.batch_size
    real = np.random.default_rng(0).uniform(-1, 1, (b, 32, 32, 3)).astype(np.float32)
    (_, k_noise, *_rest) = jax.random.split(jst.rng, 11)
    z = np.array(jax.random.normal(k_noise, (b, jgan.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    cfg = C.replace(C.smoke_config(family), **F32)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    tree = lambda p, s: jax.tree.map(np.asarray, {"params": p, "state": s})  # noqa: E731
    load_into(state.g, from_jax_tree(tree(jst.g_params, jst.g_state)))
    load_into(state.d, from_jax_tree(tree(jst.d_params, jst.d_state)))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jparams, jstate in ((state.g, state.g_opt, jnew.g_params, jnew.g_state),
                                      (state.d, state.d_opt, jnew.d_params, jnew.d_state)):
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)
        _assert_state(net, jax.tree.map(np.asarray, jstate), "after the step")
    assert state.step == 1


def test_registry_and_config_sections():
    for family, stats in (("dcgan", True), ("cnn", True), ("mlp", False)):
        cfg = C.smoke_config(family)
        assert build_gan(cfg).d_has_batch_stats is stats
        assert jax_build_gan(JC.smoke_config(family)).d_has_batch_stats is stats
        assert C.from_dict(C.to_dict(cfg)) == cfg
        # a JAX run's config.json loads here with the same baseline section
        port = C.from_dict(JC.to_dict(JC.smoke_config(family)))
        assert port.model == cfg.model, family
    assert build_gan(C.smoke_config("cnn")).latent_dim == 32 * 32 * 3
    gan = build_gan(C.smoke_config("dcgan"))
    d = gan.discriminator_init(torch.Generator().manual_seed(0), device="cpu")
    tree = to_jax_tree(d)
    assert set(tree["state"]) == {"bn1", "bn2", "bn3"} and set(tree["state"]["bn1"]) == {
        "mean", "var"}
    assert tree["params"]["conv1"]["w"].shape == (4, 4, 3, 16)  # HWIO


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_trains_and_samples_each_family(family, tmp_path):
    """cli train (DEV smoke size) and generate from its run directory."""
    import os

    from vitgan_tpu_torch import cli

    os.environ["DEV"] = "1"
    try:
        assert cli.main(["train", "--family", family, "--device", "cpu", "--run-dir",
                         str(tmp_path / "run"), "--set", "run.fid_every_epochs=0"]) == 0
    finally:
        os.environ.pop("DEV")
    assert cli.main(["generate", "--run-dir", str(tmp_path / "run"), "--device", "cpu",
                     "--num-images", "4"]) == 0
    assert (tmp_path / "run" / "test" / "generated_images.png").exists()
