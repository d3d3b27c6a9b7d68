"""The port's v1 family (the paper's ViTGAN) against the JAX package, on the CPU.

- the v1 config sections of ExperimentConfig(family="v1") and
  smoke_config("v1") field for field, and config.json both ways;
- the overlapping patches' feature order against
  jax.lax.conv_general_dilated_patches, sln, siren, the mlp chain,
  spectral_rescale with update True and False, the ISR MHSA;
- G and D forward at smoke width with JAX weights and state carried by
  from_jax_tree, D's refreshed state, the reference-default parameter counts;
- one train step at smoke size against vitgan_tpu.train.step with fixed
  latents and dropout 0, the ISR buffers included;
- `cli train --family v1 --device cpu` at DEV=1, then `generate`.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py).  1e-5 absolute and relative where both sides run the same
products in another order; 1e-4 where a result passes through sin(30 x)
(SIREN multiplies a rounding difference by up to 30) or sums many rows;
updated parameters within 2 * lr + 1e-6 (Adam's first step, as in
tests/test_torch_v2_train.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.models import layers as JL
from vitgan_tpu.models import vitgan_v1 as JV1
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan, count_params
from vitgan_tpu_torch.models import layers as L
from vitgan_tpu_torch.models import vitgan_v1 as V1
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
SIN_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# --- config ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["default", "smoke"])
def test_v1_section_equals_the_jax_presets(preset):
    """Every field of the v1 section, both ways: the port carries all of
    JAX's v1 fields with JAX's values."""
    port, jax_ = {"default": (C.ExperimentConfig(family="v1"), JC.ExperimentConfig(family="v1")),
                  "smoke": (C.smoke_config("v1"), JC.smoke_config("v1"))}[preset]
    assert C.to_dict(port)["v1"] == JC.to_dict(jax_)["v1"]
    assert port.family == "v1" and port.model is port.v1
    if preset == "default":
        m = port.v1
        assert (m.batch_size, m.latent_dim, m.generator.hidden_size, m.discriminator.depth) == \
            (128, 1024, 384, 4)
        assert m.generator.optim.name == "adam" and m.generator.optim.beta1 == 0.5
        assert m.discriminator.optim.grad_clip is None


def test_v1_config_json_is_shared_with_jax(tmp_path):
    """A JAX v1 config.json loads in the port and the port's in JAX."""
    jcfg = JC.replace(JC.smoke_config("v1"), **{"v1.generator.transformer.mlp_hidden": (32,),
                                                "v1.loss": "wgan-gp"})
    JC.save_config(jcfg, str(tmp_path / "jax.json"))
    cfg = C.load_config(str(tmp_path / "jax.json"))
    assert cfg.family == "v1" and C.to_dict(cfg)["v1"] == JC.to_dict(jcfg)["v1"]
    assert cfg.v1.generator.transformer.mlp_hidden == (32,)
    C.save_config(cfg, str(tmp_path / "port.json"))
    assert JC.load_config(str(tmp_path / "port.json")).v1 == jcfg.v1


def test_reference_default_parameter_counts():
    """G 15,936,114 and D 3,951,937 parameters at the v1 defaults, as the
    JAX package's abstract init counts them; D's ISR state is buffers of the
    JAX state's shapes."""
    cfg = C.ExperimentConfig(family="v1")
    jcfg = JC.ExperimentConfig(family="v1")
    jgan = jax_build_gan(jcfg)
    key = jax.random.PRNGKey(0)
    jg = jax.eval_shape(jgan.generator_init, key)
    jd = jax.eval_shape(jgan.discriminator_init, key)
    count = lambda t: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(t))  # noqa: E731
    with torch.device("meta"):
        gan = build_gan(cfg)
        g, d = gan.generator_init(None, device="meta"), gan.discriminator_init(None, "meta")
    assert count_params(g) == count(jg["params"]) == 15_936_114
    assert count_params(d) == count(jd["params"]) == 3_951_937
    state = {k: tuple(v.shape) for k, v in d.named_buffers()}
    want = {k: tuple(v.shape) for k, v in from_jax_tree(
        {"params": {}, "state": jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                                             jd["state"])}).items()}
    assert state == want and state["blocks.0.msha.isr.u"] == (3, 4, 432)
    assert dict(g.named_buffers()) == {}


# --- layers ---------------------------------------------------------------------------


@pytest.mark.parametrize("image,patch,overlap", [(32, 8, 2), (16, 4, 1)])
def test_overlapping_patches_match_jax_feature_order(image, patch, overlap):
    x = np.random.default_rng(0).standard_normal((2, image, image, 3)).astype(np.float32)
    want = JV1.extract_overlapping_patches(jnp.asarray(x), patch, overlap)
    got = V1.extract_overlapping_patches(torch.from_numpy(x), patch, overlap)
    assert V1.patch_geometry(image, patch, overlap) == JV1.patch_geometry(image, patch, overlap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sln_siren_and_mlp_match_jax():
    rng = np.random.default_rng(1)
    key = jax.random.PRNGKey(1)
    h, w = (rng.standard_normal((2, 5, 16)).astype(np.float32) for _ in range(2))
    jp = _np_tree(JL.sln_init(key, 16))
    jp["ln"]["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
    sln = L.SLN(16, None)
    load_into(sln, from_jax_tree(jp))
    np.testing.assert_allclose(L.sln(sln, _t(h), _t(w)).detach().numpy(),
                               np.asarray(JL.sln(jp, jnp.asarray(h), jnp.asarray(w))), **TOL)
    for first in (True, False):
        jp = _np_tree(JL.siren_init(key, 16, 24, is_first=first))
        layer = L.Siren(16, 24, first, 30.0, None)
        load_into(layer, from_jax_tree(jp))
        np.testing.assert_allclose(L.siren(layer, _t(h)).detach().numpy(),
                                   np.asarray(JL.siren(jp, jnp.asarray(h))), **SIN_TOL)
        # the init's bounds: U(+-1/in) first, U(+-sqrt(6/in)/30) after
        drawn = L.Siren(16, 24, first, 30.0, torch.Generator().manual_seed(0))
        bound = 1 / 16 if first else (6 / 16) ** 0.5 / 30
        assert drawn.w.abs().max() <= bound and drawn.w.abs().max() > 0.9 * bound
    for act in ("relu", "gelu", "tanh", "sigmoid", "leaky_relu", "unknown"):
        jp = _np_tree(JL.mlp_init(key, 16, 8, (12,)))
        m = L.MLP(16, 8, (12,), None)
        load_into(m, from_jax_tree(jp))
        np.testing.assert_allclose(L.mlp(m, _t(h), act).detach().numpy(),
                                   np.asarray(JL.mlp(jp, jnp.asarray(h), act)), **TOL,
                                   err_msg=act)


@pytest.mark.parametrize("update", [False, True])
def test_spectral_rescale_matches_jax(update):
    """The rescaled weights, and the state written back only when ``update``."""
    key = jax.random.PRNGKey(2)
    jparams, jstate = JL.mhsa_init(key, 24, 2, spectral=True)
    w = np.asarray(jparams["qkv"])
    isr = _np_tree(jstate["isr"])
    want_w, want_state = JL.spectral_rescale(jnp.asarray(w), jax.tree.map(jnp.asarray, isr),
                                             update)
    mod = L.MHSA(24, 2, None, qkv_bias=False, init="torch", spectral=True)
    load_into(mod, from_jax_tree({"params": _np_tree(jparams), "state": _np_tree(jstate)}))
    u0 = mod.isr.u.clone()
    got = L.spectral_rescale(mod.qkv, mod.isr, update)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(mod.isr.u.numpy(), np.asarray(want_state["u"]), **TOL)
    assert torch.equal(mod.isr.u, u0) != update
    # gradients flow through W alone: d(W * c)/dW = c, the estimate detached
    (gw,) = torch.autograd.grad(got.sum(), mod.qkv)
    np.testing.assert_allclose(gw.numpy(), np.asarray(want_w) / w, rtol=1e-4)


@pytest.mark.parametrize("score_mode", ["dot", "l2"])
def test_isr_mhsa_matches_jax(score_mode):
    key = jax.random.PRNGKey(3)
    jparams, jstate = JL.mhsa_init(key, 24, 2, spectral=True, qkv_bias=False)
    x = np.random.default_rng(3).standard_normal((2, 9, 24)).astype(np.float32)
    want, want_state = JL.mhsa(jparams, jstate, jnp.asarray(x), score_mode=score_mode,
                               update_state=True)
    mod = L.MHSA(24, 2, None, qkv_bias=False, init="torch", spectral=True)
    load_into(mod, from_jax_tree({"params": _np_tree(jparams), "state": _np_tree(jstate)}))
    got = L.mhsa(mod, torch.from_numpy(x), score_mode=score_mode, update_state=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(mod.isr.u.numpy(), np.asarray(want_state["isr"]["u"]), **TOL)


# --- models ---------------------------------------------------------------------------


def _v1_cfgs(**over):
    return (JC.replace(JC.smoke_config("v1"), **over), C.replace(C.smoke_config("v1"), **over))


def test_generator_with_jax_weights_matches_jax():
    jcfg, cfg = _v1_cfgs()
    jv = JV1.generator_init(jax.random.PRNGKey(4), jcfg.v1)
    g = build_gan(cfg).generator_init(None, device="cpu")
    load_into(g, from_jax_tree(_np_tree(jv)))
    z = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32)
    want, _ = JV1.generator_apply(jv, jnp.asarray(z), jcfg.v1)
    with torch.no_grad():
        got = g(torch.from_numpy(z))
    assert got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SIN_TOL)


@pytest.mark.parametrize("update_state", [False, True])
def test_discriminator_with_jax_weights_and_state_matches_jax(update_state):
    """Logits and D's new ISR state against the JAX discriminator_apply,
    the JAX variables carried whole by from_jax_tree."""
    jcfg, cfg = _v1_cfgs()
    jv = _np_tree(JV1.discriminator_init(jax.random.PRNGKey(5), jcfg.v1))
    rng = np.random.default_rng(5)
    for blk in jv["params"]["blocks"]:  # biases that matter
        blk["ln1"]["bias"] = (0.1 * rng.standard_normal(blk["ln1"]["bias"].shape)
                              ).astype(np.float32)
    gan = build_gan(cfg)
    d = gan.discriminator_init(None, device="cpu")
    sd = from_jax_tree(jv)
    assert sorted(sd) == sorted(d.state_dict())
    load_into(d, sd)
    imgs = rng.uniform(-1, 1, (4, 32, 32, 3)).astype(np.float32)
    want, want_state = JV1.discriminator_apply(jax.tree.map(jnp.asarray, jv), jnp.asarray(imgs),
                                               jcfg.v1, update_state=update_state)
    with torch.no_grad():
        got = gan.discriminator_apply(d, torch.from_numpy(imgs), update_state=update_state)
    assert got.shape == (4,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    new = from_jax_tree({"params": {}, "state": _np_tree(want_state)})
    for name, buf in d.named_buffers():
        np.testing.assert_allclose(buf.numpy(), new[name].numpy(), **TOL, err_msg=name)
    moved = any(not np.allclose(new[k].numpy(), sd[k].numpy()) for k in new if k.endswith(".u"))
    assert moved == update_state


# --- train step -----------------------------------------------------------------------


def _jax_adam_mu(opt_state):
    states = [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: isinstance(
        s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
    return from_jax_tree(_np_tree(states[0].mu))


NO_DROPOUT = {"runtime.compute_dtype": "float32",
              "v1.generator.transformer.attn_dropout": 0.0,
              "v1.generator.transformer.mlp_dropout": 0.0,
              "v1.discriminator.transformer.attn_dropout": 0.0,
              "v1.discriminator.transformer.mlp_dropout": 0.0}


def test_train_step_matches_jax():
    """One bce step (the v1 default recipe) from the JAX state: every metric,
    Adam's first moments, the updated parameters and D's ISR buffers."""
    jcfg, cfg = _v1_cfgs(**NO_DROPOUT)
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
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
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
    assert state.step == 1 and len(list(state.d_opt.params)) == len(list(state.d.parameters()))


def test_wgan_gp_step_penalty_reads_the_state_the_update_found():
    """wgan-gp, disc_steps 2 and DiffAugment on the v1 family: one CPU step
    with finite metrics; each D update refreshes u once (the penalty's
    forward does not write it)."""
    cfg = C.replace(C.smoke_config("v1"), **{"v1.loss": "wgan-gp", "v1.disc_steps": 2,
                                             "run.diff_augment": "color,translation"})
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    isr = state.d.blocks[0].msha.isr
    u0 = isr.u.clone()
    m = make_train_step(gan, cfg)(state, torch.rand(8, 32, 32, 3) * 2 - 1)
    assert all(torch.isfinite(v) for v in m.values()) and state.d_opt.count == 2
    # two power iterations on two D weights: not the init u, unit vectors
    assert not torch.equal(isr.u, u0)
    torch.testing.assert_close(torch.linalg.vector_norm(isr.u, dim=-1),
                               torch.ones(isr.u.shape[:-1]))


@pytest.mark.parametrize("family", ["v1", "v2"])
def test_r1_runs_before_the_updating_forward_only_where_d_has_state(family):
    """A D update with R1: where D has state (v1's ISR) the penalty's forward
    comes first and reads the state the update found; a v2 D, which has none,
    keeps its main forward on [real; fake] first, so that forward's dropout
    draws come first.  D's forwards are told apart by their batch."""
    cfg = C.replace(C.smoke_config(family), **{f"{family}.r1_gamma": 1.0,
                                               f"{family}.r1_interval": 1})
    gan = build_gan(cfg)
    assert gan.d_has_state == (family == "v1")
    state = create_train_state(gan, cfg, device="cpu")
    batches = []
    state.d.register_forward_hook(lambda module, args, y: batches.append(y.shape[0]))
    b = cfg.model.batch_size
    m = make_train_step(gan, cfg)(state, torch.rand(b, *gan.image_shape) * 2 - 1)
    assert torch.isfinite(m["d_r1"]) and m["d_r1"] > 0
    assert batches[:2] == ([b, 2 * b] if family == "v1" else [2 * b, b])


# --- trainer, CLI -----------------------------------------------------------------------


def test_cli_train_v1_then_generate(tmp_path, monkeypatch):
    """DEV=1 `cli train --family v1 --device cpu` with every attention forced
    through the flash route (`l2` in D; CPU tensors take the plain versions,
    never the build), then `generate` from the run directory it wrote."""
    from vitgan_tpu_torch.cli import main
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "entry", refuse)
    monkeypatch.setattr(build, "build", refuse)
    monkeypatch.setenv("DEV", "1")
    run = tmp_path / "run"
    assert main(["train", "--family", "v1", "--device", "cpu", "--run-dir", str(run),
                 "--set", "runtime.use_pallas=always"]) == 0
    cfg, gan, g, meta = restore_run(str(run), device="cpu")
    assert cfg.family == "v1" and gan.family == "v1" and meta["step"] == 2
    assert cfg.v1 == C.smoke_config("v1").v1
    assert main(["generate", "--run-dir", str(run), "--num-images", "4", "--device",
                 "cpu"]) == 0
    assert (run / "test" / "generated_images.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.load(run / "test" / "noise.npy").shape == (4, 64)


def test_serve_v1_run_directory_over_http(tmp_path):
    """A v1 run directory (save_run of a seeded smoke generator) restores on
    the meta device and answers a seeded HTTP request, byte-equal on repeat."""
    import io
    import json
    import threading
    import urllib.request

    from vitgan_tpu_torch.serve import serve
    from vitgan_tpu_torch.utils.run_dirs import save_run

    cfg = C.smoke_config("v1")
    g = build_gan(cfg).generator_init(torch.Generator().manual_seed(0), device="cpu")
    save_run(str(tmp_path / "v1run"), cfg, g, meta={"step": 0})
    httpd = serve(str(tmp_path / "v1run"), port=0, batch=4, device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        bodies = []
        for _ in range(2):
            req = urllib.request.Request(url + "/sample", headers={"Content-Type":
                                                                   "application/json"},
                                         data=json.dumps({"n": 3, "seed": 5,
                                                          "format": "npy"}).encode())
            with urllib.request.urlopen(req) as r:
                bodies.append(r.read())
        with urllib.request.urlopen(url + "/healthz") as r:
            info = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
    arr = np.load(io.BytesIO(bodies[0]))
    assert bodies[0] == bodies[1] and info["family"] == "v1"
    assert arr.shape == (3, 32, 32, 3) and np.isfinite(arr).all() and arr.std() > 1e-3
