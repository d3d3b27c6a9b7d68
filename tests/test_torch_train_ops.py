"""The port's training-slice ops against the JAX package, on the CPU.

- the plain versions of the three flash backward kernels against the JAX
  `_flash_backward` run with interpret=True under bwd_fusion 'fused' and
  'two_pass', and autograd through the port's flash_attention;
- the backward route against the JAX package's own decision, read from the
  jaxpr of its VJP (traced only);
- fused_ln_mlp's gradients, each augmentation fed JAX's draws, every loss,
  minibatch_std_feature, adam/adamw/sgd with clipping and schedules against
  optax, the discriminator with JAX weights, the synthetic dataset's bytes;
- the megablock's training gate against the JAX package's clamps and its own
  decision, read from the jaxpr of its gate and its VJP (traced only): which
  of the four variants, under both runtime.megablock_bwd modes.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py).  1e-5 absolute and relative where both sides run the same
products in another order; 1e-4 relative where a gradient sums over many rows
(fused_ln_mlp's weights, the discriminator); optimizer steps 1e-6.
"""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from vitgan_tpu.models import vitgan_v2 as JV
from vitgan_tpu.ops import augment as JAUG
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.ops.attention import _flash_backward, _flash_forward
from vitgan_tpu.ops.attention import flash_attention as jax_flash_attention
from vitgan_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from vitgan_tpu.ops.policy import set_policy as jax_set_policy
from vitgan_tpu.train import losses as JLO
from vitgan_tpu.train.state import make_optimizer as jax_make_optimizer
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.data.datasets import load_dataset, synthetic_dataset
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock, minibatch_std_feature
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import augment as AUG
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.ops import wgrad as WG
from vitgan_tpu_torch.train import losses as LO
from vitgan_tpu_torch.train.state import Optimizer, make_lr
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)
    jax_set_policy(bwd_fusion="auto")


def _qkv(b, h, n, d, seed=0, k=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, n, d)).astype(np.float32) for _ in range(k)]


# --- flash backward -----------------------------------------------------------


@pytest.mark.parametrize("n,block", [(40, 32), (64, 32), (65, 64), (128, 32)])
@pytest.mark.parametrize("fusion", ["fused", "two_pass"])
def test_plain_backward_matches_jax_kernels(fusion, n, block):
    """Each plain backward against the JAX kernels of the same route, on the
    JAX forward's o and LSE (the shapes of tests/test_pallas_attention.py and N 65)."""
    q, k, v, g = _qkv(1, 2, n, 16)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = _flash_forward(jq, jk, jv, "dot", 16.0, block, block, True, with_lse=True)
    jax_set_policy(bwd_fusion=fusion)
    want = _flash_backward(jq, jk, jv, o, lse, jg, "dot", 16.0, block, block, True)
    args = (*map(torch.from_numpy, (q, k, v, np.array(o), np.array(lse), g)), 16.0)
    if fusion == "fused":
        got = A.flash_bwd_fused_reference(*args)
    else:
        got = (A.flash_bwd_dq_reference(*args), *A.flash_bwd_dkv_reference(*args))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("n", [65, 257])
def test_flash_attention_autograd_matches_jax(n):
    """Autograd through the port's flash_attention (the Function: plain
    forward with LSE, plain backward on the JAX route) against jax.grad of
    the JAX flash_attention in interpret mode."""
    q, k, v, g = _qkv(2, 2, n, 24, seed=1)

    def jloss(q, k, v):
        return jnp.sum(jax_flash_attention(q, k, v, "dot", 24.0, interpret=True) * jnp.asarray(g))

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = A.flash_attention(tq, tk, tv, "dot", 24.0)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def _jax_pallas_calls(jaxpr) -> int:
    count = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            count += 1
            continue
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else [val]:
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    count += _jax_pallas_calls(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    count += _jax_pallas_calls(sub)
    return count


def _jax_route(n: int, dtype) -> str:
    """The JAX package's backward route: its VJP holds the forward pallas_call
    plus one (fused) or two (dq, then dk/dv) backward ones.  Traced only."""
    s = jax.ShapeDtypeStruct((1, 2, n, 64), dtype)

    def vjp(q, k, v, g):
        f = lambda q, k, v: jax_flash_attention(q, k, v, "dot", 64.0, interpret=True)  # noqa: E731
        return jax.vjp(f, q, k, v)[1](g)

    calls = _jax_pallas_calls(jax.make_jaxpr(vjp)(s, s, s, s).jaxpr)
    return {2: "fused", 3: "two_pass"}[calls]


@pytest.mark.parametrize("fusion", ["auto", "fused", "two_pass"])
def test_backward_route_is_the_jax_decision(fusion):
    jax_set_policy(bwd_fusion=fusion)
    policy.set_policy(bwd_fusion=fusion)
    for n in (64, 65, 256, 257, 1024, 1025, 4097):
        for jdt, size in ((jnp.float32, 4), (jnp.bfloat16, 2)):
            with pytest.warns(UserWarning) if fusion == "fused" and n == 1025 else nullcontext():
                got = A.backward_route(n, 64, size)
            assert got == _jax_route(n, jdt), (fusion, n, size)
    policy.set_policy(bwd_fusion="auto")
    assert A.backward_route(1024, 64, 2) == "fused"  # highres128 G
    assert A.backward_route(1025, 64, 2) == "two_pass"  # highres128 D (CLS + 1,024)


def test_attention_chunked_matches_reference_and_dispatch_uses_it(monkeypatch):
    """Above 1,024 tokens the plain route is chunked, with the same values and
    gradients as the plain attention."""
    q, k, v, g = (torch.from_numpy(x).double() for x in _qkv(1, 2, 1100, 8, seed=2))
    q.requires_grad_()
    want = A.attention_reference(q, k, v, "dot", 8.0)
    got = A.attention_chunked(q, k, v, "dot", 8.0)
    torch.testing.assert_close(got, want)
    torch.testing.assert_close(torch.autograd.grad(got, q, g)[0],
                               torch.autograd.grad(want, q, g)[0])
    calls = []
    monkeypatch.setattr(A, "attention_chunked", lambda *a: calls.append(a) or a[0])
    policy.set_policy(mode="never")
    A.dispatch_attention(q, k, v, "dot", 8.0)
    A.dispatch_attention(q[:, :, :1024], k[:, :, :1024], v[:, :, :1024], "dot", 8.0)
    assert len(calls) == 1


# --- LN -> MLP ------------------------------------------------------------------


def test_fused_ln_mlp_gradients_match_jax():
    rng = np.random.default_rng(3)
    e, hidden = 32, 128
    x = rng.standard_normal((2, 40, e)).astype(np.float32)
    args = [(1 + 0.1 * rng.standard_normal(e)).astype(np.float32),
            (0.1 * rng.standard_normal(e)).astype(np.float32),
            (0.1 * rng.standard_normal((e, hidden))).astype(np.float32),
            (0.1 * rng.standard_normal(hidden)).astype(np.float32),
            (0.1 * rng.standard_normal((hidden, e))).astype(np.float32),
            (0.1 * rng.standard_normal(e)).astype(np.float32)]
    g = rng.standard_normal((2, 40, e)).astype(np.float32)
    for residual in (False, True):
        def jloss(*a):
            return jnp.sum(jax_fused_ln_mlp(*a, "gelu", 1e-5, residual, 256, True) * g)

        want = jax.grad(jloss, argnums=tuple(range(7)))(jnp.asarray(x), *map(jnp.asarray, args))
        ts = [torch.from_numpy(a).requires_grad_() for a in (x, *args)]
        out = FM.fused_ln_mlp(*ts, "gelu", 1e-5, residual)
        got = torch.autograd.grad(out, ts, torch.from_numpy(g))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


# --- augment ----------------------------------------------------------------------


def _jax_draws(name, key, x):
    """The draws the JAX augmentation ``name`` makes from ``key``, in the port's form."""
    b, h, w, _ = x.shape
    if name == "flip":
        return torch.from_numpy(np.asarray(jax.random.bernoulli(key, 0.5, (b, 1, 1, 1))))
    lohi = {"brightness": (-0.5, 0.5), "saturation": (0.0, 2.0), "contrast": (0.5, 1.5)}
    if name in lohi:
        return torch.from_numpy(np.asarray(jax.random.uniform(key, (b, 1, 1, 1), x.dtype,
                                                              *lohi[name])))
    ky, kx = jax.random.split(key)
    if name == "translation":
        my, mx = max(1, int(h * 0.125)), max(1, int(w * 0.125))
        return (torch.from_numpy(np.asarray(jax.random.randint(ky, (b,), -my, my + 1))),
                torch.from_numpy(np.asarray(jax.random.randint(kx, (b,), -mx, mx + 1))))
    ch, cw = max(1, int(h * 0.5)), max(1, int(w * 0.5))
    return (torch.from_numpy(np.asarray(jax.random.randint(ky, (b, 1, 1), 0, h - ch + 1)))[:, 0, 0],
            torch.from_numpy(np.asarray(jax.random.randint(kx, (b, 1, 1), 0, w - cw + 1)))[:, 0, 0])


@pytest.mark.parametrize("name", ["flip", "brightness", "saturation", "contrast", "translation",
                                  "cutout"])
def test_augmentation_matches_jax_on_its_draws(name):
    x = np.random.default_rng(4).uniform(-1, 1, (6, 16, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = JAUG._AUGMENTS[name](key, jnp.asarray(x))
    got = AUG._AUGMENTS[name][1](torch.from_numpy(x), _jax_draws(name, key, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_augment_spec_matches_jax_and_translation_is_differentiable():
    x = np.random.default_rng(5).uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    spec = "color,translation,cutout"
    assert AUG.parse_augment_spec(spec) == tuple(JAUG.parse_augment_spec(spec))
    with pytest.raises(ValueError):
        AUG.parse_augment_spec("color,zoom")
    key = jax.random.PRNGKey(9)
    names = JAUG.parse_augment_spec(spec)
    draws = [(n, _jax_draws(n, k, jnp.asarray(x)))
             for n, k in zip(names, jax.random.split(key, len(names)))]
    want = JAUG.apply_augment(key, jnp.asarray(x), spec)
    np.testing.assert_allclose(AUG.apply_draws(torch.from_numpy(x), draws).numpy(),
                               np.asarray(want), **TOL)
    # the G update back-propagates through translation: same gradient as JAX
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jg = jax.grad(lambda a: jnp.sum(JAUG.random_translation(key, a) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    out = AUG.apply_translation(tx, _jax_draws("translation", key, jnp.asarray(x)))
    (tg,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    gen = torch.Generator().manual_seed(0)
    out = AUG.apply_augment(gen, torch.from_numpy(x), spec)
    assert out.shape == x.shape and torch.isfinite(out).all()


# --- losses, minibatch std ----------------------------------------------------------


def test_losses_match_jax():
    rng = np.random.default_rng(8)
    real_l, fake_l = (rng.standard_normal(16).astype(np.float32) * 3 for _ in range(2))
    t = torch.from_numpy
    ones, zeros = np.ones(16, np.float32), np.zeros(16, np.float32)
    pairs = [
        (LO.bce_with_logits(t(real_l), t(ones)), JLO.bce_with_logits(real_l, ones)),
        (LO.bce_with_logits(t(fake_l), t(zeros)), JLO.bce_with_logits(fake_l, zeros)),
        (LO.mse_on_probs(t(real_l), t(ones)), JLO.mse_on_probs(real_l, ones)),
        (LO.d_adversarial_loss(LO.bce_with_logits, t(real_l), t(fake_l)),
         JLO.d_adversarial_loss(JLO.bce_with_logits, real_l, fake_l)),
        (LO.g_adversarial_loss(LO.mse_on_probs, t(fake_l)),
         JLO.g_adversarial_loss(JLO.mse_on_probs, fake_l)),
        (LO.wasserstein_d_loss(t(real_l), t(fake_l)), JLO.wasserstein_d_loss(real_l, fake_l)),
        (LO.wasserstein_g_loss(t(fake_l)), JLO.wasserstein_g_loss(fake_l)),
        (LO.accuracy_from_logits(t(real_l), True), JLO.accuracy_from_logits(real_l, True)),
        (LO.accuracy_from_logits(t(fake_l), False), JLO.accuracy_from_logits(fake_l, False)),
    ]
    imgs = rng.uniform(-1, 1, (5, 4, 4, 3)).astype(np.float32)
    pairs.append((LO.diversity_loss(t(imgs)), JLO.diversity_loss(imgs)))
    # WGAN-GP and R1 through the same small critic on both sides
    w = rng.standard_normal((48,)).astype(np.float32)
    real, fake = (rng.uniform(-1, 1, (5, 4, 4, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(3)
    eps = np.asarray(jax.random.uniform(key, (5, 1, 1, 1), jnp.float32))

    def jdisc(x):
        return jnp.tanh(x.reshape(x.shape[0], -1) @ w) * jnp.sum(x.reshape(x.shape[0], -1) ** 2, -1)

    def tdisc(x):
        flat = x.reshape(x.shape[0], -1)
        return torch.tanh(flat @ t(w)) * (flat ** 2).sum(-1)

    pairs.append((LO.gradient_penalty(tdisc, t(real), t(fake), t(eps)),
                  JLO.gradient_penalty(jdisc, real, fake, key)))
    pairs.append((LO.r1_penalty(tdisc, t(real)), JLO.r1_penalty(jdisc, real)))
    for i, (a, b) in enumerate(pairs):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL, err_msg=str(i))
    with pytest.raises(ValueError):
        LO.pick_criterion("hinge")


@pytest.mark.parametrize("b", [16, 12, 6, 5])
def test_minibatch_std_feature_matches_jax(b):
    feats = np.random.default_rng(b).standard_normal((b, 10)).astype(np.float32)
    np.testing.assert_allclose(minibatch_std_feature(torch.from_numpy(feats)).numpy(),
                               np.asarray(JV.minibatch_std_feature(jnp.asarray(feats))), **TOL)


# --- optimizer ----------------------------------------------------------------------------


OPTIMS = [
    dict(name="adam", learning_rate=1e-2, beta1=0.5, grad_clip=None),
    dict(name="adamw", learning_rate=5e-3, beta1=0.9, weight_decay=1e-2, grad_clip=0.5),
    dict(name="sgd", learning_rate=0.1, grad_clip=1.0),
    dict(name="adamw", learning_rate=5e-3, weight_decay=1e-3, grad_clip=5.0, warmup_steps=2),
    dict(name="adam", learning_rate=1e-2, schedule="cosine", decay_steps=4, min_lr_ratio=0.1,
         grad_clip=0.5),
    dict(name="adamw", learning_rate=1e-2, schedule="warmup_cosine", warmup_steps=1,
         decay_steps=4, min_lr_ratio=0.2, weight_decay=1e-2),
]


@pytest.mark.parametrize("kw", OPTIMS, ids=[f"{o['name']}_{o.get('schedule', 'constant')}_"
                                            f"w{o.get('warmup_steps', 0)}" for o in OPTIMS])
def test_optimizer_matches_optax_over_three_steps(kw):
    """Same parameters, same gradients each step (large enough that the clip
    triggers on some steps and not on others); parameters after every step
    within 1e-6, and Adam's first moments likewise."""
    rng = np.random.default_rng(10)
    params = [rng.standard_normal(s).astype(np.float32) for s in ((4, 3), (5,))]
    grads = [[(s * rng.standard_normal(p.shape)).astype(np.float32) for p in params]
             for s in (0.05, 1.0, 0.2)]
    jcfg, cfg = JC.OptimConfig(**kw), C.OptimConfig(**kw)
    tx = jax_make_optimizer(jcfg)
    jp = [jnp.asarray(p) for p in params]
    jstate = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = Optimizer(cfg, tp)
    for step, gs in enumerate(grads):
        upd, jstate = tx.update([jnp.asarray(g) for g in gs], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        norm = opt.step()
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(gs)), rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-6,
                                       err_msg=f"step {step}")
    if cfg.name != "sgd":
        mus = [s for s in jax.tree.leaves(jstate, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)]
        for a, b in zip((opt.opt.state[p]["exp_avg"] for p in tp), mus[0].mu):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_schedules_and_unported_options():
    from vitgan_tpu.train.state import make_lr as jax_make_lr

    for kw in OPTIMS[3:]:
        jlr, lr = jax_make_lr(JC.OptimConfig(**kw)), make_lr(C.OptimConfig(**kw))
        for count in range(7):
            want = jlr(count) if callable(jlr) else jlr
            assert abs(lr(count) - float(want)) <= 1e-9, (kw, count)
    p = [torch.nn.Parameter(torch.zeros(2))]
    # grad_accum and inject_lr are ported (tests/test_torch_grad_accum.py); the
    # combinations the JAX make_optimizer refuses raise its ValueErrors
    assert Optimizer(C.OptimConfig(grad_accum=2), p).k == 2
    assert Optimizer(C.OptimConfig(inject_lr=True), p).learning_rate == 2e-4
    for bad, msg in ((dict(inject_lr=True, grad_accum=2), "incompatible with grad_accum"),
                     (dict(inject_lr=True, schedule="cosine", decay_steps=4), "constant lr only"),
                     (dict(inject_lr=True, warmup_steps=2), "constant lr only")):
        with pytest.raises(ValueError, match=msg):
            jax_make_optimizer(JC.OptimConfig(**bad))
        with pytest.raises(ValueError, match=msg):
            Optimizer(C.OptimConfig(**bad), p)
    with pytest.raises(ValueError):
        make_lr(C.OptimConfig(schedule="cosine"))


# --- discriminator, weights ----------------------------------------------------------------


@pytest.mark.parametrize("mbstd", [False, True])
def test_discriminator_with_jax_weights_matches_jax(mbstd):
    jcfg = JC.replace(JC.smoke_config(), **{"v2.minibatch_std": mbstd}).v2
    tree = jax.tree.map(np.asarray, JV.discriminator_init(jax.random.PRNGKey(1), jcfg)["params"])
    rng = np.random.default_rng(12)
    for blk in tree["blocks"]:
        for sub in (blk["fc1"], blk["fc2"], blk["msha"]["out"]):
            sub["b"] = (0.05 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
        bias = blk["ln1"]["bias"]
        blk["ln1"]["bias"] = (0.1 * rng.standard_normal(bias.shape)).astype(np.float32)
    tree["head_fc2"]["b"] = np.array([0.3], np.float32)
    cfg = C.replace(C.smoke_config(), **{"v2.minibatch_std": mbstd})
    gan = build_gan(cfg)
    assert gan.d_has_batch_stats is False
    d = gan.discriminator_init(torch.Generator().manual_seed(0), device="cpu")
    sd = from_jax_tree(tree)
    assert sorted(sd) == sorted(d.state_dict())
    load_into(d, sd)
    imgs = rng.uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    want, _ = JV.discriminator_apply({"params": jax.tree.map(jnp.asarray, tree)},
                                     jnp.asarray(imgs), jcfg)
    with torch.no_grad():
        got = gan.discriminator_apply(d, torch.from_numpy(imgs))
    assert got.shape == (8,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_synthetic_dataset_is_byte_identical(tmp_path):
    for n, size, seed in ((16, 32, 0), (3, 128, 5)):
        imgs, labels = synthetic_dataset(n, size, 3, seed=seed)
        jimgs, jlabels = jax_synthetic_dataset(n, size, 3, seed=seed)
        assert imgs.tobytes() == jimgs.tobytes() and labels.tobytes() == jlabels.tobytes()
    imgs, labels = load_dataset("synthetic", image_size=32, synthetic_samples=16)
    assert imgs.tobytes() == synthetic_dataset(16, 32, 3)[0].tobytes()
    # CIFAR-10 is decoded now (tests/test_torch_data.py); with no files under
    # its root the loader names the files it looked for
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        load_dataset("cifar10", root=str(tmp_path))


# --- megablock training gate -------------------------------------------------------------


# (tokens, E, heads, hidden): highres128's G and D, deit64, short and long
# sequences, then widths past 384, which the wide variants take: DeiT-B's
# D (257, 768, 12, 3072) and the reference sweep's embed-512 trials.
GATE_SHAPES = [(1024, 384, 6, 1536), (1025, 384, 6, 1536), (257, 192, 3, 768),
               (65, 128, 4, 256), (4097, 128, 2, 512), (257, 768, 12, 3072),
               (1025, 512, 8, 1024), (1025, 512, 8, 2048), (65, 512, 8, 1024)]


@pytest.mark.parametrize("n,e,heads,hidden", GATE_SHAPES)
def test_megablock_training_gate_is_the_jax_arithmetic(n, e, heads, hidden):
    """The port's copies of the VMEM clamps give the JAX package's answers
    (the clamps decide where 'auto' sends a training block)."""
    c = lambda x, m: (x + m - 1) // m * m  # noqa: E731
    pads = (c(n, 8), c(e, 128), c(hidden, 128), c(3 * e, 128))
    for drop in (False, True):
        assert FB.saved_fwd_group(1, *pads, drop) == JFB.saved_fwd_group(1, *pads, drop)
        assert FB.saved_bwd_group(8, *pads, drop) == JFB.saved_bwd_group(8, *pads, drop)


def _jax_pallas_outputs(jaxpr) -> list:
    """The output count of every pallas_call in ``jaxpr``, in order, nested
    jaxprs included."""
    outs = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            outs.append(len(eqn.outvars))
            continue
        for val in eqn.params.values():
            for sub in val if isinstance(val, (list, tuple)) else [val]:
                if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                    outs += _jax_pallas_outputs(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    outs += _jax_pallas_outputs(sub)
    return outs


# The JAX megablock forward's pallas_call outputs by variant: out; + m1, m2;
# + x1, z1, ao, lse; both.
JAX_VARIANTS = {1: "encoder_block_fused", 3: "encoder_block_fused_dropout",
                5: "encoder_block_fused_saved", 7: "encoder_block_fused_dropout_saved"}


def _jax_megablock_variant(n, e, heads, hidden, dropout, mode, bwd, monkeypatch):
    """The JAX package's own decision for a training block on a TPU, read
    from the jaxpr of its `_encoder_apply` gate (traced only): the variant
    named by the output count of the megablock forward's pallas_call, and
    for a saved variant the 13-output backward pallas_call in the gate's VJP.
    None: the standard path."""
    from vitgan_tpu.ops import policy as JP

    monkeypatch.setattr(JP, "on_tpu", lambda: True)
    saved = JP.get_policy()
    JP.set_policy(mode="auto", megablock=mode, megablock_bwd=bwd)
    cfg = JC.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e, dropout=dropout)
    dh = e // heads
    z = jnp.zeros
    p = {"ln1": {"scale": z(e), "bias": z(e)}, "ln2": {"scale": z(e), "bias": z(e)},
         "msha": {"qkv": z((3, heads, e, dh)), "qkv_b": z((3, heads, dh)),
                  "out": {"w": z((heads * dh, e)), "b": z(e)}},
         "fc1": {"w": z((e, hidden)), "b": z(hidden)}, "fc2": {"w": z((hidden, e)), "b": z(e)}}

    def gate(x, p):
        out = JFB.maybe_megablock(p, x, cfg, jax.random.PRNGKey(0), True)
        return x if out is None else out

    xs = jax.ShapeDtypeStruct((2, n, e), jnp.bfloat16)
    try:
        try:
            outs = _jax_pallas_outputs(jax.make_jaxpr(gate)(xs, p).jaxpr)
        except ValueError as err:
            # 'on' with the recompute backward checks no clamp in the gate:
            # the block goes to the recompute variant, whose forward then
            # refuses the shape for the TPU's VMEM
            assert "cannot fit scoped VMEM" in str(err)
            return "encoder_block_fused_dropout" if dropout else "encoder_block_fused"
        if not outs:
            return None
        variant = JAX_VARIANTS[outs[0]]
        if variant.endswith("_saved"):
            vjp = jax.make_jaxpr(lambda x, p, ct: jax.vjp(gate, x, p)[1](ct))(xs, p, xs)
            assert 13 in _jax_pallas_outputs(vjp.jaxpr)  # fused_encoder_block_bwd
        return variant
    finally:
        JP.set_policy(mode=saved["mode"], megablock=saved["megablock"],
                      megablock_bwd=saved["megablock_bwd"])


@pytest.mark.parametrize("mode,bwd", [("auto", "saved"), ("on", "saved"),
                                      ("auto", "recompute"), ("on", "recompute")],
                         ids=["auto", "on", "auto-recompute", "on-recompute"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("n,e,heads,hidden", GATE_SHAPES)
def test_megablock_training_gate_is_the_jax_decision(n, e, heads, hidden, dropout, mode, bwd,
                                                     monkeypatch):
    """On the card ('on TPU' read as 'tensor on CUDA'; meta tensors stand in)
    a training block takes the variant the JAX package's gate takes, saved
    or recompute backward, dropout or not (highres128's 1,024 and 1,025
    tokens and deit64's 257 take encoder_block_fused_dropout_saved under the
    default 'auto' with dropout), and the standard path where JAX takes it;
    on the CPU 'auto' always takes the standard path."""
    want = _jax_megablock_variant(n, e, heads, hidden, dropout, mode, bwd, monkeypatch)
    cfg = C.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e, dropout=dropout)
    block = EncoderBlock(cfg, None)
    x = torch.empty(2, n, e, device="meta", dtype=torch.bfloat16)  # the JAX side's dtype
    policy.set_policy(mode="auto", megablock="auto", megablock_bwd=bwd)
    assert FB.maybe_megablock(block, x, cfg, train=True) is None  # not on CUDA
    monkeypatch.setattr(FB, "on_cuda", lambda t: True)
    policy.set_policy(megablock=mode)
    assert FB.megablock_route(block, x, cfg, True, True) == want
    if mode == "auto":
        c = lambda x, m: (x + m - 1) // m * m  # noqa: E731
        pads = (c(n, 8), c(e, 128), c(hidden, 128), c(3 * e, 128))
        fits = (128 <= n <= 1056 and JFB.saved_fwd_group(1, *pads, dropout > 0) >= 1
                and JFB.saved_bwd_group(1, *pads, dropout > 0) >= 1)
        assert want == (("encoder_block_fused_dropout_saved" if dropout else
                         "encoder_block_fused_saved") if fits and bwd == "saved" else None)
    policy.set_policy(megablock="off")
    assert FB.megablock_route(block, x, cfg, True, True) is None


def _jax_routes(n, e, heads, hidden, batch, monkeypatch) -> tuple:
    """The JAX package's own decisions on a TPU, read from jaxprs (traced
    only): whether its dispatch_ln_mlp on (batch, n, E) rows takes the
    kernel, and the megablock variant its inference gate takes (None: the
    standard path)."""
    from vitgan_tpu.ops import policy as JP
    from vitgan_tpu.ops.fused_mlp import dispatch_ln_mlp as jax_dispatch_ln_mlp

    monkeypatch.setattr(JP, "on_tpu", lambda: True)
    saved = JP.get_policy()
    JP.set_policy(mode="auto", megablock="auto", megablock_bwd="saved")
    try:
        z = jnp.zeros
        xs = jax.ShapeDtypeStruct((batch, n, e), jnp.bfloat16)
        mlp = jax.make_jaxpr(lambda x: jax_dispatch_ln_mlp(
            x, z(e), z(e), z((e, hidden)), z(hidden), z((hidden, e)), z(e)))(xs)
        cfg = JC.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e)
        dh = e // heads
        p = {"ln1": {"scale": z(e), "bias": z(e)}, "ln2": {"scale": z(e), "bias": z(e)},
             "msha": {"qkv": z((3, heads, e, dh)), "qkv_b": z((3, heads, dh)),
                      "out": {"w": z((heads * dh, e)), "b": z(e)}},
             "fc1": {"w": z((e, hidden)), "b": z(hidden)},
             "fc2": {"w": z((hidden, e)), "b": z(e)}}

        def gate(x):
            out = JFB.maybe_megablock(p, x, cfg, None, False)
            return x if out is None else out

        block = _jax_pallas_outputs(jax.make_jaxpr(gate)(xs).jaxpr)
    finally:
        JP.set_policy(mode=saved["mode"], megablock=saved["megablock"],
                      megablock_bwd=saved["megablock_bwd"])
    return bool(_jax_pallas_outputs(mlp.jaxpr)), (JAX_VARIANTS[block[0]] if block else None)


@pytest.mark.parametrize("n,e,heads,hidden", GATE_SHAPES)
def test_auto_gates_decide_as_the_jax_gates(n, e, heads, hidden, monkeypatch):
    """'auto' on the card ('on TPU' read as 'tensor on CUDA'; meta tensors
    stand in) decides as the JAX package at every gate shape, E > 384
    included: dispatch_ln_mlp takes the kernel (its wrapper then refuses the
    meta tensor) where the JAX dispatch_ln_mlp takes the Pallas kernel
    (2,048 rows, hidden >= 512), and the megablock's inference gate names
    the JAX gate's variant.  No width cap of the port's own remains."""
    batch = 8
    want_mlp, want_block = _jax_routes(n, e, heads, hidden, batch, monkeypatch)
    policy.set_policy(mode="auto", megablock="auto", megablock_bwd="saved")
    monkeypatch.setattr(FM, "on_cuda", lambda t: True)
    monkeypatch.setattr(FB, "on_cuda", lambda t: True)
    x = torch.empty(batch, n, e, device="meta")
    w1, w2 = torch.empty(e, hidden, device="meta"), torch.empty(hidden, e, device="meta")
    b1, b = torch.empty(hidden, device="meta"), torch.empty(e, device="meta")
    try:
        took = not FM.dispatch_ln_mlp(x, b, b, w1, b1, w2, b).is_meta
    except ValueError as err:
        assert "CUDA" in str(err)
        took = True
    assert took == want_mlp
    cfg = C.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e)
    assert FB.megablock_route(EncoderBlock(cfg, None), x, cfg, False, False) == want_block
    if e > 384 and 128 <= n <= 1056:  # the JAX gate takes these widths, and so does the port
        assert want_block == "encoder_block_fused"


# --- no plain version on the card -------------------------------------------------------


def test_training_wrappers_raise_rather_than_fall_back(monkeypatch):
    """On a tensor that is not on the CPU (meta tensors stand in for CUDA
    ones), the forward Functions, every backward wrapper, the megablock's
    four training Functions, its backward pieces and the weight-gradient
    kernel raise naming CUDA; the plain versions, patched to fail, are never
    reached."""
    def plain(*a, **k):
        raise AssertionError("a plain version was reached off the CPU")

    for name in ("attention_forward_reference", "flash_bwd_fused_reference",
                 "flash_bwd_dq_reference", "flash_bwd_dkv_reference"):
        monkeypatch.setattr(A, name, plain)
    monkeypatch.setattr(FM, "_reference", plain)
    for n in (1024, 1025):  # the fused route, then the two-pass route
        q = torch.empty(1, 2, n, 64, device="meta", dtype=torch.bfloat16)
        lse = torch.empty(1, 2, n, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            A.flash_attention(q, q, q)
        with pytest.raises(ValueError, match="CUDA"):
            A.flash_backward(q, q, q, q, lse, q, 64.0)
    x = torch.empty(2, 16, 32, device="meta", dtype=torch.bfloat16)
    w1, w2 = torch.empty(32, 64, device="meta"), torch.empty(64, 32, device="meta")
    b = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FM.fused_ln_mlp(x, b, b, w1, torch.empty(64, device="meta"), w2, b)
    # the megablock's training forms, its backward pieces and the weight gradients
    for name in ("_block_reference", "_block_reference_masked", "_proj_ln_mlp_train_reference",
                 "_bwd_mlp_reference", "_bwd_ln1_reference", "_ln_qkv_reference"):
        monkeypatch.setattr(FB, name, plain)
    monkeypatch.setattr(WG, "wgrad_reference", plain)
    cfg = C.V2Config(embed_dim=32, num_heads=2, mlp_ratio=2)
    block = EncoderBlock(cfg, None)
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    for fn in (FB.encoder_block_fused, FB.encoder_block_fused_saved):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, block, 2)
    for fn in (FB.encoder_block_fused_dropout, FB.encoder_block_fused_dropout_saved):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, block, seed, 0.1, 2)
    rows = x.reshape(32, 32)
    with pytest.raises(ValueError, match="CUDA"):
        FB.ln_mlp_train_forward(rows, rows, w2[:32], b, b, b, w1, torch.empty(64, device="meta"),
                                w2, b, seed, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        FB.megablock_bwd_mlp(rows, None, None, rows, rows, rows, w1, w2, w2[:32], b, b, 2, 16,
                             2)
    with pytest.raises(ValueError, match="CUDA"):
        FB.megablock_bwd_ln1(rows, torch.empty(3, 2, 32, 16, device="meta"), rows,
                             rows.float(), b, b)
    with pytest.raises(ValueError, match="CUDA"):
        WG.wgrad_gemm(rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        WG.wgrad(rows, rows)


def test_cpu_train_step_never_touches_the_build(monkeypatch):
    """A whole train step on CPU tensors with every kernel route forced
    ('always') runs on the plain versions without the build."""
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "entry", refuse)
    monkeypatch.setattr(build, "build", refuse)
    cfg = C.replace(C.smoke_config(), **{"runtime.use_pallas": "always",
                                         "run.diff_augment": "color,translation"})
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    before = dict(build.LAUNCHES)
    real = torch.rand(8, 32, 32, 3) * 2 - 1
    m = make_train_step(gan, cfg)(state, real)
    assert all(torch.isfinite(v) for v in m.values())
    assert build.LAUNCHES == before and state.step == 1
