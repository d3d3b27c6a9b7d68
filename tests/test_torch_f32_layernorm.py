"""The LayerNorm family's forward in f32 (#1 LN->fc1 and linear stages, #4
LN->qkv and the megablock forward), on the CPU.

- the f32 stage plain versions (the f32 kernels' arithmetic: no rounding of
  x1 or h), composed into the LN->MLP with each activation and into the
  megablock's serving and training forms, against the JAX `fused_ln_mlp` and
  `fused_encoder_block` (interpret mode, f32 inputs) at E 32, 128 and 520;
  the port's `fused_encoder_block` (inference form, and with its residuals)
  against the JAX one;
- the K-major weights the f32 tile reads (fused_mlp.kmajor,
  fused_block._qkv_weight_kmajor): the weights' transposes, the JAX wqkv's
  too, and the LN->MLP and the megablock's inference form computed through
  them against the JAX `fused_ln_mlp` and `fused_encoder_block`;
- the dtype gate (fused_mlp.kernel_dtype): bf16 and f32, one dtype;
- the wrappers on meta tensors with the C entries replaced by a recorder:
  f32 calls launch the `_f32` entries with f32 weights and f32 outputs at
  every E (no wide variant) and each weight K-major, bf16 calls the bf16
  entries as before, the f32
  megablock forward asks the flash forward for the (B, N, H*Dh) layout;
- the training gate: every route, the saved ones included, is the JAX
  package's decision for f32 inputs as for bf16 (read from its jaxpr);
- the slice: one v2 step in f32 under megablock=on, megablock_bwd=recompute
  against the JAX step; the f32 generator on the megablock route against
  the JAX generator.

Tolerances: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py): the forms within TOL (tests/test_torch_megablock_train.py),
the step within tests/test_torch_v2_train.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.models import vitgan_v2 as JV
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_train_step as jax_make_train_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_train_step
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
f32 = torch.float32

# (batch, tokens, embed, heads), mlp_ratio 2: E 32 and 128 (the bf16 route's
# resident kernels) and 520 (its wide variants; a multiple of 8, not of 64).
SHAPES = [dict(b=2, n=17, e=32, heads=2), dict(b=3, n=65, e=128, heads=4),
          dict(b=2, n=16, e=520, heads=5)]
IDS = ["n17_e32", "n65_e128", "n16_e520"]


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _block(shape, seed=0):
    """A JAX encoder block tree with its LN parameters and biases perturbed,
    and the port's EncoderBlock holding the same values."""
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


def _x(shape, seed=1):
    s = (shape["b"], shape["n"], shape["e"])
    return np.random.default_rng(seed).standard_normal(s).astype(np.float32)


def _mlp_args(block):
    return [t.detach() for t in (block.ln2.scale, block.ln2.bias, block.fc1.w, block.fc1.b,
                                 block.fc2.w, block.fc2.b)]


# --- the forms against the JAX package ----------------------------------------------------


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("activation", list(FM.ACTIVATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_ln_mlp_stages_match_jax(shape, activation, residual):
    """fc1 then fc2 in f32 (ln_mlp_forward's two launches, h kept in f32)
    equal the JAX fused_ln_mlp on the same f32 rows, and the whole-form plain
    version."""
    tree, block = _block(shape)
    xn = _x(shape).reshape(-1, shape["e"])
    args = _mlp_args(block)
    with torch.no_grad():
        got = FM.ln_mlp_stages_reference(torch.from_numpy(xn), *args, residual=residual,
                                         dtype=f32, activation=activation)
        whole = FM._reference(torch.from_numpy(xn), *args, activation, 1e-5, residual)
    assert got.dtype == f32
    jargs = [tree["ln2"]["scale"], tree["ln2"]["bias"], tree["fc1"]["w"], tree["fc1"]["b"],
             tree["fc2"]["w"], tree["fc2"]["b"]]
    want = jax_fused_ln_mlp(jnp.asarray(xn), *map(jnp.asarray, jargs), activation, 1e-5,
                            residual, 256, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_encoder_block_matches_jax(shape):
    """The megablock's f32 inference form: the port's fused_encoder_block and
    its launches' f32 plain versions composed (LN1 -> qkv, attention in the
    (B, N, H*Dh) rows, the out-projection, LN2 -> fc1 -> GELU, fc2) against
    the JAX fused_encoder_block in interpret mode."""
    tree, block = _block(shape)
    xn = _x(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    want = np.asarray(JFB.fused_encoder_block(jnp.asarray(xn), jax.tree.map(jnp.asarray, tree),
                                              num_heads=h, group=1, interpret=True))
    x = torch.from_numpy(xn)
    with torch.no_grad():
        got = FB.fused_encoder_block(x, block, num_heads=h)
        qkv = FB._ln_qkv_reference(x, block.ln1.scale, block.ln1.bias, block.msha.qkv,
                                   FB._qkv_bias(block))
        ao = FB.attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(e // h))
        ao = ao.transpose(1, 2).reshape(b * n, e)
        staged = FM.ln_mlp_stages_reference(x.reshape(b * n, e), *_mlp_args(block), attn=ao,
                                             wout=block.msha.out.w, bout=block.msha.out.b,
                                             dtype=f32)
    assert got.dtype == staged.dtype == f32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(staged.reshape(b, n, e).numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_encoder_block_residuals_match_jax(shape):
    """fused_encoder_block(want_residuals=True) in f32 and the training
    form's f32 stage plain versions composed (dropout-free): out, x1, z1, ao
    and the LSE against the JAX saved-residual forward in interpret mode."""
    tree, block = _block(shape)
    xn = _x(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    want, (_, x1p, z1p, aop, lsep) = JFB.fused_encoder_block(
        jnp.asarray(xn), jax.tree.map(jnp.asarray, tree), num_heads=h, group=1, interpret=True,
        want_residuals=True)
    x = torch.from_numpy(xn)
    with torch.no_grad():
        out, res = FB.fused_encoder_block(x, block, num_heads=h, want_residuals=True)
        staged, m1, m2, sx1, sz1 = FB._proj_ln_mlp_train_stages_reference(
            x.reshape(b * n, e), res.ao.reshape(b * n, e), block.msha.out.w, block.msha.out.b,
            *_mlp_args(block), None, 0.0)
    assert m1 is None and m2 is None
    assert all(t.dtype == f32 for t in (out, res.x1, res.z1, res.ao, staged, sx1, sz1))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(staged.reshape(b, n, e).numpy(), np.asarray(want), **TOL)
    for got, jax_ in ((res.x1, x1p), (sx1.reshape(b, n, e), x1p)):
        np.testing.assert_allclose(got.numpy(), np.asarray(jax_)[:b, :n, :e], **TOL)
    for got in (res.z1, sz1.reshape(b, n, -1)):
        np.testing.assert_allclose(got.numpy(), np.asarray(z1p)[:b, :n, :2 * e], **TOL)
    np.testing.assert_allclose(res.ao.numpy(), np.asarray(aop)[:b, :n, :e], **TOL)
    np.testing.assert_allclose(res.lse.numpy(), np.asarray(lsep)[:b, :h, :n], **TOL)


# --- the K-major weights the f32 tile reads ----------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_kmajor_weights_are_the_transposes(shape):
    """fused_mlp.kmajor(w) is w.t() and fused_block._qkv_weight_kmajor is
    _qkv_weight(qkv_w, f32).t(), each a contiguous copy; the latter is the
    JAX package's wqkv (`_pad_params`, unpadded) transposed."""
    tree, block = _block(shape)
    e, h = shape["e"], shape["heads"]
    for w in (block.fc1.w, block.fc2.w, block.msha.out.w):
        got = FM.kmajor(w.detach())
        assert got.is_contiguous() and got.data_ptr() != w.data_ptr()
        assert torch.equal(got, w.detach().t())
    qkv_w = block.msha.qkv.detach()
    got = FB._qkv_weight_kmajor(qkv_w)
    assert got.is_contiguous() and got.data_ptr() != qkv_w.data_ptr()
    assert got.dtype == f32 and got.shape == (3 * e, e)
    assert torch.equal(got, FB._qkv_weight(qkv_w, f32).t())
    pads = JFB._pad_params(jax.tree.map(jnp.asarray, tree), h, jnp.float32)[3]
    np.testing.assert_array_equal(got.t().numpy(), np.asarray(pads["wqkv"])[:e, :3 * e])


def _ln(x, s, b, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * s + b


@pytest.mark.parametrize("activation", list(FM.ACTIVATIONS))
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_ln_mlp_through_kmajor_weights_matches_jax(shape, activation):
    """LN -> fc1 -> act -> fc2 + x in f32 with each product read as the f32
    tile reads it, y . (w K-major)^T, equals the JAX fused_ln_mlp."""
    tree, block = _block(shape)
    xn = _x(shape).reshape(-1, shape["e"])
    ln_s, ln_b, w1, b1, w2, b2 = _mlp_args(block)
    x = torch.from_numpy(xn)
    with torch.no_grad():
        z1 = _ln(x, ln_s, ln_b) @ FM.kmajor(w1).t() + b1
        got = x + FM._act(activation)(z1) @ FM.kmajor(w2).t() + b2
    jargs = [tree["ln2"]["scale"], tree["ln2"]["bias"], tree["fc1"]["w"], tree["fc1"]["b"],
             tree["fc2"]["w"], tree["fc2"]["b"]]
    want = jax_fused_ln_mlp(jnp.asarray(xn), *map(jnp.asarray, jargs), activation, 1e-5, True,
                            256, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_encoder_block_through_kmajor_weights_matches_jax(shape):
    """The megablock's f32 inference form with every product read K-major
    (LN1 -> qkv through _qkv_weight_kmajor, the out-projection, fc1 and fc2
    through kmajor) equals the JAX fused_encoder_block in interpret mode."""
    tree, block = _block(shape)
    xn = _x(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    want = np.asarray(JFB.fused_encoder_block(jnp.asarray(xn), jax.tree.map(jnp.asarray, tree),
                                              num_heads=h, group=1, interpret=True))
    x = torch.from_numpy(xn)
    ln_s, ln_b, w1, b1, w2, b2 = _mlp_args(block)
    with torch.no_grad():
        qkv = (_ln(x, block.ln1.scale, block.ln1.bias)
               @ FB._qkv_weight_kmajor(block.msha.qkv).t() + FB._qkv_bias(block))
        qkv = qkv.reshape(b, n, 3, h, e // h).permute(2, 0, 3, 1, 4)
        ao = FB.attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(e // h))
        ao = ao.transpose(1, 2).reshape(b, n, e)
        x1 = x + ao @ FM.kmajor(block.msha.out.w).t() + block.msha.out.b
        z1 = _ln(x1, ln_s, ln_b) @ FM.kmajor(w1).t() + b1
        got = x1 + FM._act("gelu")(z1) @ FM.kmajor(w2).t() + b2
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# --- the dtype gate ------------------------------------------------------------------------


# --- the wrappers reach the f32 entries ----------------------------------------------------


def _recorder(calls):
    """A build.entry that records (name, args), each call with its C
    signature's argument count, and launches nothing."""
    def entry(name):
        def fn(*args):
            assert len(args) == len(build.SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn
    return entry


@pytest.fixture
def recorded(monkeypatch):
    """Meta tensors through the wrappers: the CUDA checks lifted, the C
    entries replaced by a recorder of (name, args), the launch counts
    fresh; returns (calls, the dtypes of every operand the wrappers hand a
    kernel)."""
    calls, operand_dtypes = [], []
    operands = FM._operands

    def recording_operands(dev, *pairs):
        got = operands(dev, *pairs)
        operand_dtypes.extend(t.dtype for t in got if t is not None)
        return got

    for mod in (FM, FB):
        monkeypatch.setattr(mod, "_on_card", lambda what, *ts: None)
        monkeypatch.setattr(mod, "_operands", recording_operands)
    monkeypatch.setattr(A, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(build, "entry", _recorder(calls))
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    monkeypatch.setattr(build, "LAUNCHES", {k: 0 for k in build.LAUNCHES})
    return calls, operand_dtypes


def _launched():
    return {k: n for k, n in build.LAUNCHES.items() if n}


def test_kernel_dtype_takes_bf16_and_f32_and_names_the_item_otherwise(recorded):
    """bf16 or f32, one dtype for all the activations; f16, f64 and mixes
    raise naming the item, in the gate and in the stage wrappers, before any
    launch."""
    calls, _ = recorded
    x = torch.zeros(4, 8)
    for dt in (torch.bfloat16, f32):
        assert FM.kernel_dtype("LN->MLP kernel", x.to(dt), x.to(dt)) == dt
    for ts in ((x.half(),), (x.double(), x.double()), (x, x.bfloat16()), (x.bfloat16(), x.half())):
        with pytest.raises(TypeError, match="queue 1 item 7"):
            FM.kernel_dtype("LN->MLP kernel", *ts)
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    rows, w = torch.empty(34, 32, device="meta"), torch.zeros(32, 32)
    for a, res in ((rows.half(), None), (rows.double(), None), (rows, rows.bfloat16())):
        with pytest.raises(TypeError, match="queue 1 item 7"):
            FM.linear_stage(a, w, w[0], res, seed)
        attn = None if res is None else res.reshape(2, 17, 32)  # x and attn of two dtypes
        with pytest.raises(TypeError, match="queue 1 item 7"):
            FM.ln_mlp_forward(a.reshape(2, 17, 32), w[0], w[0], w, w[0], w, w[0], attn=attn,
                              wout=w, bout=w[0])
    with pytest.raises(TypeError, match="queue 1 item 7"):
        FB.ln_qkv_forward(rows.half().reshape(2, 17, 32), w[0], w[0], torch.zeros(3, 4, 32, 8),
                          torch.zeros(96))
    assert calls == [] and not _launched()


@pytest.mark.parametrize("e", [32, 520])
def test_f32_wrappers_launch_the_f32_entries(recorded, monkeypatch, e):
    """Each f32 stage launches its `_f32` entry once, with the C signature's
    argument count, f32 weights and f32 outputs, at E 32 and 520 alike (the
    f32 kernels stream every E: ``wide`` does not apply); the forms count
    their calls as in bf16.  Each f32 launch is handed its weight K-major,
    copied in the call (fused_mlp.kmajor, fused_block._qkv_weight_kmajor)."""
    calls, dtypes = recorded
    copies = []

    def recording(copy):
        def fn(*args):
            out = copy(*args)
            copies.append(tuple(out.shape))
            return out
        return fn

    monkeypatch.setattr(FM, "kmajor", recording(FM.kmajor))
    monkeypatch.setattr(FB, "_qkv_weight_kmajor", recording(FB._qkv_weight_kmajor))
    m, hidden, seed = 34, 2 * e, torch.zeros(1, dtype=torch.int64, device="meta")
    a = torch.empty(m, e, device="meta")
    w1, b1 = torch.zeros(e, hidden), torch.zeros(hidden)
    w2, ln = torch.zeros(hidden, e), torch.ones(e)
    for wide in (False, True):
        h, z1 = FM.ln_fc1_stage(a, ln, ln, w1, b1, want_z1=True, wide=wide)
        assert h.dtype == z1.dtype == f32 and h.shape == (m, hidden)
        assert [c[0] for c in calls] == ["ln_mlp_fc1_f32"]
        calls.clear()
    out, mask = FM.linear_stage(h, w2, ln, a, seed, 0.1, 1)
    assert out.dtype == mask.dtype == f32 and out.shape == (m, e)
    name, args = calls.pop()
    assert name == "ln_mlp_linear_f32" and args[10] == 1 and args[11] == FM.threshold(0.1)
    assert FM.ln_mlp_forward(a.reshape(2, 17, e), ln, ln, w1, b1, w2, ln).dtype == f32
    attn = torch.empty(2, 17, e, device="meta")
    FM.ln_mlp_forward(a.reshape(2, 17, e), ln, ln, w1, b1, w2, ln, attn=attn, wout=w2[:e],
                      bout=ln)
    assert [c[0] for c in calls] == ["ln_mlp_fc1_f32", "ln_mlp_linear_f32", "ln_mlp_linear_f32",
                                     "ln_mlp_fc1_f32", "ln_mlp_linear_f32"]
    calls.clear()
    heads = e // 8 if e == 32 else 5
    qkv = FB.ln_qkv_forward(a.reshape(2, 17, e), ln, ln, torch.zeros(3, heads, e, e // heads),
                            torch.zeros(3 * e), wide=True)
    assert qkv.dtype == f32 and qkv.shape == (3, 2, heads, 17, e // heads)
    assert [c[0] for c in calls] == ["ln_qkv_fwd_f32"]
    # w1 twice, w2, then the forms' w1, w2 and wout (E, E), w1, w2; wqkv
    assert copies == [(hidden, e)] * 2 + [(e, hidden), (hidden, e), (e, hidden), (e, e),
                                          (hidden, e), (e, hidden), (3 * e, e)]
    assert set(dtypes) == {f32}
    assert _launched() == {"ln_mlp_fc1_f32": 4, "ln_mlp_linear_f32": 4, "ln_qkv_fwd_f32": 1,
                           "ln_mlp_fwd": 1, "proj_ln_mlp_fwd": 1}
    for stage in (lambda: FM.ln_rows(a, ln, ln), lambda: FM.fc1_stage(a, w1, b1),
                  lambda: FB.qkv_stage(a.reshape(2, 17, e), torch.zeros(3, heads, e, e // heads),
                                       torch.zeros(3 * e))):
        with pytest.raises(TypeError, match="stream every E"):
            stage()


def test_bf16_wrappers_launch_the_bf16_entries(recorded):
    """The same calls on bf16 rows launch today's bf16 entries, with bf16
    weights and outputs: the resident stages at E 32, the wide route (LN
    rows, then the streamed product) at E 520."""
    calls, dtypes = recorded
    bf16 = torch.bfloat16
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    for e, fc1 in ((32, ["ln_mlp_fc1"]), (520, ["ln_rows", "ln_mlp_fc1_wide"])):
        a = torch.empty(34, e, device="meta", dtype=bf16)
        ln, w1, b1 = torch.ones(e), torch.zeros(e, 2 * e), torch.zeros(2 * e)
        h, z1 = FM.ln_fc1_stage(a, ln, ln, w1, b1, want_z1=True)
        assert h.dtype == z1.dtype == bf16
        out, mask = FM.linear_stage(h, torch.zeros(2 * e, e), ln, a, seed, 0.1, 1)
        assert out.dtype == bf16 and mask.dtype == f32
        heads = 4 if e == 32 else 5
        qkv = FB.ln_qkv_forward(a.reshape(2, 17, e), ln, ln, torch.zeros(3, heads, e, e // heads),
                                torch.zeros(3 * e))
        assert qkv.dtype == bf16
        qkv_names = ["ln_qkv_fwd"] if e == 32 else ["ln_rows", "ln_qkv_fwd_wide"]
        assert [c[0] for c in calls] == fc1 + ["ln_mlp_linear"] + qkv_names
        calls.clear()
    weights = [d for d in dtypes if d != f32]  # LN parameters, biases and masks stay f32
    assert weights and set(weights) == {bf16}


@pytest.mark.parametrize("dtype", [f32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", ["inference", "residuals"])
def test_megablock_forward_launches_in_its_dtype(recorded, dtype, form):
    """fused_encoder_block launches LN->qkv, the flash forward into the
    (B, N, H*Dh) layout (out_bnhd 1, H heads) and the three LN->MLP stages,
    all in x's dtype; its attention buffer, output and residuals are in x's
    dtype."""
    calls, _ = recorded
    shape = dict(b=2, n=17, e=32, heads=4)
    _, block = _block(shape)
    x = torch.empty(2, 17, 32, device="meta", dtype=dtype)
    seed = torch.zeros(1, dtype=torch.int64, device="meta")
    with torch.no_grad():
        if form == "inference":
            out = FB.fused_encoder_block(x, block, num_heads=4)
        else:
            out, res = FB.fused_encoder_block(x, block, num_heads=4, rate=0.1, seed=seed,
                                              want_residuals=True)
            assert res.x1.dtype == res.z1.dtype == res.ao.dtype == dtype
            assert res.m1.dtype == res.m2.dtype == f32
    assert out.dtype == dtype and out.shape == x.shape
    sfx = "_f32" if dtype == f32 else ""
    assert [c[0] for c in calls] == [f"ln_qkv_fwd{sfx}", f"flash_attn_fwd{sfx}",
                                     f"ln_mlp_linear{sfx}", f"ln_mlp_fc1{sfx}",
                                     f"ln_mlp_linear{sfx}"]
    args = calls[1][1]
    if dtype == f32:  # ..., inv_scale, mode, heads, out_bnhd, stream
        assert args[10] == 4 and args[11] == 1
    else:  # ..., heads, inv_scale, out_bnhd, mode, grid, stream
        assert args[8] == 4 and args[10] == 1


# --- the training gate ---------------------------------------------------------------------


def _pallas_outputs(jaxpr) -> list:
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
                    outs += _pallas_outputs(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    outs += _pallas_outputs(sub)
    return outs


def _jax_variant(x_dtype, n, e, heads, hidden, dropout, mode, bwd, train, monkeypatch):
    """The JAX package's decision on a TPU for a block of ``x_dtype`` inputs,
    read from its gate's jaxpr (traced only): the megablock variant by the
    output count of its forward's pallas_call (the saved variants' residuals
    among them), None for the standard path."""
    from vitgan_tpu.ops import policy as JP

    monkeypatch.setattr(JP, "on_tpu", lambda: True)
    saved = JP.get_policy()
    JP.set_policy(mode="auto", megablock=mode, megablock_bwd=bwd)
    cfg = JC.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e, dropout=dropout)
    z, dh = jnp.zeros, e // heads
    p = {"ln1": {"scale": z(e), "bias": z(e)}, "ln2": {"scale": z(e), "bias": z(e)},
         "msha": {"qkv": z((3, heads, e, dh)), "qkv_b": z((3, heads, dh)),
                  "out": {"w": z((heads * dh, e)), "b": z(e)}},
         "fc1": {"w": z((e, hidden)), "b": z(hidden)}, "fc2": {"w": z((hidden, e)), "b": z(e)}}

    def gate(x):
        out = JFB.maybe_megablock(p, x, cfg, jax.random.PRNGKey(0) if train else None, train)
        return x if out is None else out

    try:
        jaxpr = jax.make_jaxpr(gate)(jax.ShapeDtypeStruct((2, n, e), x_dtype)).jaxpr
    finally:
        JP.set_policy(mode=saved["mode"], megablock=saved["megablock"],
                      megablock_bwd=saved["megablock_bwd"])
    outs = _pallas_outputs(jaxpr)
    return {1: "encoder_block_fused", 3: "encoder_block_fused_dropout",
            5: "encoder_block_fused_saved", 7: "encoder_block_fused_dropout_saved"}.get(
        outs[0] if outs else None)


@pytest.mark.parametrize("mode,bwd,train", [("auto", "saved", True), ("on", "saved", True),
                                            ("auto", "recompute", True),
                                            ("on", "recompute", True), ("off", "saved", True),
                                            ("auto", "saved", False)],
                         ids=["auto", "on", "auto-recompute", "on-recompute", "off", "inference"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_gate_takes_the_jax_decision_for_f32_and_bf16(monkeypatch, mode, bwd, train, dropout):
    """highres128's G block (1,024 tokens, E 384, 6 heads, hidden 1,536) on
    the card (meta tensors stand in; on_cuda patched): megablock_route
    returns the JAX gate's decision for f32 and for bf16 inputs in every
    mode, megablock_bwd and dropout, the saved variants included (the saved
    backward has f32 kernels)."""
    n, e, heads, hidden = 1024, 384, 6, 1536
    cfg = C.V2Config(embed_dim=e, num_heads=heads, mlp_ratio=hidden // e, dropout=dropout)
    block = EncoderBlock(cfg, None)
    monkeypatch.setattr(FB, "on_cuda", lambda t: True)
    policy.set_policy(mode="auto", megablock=mode, megablock_bwd=bwd)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16), (f32, jnp.float32)):
        want = _jax_variant(jdtype, n, e, heads, hidden, dropout, mode, bwd, train, monkeypatch)
        x = torch.empty(2, n, e, device="meta", dtype=dtype)
        assert FB.megablock_route(block, x, cfg, train, True) == want
    if mode == "auto" and bwd == "saved" and train:  # the presets' default route
        assert want == ("encoder_block_fused_dropout_saved" if dropout else
                        "encoder_block_fused_saved")


# --- the slice -----------------------------------------------------------------------------


def _jax_adam_mu(jopt):
    adam = [t for t in jax.tree.leaves(jopt, is_leaf=lambda t: isinstance(
        t, optax.ScaleByAdamState)) if isinstance(t, optax.ScaleByAdamState)]
    return from_jax_tree(jax.tree.map(np.asarray, adam[0].mu))


def test_f32_train_step_megablock_recompute_matches_jax(monkeypatch):
    """One bce step at smoke widths in f32, dropout 0, under megablock=on and
    megablock_bwd=recompute (every block of G and D through
    encoder_block_fused: the kernels' forward, autograd of the plain block
    behind it), from the JAX state, against the JAX make_train_step: every
    metric, Adam's first moments, the updated parameters
    (test_torch_v2_train.test_train_step_matches_jax's bounds)."""
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(0), jgan, jcfg)
    real = np.random.default_rng(0).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    k_noise = jax.random.split(jst.rng, 11)[1]  # the JAX step's latents (step.py:66-73)
    z = np.array(jax.random.normal(k_noise, (8, jcfg.v2.latent_dim), jnp.float32))
    jnew, jm = jax_make_train_step(jgan, jcfg, donate=False)(jst, jnp.asarray(real))

    routes = []
    apply = FB.megablock_apply
    monkeypatch.setattr(FB, "megablock_apply", lambda route, *a, **k: routes.append(route)
                        or apply(route, *a, **k))
    cfg = C.replace(C.smoke_config(), **over, **{
        "runtime.use_pallas": "auto", "runtime.megablock": "on",
        "runtime.megablock_bwd": "recompute"})
    policy.apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    m = make_train_step(gan, cfg)(state, torch.from_numpy(real), z=torch.from_numpy(z))
    assert routes and set(routes) == {"encoder_block_fused"}
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), **TOL, err_msg=k)
    for net, opt, jopt, jparams in ((state.g, state.g_opt, jnew.g_opt, jnew.g_params),
                                    (state.d, state.d_opt, jnew.d_opt, jnew.d_params)):
        mu = _jax_adam_mu(jopt)
        for name, p in net.named_parameters():
            np.testing.assert_allclose(opt.opt.state[p]["exp_avg"].numpy(), mu[name].numpy(),
                                       **TOL, err_msg=name)
        want = from_jax_tree(jax.tree.map(np.asarray, jparams))
        lr = opt.cfg.learning_rate
        for name, p in net.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                       atol=2 * lr + 1e-6, err_msg=name)


def test_f32_generator_on_the_megablock_matches_jax(monkeypatch):
    """The f32 serving call's generator (depth 2, embed 32, its LN parameters
    and biases perturbed) with every block on the megablock's inference form
    against the JAX generator_apply."""
    jcfg = JC.smoke_config().v2
    tree = jax.tree.map(np.asarray, JV.generator_init(jax.random.PRNGKey(0), jcfg)["params"])
    rng = np.random.default_rng(0)
    for blk in tree["blocks"]:
        for k in ("ln1", "ln2"):
            blk[k]["scale"] = (1 + 0.1 * rng.standard_normal(blk[k]["scale"].shape)
                               ).astype(np.float32)
            blk[k]["bias"] = (0.05 * rng.standard_normal(blk[k]["bias"].shape)).astype(np.float32)
    gan = build_gan(C.replace(C.smoke_config(), **{"runtime.compute_dtype": "float32"}))
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    load_into(g, from_jax_tree(tree))
    z = np.random.default_rng(3).standard_normal((4, jcfg.latent_dim)).astype(np.float32)
    want, _ = JV.generator_apply({"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(z), jcfg)
    forms = []
    block = FB.fused_encoder_block
    monkeypatch.setattr(FB, "fused_encoder_block", lambda x, *a, **k: forms.append(x.dtype)
                        or block(x, *a, **k))
    policy.set_policy(mode="auto", megablock="on")
    with torch.inference_mode():
        got = g(torch.from_numpy(z))
    assert forms == [f32] * jcfg.depth
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
