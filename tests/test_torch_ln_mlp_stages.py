"""The LN->MLP forward as csrc/ln_mlp_fwd.cu computes it, stage by stage, on
the CPU: the stage plain versions (out-projection, LN -> fc1 -> GELU, fc2,
with the kernels' bf16 roundings of x1 and h) composed into the three forms
against the whole-form plain versions (fused_mlp._reference,
fused_block._proj_ln_mlp_reference, _proj_ln_mlp_train_reference) and the JAX
package's `fused_ln_mlp` and `fused_encoder_block` (interpret mode, f32); and
`sum_partials_reference`, the order model of the sum_partials kernel,
against ``part.sum(0)``.  The stage kernels themselves are held to these
stage plain versions on the card (tests/test_torch_kernels_cuda.py,
chip_smoke.py).

Tolerance of a composed form: |stages - whole| <= STAGE_RTOL * max(1,
max|whole|), the limit chip_smoke.py holds the forward kernels to.  The
stages round x1 and h to bf16 (2**-9 relative each) where the whole forms
keep f32, and both sides round their outputs to bf16, so two outputs of
magnitude up to 4 may differ by two bf16 units in the last place (2**-6
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from vitgan_tpu_torch.config import V2Config
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import wgrad as WG
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
STAGE_RTOL = 2e-2
RATE = 0.1

# (batch, tokens, embed, heads), mlp_ratio 4: ragged row counts (34 and 195
# rows, neither a multiple of the kernels' 128-row tiles) at E 32 and 48, and
# the wide variants' widths (E > 384) at 32 rows: E 520 (a multiple of 8 and
# not of 64: the last 64-column box is zero-filled) and DeiT-B's 768.
SHAPES = [dict(b=2, n=17, e=32, heads=2), dict(b=3, n=65, e=48, heads=2),
          dict(b=2, n=16, e=520, heads=5), dict(b=2, n=16, e=768, heads=12)]
IDS = ["rows34_e32", "rows195_e48", "rows32_e520", "rows32_e768"]
# Wide plain versions against the fused stage plain versions, both in f32.
WIDE_TOL = dict(rtol=1e-5, atol=1e-5)


def _block(shape, seed=0):
    """A JAX encoder block tree with LN parameters and biases perturbed, and
    the port's EncoderBlock holding the same values."""
    cfg = JaxV2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4)
    tree = jax.tree.map(np.asarray, _encoder_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        tree[k]["scale"] = (1 + 0.1 * rng.standard_normal(tree[k]["scale"].shape)).astype(np.float32)
        tree[k]["bias"] = (0.1 * rng.standard_normal(tree[k]["bias"].shape)).astype(np.float32)
    for sub in (tree["fc1"], tree["fc2"], tree["msha"]["out"]):
        sub["b"] = (0.1 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
    block = EncoderBlock(V2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4),
                         torch.Generator().manual_seed(seed))
    load_into(block, from_jax_tree(tree))
    return tree, block


def _bf16(a):
    """numpy f32 -> (bf16 torch tensor, its values as numpy f32)."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t, t.float().numpy()


def _rows(shape, width, seed):
    rng = np.random.default_rng(seed)
    return _bf16(rng.standard_normal((shape["b"] * shape["n"], width)).astype(np.float32))


def _close(got, want, what: str):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    tol = STAGE_RTOL * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: {err:.4g} > {tol:.4g}"


def _mlp_args(block):
    return [t.detach() for t in (block.ln2.scale, block.ln2.bias, block.fc1.w, block.fc1.b,
                                 block.fc2.w, block.fc2.b)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_ln_mlp_stages_compose_to_the_whole_form_and_jax(shape, residual):
    """fc1 then fc2 (h in bf16) equal fused_mlp._reference and the JAX
    fused_ln_mlp on the same bf16 rows."""
    tree, block = _block(shape)
    x, xn = _rows(shape, shape["e"], 1)
    args = _mlp_args(block)
    got = FM.ln_mlp_stages_reference(x, *args, residual=residual)
    assert got.dtype == torch.bfloat16
    _close(got.float(), FM._reference(x.float(), *args, "gelu", 1e-5, residual), "whole form")
    jargs = [tree["ln2"]["scale"], tree["ln2"]["bias"], tree["fc1"]["w"], tree["fc1"]["b"],
             tree["fc2"]["w"], tree["fc2"]["b"]]
    want = jax_fused_ln_mlp(jnp.asarray(xn), *map(jnp.asarray, jargs), "gelu", 1e-5, residual,
                            256, True)
    _close(got.float(), np.asarray(want), "JAX fused_ln_mlp")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_serving_stages_compose_to_the_whole_form_and_jax(shape):
    """The out-projection (x1 in bf16), fc1 and fc2 equal
    _proj_ln_mlp_reference; behind the plain LN1 -> qkv and attention they
    equal the JAX fused_encoder_block (interpret mode, dropout-free)."""
    tree, block = _block(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    x, xn = _bf16(np.random.default_rng(1).standard_normal((b, n, e)).astype(np.float32))
    attn, _ = _rows(shape, e, 2)
    wout, bout = block.msha.out.w.detach(), block.msha.out.b.detach()
    rows = x.reshape(b * n, e)
    got = FM.ln_mlp_stages_reference(rows, *_mlp_args(block), attn=attn, wout=wout, bout=bout)
    want = FB._proj_ln_mlp_reference(rows.float(), attn.float(), wout, bout, *_mlp_args(block))
    _close(got.float(), want, "whole form")
    # the whole block: plain LN1 -> qkv -> attention, then the stages
    with torch.no_grad():
        qkv = FB._ln_qkv_reference(x.float(), block.ln1.scale, block.ln1.bias, block.msha.qkv,
                                   FB._qkv_bias(block))
        ao = FB.attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(e // h))
        ao = ao.transpose(1, 2).reshape(b * n, e).to(torch.bfloat16)
        got = FM.ln_mlp_stages_reference(rows, *_mlp_args(block), attn=ao, wout=wout, bout=bout)
    want = JFB.fused_encoder_block(jnp.asarray(xn), jax.tree.map(jnp.asarray, tree),
                                   num_heads=h, group=1, interpret=True)
    _close(got.float().reshape(b, n, e), np.asarray(want), "JAX fused_encoder_block")


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_training_stages_compose_to_the_whole_form(shape, rate):
    """The training form's stages (masks drawn by Philox streams 0 and 1)
    equal _proj_ln_mlp_train_reference: masks bit-equal, out, x1 and z1
    within STAGE_RTOL."""
    _, block = _block(shape)
    e = shape["e"]
    x, _ = _rows(shape, e, 1)
    attn, _ = _rows(shape, e, 2)
    seed = torch.tensor([123456789], dtype=torch.int64)
    args = (x, attn, block.msha.out.w.detach(), block.msha.out.b.detach(), *_mlp_args(block),
            seed, rate)
    got = FB._proj_ln_mlp_train_stages_reference(*args)
    want = FB._proj_ln_mlp_train_reference(*args)
    for i in (1, 2):
        assert (got[i] is None) == (rate == 0.0)
        if rate:
            assert torch.equal(got[i], want[i])
            assert 0.85 < (got[i] > 0).float().mean().item() < 0.95
    for i, what in ((0, "out"), (3, "x1"), (4, "z1")):
        assert got[i].dtype == torch.bfloat16
        _close(got[i].float(), want[i].float(), what)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_training_stages_match_jax_masked_block(shape, monkeypatch):
    """Behind the plain LN1 -> qkv and attention, the training stages on
    numpy masks equal the JAX _block_reference_masked on the same masks."""
    tree, block = _block(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    rng = np.random.default_rng(3)
    x, xn = _bf16(rng.standard_normal((b, n, e)).astype(np.float32))
    m1, m2 = ((rng.random((b * n, e)) >= RATE).astype(np.float32) / np.float32(1 - RATE)
              for _ in range(2))
    masks = {0: torch.from_numpy(m1), 1: torch.from_numpy(m2)}
    monkeypatch.setattr(FB, "dropout_mask", lambda seed, i, s, rate: masks[i].reshape(s))
    with torch.no_grad():
        qkv = FB._ln_qkv_reference(x.float(), block.ln1.scale, block.ln1.bias, block.msha.qkv,
                                   FB._qkv_bias(block))
        ao = FB.attention_reference(qkv[0], qkv[1], qkv[2], "dot", float(e // h))
        ao = ao.transpose(1, 2).reshape(b * n, e).to(torch.bfloat16)
        out, f1, f2, _, _ = FB._proj_ln_mlp_train_stages_reference(
            x.reshape(b * n, e), ao, block.msha.out.w, block.msha.out.b, *_mlp_args(block),
            torch.zeros(1, dtype=torch.int64), RATE)
    assert torch.equal(f1, masks[0]) and torch.equal(f2, masks[1])
    want = JFB._block_reference_masked(jnp.asarray(xn), jax.tree.map(jnp.asarray, tree),
                                       jnp.asarray(m1.reshape(b, n, e)),
                                       jnp.asarray(m2.reshape(b, n, e)), h, 1e-5)
    _close(out.float().reshape(b, n, e), np.asarray(want), "JAX _block_reference_masked")


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_wide_stages_compose_to_the_fused_stage_plain_versions(shape):
    """The wide variants' plain versions (LN rows, then the streamed fc1 or
    qkv product) composed in f32 equal the resident stages' plain versions
    in f32 (ln_fc1_stage_reference, _ln_qkv_reference) within 1e-5."""
    _, block = _block(shape)
    b, n, e = shape["b"], shape["n"], shape["e"]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((b, n, e)).astype(np.float32))
    ln2, f32 = (block.ln2.scale.detach(), block.ln2.bias.detach()), torch.float32
    w1, b1 = block.fc1.w.detach(), block.fc1.b.detach()
    y = FM.ln_rows_reference(x, *ln2, dtype=f32)
    got = FM.fc1_stage_reference(y, w1, b1, dtype=f32)
    want = FM.ln_fc1_stage_reference(x, *ln2, w1, b1, dtype=f32)
    for g, w in zip(got, want):
        assert g.dtype == f32
        torch.testing.assert_close(g, w, **WIDE_TOL)
    with torch.no_grad():
        ln1 = (block.ln1.scale, block.ln1.bias)
        got = FB.qkv_stage_reference(FM.ln_rows_reference(x, *ln1, dtype=f32), block.msha.qkv,
                                     FB._qkv_bias(block), dtype=f32)
        want = FB._ln_qkv_reference(x, *ln1, block.msha.qkv, FB._qkv_bias(block))
    assert got.shape == (3, b, shape["heads"], n, e // shape["heads"])
    torch.testing.assert_close(got, want, **WIDE_TOL)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_wide_ln_mlp_stages_match_the_whole_form_and_jax(shape, residual):
    """The wide LN->MLP as the card runs it (LN(x) handed on in bf16, then
    fc1, h in bf16, fc2) equals fused_mlp._reference and the JAX
    fused_ln_mlp on the same bf16 rows, within STAGE_RTOL."""
    tree, block = _block(shape)
    x, xn = _rows(shape, shape["e"], 1)
    args = _mlp_args(block)
    y = FM.ln_rows_reference(x, args[0], args[1])
    assert y.dtype == torch.bfloat16
    h, _ = FM.fc1_stage_reference(y, args[2], args[3])
    got = FM.linear_stage_reference(h, args[4], args[5], x if residual else None)
    _close(got.float(), FM._reference(x.float(), *args, "gelu", 1e-5, residual), "whole form")
    jargs = [tree["ln2"]["scale"], tree["ln2"]["bias"], tree["fc1"]["w"], tree["fc1"]["b"],
             tree["fc2"]["w"], tree["fc2"]["b"]]
    want = jax_fused_ln_mlp(jnp.asarray(xn), *map(jnp.asarray, jargs), "gelu", 1e-5, residual,
                            256, True)
    _close(got.float(), np.asarray(want), "JAX fused_ln_mlp")


@pytest.mark.parametrize("splits,count", [(1, 8), (5, 96), (128, 768), (512, 768),
                                          (1025, 768), (300, 20)])
def test_sum_partials_order_model_matches_sum(splits, count):
    """sum_partials_reference (the kernel's lanes and pairwise tree, by
    elementwise adds) against part.sum(0): within 1e-6 of each column's sum
    of magnitudes (f32 sums in two orders); bit-equal for one row."""
    part = torch.from_numpy(np.random.default_rng(splits).standard_normal(
        (splits, count)).astype(np.float32))
    got, want = WG.sum_partials_reference(part), part.sum(0)
    assert got.dtype == torch.float32 and got.shape == (count,)
    assert ((got - want).abs() <= 1e-6 * part.abs().sum(0)).all()
    if splits == 1:
        assert torch.equal(got, part[0])


def test_stage_wrappers_refuse_tensors_off_the_cpu_and_cuda():
    """A tensor on neither the CPU nor CUDA is refused by the stage wrappers
    and sum_partials, never sent to a plain version or the build."""
    a = torch.empty(34, 32, device="meta", dtype=torch.bfloat16)
    w, b = torch.empty(32, 32, device="meta"), torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FM.linear_stage(a, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        FM.ln_fc1_stage(a, b, b, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        WG.sum_partials(torch.empty(4, 32, device="meta"))


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_stage_wrappers_count_each_launch_and_no_refusal(monkeypatch, rate):
    """Each stage wrapper adds one to its kernel's count where it launches
    the kernel, and nothing where it refuses its inputs: run on CPU tensors
    with the C entry replaced by a recorder and the CUDA check lifted."""
    launched = []

    def entry(name):
        def fn(*args):
            launched.append(name)
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(FM.build, "entry", entry)
    monkeypatch.setattr(FM.build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(FM, "_kernel_rows", lambda t, what: t.contiguous())
    monkeypatch.setattr(FM.build, "LAUNCHES", {k: 0 for k in FM.build.LAUNCHES})
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((34, 32), np.float32)).to(torch.bfloat16)
    w1 = torch.from_numpy(rng.standard_normal((32, 64), np.float32))
    w2 = torch.from_numpy(rng.standard_normal((64, 32), np.float32))
    b = torch.zeros(64)
    seed = torch.tensor([5], dtype=torch.int64)
    h, _ = FM.ln_fc1_stage(a, b[:32] + 1, b[:32], w1, b, want_z1=True)
    FM.linear_stage(h, w2, b[:32], a, seed, rate, 1)
    with pytest.raises(ValueError, match="fit"):
        FM.linear_stage(h, w2, b[:32], h)  # a (34, 64) residual for a (34, 32) out
    with pytest.raises(ValueError):
        FM.ln_fc1_stage(a, b[:32], b[:32], w2, b)
    assert launched == ["ln_mlp_fc1", "ln_mlp_linear"]
    assert {k: n for k, n in FM.build.LAUNCHES.items() if n} == {"ln_mlp_fc1": 1,
                                                                 "ln_mlp_linear": 1}


@pytest.mark.parametrize("e,wide", [(32, True), (520, False), (768, False)])
def test_wide_fc1_stage_launches_ln_rows_then_the_streamed_product(monkeypatch, e, wide):
    """Past E 384, or forced by ``wide``, ln_fc1_stage launches the wide
    variant, ln_rows then ln_mlp_fc1_wide, each counted once, and no
    resident fc1; below it without ``wide`` the resident stage alone.  C
    entries replaced by a recorder, the CUDA check lifted."""
    launched = []

    def entry(name):
        def fn(*args):
            launched.append(name)
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(FM.build, "entry", entry)
    monkeypatch.setattr(FM.build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(FM, "_kernel_rows", lambda t, what: t.contiguous())
    monkeypatch.setattr(FM.build, "LAUNCHES", {k: 0 for k in FM.build.LAUNCHES})
    a = torch.zeros(34, e, dtype=torch.bfloat16)
    w1, b1, ln = torch.zeros(e, 2 * e), torch.zeros(2 * e), torch.ones(e)
    h, z1 = FM.ln_fc1_stage(a, ln, ln, w1, b1, want_z1=True, wide=wide)
    assert h.shape == z1.shape == (34, 2 * e)
    assert launched == ["ln_rows", "ln_mlp_fc1_wide"]
    assert {k: n for k, n in FM.build.LAUNCHES.items() if n} == {"ln_rows": 1,
                                                                 "ln_mlp_fc1_wide": 1}
    launched.clear()
    FM.ln_fc1_stage(a[:, :32], ln[:32], ln[:32], w1[:32, :64], b1[:64])
    assert launched == ["ln_mlp_fc1"]
    with pytest.raises(ValueError, match="multiples of 8"):
        FM.ln_fc1_stage(a[:, :12], ln[:12], ln[:12], w1[:12, :64], b1[:64], wide=True)
