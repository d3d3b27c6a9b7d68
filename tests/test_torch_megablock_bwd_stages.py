"""The megablock backward's MLP half as csrc/megablock_bwd_mlp.cu computes it,
stage by stage, on the CPU: the stage plain versions (dz1, dx1 with the LN2
backward, dao with delta; dmlp, dz1 and da handed on in bf16 as the kernels
do) composed against the whole-half plain version `_bwd_mlp_reference` and,
inside the saved-residual backward, against the JAX package's
`fused_encoder_block_bwd` (interpret mode, f32), with and without dropout;
the dx1 stage's dln2 partials (one row per 64-row tile) against their
column sums; and the stage wrappers' launch counts and refusals.  The stage
kernels themselves are held to these stage plain versions on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerances.  A composed output: |stages - whole| <= STAGE_RTOL * max|whole|
of that output, the limit chip_smoke.py holds the backward kernels to: the
stages round dmlp, dz1 and da to bf16 (2**-9 relative each) where the whole
half keeps f32, and the half's outputs are sums over up to 4E terms.  Inside
the saved backward every gradient leaf within STAGE_RTOL * max|JAX leaf|
(chip_smoke's MB_GRAD_RTOL for the kernels' saved backward).  The 64-row
tile partials sum, in another order, to the one-row partials within 1e-5 of
each column's sum of magnitudes (f32 sums of at most 1,000 rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops import fused_block as JFB
from vitgan_tpu_torch.config import V2Config
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
STAGE_RTOL = 2e-2
RATE = 0.1

# (batch, tokens, embed, heads), mlp_ratio 4: row counts 66 and 195, neither a
# multiple of the kernels' 64- and 128-row tiles, at E 48 and deit64's 192;
# and 32 rows at the wide variants' widths (E > 384): E 520 (a multiple of 8
# and not of 64) and DeiT-B's 768, whose halves compose the wide stages'
# plain versions (dmlp rows, dy2 in f32, the dx1 rows).
SHAPES = [dict(b=2, n=33, e=48, heads=2), dict(b=3, n=65, e=192, heads=3),
          dict(b=2, n=16, e=520, heads=5), dict(b=2, n=16, e=768, heads=12)]
IDS = ["rows66_e48", "rows195_e192", "rows32_e520", "rows32_e768"]
# The wide plain versions against the fused stage plain versions, both in
# f32: each output within 1e-5, the column partials summed over the tiles
# within 1e-4 (sums of up to 4E products).
WIDE_TOL = dict(rtol=1e-5, atol=1e-5)
WIDE_PART_TOL = dict(rtol=1e-4, atol=1e-4)


def _wide(shape) -> bool:
    return FB.wide_route(shape["e"])


def _block(shape, seed=0):
    """A JAX encoder block tree with every parameter perturbed, and the port's
    EncoderBlock holding the same values."""
    cfg = JaxV2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4)
    tree = jax.tree.map(np.asarray, _encoder_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        tree[k]["scale"] = (1 + 0.1 * rng.standard_normal(tree[k]["scale"].shape)
                            ).astype(np.float32)
        tree[k]["bias"] = (0.1 * rng.standard_normal(tree[k]["bias"].shape)).astype(np.float32)
    for sub in (tree["fc1"], tree["fc2"], tree["msha"]["out"]):
        sub["b"] = (0.05 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
    tree["msha"]["qkv_b"] = (0.05 * rng.standard_normal(tree["msha"]["qkv_b"].shape)
                             ).astype(np.float32)
    block = EncoderBlock(V2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4),
                         torch.Generator().manual_seed(seed))
    load_into(block, from_jax_tree(tree))
    return tree, block


def _masks(rng, shape):
    """Two numpy inverted-dropout masks of keep rate 1 - RATE."""
    return [(rng.random(shape) >= RATE).astype(np.float32) / np.float32(1 - RATE)
            for _ in range(2)]


def _half_inputs(shape, has_drop: bool, seed=1):
    """bf16 rows g, x1, z1, ao and f32 masks (or None) of one block's MLP half."""
    rng = np.random.default_rng(seed)
    m, e = shape["b"] * shape["n"], shape["e"]
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    g, x1, ao = (bf(rng.standard_normal((m, e))) for _ in range(3))
    z1 = bf(rng.standard_normal((m, 4 * e)))
    m1 = m2 = None
    if has_drop:
        m1, m2 = (torch.from_numpy(a) for a in _masks(rng, (m, e)))
    return g, m1, m2, x1, z1, ao


def _close(got, want, what: str, rtol: float = STAGE_RTOL):
    got, want = got.detach().float(), want.detach().float()
    assert got.shape == want.shape, what
    tol = rtol * float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err:.4g} > {tol:.4g}"


@pytest.mark.parametrize("has_drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_stages_compose_to_the_whole_mlp_half(shape, has_drop):
    """dz1 -> dx1 -> dao (bf16 hand-offs) equal _bwd_mlp_reference on the same
    bf16 rows: every BwdMlp output in the kernels' dtype and layout, and the
    dln2 partials' column sums."""
    _, block = _block(shape)
    b, n, h = shape["b"], shape["n"], shape["heads"]
    rows = _half_inputs(shape, has_drop)
    weights = [t.detach() for t in (block.fc1.w, block.fc2.w, block.msha.out.w, block.ln2.scale,
                                    block.ln2.bias)]
    got = FB.bwd_mlp_stages_reference(*rows, *weights, b, n, h, wide=_wide(shape))
    want = FB._bwd_mlp_reference(*rows, *weights, b, n, h)
    for name in ("dmlp", "dz1", "h1", "y2", "da", "dao"):
        assert getattr(got, name).dtype == torch.bfloat16, name
    assert got.dx1.dtype == got.delta.dtype == got.part.dtype == torch.float32
    assert got.dao.shape == (b, h, n, shape["e"] // h) and got.delta.shape == (b, h, n)
    for name in FB.BwdMlp._fields:
        if name != "part":
            _close(getattr(got, name), getattr(want, name), name)
    _close(got.part.sum(0), want.part[0], "dln2")
    if not has_drop:
        assert got.dmlp is rows[0]  # dmlp is g itself


@pytest.mark.parametrize("has_drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_stages_in_the_saved_backward_match_jax(shape, has_drop, monkeypatch):
    """The port's saved-residual backward with its MLP half taken by the
    composed stage plain versions against the JAX fused_encoder_block_bwd in
    interpret mode on the same residuals and masks: dx and the 12 parameter
    gradients within STAGE_RTOL * max|JAX leaf|."""
    tree, block = _block(shape)
    b, n, e, h = shape["b"], shape["n"], shape["e"], shape["heads"]
    rng = np.random.default_rng(2)
    x, g = (rng.standard_normal((b, n, e)).astype(np.float32) for _ in range(2))
    m1, m2 = _masks(rng, (b, n, e)) if has_drop else (np.ones_like(x), np.ones_like(x))
    masks = {0: torch.from_numpy(m1), 1: torch.from_numpy(m2)}
    monkeypatch.setattr(FB, "dropout_mask", lambda seed, i, s, rate: masks[i].reshape(s))

    def staged(g_, *args):
        out = FB.bwd_mlp_stages_reference(g_, *args, wide=_wide(shape))
        return FB.BwdMlp(*(t.to(g_.dtype) if t.dtype == torch.bfloat16 else t for t in out))

    monkeypatch.setattr(FB, "_bwd_mlp_reference", staged)
    with torch.no_grad():
        _, res = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=h,
                                        rate=RATE if has_drop else 0.0,
                                        seed=torch.zeros(1, dtype=torch.int64),
                                        want_residuals=True)
        dx, grads = FB.fused_encoder_block_bwd(FB.block_params(block), torch.from_numpy(g), res,
                                               num_heads=h)
    npad, epad, hpad = -(-n // 8) * 8, -(-e // 128) * 128, -(-4 * e // 128) * 128
    def pad(a, shape):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        return jnp.asarray(np.pad(a, [(0, t - u) for u, t in zip(a.shape, shape)]))

    residuals = [pad(x, (b, npad, epad))]
    if has_drop:
        residuals += [pad(m1, (b, npad, epad)), pad(m2, (b, npad, epad))]
    residuals += [pad(res.x1, (b, npad, epad)), pad(res.z1, (b, npad, hpad)),
                  pad(res.ao, (b, npad, epad)), pad(res.lse, (b, -(-h // 8) * 8, npad))]
    jdx, jdp = JFB.fused_encoder_block_bwd(jax.tree.map(jnp.asarray, tree), jnp.asarray(g),
                                           tuple(residuals), num_heads=h, eps=1e-5, group=1,
                                           interpret=True, n_real=n, has_drop=has_drop)
    want = [jdx, jdp["ln1"]["scale"], jdp["ln1"]["bias"], jdp["msha"]["qkv"],
            jdp["msha"]["qkv_b"], jdp["msha"]["out"]["w"], jdp["msha"]["out"]["b"],
            jdp["ln2"]["scale"], jdp["ln2"]["bias"], jdp["fc1"]["w"], jdp["fc1"]["b"],
            jdp["fc2"]["w"], jdp["fc2"]["b"]]
    for name, a, w in zip(("x",) + FB.BLOCK_PARAMS, [dx, *grads], want):
        _close(a, torch.from_numpy(np.array(w)), f"d{name}")


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 195, 1000])
def test_dx1_stage_partials_are_64_row_tile_sums(rows):
    """The dx1 stage's dln2 partials: one row per 64-row tile (ceil(M / 64),
    the kernel's tile height and sum_partials' split count), each the
    tile's column sums of dy2 * yhat2 and dy2; summed over the tiles they
    equal the whole half's one-row partials."""
    e, hidden = 48, 96
    rng = np.random.default_rng(rows)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)  # noqa: E731
                                     ).to(torch.bfloat16)
    dz1, g, x1 = bf(rows, hidden), bf(rows, e), bf(rows, e)
    w1, ln_s, ln_b = 0.1 * bf(e, hidden).float(), 1 + 0.1 * bf(e).float(), 0.1 * bf(e).float()
    _, _, _, part = FB.bwd_dx1_stage_reference(dz1, g, None, x1, w1, ln_s, ln_b)
    assert part.dtype == torch.float32 and part.shape == (-(-rows // 64), 2 * e)
    dy2 = dz1.float() @ w1.T
    yhat, _ = FB._ln_stats(x1.float(), 1e-5)
    cols = torch.cat([dy2 * yhat, dy2], 1)
    for i in range(part.shape[0]):
        torch.testing.assert_close(part[i], cols[64 * i:64 * (i + 1)].sum(0), rtol=0, atol=1e-5)
    assert ((part.sum(0) - cols.sum(0)).abs() <= 1e-5 * cols.abs().sum(0)).all()


@pytest.mark.parametrize("has_drop", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_wide_stages_compose_to_the_fused_stage_plain_versions(shape, has_drop):
    """In f32, the wide variants' plain versions equal the resident stages'
    plain versions: dmlp rows then the streamed dz1 product against the dz1
    stage, dy2 = dz1 . w1^T then the dx1 rows against the dx1 stage, dy1 =
    dqkv . wqkv^T then the LN1 rows against _bwd_ln1_reference; each output
    within 1e-5, the partials summed over the tiles within 1e-4."""
    _, block = _block(shape)
    e, f32 = shape["e"], torch.float32
    g, m1, m2, x1, z1, _ = (None if t is None else t.float()
                            for t in _half_inputs(shape, has_drop))
    w1, w2 = block.fc1.w.detach(), block.fc2.w.detach()
    ln = (block.ln2.scale.detach(), block.ln2.bias.detach())
    dmlp = g if m2 is None else FB.bwd_dmlp_rows_reference(g, m2, f32)
    got = (dmlp, *FB.bwd_dz1_stage_reference(dmlp, None, z1, w2, f32)[1:])
    want = FB.bwd_dz1_stage_reference(g, m2, z1, w2, f32)
    for name, a, w in zip(("dmlp", "dz1", "h1"), got, want):
        torch.testing.assert_close(a, w, **WIDE_TOL, msg=name)
    dz1 = want[1]
    got = FB.bwd_dx1_rows_reference(FB.bwd_dy_reference(dz1, w1), g, m1, x1, *ln, dtype=f32)
    want = FB.bwd_dx1_stage_reference(dz1, g, m1, x1, w1, *ln, dtype=f32)
    for name, a, w in zip(("dx1", "da", "y2"), got[:3], want[:3]):
        assert a.dtype == f32
        torch.testing.assert_close(a, w, **WIDE_TOL, msg=name)
    assert got[3].shape == want[3].shape == (-(-x1.shape[0] // 64), 2 * e)
    torch.testing.assert_close(got[3].sum(0), want[3].sum(0), **WIDE_PART_TOL)
    rng = np.random.default_rng(6)
    dqkv = torch.from_numpy(rng.standard_normal((x1.shape[0], 3 * e)).astype(np.float32))
    dx1 = torch.from_numpy(rng.standard_normal(x1.shape).astype(np.float32))
    ln1 = (block.ln1.scale.detach(), block.ln1.bias.detach())
    wqkv = FB._qkv_weight(block.msha.qkv.detach(), f32)
    got = FB.bwd_ln1_rows_reference(FB.bwd_dy_reference(dqkv, wqkv), x1, dx1, *ln1)
    want = FB._bwd_ln1_reference(dqkv, block.msha.qkv.detach(), x1, dx1, *ln1)
    for name, a, w in zip(("dx", "y1"), got[:2], want[:2]):
        assert a.dtype == f32
        torch.testing.assert_close(a, w, **WIDE_TOL, msg=name)
    torch.testing.assert_close(got[2].sum(0), want[2].sum(0), **WIDE_PART_TOL)


@pytest.mark.parametrize("e", [520, 768])
@pytest.mark.parametrize("rows", [1, 65, 195])
def test_wide_rows_partials_are_64_row_tile_sums(rows, e):
    """The wide dx1 rows' dln2 partials: one row per 64-row tile, each the
    tile's column sums of dy2 * yhat2 and dy2, as the resident dx1 stage's."""
    rng = np.random.default_rng(rows + e)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)  # noqa: E731
                                     ).to(torch.bfloat16)
    dy2 = torch.from_numpy(rng.standard_normal((rows, e)).astype(np.float32))
    g, x1 = bf(rows, e), bf(rows, e)
    ln_s, ln_b = 1 + 0.1 * bf(e).float(), 0.1 * bf(e).float()
    dx1, da, y2, part = FB.bwd_dx1_rows_reference(dy2, g, None, x1, ln_s, ln_b)
    assert dx1.dtype == part.dtype == torch.float32 and da.dtype == y2.dtype == torch.bfloat16
    assert part.shape == (-(-rows // 64), 2 * e)
    yhat, _ = FB._ln_stats(x1.float(), 1e-5)
    cols = torch.cat([dy2 * yhat, dy2], 1)
    for i in range(part.shape[0]):
        torch.testing.assert_close(part[i], cols[64 * i:64 * (i + 1)].sum(0), rtol=0, atol=1e-4)


def test_stage_wrappers_refuse_tensors_off_the_cpu_and_cuda():
    """A tensor on neither the CPU nor CUDA is refused by each stage wrapper,
    never sent to a plain version or the build."""
    rows = torch.empty(34, 32, device="meta", dtype=torch.bfloat16)
    wide = torch.empty(34, 64, device="meta", dtype=torch.bfloat16)
    w = torch.empty(32, 64, device="meta")
    b = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FB.bwd_dz1_stage(rows, None, wide, w.T)
    with pytest.raises(ValueError, match="CUDA"):
        FB.bwd_dx1_stage(wide, rows, None, rows, w, b, b)
    with pytest.raises(ValueError, match="CUDA"):
        FB.bwd_dao_stage(rows, rows, w[:, :32], 2, 17, 2)


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_stage_wrappers_count_each_launch_and_no_refusal(monkeypatch, rate):
    """Each stage wrapper adds one to its kernel's count where it launches
    the kernel, megablock_bwd_mlp one call besides, and nothing is counted
    where a wrapper refuses its inputs: run on CPU tensors with the C entries
    replaced by a recorder and the CUDA check lifted."""
    launched = []

    def entry(name):
        def fn(*args):
            launched.append(name)
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(FB.build, "entry", entry)
    monkeypatch.setattr(FB.build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(FB, "_check_bwd", lambda what, *ts: None)
    monkeypatch.setattr(FB.build, "LAUNCHES", {k: 0 for k in FB.build.LAUNCHES})
    shape = dict(b=2, n=17, e=32, heads=2)
    g, m1, m2, x1, z1, ao = _half_inputs(shape, rate > 0)
    rng = np.random.default_rng(4)
    w1, w2, wout = (torch.from_numpy(rng.standard_normal(s, np.float32))
                    for s in ((32, 128), (128, 32), (32, 32)))
    ln = torch.ones(32)
    out = FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout, ln, ln, 2, 17, 2)
    assert out.dmlp is not g if rate else out.dmlp is g
    assert out.part.shape == (1, 64) and out.dao.shape == (2, 2, 17, 16)
    with pytest.raises(ValueError, match="fit"):
        FB.bwd_dz1_stage(g, m2, z1, w1)  # w2 must be (hidden, E)
    with pytest.raises(ValueError, match="fit"):
        FB.bwd_dao_stage(out.da, ao, wout, 3, 17, 2)  # 34 rows are not 3 x 17
    with pytest.raises(ValueError, match="multiple of 8"):
        FB.bwd_dao_stage(out.da, ao, wout, 2, 17, 8)  # Dh 4
    with pytest.raises(ValueError, match="both dropout masks"):
        FB.megablock_bwd_mlp(g, torch.ones(34, 32), None, x1, z1, ao, w1, w2, wout, ln, ln, 2,
                             17, 2)
    assert launched == ["megablock_bwd_mlp_dz1", "megablock_bwd_mlp_dx1", "megablock_bwd_mlp_dao"]
    assert {k: c for k, c in FB.build.LAUNCHES.items() if c} == {
        "megablock_bwd_mlp": 1, "megablock_bwd_mlp_dz1": 1, "megablock_bwd_mlp_dx1": 1,
        "megablock_bwd_mlp_dao": 1}


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_wide_wrappers_launch_the_wide_stages(monkeypatch, rate):
    """Forced wide (as E > 384 takes them), the MLP half launches the dmlp
    rows (with dropout), the streamed dz1, dy2 = dz1 . w1^T, the dx1 rows
    and the streamed dao, one each, and counts one megablock_bwd_mlp call;
    the LN1 half launches dy1 and the LN1 rows and no megablock_bwd_ln1.  C
    entries replaced by a recorder, the CUDA check lifted."""
    launched = []

    def entry(name):
        def fn(*args):
            launched.append(name)
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(FB.build, "entry", entry)
    monkeypatch.setattr(FB.build, "stream_ptr", lambda dev: None)
    monkeypatch.setattr(FB, "_check_bwd", lambda what, *ts: None)
    monkeypatch.setattr(FB.build, "LAUNCHES", {k: 0 for k in FB.build.LAUNCHES})
    shape = dict(b=2, n=17, e=32, heads=2)
    g, m1, m2, x1, z1, ao = _half_inputs(shape, rate > 0)
    rng = np.random.default_rng(4)
    w1, w2, wout = (torch.from_numpy(rng.standard_normal(s, np.float32))
                    for s in ((32, 128), (128, 32), (32, 32)))
    ln = torch.ones(32)
    out = FB.megablock_bwd_mlp(g, m1, m2, x1, z1, ao, w1, w2, wout, ln, ln, 2, 17, 2, wide=True)
    assert out.part.shape == (1, 64) and out.dao.shape == (2, 2, 17, 16)
    assert out.dmlp is not g if rate else out.dmlp is g
    qkv_w = torch.from_numpy(rng.standard_normal((3, 2, 32, 16), np.float32))
    dx, y1, part = FB.megablock_bwd_ln1(z1[:, :96], qkv_w, x1, out.dx1, ln, ln, wide=True)
    assert dx.shape == y1.shape == (34, 32) and part.shape == (1, 64)
    stages = (["megablock_bwd_mask_rows"] if rate else []) + [
        "megablock_bwd_mlp_dz1_wide", "megablock_bwd_dy", "megablock_bwd_mlp_dx1_rows",
        "megablock_bwd_mlp_dao_wide"]
    assert launched == stages + ["megablock_bwd_dy", "megablock_bwd_ln1_rows"]
    counts = {k: c for k, c in FB.build.LAUNCHES.items() if c}
    assert counts == {"megablock_bwd_mlp": 1, "megablock_bwd_dy": 2,
                      **{k: 1 for k in stages if k != "megablock_bwd_dy"},
                      "megablock_bwd_ln1_rows": 1}
