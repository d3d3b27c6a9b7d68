"""Host-side planning of the Hopper weight-gradient kernel, and the CPU route
of ``wgrad()`` and ``flash_backward()`` against the JAX package.

csrc/wgrad_gemm.cu cannot run here; what it reads from the host is planned
in Python (ops/wgrad.py): the rows a split sums (``plan``) and the scratch
layout (``scratch_floats``).  These tests hold that plan to the ranges and
offsets the C entry forms from it (its arithmetic, written out here), the
f32 kernel's unit order (``units``) to what it must cover, its on-chip
addressing (the re-lay of B and the A-fragment loads of
csrc/wgrad_gemm_f32.cu, written out here as ``relay_chunks``, ``reg_a_col``
and ``a_fragment_offsets``) to its layouts and banks, and the plain versions
that CPU tensors take to the JAX package at 1e-5 in f32.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.ops.attention import _flash_backward, _flash_forward
from vitgan_tpu.ops.policy import set_policy as jax_set_policy
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.ops import wgrad as WG

TOL = dict(rtol=1e-5, atol=1e-5)
# (Ka, Nb) of one block backward's four products at highres128's widths
# (E 384, hidden 1536) and deit64's (E 192, hidden 768)
PAIRS = ((1536, 384), (384, 1536), (384, 384), (384, 1152),
         (768, 192), (192, 768), (192, 192), (192, 576))
ROWS = {"G": 32 * 1024, "D": 64 * 1025, "ragged": 2 * 257, "one_stage": 64}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)
    jax_set_policy(bwd_fusion="auto")


# csrc/wgrad_gemm_f32.cu's on-chip layouts, its addressing written out: a
# 32-row stage of an operand lands as four 32-column boxes of 32 rows
# (128-byte rows, 16-byte chunk c of row r at chunk c ^ r % 8); B's is
# re-laid K-major as one box of 128 rows of 32 summed values (the same
# swizzle, its `relay`), A's read into registers as it landed.
F32_STAGE_ROWS = 32
LANDED_BOX = F32_STAGE_ROWS * 32 * 4


def relay_chunks(wq: int, lane: int, h: int) -> tuple:
    """The 4 x 4 block lane ``lane`` of re-lay warp ``wq`` moves in its step
    ``h`` (0 or 1), as the kernel's `relay` addresses it: (c, q, loads,
    stores), where loads[j] is the landed byte offset of row 4 c + j's chunk
    of columns 4 q .. 4 q + 3, and stores[j] the re-laid byte offset of row
    4 q + j's chunk of summed rows 4 c .. 4 c + 3 (column j of the block read
    across)."""
    q, c = lane, (lane & 7) ^ (2 * wq + h)
    loads = [(q >> 3) * LANDED_BOX + k * 128 + (((q & 7) ^ (k & 7)) << 4)
             for k in range(4 * c, 4 * c + 4)]
    stores = [i * 128 + ((c ^ (i & 7)) << 4) for i in range(4 * q, 4 * q + 4)]
    return c, q, loads, stores


def reg_a_col(wr: int, g: int, h: int) -> int:
    """The kernel's `reg_a_col`: the column of A (of a consumer warpgroup's
    64) whose output row the accumulator rows 16 wr + g + 8 h of warp wr's
    lane (g = lane // 4) hold, permuted so that a warp's A-fragment loads hit
    32 different banks."""
    return 32 * (wr >> 1) + 16 * (g >> 2) + 8 * (wr & 1) + 4 * h + (g & 3)


def a_fragment_offsets(w: int, wr: int, lane: int) -> list:
    """The landed byte offsets of the words a0 .. a3 (the mma.m16n8k8 TF32 A
    fragment: rows h = 0, 1, 0, 1 at summed rows t, t, t + 4, t + 4, t =
    lane % 4) that lane ``lane`` of warp ``wr`` of consumer warpgroup ``w``
    reads at the first k8 step of a stage, as the kernel's `aoff` addresses
    them; step kk adds 1024 (eight rows)."""
    g, t = lane >> 2, lane & 3
    off = []
    for h in (0, 1):
        col = 64 * w + reg_a_col(wr, g, h)
        off.append((col >> 5) * LANDED_BOX + t * 128 + ((((col & 31) >> 2) ^ t) << 4)
                   + 4 * (col & 3))
    return [off[0], off[1], (off[0] ^ 64) + 512, (off[1] ^ 64) + 512]



def _entry_ranges(m, rps):
    """The [r0, r1) rows of each split, in split order, as csrc/wgrad_gemm.cu
    forms them: splits = ceil(m / rps), split s sums [s rps, min(m, (s+1) rps))."""
    return [(s * rps, min(m, (s + 1) * rps)) for s in range(math.ceil(m / rps))]


def _blocks(m, ka, nb, rps):
    return WG.row_tiles(ka) * math.ceil(nb / WG.TILE) * len(_entry_ranges(m, rps))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 514, 4097, 32768, 65600])
@pytest.mark.parametrize("ka,nb", [(1536, 384), (384, 384), (72, 136), (8, 8)])
def test_row_splits_cover_every_row_once_in_order(m, ka, nb):
    """The ranges the C entry cuts from the plan tile [0, m) in split order,
    each a whole number of 64-row stages but the last, none empty."""
    rps = WG.plan(m, ka, nb)
    ranges = _entry_ranges(m, rps)
    assert rps % WG.STAGE_ROWS == 0 and rps >= WG.STAGE_ROWS
    assert ranges[0][0] == 0 and ranges[-1][1] == m
    for (a0, a1), (b0, _) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a1 - a0 == rps
    assert all(r1 > r0 for r0, r1 in ranges)


@pytest.mark.parametrize("m", [64, 1000, 32768, 65600])
@pytest.mark.parametrize("ka,nb", [(1536, 384), (384, 1152), (72, 136)])
def test_scratch_holds_every_partial_the_entry_indexes(m, ka, nb):
    """The C entry writes dW partial (split, i, j) at split * ka * nb + i * nb
    + j, then db partial (split, row tile, j) at splits * ka * nb + (split *
    row_tiles + tile) * nb + j; the reduce pass reads the same.  The last of
    each fits the scratch exactly."""
    rps = WG.plan(m, ka, nb)
    splits = len(_entry_ranges(m, rps))
    size = WG.scratch_floats(m, ka, nb, rps)
    last_dw = (splits - 1) * ka * nb + (ka - 1) * nb + nb - 1
    tiles = WG.row_tiles(ka)
    last_db = splits * ka * nb + ((splits - 1) * tiles + tiles - 1) * nb + nb - 1
    assert last_dw < splits * ka * nb <= last_db < size == last_db + 1
    # four f32 a thread in the reduce pass: both regions start 16-byte aligned
    assert (ka * nb) % 4 == 0 and (splits * ka * nb) % 4 == 0 and nb % 4 == 0


@pytest.mark.parametrize("ka,nb", PAIRS)
@pytest.mark.parametrize("label", ["G", "D"])
def test_plan_fills_the_card_at_the_train_step_shapes(label, ka, nb):
    """At G's and D's rows every product's blocks fill at least 80% of the
    waves they take on 132 SMs (one block an SM)."""
    m = ROWS[label]
    blocks = _blocks(m, ka, nb, WG.plan(m, ka, nb))
    waves = math.ceil(blocks / WG.SMS)
    assert blocks / (waves * WG.SMS) >= 0.8, (blocks, waves)


@pytest.mark.parametrize("ka,nb", PAIRS[:4])
@pytest.mark.parametrize("label", ["ragged", "one_stage"])
def test_plan_at_few_rows_takes_one_wave_of_non_empty_blocks(label, ka, nb):
    """Where the rows cannot fill the card (2 x 257 rows, 64 rows) the plan
    takes one wave, every block sums at least one stage, and a single stage
    is not split."""
    m = ROWS[label]
    rps = WG.plan(m, ka, nb)
    splits = len(_entry_ranges(m, rps))
    assert _blocks(m, ka, nb, rps) <= WG.SMS
    assert splits <= math.ceil(m / WG.STAGE_ROWS)
    if m <= WG.STAGE_ROWS:
        assert splits == 1 and rps == WG.STAGE_ROWS


def test_plan_splits_further_on_a_wider_card():
    """The multiprocessor count is an input: more SMs, more row splits."""
    m, ka, nb = ROWS["G"], 384, 384
    assert WG.plan(m, ka, nb, sms=264) < WG.plan(m, ka, nb)


@pytest.mark.parametrize("m", [1, 64, 514, 32768, 65600])
@pytest.mark.parametrize("ka,nb", [(1536, 384), (384, 1152), (72, 136), (8, 8)])
def test_f32_units_write_every_partial_once(m, ka, nb):
    """csrc/wgrad_gemm_f32.cu's persistent blocks (ops/wgrad.units) take every
    (split, row tile, column tile) unit once, at most one block an SM;
    their dW partials cover each (split, i, j) under ka and nb once, their
    db partial rows each (split * row_tiles + row tile, j) once, and the
    row tiles of a split sum each of its 32-row stages into db once.  A
    stage never holds another split's rows."""
    rps = WG.plan(m, ka, nb)
    splits, tiles = len(_entry_ranges(m, rps)), WG.row_tiles(ka)
    nbt = math.ceil(nb / WG.TILE)
    blocks = WG.units(m, ka, nb, rps)
    taken = [u for b in blocks for u in b]
    assert len(blocks) == min(len(taken), WG.SMS) and all(blocks)
    assert sorted(taken) == [(s, y, x) for s in range(splits) for y in range(tiles)
                             for x in range(nbt)]
    dw = np.zeros((splits, ka, nb), np.int32)
    dbp = np.zeros((splits * tiles, nb), np.int32)
    summed = {s: np.zeros(math.ceil((min(m, (s + 1) * rps) - s * rps) / F32_STAGE_ROWS),
                          np.int32) for s in range(splits)}
    for s, y, x in taken:
        rows, cols = slice(y * WG.TILE, (y + 1) * WG.TILE), slice(x * WG.TILE, (x + 1) * WG.TILE)
        dw[s, rows, cols] += 1
        dbp[s * tiles + y, cols] += 1
        if x == 0:
            summed[s][y::tiles] += 1
    assert (dw == 1).all() and (dbp == 1).all()
    assert all((c == 1).all() for c in summed.values())
    assert rps % F32_STAGE_ROWS == 0


@pytest.mark.parametrize("sms", [1, 114, 264])
def test_f32_units_follow_the_card_s_sms(sms):
    """On a card of another SM count (the wrapper reads the card's) the
    persistent grid is min(units, sms) blocks, block b takes units b, b +
    grid, ... in increasing order, and every unit is taken once."""
    m, ka, nb = ROWS["D"], 384, 1152
    rps = WG.plan(m, ka, nb, sms)
    blocks = WG.units(m, ka, nb, rps, sms)
    tiles = WG.row_tiles(ka) * math.ceil(nb / WG.TILE)
    total = tiles * len(_entry_ranges(m, rps))
    assert len(blocks) == min(total, sms)
    order = [[s * tiles + y * math.ceil(nb / WG.TILE) + x for s, y, x in b] for b in blocks]
    assert all(o == list(range(b, total, len(blocks))) for b, o in enumerate(order))
    assert sorted(u for o in order for u in o) == list(range(total))


def test_f32_units_run_a_split_s_tiles_together():
    """The blocks that run at once take neighbouring units: at G's dWqkv the
    first wave spans at most two splits (their rows shared in L2)."""
    m, ka, nb = ROWS["G"], 384, 1152
    blocks = WG.units(m, ka, nb, WG.plan(m, ka, nb))
    tiles = WG.row_tiles(ka) * math.ceil(nb / WG.TILE)
    assert len({b[0][0] for b in blocks}) <= math.ceil(len(blocks) / tiles) + 1


@pytest.mark.parametrize("wq", range(4))
@pytest.mark.parametrize("h", range(2))
def test_f32_relay_is_free_of_bank_conflicts(wq, h):
    """Each quarter-warp's eight 16-byte loads, and its eight stores, of one
    re-lay step lie at eight different 16-byte places of a 128-byte row
    (shared memory serves them in one pass)."""
    for quarter in range(4):
        for j in range(4):
            for side in (2, 3):
                places = {relay_chunks(wq, lane, h)[side][j] % 128 // 16
                          for lane in range(8 * quarter, 8 * quarter + 8)}
                assert len(places) == 8, (quarter, j, side)


@pytest.mark.parametrize("seed", range(3))
def test_f32_relay_lays_the_landed_stage_k_major(seed):
    """Every (row chunk, column chunk) block is moved once by the re-lay
    warpgroup, and the re-laid box read as the canonical K-major 128-byte
    swizzled operand (tile_f32.cuh's) is the landed stage transposed: the
    landed stage written as TMA writes four 32-column boxes of 32 rows, the
    blocks moved and transposed as the kernel's lanes move them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F32_STAGE_ROWS, 128)).astype(np.float32)
    landed = _landed(x)
    relaid = np.full(128 * F32_STAGE_ROWS, np.nan, np.float32)
    moved = set()
    for wq in range(4):
        for lane in range(32):
            for h in range(2):
                c, q, loads, stores = relay_chunks(wq, lane, h)
                moved.add((c, q))
                block = np.stack([landed[ld // 4:ld // 4 + 4] for ld in loads])  # [k][i]
                for j, st in enumerate(stores):
                    relaid[st // 4:st // 4 + 4] = block[:, j]
    assert moved == {(c, q) for c in range(8) for q in range(32)}
    got = np.empty((128, F32_STAGE_ROWS), np.float32)
    for i in range(128):
        for k in range(F32_STAGE_ROWS):
            got[i, k] = relaid[(i * 128 + (((k // 4) ^ (i % 8)) * 16)) // 4 + k % 4]
    np.testing.assert_array_equal(got, x.T)


def _landed(x):
    """A (32, 128) stage as TMA lands it: four 32-column boxes of 32 rows,
    128-byte rows, 16-byte chunk c of row k at chunk c ^ k % 8, as floats."""
    landed = np.zeros(4 * LANDED_BOX // 4, np.float32)
    for k in range(F32_STAGE_ROWS):
        for col in range(128):
            byte = (col // 32) * LANDED_BOX + k * 128 + (((col % 32) // 4) ^ (k % 8)) * 16
            landed[byte // 4 + col % 4] = x[k, col]
    return landed


def test_f32_a_fragment_rows_are_a_permutation():
    """The consumers' accumulator rows (16 wr + g + 8 h) stand for A's
    columns one to one within each warpgroup's 64."""
    cols = sorted(reg_a_col(wr, g, h) for wr in range(4) for g in range(8) for h in range(2))
    assert cols == list(range(64))


@pytest.mark.parametrize("w", range(2))
@pytest.mark.parametrize("wr", range(4))
def test_f32_a_fragment_loads_are_free_of_bank_conflicts(w, wr):
    """Each of a warp's four A-fragment loads of a k8 step reads 32 words
    in 32 different banks."""
    for j in range(4):
        banks = {a_fragment_offsets(w, wr, lane)[j] % 128 // 4 for lane in range(32)}
        assert len(banks) == 32, j


@pytest.mark.parametrize("seed", range(2))
def test_f32_a_fragments_read_the_landed_stage(seed):
    """The words each lane reads at each k8 step are the mma.m16n8k8 TF32 A
    fragment of its accumulator rows: a0 (row g, k t), a1 (g + 8, t), a2 (g,
    t + 4), a3 (g + 8, t + 4), row r standing for A's column 64 w +
    reg_a_col, k the stage's summed row 8 kk + ..."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((F32_STAGE_ROWS, 128)).astype(np.float32)
    landed = _landed(x)
    for w in range(2):
        for wr in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                offs = a_fragment_offsets(w, wr, lane)
                for kk in range(F32_STAGE_ROWS // 8):
                    for j, (h, dk) in enumerate(((0, 0), (1, 0), (0, 4), (1, 4))):
                        want = x[8 * kk + t + dk, 64 * w + reg_a_col(wr, g, h)]
                        assert landed[(offs[j] + 1024 * kk) // 4] == want


@pytest.mark.parametrize("m,ka,nb", [(96, 24, 40), (257, 16, 48), (0, 8, 8)])
def test_cpu_wgrad_takes_the_plain_route_and_matches_jax(monkeypatch, m, ka, nb):
    """wgrad() of CPU tensors never reaches the build and gives what jax.vjp
    of the dense layer x . W + b gives for W and b under cotangent B."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "entry", refuse)
    rng = np.random.default_rng(m + ka)
    a = rng.standard_normal((m, ka)).astype(np.float32)
    b = rng.standard_normal((m, nb)).astype(np.float32)
    dw, db = WG.wgrad(torch.from_numpy(a), torch.from_numpy(b))
    _, vjp = jax.vjp(lambda w, bias: jnp.asarray(a) @ w + bias,
                     jnp.zeros((ka, nb), jnp.float32), jnp.zeros((nb,), jnp.float32))
    want_w, want_b = vjp(jnp.asarray(b))
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_w), **TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_b), **TOL)


@pytest.mark.parametrize("n", [64, 65])
@pytest.mark.parametrize("fusion", ["fused", "two_pass"])
def test_cpu_flash_backward_takes_the_plain_route_and_matches_jax(monkeypatch, fusion, n):
    """flash_backward() of CPU tensors on either route never reaches the
    build and matches the JAX `_flash_backward` kernels (interpret mode) of
    the same route on the JAX forward's o and LSE."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "entry", refuse)
    rng = np.random.default_rng(n)
    q, k, v, g = (rng.standard_normal((1, 2, n, 16)).astype(np.float32) for _ in range(4))
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = _flash_forward(jq, jk, jv, "dot", 16.0, 64, 64, True, with_lse=True)
    jax_set_policy(bwd_fusion=fusion)
    policy.set_policy(bwd_fusion=fusion)
    want = _flash_backward(jq, jk, jv, o, lse, jg, "dot", 16.0, 64, 64, True)
    got = A.flash_backward(*map(torch.from_numpy, (q, k, v, np.array(o), np.array(lse), g)),
                           16.0)
    for name, x, y in zip("qkv", got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **TOL, err_msg=f"d{name}")
