"""The on-chip layouts of the f32 k-block flash kernel, on the CPU.

csrc/flash_f32_bwd.cuh cannot run here.  Its shared-memory addressing is
written out below as the kernel computes it, and held to what it must do:

- the re-lay warpgroup (`relay_block`, `relay`) moves each landed Q and dO
  tile (TQ query rows of DP columns, 128-byte swizzled boxes of 32 columns,
  as TMA lands them) into d rows of TQ summed positions, the queries of each
  8-wide chunk in the order the accumulator hands P^T and dS^T to the TF32 A
  fragment (query 2u of the chunk at position u, 2u + 1 at u + 4), and the
  block's K (KEYS rows) into K^T with its keys in order.  Every 4 x 4 block
  is moved once, every element lands where the canonical K-major 128-byte
  swizzled B descriptor of dV += P^T dO, dK += dS^T Q and dQ = dS K reads
  it, and each quarter-warp's eight 16-byte loads, and its eight stores, lie
  at eight different 16-byte places of a 128-byte row (no bank conflict);
- the accumulator fragments the consumers hand to dV and dK as A (k8 step j,
  lane (g, t): columns 8 j + 2 t and + 1 of the chunk at fragment columns t
  and t + 4) meet the re-laid rows' positions;
- the consumers' dS stores into the [query][key] buffer that dQ = dS K reads
  as its K-major A operand are conflict-free and land where it reads them.

Each (DP, tile) the kernel instantiates: DP 32 and 64 with 64-query tiles
and 128-key blocks, DP 96 and 128 with 32-query tiles and 64-key blocks
(ops/attention.F32_BLOCK_KEYS, F32_TILE_QUERIES).
"""

import numpy as np
import pytest

from vitgan_tpu_torch.ops import attention as A

DPS = (32, 64, 96, 128)


def tile_of(dp: int) -> int:
    return A.F32_TILE_QUERIES[dp]


def keys_of(dp: int) -> int:
    return A.F32_BLOCK_KEYS[dp]


def relay_block(s: int, lane8: int, rows: int, perm: bool) -> tuple:
    """The kernel's `relay_block`: (p, c) of the 4 x 4 block that lane
    ``lane8`` of a quarter-warp moves in its step ``s``."""
    pg = rows // 32
    p = 8 * (s % pg) + lane8
    c0 = s // pg
    return p, (c0 ^ (lane8 & 6)) if perm else (c0 ^ lane8)


def block_rows(p: int, perm: bool) -> list:
    """The landed rows (queries or keys) of position chunk p, j = 0 .. 3."""
    if perm:
        return [8 * (p >> 1) + 2 * j + (p & 1) for j in range(4)]
    return [4 * p + j for j in range(4)]


def relay_offsets(s: int, lane8: int, rows: int, dp: int, perm: bool) -> tuple:
    """(p, c, loads, stores) as the kernel's `relay` addresses them: loads[j]
    the landed byte offset of row block_rows(p)[j]'s chunk of columns 4 c ..
    4 c + 3; stores[ii] the re-laid byte offset of row 4 c + ii's chunk of
    positions 4 p .. 4 p + 3."""
    p, c = relay_block(s, lane8, rows, perm)
    loads = [(c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4)
             for r in block_rows(p, perm)]
    stores = [(p >> 3) * dp * 128 + i * 128 + (((p & 7) ^ (i & 7)) << 4)
              for i in range(4 * c, 4 * c + 4)]
    return p, c, loads, stores


def steps_of(qw: int, rows: int, dp: int) -> list:
    """The steps quarter-warp ``qw`` (0 .. 15) of the re-lay warpgroup takes."""
    return list(range(qw, rows // 32 * (dp // 4), 16))


def landed(x: np.ndarray) -> np.ndarray:
    """A (rows, DP) operand as TMA lands it: DP / 32 boxes of rows x 32
    floats, 128-byte rows, 16-byte chunk c of row r at chunk c ^ r % 8."""
    rows, dp = x.shape
    out = np.zeros(rows * dp, np.float32)
    for r in range(rows):
        for col in range(dp):
            byte = (col // 32) * rows * 128 + r * 128 + (((col % 32) // 4) ^ (r % 8)) * 16
            out[byte // 4 + col % 4] = x[r, col]
    return out


def kmajor_read(buf: np.ndarray, nrows: int, depth: int) -> np.ndarray:
    """A K-major operand of nrows rows and `depth` summed values as the
    canonical 128-byte-swizzled descriptor reads it (boxes of nrows x 32,
    k8 step kk at box kk // 4, 32 bytes a step): element (row, k)."""
    out = np.empty((nrows, depth), np.float32)
    for row in range(nrows):
        for k in range(depth):
            byte = (k // 32) * nrows * 128 + row * 128 + ((((k % 32) // 4) ^ (row % 8)) << 4)
            out[row, k] = buf[byte // 4 + k % 4]
    return out


def position_query(pos: int) -> int:
    """The query a re-laid position holds: 2u at u, 2u + 1 at u + 4 within
    each 8-wide chunk."""
    u = pos % 8
    return pos - u + 2 * (u % 4) + u // 4


def run_relay(x: np.ndarray, perm: bool) -> tuple:
    """The re-lay warpgroup's 16 quarter-warps on landed(x): the re-laid
    buffer and the blocks moved, as a list."""
    rows, dp = x.shape
    src = landed(x)
    dst = np.full(rows * dp, np.nan, np.float32)
    moved = []
    for qw in range(16):
        for s in steps_of(qw, rows, dp):
            for lane8 in range(8):
                p, c, loads, stores = relay_offsets(s, lane8, rows, dp, perm)
                moved.append((p, c))
                block = np.stack([src[ld // 4:ld // 4 + 4] for ld in loads])  # [j][ii]
                for ii, st in enumerate(stores):
                    dst[st // 4:st // 4 + 4] = block[:, ii]
    return dst, moved


def relay_cases():
    for dp in DPS:
        yield dp, tile_of(dp), True
        yield dp, keys_of(dp), False


@pytest.mark.parametrize("dp,rows,perm", list(relay_cases()),
                         ids=[f"dp{dp}_{'q' if perm else 'kt'}" for dp, _, perm in relay_cases()])
def test_relay_moves_every_block_once_where_the_descriptor_reads_it(dp, rows, perm):
    """Every (position chunk, column chunk) block is moved once, and the
    re-laid operand read as the B descriptor reads it is the landed tile
    transposed: Q and dO with each chunk's queries in the fragment's order,
    K^T with its keys in order."""
    x = np.random.default_rng(dp + rows).standard_normal((rows, dp)).astype(np.float32)
    dst, moved = run_relay(x, perm)
    assert sorted(moved) == [(p, c) for p in range(rows // 4) for c in range(dp // 4)]
    got = kmajor_read(dst, dp, rows)  # [d][position]
    order = [position_query(pos) if perm else pos for pos in range(rows)]
    np.testing.assert_array_equal(got, x[order].T)


@pytest.mark.parametrize("dp,rows,perm", list(relay_cases()),
                         ids=[f"dp{dp}_{'q' if perm else 'kt'}" for dp, _, perm in relay_cases()])
def test_relay_is_free_of_bank_conflicts(dp, rows, perm):
    """Each quarter-warp's eight 16-byte loads (one a lane, the same j) and
    its eight stores (the same ii) of every step fall on eight different
    16-byte places of a 128-byte row."""
    for qw in range(16):
        for s in steps_of(qw, rows, dp):
            offs = [relay_offsets(s, lane8, rows, dp, perm) for lane8 in range(8)]
            for side in (2, 3):
                for j in range(4):
                    assert len({o[side][j] % 128 // 16 for o in offs}) == 8, (qw, s, side, j)


@pytest.mark.parametrize("dp", DPS)
def test_accumulator_fragments_meet_the_relaid_positions(dp):
    """The A fragment of k8 step j that lane (g, t) hands to dV and dK from
    its S^T / dS^T accumulator chunk j (a0 = c0, a1 = c2, a2 = c1, a3 = c3:
    queries 8 j + 2 t and + 1 at fragment columns t and t + 4) multiplies
    the B rows' positions 8 j + t and 8 j + t + 4, which hold those queries;
    so the product sums P^T[key][query] dO[query][d] over every query once."""
    tq = tile_of(dp)
    rng = np.random.default_rng(dp)
    pt = rng.standard_normal((64, tq)).astype(np.float32)       # P^T [key][query]
    do = rng.standard_normal((tq, dp)).astype(np.float32)       # dO [query][d]
    dst, _ = run_relay(do, True)
    b = kmajor_read(dst, dp, tq)                                # [d][position]
    out = np.zeros((64, dp), np.float64)
    for j in range(tq // 8):
        for wr in range(4):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    key = 16 * wr + g + 8 * h
                    # accumulator c[e] = (key row g + 8 (e >> 1), query 8 j + 2 t + (e & 1))
                    acc = [pt[16 * wr + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)]
                           for e in range(4)]
                    frag = [acc[0], acc[2], acc[1], acc[3]]  # a0 .. a3
                    # a0 / a2: row g at columns t / t + 4; a1 / a3: row g + 8
                    for col, val in ((t, frag[h]), (t + 4, frag[h + 2])):
                        out[key] += val * b[:, 8 * j + col]
    np.testing.assert_allclose(out, pt.astype(np.float64) @ do, rtol=1e-5, atol=1e-5)


def ds_store_offset(w: int, wr: int, lane: int, h: int, j: int, e: int) -> tuple:
    """(query, key, byte offset) of the dS value that consumer warpgroup w's
    lane (g, t) of warp wr stores for accumulator row h, chunk j, column e,
    as the kernel's dS store addresses it (32-key boxes of 64 query rows)."""
    g, t = lane >> 2, lane & 3
    kr = 64 * w + 16 * wr + g + 8 * h
    qi = 8 * j + 2 * t + e
    off = (kr >> 5) * 64 * 128 + 4 * (kr & 3) + qi * 128 + ((((kr & 31) >> 2) ^ (qi & 7)) << 4)
    return qi, kr, off


@pytest.mark.parametrize("dp", DPS)
def test_ds_stores_are_conflict_free_and_land_where_dq_reads(dp):
    """Each warp's 32 four-byte dS stores (one (h, j, e) at a time) hit 32
    different banks, and the buffer read as dQ = dS K's K-major A operand
    (64 query rows, the block's keys summed) is dS[query][key]."""
    tq, keys = tile_of(dp), keys_of(dp)
    ds = np.random.default_rng(dp).standard_normal((tq, keys)).astype(np.float32)
    buf = np.zeros(keys // 32 * 64 * 32, np.float32)
    for w in range(keys // 64):
        for wr in range(4):
            for h in range(2):
                for j in range(tq // 8):
                    for e in range(2):
                        stores = [ds_store_offset(w, wr, lane, h, j, e) for lane in range(32)]
                        assert len({off % 128 // 4 for _, _, off in stores}) == 32
                        for qi, kr, off in stores:
                            buf[off // 4] = ds[qi, kr]
    got = kmajor_read(buf, 64, keys)
    np.testing.assert_array_equal(got[:tq], ds)
    assert not got[tq:].any()  # the rows past a 32-query tile stay zero


def test_blocks_and_tiles_follow_the_padded_width():
    """128 keys a block and 64-query tiles at DP <= 64, 64 and 32 above; a
    block's keys are 64 a consumer warpgroup, a tile a whole number of
    32-position re-laid boxes."""
    for dp in DPS:
        assert keys_of(dp) == (128 if dp <= 64 else 64)
        assert tile_of(dp) == (64 if dp <= 64 else 32)
        assert keys_of(dp) % 64 == 0 and tile_of(dp) % 32 == 0
