"""The `dot` flash forward's plain version at the edges of the Hopper kernel
(csrc/flash_attn_fwd.cu), and the order of the single pass's dQ additions
(csrc/flash_attn_bwd.cuh), on the CPU.

- attention_forward_reference (o and the LSE) against the JAX
  `_flash_forward` in interpret mode at N in {1, 32, 63, 65, 129} (one row,
  the v1 generator's 32 tokens, both sides of the kernel's 64-row
  warpgroups, past its 128-key tiles) and Dh in {16, 64, 96, 128} (one and
  two 64-column boxes, 64- and 128-key tiles);
- ops/attention.fused_dq_schedule, the grid order and the rule the
  single-pass kernels' key blocks wait by: every key block waits on a lower
  linear index, and each block (`dot`) or persistent block's unit (`l2`, one
  or two consecutive key blocks) takes its linear index from the launch's
  ticket (the count of units started before it), not from blockIdx.  A
  simulation of dispatch at G's and D's `dot` grids and at the `l2` ragged
  shape (Dh 108: units of one 64-key block; Dh 64: of two) shows that every
  block finishes and that each (head, tile) receives its key blocks'
  additions in one fixed order: dispatched in order onto one and two
  resident blocks on each of 132 SMs, and dispatched in order, in reverse and
  in a seeded random order onto fewer slots than a head's units.  Taking the
  index from blockIdx instead, the reversed dispatch deadlocks (the hazard
  the ticket removes).

Tolerance: 1e-5 absolute and relative, f32 on both sides (JAX at 'highest'
matmul precision, tests/conftest.py); the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.ops.attention import _flash_forward
from vitgan_tpu_torch.ops import attention as A

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_N = (1, 32, 63, 65, 129)
EDGE_DH = (16, 64, 96, 128)
SMS = 132  # an H100's streaming multiprocessors


def qkv(n, dh, seed=0, k=3):
    """k f32 arrays of (1, 2, n, dh): B*H = 2."""
    rng = np.random.default_rng(seed + 1000 * n + dh)
    return [(0.5 * rng.standard_normal((1, 2, n, dh))).astype(np.float32) for _ in range(k)]


@pytest.mark.parametrize("dh", EDGE_DH)
@pytest.mark.parametrize("n", EDGE_N)
def test_plain_forward_matches_jax_kernel_at_kernel_edges(n, dh):
    q, k, v = qkv(n, dh)
    scale = float(dh)
    jo, jlse = _flash_forward(*map(jnp.asarray, (q, k, v)), "dot", scale, 128, 128, True,
                              with_lse=True)
    o, lse = A.attention_forward_reference(*map(torch.from_numpy, (q, k, v)), scale)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **TOL)


def units_of(plan: A.FusedSchedule) -> list:
    """The units of ``plan`` in ticket order: runs of plan.unit_blocks
    consecutive key blocks of a head (one block each for `dot`), as lists of
    linear indices."""
    per = plan.unit_blocks
    return sorted([plan.index(kb, head) for kb in range(kb0, min(kb0 + per, plan.k_blocks))]
                  for head in range(plan.batch_heads) for kb0 in range(0, plan.k_blocks, per))


def simulate(plan: A.FusedSchedule, slots: int, order=None, ticket: bool = True) -> dict:
    """Units of ``plan`` (by dispatch id: blockIdx for `dot`, a persistent
    block's turn for `l2`) dispatched in ``order`` (default: id order) onto
    ``slots`` resident places.  A unit that starts takes its place from the
    ticket, the count of units started before it, as the kernels do; with
    ``ticket`` False, from its id.  Each tick every key block of a resident
    unit tries to add its next tile's dQ: it may when plan.waits_on(index) is
    None or that block has added the tile already.  A unit whose blocks have
    added all their tiles leaves its slot to the next unit in ``order``.
    Returns {"finished": key blocks done, "deadlock": True if a tick moved
    nothing while blocks were left, "adds": {(head, tile): [k-block, ...] in
    the order the additions happened}}."""
    units = units_of(plan)
    order = list(range(len(units))) if order is None else list(order)
    done_tiles = [0] * (plan.k_blocks * plan.batch_heads)
    queue, resident = iter(order), []
    adds: dict = {}
    finished = 0
    started = iter(range(len(units)))  # the ticket

    def start(into: list) -> None:
        """The next unit in ``order`` starts, into ``into`` by its place."""
        unit = next(queue, None)
        if unit is not None:
            into.append(units[next(started) if ticket else unit])

    for _ in range(slots):
        start(resident)
    while resident:
        moved = []
        for unit in resident:
            for blk in unit:
                pred = plan.waits_on(blk)
                if done_tiles[blk] < plan.q_tiles and (
                        pred is None or done_tiles[pred] > done_tiles[blk]):
                    moved.append(blk)
        if not moved:
            return {"finished": finished, "deadlock": True, "adds": adds}
        for blk in moved:  # every block that may add this tick adds its tile
            kb, head = plan.coords(blk)
            adds.setdefault((head, done_tiles[blk]), []).append(kb)
            done_tiles[blk] += 1
        left: list = []
        for unit in resident:
            if all(done_tiles[blk] == plan.q_tiles for blk in unit):
                finished += len(unit)
                start(left)
            else:
                left.append(unit)
        resident = left
    return {"finished": finished, "deadlock": False, "adds": adds}


@pytest.mark.parametrize("resident", [1, 2])
@pytest.mark.parametrize("grid", [("G", 1024, 32 * 6), ("D", 1025, 64 * 6)], ids=["G", "D"])
def test_in_order_dispatch_finishes_every_block_in_key_block_order(grid, resident):
    _, n, bh = grid
    plan = A.fused_dq_schedule(n, bh, "dot")
    assert (plan.k_blocks, plan.q_tiles) == (-(-n // 128), -(-n // 64))
    total = plan.k_blocks * bh
    assert sorted(plan.index(*plan.coords(i)) for i in range(total)) == list(range(total))
    assert all(plan.waits_on(i) is None or plan.waits_on(i) < i for i in range(total))
    res = simulate(plan, SMS * resident)
    assert not res["deadlock"]
    assert res["finished"] == plan.k_blocks * bh
    assert len(res["adds"]) == bh * plan.q_tiles
    assert all(kbs == list(range(plan.k_blocks)) for kbs in res["adds"].values())


@pytest.mark.parametrize("dispatch", ["in_order", "reversed", "random"])
@pytest.mark.parametrize("grid", [("G", 1024, 32 * 6, "dot", 64), ("D", 1025, 64 * 6, "dot", 64),
                                  ("l2", 1025, 16, "l2", 108), ("l2_dh64", 1025, 16, "l2", 64)],
                         ids=["G", "D", "l2", "l2_dh64"])
def test_the_ticket_finishes_any_dispatch_order(grid, dispatch):
    """The rule needs the waited-on block resident or finished.  With each
    unit's place taken from the ticket, every dispatch order finishes, onto
    fewer slots than a head's units, and adds every tile in key-block order
    (an `l2` unit of two key blocks adds them in warpgroup order).
    Dispatched in reverse with the place taken from the dispatch id (the rule
    before the ticket), every slot holds a unit whose predecessor never
    starts."""
    _, n, bh, mode, d = grid
    plan = A.fused_dq_schedule(n, bh, mode, d)
    assert plan.unit_blocks == (2 if mode == "l2" and d == 64 else 1)
    total = plan.k_blocks * bh
    units = len(units_of(plan))
    slots = -(-plan.k_blocks // plan.unit_blocks) - 1  # fewer than a head's units
    order = {"in_order": range(units), "reversed": reversed(range(units)),
             "random": np.random.default_rng(11).permutation(units)}[dispatch]
    res = simulate(plan, slots, order=order)
    assert not res["deadlock"] and res["finished"] == total
    assert len(res["adds"]) == bh * plan.q_tiles
    assert all(kbs == list(range(plan.k_blocks)) for kbs in res["adds"].values())
    if dispatch == "reversed":
        res = simulate(plan, slots, order=reversed(range(units)), ticket=False)
        assert res["deadlock"] and res["finished"] == 0


def test_fused_schedule_sizes_the_wrapper_buffers():
    """The grid and the buffer of flags and ticket of the single pass at the
    main path's shapes: G (1,024 tokens: a flag per (head, tile), then the
    ticket), the v1 generator (32 tokens, one k-block: no flags, no ticket),
    the v1 discriminator's `l2` 50 tokens (64 keys a block: one k-block) and
    the `l2` ragged and wide shapes (units of one and two key blocks)."""
    g = A.fused_dq_schedule(1024, 192, "dot")
    assert (g.k_blocks, g.q_tiles, g.group_heads) == (8, 16, 32)
    assert (g.ticket, g.flags) == (192 * 16, (192 * 16 + 1,))
    # groups of 32 heads, k-block slowest: block (kb, h) waits 32 indices back
    assert [g.coords(i) for i in (0, 1, 32, 33, 255, 256)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (7, 31), (0, 32)]
    assert [g.waits_on(i) for i in (0, 31, 32, 33, 256, 288)] == [None, None, 0, 1, None, 256]
    ragged = A.fused_dq_schedule(1024, 40, "dot")  # a last group of 8 heads
    assert ragged.coords(256) == (0, 32) and ragged.coords(264) == (1, 32)
    assert ragged.waits_on(264) == 256
    v1 = A.fused_dq_schedule(32, 512, "dot")
    assert (v1.k_blocks, v1.q_tiles, v1.flags, v1.ticket) == (1, 1, (0,), None)
    assert v1.waits_on(5) is None
    d_l2 = A.fused_dq_schedule(50, 1024, "l2", 108)  # a unit a head: no flags, no ticket
    assert (d_l2.k_blocks, d_l2.flags, d_l2.ticket) == (1, (0,), None)
    ragged_l2 = A.fused_dq_schedule(1025, 16, "l2", 108)  # `l2`: k-block fastest
    assert (ragged_l2.k_blocks, ragged_l2.q_tiles, ragged_l2.flags) == (17, 17, (16 * 17 + 1,))
    assert ragged_l2.coords(18) == (1, 1) and ragged_l2.waits_on(18) == 17
    assert ragged_l2.unit_blocks == 1
    wide_l2 = A.fused_dq_schedule(1024, 48, "l2", 64)  # units of two key blocks
    assert (wide_l2.k_blocks, wide_l2.unit_blocks, wide_l2.flags) == (16, 2, (48 * 16 + 1,))
    assert units_of(wide_l2)[:2] == [[0, 1], [2, 3]] and wide_l2.waits_on(2) == 1


def test_f32_fused_schedule_sizes_the_wrapper_buffers():
    """The f32 single pass's grid and buffer of flags and ticket
    (csrc/flash_f32_bwd.cuh; the wrapper passes the head width where it
    lies): G at 1,024 tokens x 192 heads (128-key blocks, 64-query tiles, 32
    heads a group), a ragged last group (40 heads), the v1 generator (32
    tokens, Dh 96) and discriminator (50 tokens, Dh 108: 64-key blocks,
    32-query tiles) with one key block (no flags, no ticket), and highres128's
    D width at Dh 108 (DP 128), whose blocks and tiles are half G's."""
    f32 = torch.float32
    g = A.fused_dq_schedule(1024, 192, "dot", 64, f32)
    assert (g.k_blocks, g.q_tiles, g.group_heads, g.unit_blocks) == (8, 16, 32, 1)
    assert (g.ticket, g.flags) == (192 * 16, (192 * 16 + 1,))
    assert [g.coords(i) for i in (0, 1, 32, 33, 255, 256)] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (7, 31), (0, 32)]
    assert [g.waits_on(i) for i in (0, 31, 32, 33, 256, 288)] == [None, None, 0, 1, None, 256]
    ragged = A.fused_dq_schedule(1024, 40, "dot", 64, f32)  # a last group of 8 heads
    assert (ragged.ticket, ragged.flags) == (40 * 16, (40 * 16 + 1,))
    assert ragged.coords(256) == (0, 32) and ragged.coords(264) == (1, 32)
    assert ragged.coords(319) == (7, 39) and ragged.waits_on(264) == 256
    for n, bh, d, tiles in ((32, 512, 96, 1), (50, 1024, 108, 2)):
        v1 = A.fused_dq_schedule(n, bh, "l2" if d == 108 else "dot", d, f32)
        assert (v1.k_blocks, v1.q_tiles, v1.flags, v1.ticket) == (1, tiles, (0,), None)
        assert v1.waits_on(5) is None
    wide = A.fused_dq_schedule(1025, 6, "dot", 108, f32)
    assert (wide.k_blocks, wide.q_tiles, wide.group_heads) == (17, 33, 32)
    assert wide.flags == (6 * 33 + 1,) and wide.waits_on(6) == 0
    assert A.fused_dq_schedule(1025, 6, "dot", 64, f32).k_blocks == 9
