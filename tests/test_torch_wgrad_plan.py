"""Host-side planning of the Hopper weight-gradient kernel, and the CPU route
of ``wgrad()`` and ``flash_backward()`` against the JAX package.

csrc/wgrad_gemm.cu cannot run here; what it reads from the host is planned
in Python (ops/wgrad.py): the rows a split sums (``plan``) and the scratch
layout (``scratch_floats``).  These tests hold that plan to the ranges and
offsets the C entry forms from it (its arithmetic, written out here), and
the plain versions that CPU tensors take to the JAX package at 1e-5 in f32.
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
