"""The `dot` flash dq kernel's plain version at the edges of the Hopper
kernel (csrc/flash_attn_bwd_dq.cu), on the CPU.

flash_bwd_dq_reference against the JAX dq kernel (`_flash_bwd_dq_kernel`,
run by `_flash_backward` on its two-pass route in interpret mode) on the JAX
forward's o and LSE, at N in {1, 32, 63, 65, 129} (one row, the v1
generator's 32 tokens, both sides of the kernel's 64-row warpgroups and
64-key tiles, past its 128-query blocks) and Dh in {16, 64, 96, 128} (one
and two 64-column boxes).

Tolerance: 1e-5 absolute and relative, f32 on both sides (JAX at 'highest'
matmul precision, tests/conftest.py); the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.ops.attention import _flash_backward, _flash_forward
from vitgan_tpu.ops.policy import set_policy as jax_set_policy
from vitgan_tpu_torch.ops import attention as A

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
EDGE_N = (1, 32, 63, 65, 129)
EDGE_DH = (16, 64, 96, 128)


def qkv(n, dh, seed=0, k=3):
    """k f32 arrays of (1, 2, n, dh): B*H = 2."""
    rng = np.random.default_rng(seed + 1000 * n + dh)
    return [(0.5 * rng.standard_normal((1, 2, n, dh))).astype(np.float32) for _ in range(k)]


@pytest.fixture(autouse=True)
def _restore_jax_policy():
    yield
    jax_set_policy(bwd_fusion="auto")


@pytest.mark.parametrize("dh", EDGE_DH)
@pytest.mark.parametrize("n", EDGE_N)
def test_plain_dq_matches_jax_dq_kernel_at_kernel_edges(n, dh):
    q, k, v, g = qkv(n, dh, seed=1, k=4)
    scale = float(dh)
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    o, lse = _flash_forward(jq, jk, jv, "dot", scale, 128, 128, True, with_lse=True)
    jax_set_policy(bwd_fusion="two_pass")
    want = _flash_backward(jq, jk, jv, o, lse, jg, "dot", scale, 128, 128, True)[0]
    got = A.flash_bwd_dq_reference(*map(torch.from_numpy, (q, k, v, np.array(o), np.array(lse),
                                                           g)), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
