"""The megablock backward's LN1 half, plain version, on the CPU: its dln1
column partials come one row per 64-row tile, as the kernel
(csrc/megablock_bwd_ln1.cu) gives them and sum_partials sums them.

The same inputs, made from a seed with numpy, go through
``_bwd_ln1_reference``; each tile's row is held to that tile's column sums of
dy1 * yhat1 and of dy1 (dy1 = dqkv . wqkv^T, yhat1 = LN1(x) before its
scale and bias) at 1e-5 absolute in f32, and the sum of the rows to the
whole rows' sums at 1e-5 relative to the sum of magnitudes (f32 sums in
another order).  The saved backward that consumes them is held to the JAX
package in tests/test_torch_megablock_train.py and
tests/test_torch_megablock_bwd_stages.py.
"""

import numpy as np
import pytest
import torch

from vitgan_tpu_torch.ops import fused_block as FB


@pytest.mark.parametrize("rows", [1, 63, 64, 65, 195, 1000])
def test_ln1_half_partials_are_64_row_tile_sums(rows):
    """One row of dln1 partials per 64-row tile (ceil(M / 64), 2E), each the
    tile's column sums of dy1 * yhat1, then of dy1; summed over the tiles
    they equal the sums over all rows, and dx and y1 keep their shapes."""
    e, heads, dh = 48, 2, 8
    rng = np.random.default_rng(rows)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)  # noqa: E731
                                     ).to(torch.bfloat16)
    dqkv, x = bf(rows, 3 * heads * dh), bf(rows, e)
    dx1 = torch.from_numpy(rng.standard_normal((rows, e)).astype(np.float32))
    qkv_w = 0.1 * bf(3, heads, e, dh).float()
    ln_s, ln_b = 1 + 0.1 * bf(e).float(), 0.1 * bf(e).float()
    dx, y1, part = FB._bwd_ln1_reference(dqkv, qkv_w, x, dx1, ln_s, ln_b)
    assert dx.shape == y1.shape == (rows, e) and dx.dtype == y1.dtype == torch.bfloat16
    assert part.dtype == torch.float32 and part.shape == (-(-rows // 64), 2 * e)
    dy1 = dqkv.float() @ FB._qkv_weight(qkv_w, torch.float32).T
    yhat, _ = FB._ln_stats(x.float(), 1e-5)
    cols = torch.cat([dy1 * yhat, dy1], 1)
    for i in range(part.shape[0]):
        torch.testing.assert_close(part[i], cols[64 * i:64 * (i + 1)].sum(0), rtol=0, atol=1e-5)
    assert ((part.sum(0) - cols.sum(0)).abs() <= 1e-5 * cols.abs().sum(0)).all()


@pytest.mark.parametrize("e", [520, 768])
@pytest.mark.parametrize("rows", [1, 64, 195])
def test_wide_ln1_rows_partials_are_64_row_tile_sums(rows, e):
    """The wide LN1 half (dy1 = dqkv . wqkv^T in f32, then the LN1 rows): one
    row of dln1 partials per 64-row tile, each the tile's column sums of dy1
    * yhat1 and of dy1 (1e-4: sums of 64 products of up to 3E terms each),
    and dx, y1 in x's dtype and shape."""
    dh = 64 if e == 768 else 104  # 12 and 5 heads
    heads = e // dh
    rng = np.random.default_rng(rows + e)
    bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)  # noqa: E731
                                     ).to(torch.bfloat16)
    dqkv, x = bf(rows, 3 * heads * dh), bf(rows, e)
    dx1 = torch.from_numpy(rng.standard_normal((rows, e)).astype(np.float32))
    qkv_w = 0.05 * bf(3, heads, e, dh).float()
    ln_s, ln_b = 1 + 0.1 * bf(e).float(), 0.1 * bf(e).float()
    dy1 = FB.bwd_dy_reference(dqkv, FB._qkv_weight(qkv_w, torch.float32))
    dx, y1, part = FB.bwd_ln1_rows_reference(dy1, x, dx1, ln_s, ln_b)
    assert dx.shape == y1.shape == (rows, e) and dx.dtype == y1.dtype == torch.bfloat16
    assert part.dtype == torch.float32 and part.shape == (-(-rows // 64), 2 * e)
    yhat, _ = FB._ln_stats(x.float(), 1e-5)
    cols = torch.cat([dy1 * yhat, dy1], 1)
    for i in range(part.shape[0]):
        torch.testing.assert_close(part[i], cols[64 * i:64 * (i + 1)].sum(0), rtol=0, atol=1e-4)
