"""The port's ops (vitgan_tpu_torch.ops) against the JAX package's Pallas
kernels run with interpret=True, on the CPU, in f32.

On the CPU every wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions (and the routing around them) to the TPU
kernels.  The CUDA kernels themselves are held to the plain versions on the
card: tests/test_torch_kernels_cuda.py and chip_smoke.py.

Tolerance: 2e-5 absolute and relative.  Both sides compute in f32 (JAX at
'highest' matmul precision, tests/conftest.py); the TPU kernels evaluate erf
with a polynomial whose error is below 1.5e-7, the port with the exact erf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.config import V2Config as JaxV2Config
from vitgan_tpu.models.vitgan_v2 import _encoder_init
from vitgan_tpu.ops.attention import flash_attention as jax_flash_attention
from vitgan_tpu.ops.fused_block import _pad_params
from vitgan_tpu.ops.fused_block import fused_encoder_block as jax_fused_encoder_block
from vitgan_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from vitgan_tpu_torch.config import V2Config
from vitgan_tpu_torch.models.vitgan_v2 import EncoderBlock
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import build
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)

# (batch, tokens, embed, heads): ragged (65 tokens, E 48, Dh 24) and aligned.
SHAPES = [dict(b=2, n=65, e=48, heads=2), dict(b=3, n=64, e=64, heads=4)]
IDS = ["ragged_n65_e48_h2", "aligned_n64_e64_h4"]


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _block_params(shape, seed=0):
    """A JAX encoder block tree (mlp_ratio 4) with LN and biases perturbed so
    every parameter matters, plus the port's EncoderBlock holding the same."""
    cfg = JaxV2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4)
    tree = jax.tree.map(np.asarray, _encoder_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for k in ("ln1", "ln2"):
        tree[k]["scale"] = (1 + 0.1 * rng.standard_normal(tree[k]["scale"].shape)).astype(np.float32)
        tree[k]["bias"] = (0.1 * rng.standard_normal(tree[k]["bias"].shape)).astype(np.float32)
    for sub in (tree["fc1"], tree["fc2"], tree["msha"]["out"]):
        sub["b"] = (0.02 * rng.standard_normal(sub["b"].shape)).astype(np.float32)
    tree["msha"]["qkv_b"] = (0.02 * rng.standard_normal(tree["msha"]["qkv_b"].shape)
                             ).astype(np.float32)
    block = EncoderBlock(V2Config(embed_dim=shape["e"], num_heads=shape["heads"], mlp_ratio=4),
                         torch.Generator().manual_seed(seed))
    load_into(block, from_jax_tree(tree))
    return tree, block


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (shape["b"], shape["n"], shape["e"])).astype(np.float32)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fused_ln_mlp_matches_pallas(shape, residual):
    tree, _ = _block_params(shape)
    x = _x(shape)
    args = [tree["ln2"]["scale"], tree["ln2"]["bias"], tree["fc1"]["w"], tree["fc1"]["b"],
            tree["fc2"]["w"], tree["fc2"]["b"]]
    want = jax_fused_ln_mlp(jnp.asarray(x), *map(jnp.asarray, args), "gelu", 1e-5, residual,
                            256, True)
    got = FM.fused_ln_mlp(torch.from_numpy(x), *map(torch.from_numpy, args), "gelu", 1e-5,
                          residual)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_attention_matches_pallas(shape):
    dh = shape["e"] // shape["heads"]
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((shape["b"], shape["heads"], shape["n"], dh))
               .astype(np.float32) for _ in range(3))
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), "dot", float(dh), interpret=True)
    got = A.flash_attention(*map(torch.from_numpy, (q, k, v)), "dot", float(dh))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fused_encoder_block_matches_pallas(shape):
    tree, block = _block_params(shape)
    x = _x(shape)
    want = jax_fused_encoder_block(jnp.asarray(x), jax.tree.map(jnp.asarray, tree),
                                   num_heads=shape["heads"], group=2, interpret=True)
    with torch.inference_mode():
        got = FB.fused_encoder_block(torch.from_numpy(x), block, num_heads=shape["heads"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_qkv_weight_column_order_matches_pad_params():
    """The LN->qkv kernel's weight layout is `_pad_params`' column order."""
    shape = SHAPES[0]
    tree, block = _block_params(shape)
    h, dh, _, pads = _pad_params(jax.tree.map(jnp.asarray, tree), shape["heads"], jnp.float32)
    e = shape["e"]
    want = np.asarray(pads["wqkv"])[:e, :3 * h * dh]
    np.testing.assert_array_equal(FB._qkv_weight(block.msha.qkv, torch.float32).detach().numpy(),
                                  want)
    np.testing.assert_array_equal(FB._qkv_bias(block).detach().numpy(),
                                  np.asarray(pads["bqkv"])[0, :3 * h * dh])


def test_maybe_megablock_gate_on_cpu():
    """'auto' never routes a CPU block (the kernels are the reason to route);
    'on' routes inference blocks to the plain block; training never routes."""
    shape = dict(b=2, n=130, e=48, heads=2)
    _, block = _block_params(shape)
    cfg = V2Config(embed_dim=48, num_heads=2, mlp_ratio=4)
    x = torch.from_numpy(_x(shape))
    policy.set_policy(mode="auto", megablock="auto")
    assert FB.maybe_megablock(block, x, cfg, train=False) is None
    policy.set_policy(megablock="on")
    with torch.inference_mode():
        out = FB.maybe_megablock(block, x, cfg, train=False)
        assert out is not None
        torch.testing.assert_close(out, FB._block_reference(x, block, 2))
    assert FB.maybe_megablock(block, x, cfg, train=True) is None
    policy.set_policy(mode="never")
    assert FB.maybe_megablock(block, x, cfg, train=False) is None


def test_dispatch_gates_follow_the_policy():
    q = torch.zeros(1, 2, 300, 16)
    policy.set_policy(mode="auto")
    assert not A.use_flash_attention(q, 300)  # CPU tensor
    policy.set_policy(mode="always")
    assert A.use_flash_attention(q, 300)
    policy.set_policy(mode="never")
    assert not A.use_flash_attention(q, 300)
    with pytest.raises(ValueError):
        policy.set_policy(mode="sometimes")


def test_auto_gates_are_the_jax_gates(monkeypatch):
    """'auto' reads the device, the JAX package's size thresholds and the
    widths the kernels take: every multiple of 8 (E 400 takes the wide
    variants on the card, as E 384 the resident kernels), not E 404.  A
    CUDA tensor of another dtype passes the gate and reaches the kernel's
    wrapper, which raises; it never reaches the plain version; so does an
    unaligned block under 'always' and megablock 'on'.  Meta tensors stand
    in for CUDA ones: the wrappers refuse them, where the plain versions
    would return a meta result without complaint."""
    for mod in (A, FM, FB):
        monkeypatch.setattr(mod, "on_cuda", lambda t: True)
    policy.set_policy(mode="auto", megablock="auto")
    q = torch.empty(1, 2, 300, 200, device="meta")  # f32, Dh 200 > 128
    assert A.use_flash_attention(q, 256) and not A.use_flash_attention(q, 255)
    with pytest.raises(ValueError, match="CUDA"):
        A.dispatch_attention(q, q, q, "dot", 200.0)
    # f32; E 404 (Dh 202) is no multiple of 8
    for e, has_variant in ((384, True), (400, True), (404, False)):
        hidden = 4 * e
        x = torch.empty(2, 1057, e, device="meta")
        w1, w2 = torch.empty(e, hidden, device="meta"), torch.empty(hidden, e, device="meta")
        b1, b = torch.empty(hidden, device="meta"), torch.empty(e, device="meta")
        block = EncoderBlock(V2Config(embed_dim=e, num_heads=2, mlp_ratio=4),
                             torch.Generator().manual_seed(0))
        cfg = V2Config(embed_dim=e, num_heads=2, mlp_ratio=4)
        if has_variant:
            with pytest.raises(ValueError, match="CUDA"):
                FM.dispatch_ln_mlp(x, b, b, w1, b1, w2, b, residual=False)
            with pytest.raises(ValueError, match="CUDA"):
                FB.maybe_megablock(block, x[:, :128], cfg, train=False)
        else:
            assert FM.dispatch_ln_mlp(x, b, b, w1, b1, w2, b, residual=False).is_meta
            assert FB.maybe_megablock(block, x[:, :128], cfg, train=False) is None
            policy.set_policy(mode="always", megablock="on")
            with pytest.raises(ValueError, match="CUDA"):
                FM.dispatch_ln_mlp(x, b, b, w1, b1, w2, b, residual=False)
            with pytest.raises(ValueError, match="CUDA"):
                FB.maybe_megablock(block, x[:, :128], cfg, train=False)
            policy.set_policy(mode="auto", megablock="auto")
        assert FM.dispatch_ln_mlp(x[:, :1023], b, b, w1, b1, w2, b).is_meta  # rows < 2048
        assert FB.maybe_megablock(block, x[:, :127], cfg, train=False) is None
        assert FB.maybe_megablock(block, x[:, :1057], cfg, train=False) is None


def test_cpu_tensors_never_touch_the_build(monkeypatch):
    """Every wrapper and every route on CPU tensors runs without the build."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(build, "entry", refuse)
    monkeypatch.setattr(build, "build", refuse)
    shape = SHAPES[0]
    tree, block = _block_params(shape)
    x = torch.from_numpy(_x(shape))
    policy.set_policy(mode="always", megablock="on")
    before = dict(build.LAUNCHES)
    with torch.inference_mode():
        FB.fused_encoder_block(x, block, num_heads=2)
        FM.dispatch_ln_mlp(x, block.ln2.scale, block.ln2.bias, block.fc1.w, block.fc1.b,
                           block.fc2.w, block.fc2.b, residual=False)
        q = torch.randn(2, 2, 65, 24)
        A.dispatch_attention(q, q, q, "dot", 24.0)
    assert build.LAUNCHES == before


def test_wrappers_refuse_rather_than_fall_back(monkeypatch, tmp_path):
    """A tensor that is neither on the CPU nor on CUDA is refused, not sent to
    the plain version; with no CUDA toolkit the build refuses too."""
    q = torch.empty(1, 2, 16, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        A.flash_attention(q, q, q)
    x = torch.empty(2, 16, 32, device="meta")
    w1, w2 = torch.empty(32, 64, device="meta"), torch.empty(64, 32, device="meta")
    b = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        FM.fused_ln_mlp(x, b, b, w1, torch.empty(64, device="meta"), w2, b)
    with pytest.raises(ValueError, match="CUDA"):
        FB.ln_qkv_forward(x, b, b, torch.empty(3, 2, 32, 16, device="meta"),
                          torch.empty(96, device="meta"))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.entry("flash_attn_fwd")
