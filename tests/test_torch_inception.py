"""The port's InceptionV3 (vitgan_tpu_torch/models/inception.py) against the
JAX package's (vitgan_tpu/models/inception.py) on the CPU: the architecture
table, the random state dict (bit-equal), the BN fold (within 1e-6), the
JAX ``.npz`` read by the port, every block kind against the JAX private block
function on the same random input, and the whole network's features and
logits at resize_to=75 on 2 images.

Tolerances: a block's output within 1e-4 * max(max|JAX|, 1); the whole
network within 1e-3 * max(max|JAX|, 1), the JAX package's own cross-framework
bar (tests/test_inception.py:65-85).  Both sides run in f32 (the JAX
convolutions at Precision.HIGHEST)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.models import inception as JI
from vitgan_tpu_torch.models import inception as I
from vitgan_tpu_torch.weights import inception_from_jax

torch.set_num_threads(1)

BLOCK_TOL, NET_TOL = 1e-4, 1e-3


@pytest.fixture(scope="module")
def params():
    return JI.convert_torch_state_dict(JI.random_torch_state_dict(0))


@pytest.fixture(scope="module")
def net(params):
    return I.InceptionV3.from_params(params, device="cpu")


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    scale = float(np.abs(np.asarray(want)).max())
    assert err <= tol * max(scale, 1.0), f"{what}: max|d| {err} (scale {scale})"


def test_conv_specs_equal_jax():
    assert I.conv_specs() == JI.conv_specs()
    assert len(I.conv_specs()) == 94


@pytest.mark.parametrize("seed", [0, 1])
def test_random_state_dict_is_bit_equal(seed):
    ours, theirs = I.random_torch_state_dict(seed), JI.random_torch_state_dict(seed)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_convert_matches_jax():
    sd = {k: torch.from_numpy(v) for k, v in I.random_torch_state_dict(2).items()}
    ours = I.convert_torch_state_dict(sd)
    theirs = JI.convert_torch_state_dict(JI.random_torch_state_dict(2))
    assert set(ours) == set(theirs)
    for name in theirs:
        for leaf in ("w", "b"):
            np.testing.assert_allclose(ours[name][leaf], theirs[name][leaf], rtol=0, atol=1e-6)


def test_convert_rejects_wrong_shapes():
    sd = I.random_torch_state_dict(0)
    sd["Conv2d_1a_3x3.conv.weight"] = sd["Conv2d_1a_3x3.conv.weight"][:, :2]
    with pytest.raises(ValueError):
        I.convert_torch_state_dict(sd)


def test_reads_the_jax_npz(tmp_path, params):
    path = str(tmp_path / "fid_inception.npz")
    JI.save_params(path, params)
    loaded = I.load_params(path)
    assert set(loaded) == set(params)
    for name in params:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(loaded[name][leaf], params[name][leaf])
    net = I.InceptionV3.from_params(loaded, device="cpu")
    sd = net.state_dict()
    assert net.has_fc and len(sd) == 2 * 95
    np.testing.assert_array_equal(sd["Mixed_6b.branch7x7_2.w"].numpy(),
                                  np.transpose(params["Mixed_6b.branch7x7_2"]["w"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["fc.w"].numpy(), params["fc"]["w"])


def test_state_dict_round_trips_through_the_jax_tree(params):
    sd = inception_from_jax(params)
    assert sd["Conv2d_1a_3x3.w"].shape == (32, 3, 3, 3) and sd["fc.w"].shape == (2048, 1000)
    with torch.device("meta"):
        own = I.InceptionV3(num_classes=1000, device="meta").state_dict()
    assert set(sd) == set(own)
    assert all(tuple(sd[k].shape) == tuple(own[k].shape) for k in sd)


# (kind, block name, input channels, spatial size): small random inputs of the
# widths each block takes in the network
BLOCKS = [
    ("stem", None, 3, 75),
    ("a", "Mixed_5c", 256, 7),
    ("b", "Mixed_6a", 288, 9),
    ("c", "Mixed_6d", 768, 5),
    ("d", "Mixed_7a", 768, 9),
    ("e_avg", "Mixed_7b", 1280, 4),
    ("e_max", "Mixed_7c", 2048, 4),
]


def _jax_block(kind, name, P, x):
    if kind == "stem":
        x = JI._conv(P["Conv2d_1a_3x3"], x, stride=2)
        x = JI._conv(P["Conv2d_2a_3x3"], x)
        x = JI._conv(P["Conv2d_2b_3x3"], x, padding=1)
        x = JI._max_pool(x)
        x = JI._conv(P["Conv2d_3b_1x1"], x)
        x = JI._conv(P["Conv2d_4a_3x3"], x)
        return JI._max_pool(x)
    if kind.startswith("e_"):
        return JI._block_e(P, name, x, pool_branch=kind[2:])
    return getattr(JI, f"_block_{kind}")(P, name, x)


def _port_block(kind, name, net, x):
    if kind == "stem":
        return I._stem(net, x)
    if kind.startswith("e_"):
        return I._block_e(net, name, x, pool_branch=kind[2:])
    return getattr(I, f"_block_{kind}")(net, name, x)


@pytest.mark.parametrize("kind,name,c_in,size", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_block_matches_jax(params, net, kind, name, c_in, size):
    x = np.random.default_rng(11).uniform(-1, 1, (2, size, size, c_in)).astype(np.float32)
    want = np.asarray(jax.jit(lambda P, v: _jax_block(kind, name, P, v))(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = _port_block(kind, name, net, torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    _close(got, want, BLOCK_TOL, kind)


def test_whole_network_features_and_logits_match_jax(params, net):
    imgs = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    want = np.asarray(jax.jit(lambda p, x: JI.inception_features(p, x, resize_to=75))(
        params, jnp.asarray(imgs)))
    want_logits = np.asarray(JI.apply_fc(params, jnp.asarray(want)))
    x = torch.from_numpy(imgs)
    got = I.inception_features(net, x, resize_to=75)
    assert got.dtype == torch.float32 and got.shape == (2, I.FEATURE_DIM)
    _close(got.numpy(), want, NET_TOL, "features")
    _close(I.inception_logits(net, x, resize_to=75).numpy(), want_logits, NET_TOL, "logits")


def test_no_fc_head_raises(params):
    net = I.InceptionV3.from_params({k: v for k, v in params.items() if k != "fc"}, "cpu")
    assert not net.has_fc
    with pytest.raises(KeyError):
        I.apply_fc(net, torch.zeros(1, I.FEATURE_DIM))


def test_full_f32_scopes_and_restores_the_tf32_switches():
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        with I.full_f32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
