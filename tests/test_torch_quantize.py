"""Weight-only int8 (utils/quantize.py) and the int8 serving route, on the CPU.

- The port's int8 values and scales are bit-equal to the JAX package's
  quantize_leaf / quantize_tree on the same f32 tree (a v2 generator's);
- the JAX file's contract (tests/test_quantize.py): the round-trip error
  bound amax_c / 254, exact negation, the tree's pass-through rules and
  idempotence, the modes, the byte count;
- the sampler: SamplerService(quantize="int8") keeps only the int8 tree
  (the module on the meta device), reproduces a seed bit for bit, and its
  uint8 output drifts from the float route's within the JAX package's bounds
  (mean <= 4, p99 <= 24 levels, tests/test_quantize.py:123-124).
"""

import jax
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.utils import quantize as JQ
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.serve import SamplerService
from vitgan_tpu_torch.utils.quantize import (QuantLeaf, dequantize_tree, maybe_quantize,
                                             quantize_leaf, quantize_tree, quantized_bytes)
from vitgan_tpu_torch.weights import from_jax_tree

torch.set_num_threads(1)


def test_int8_bit_equal_to_jax_on_a_generator_tree():
    gan = jax_build_gan(JC.smoke_config("v2"))
    tree = jax.tree.map(np.asarray, gan.generator_init(jax.random.PRNGKey(0))["params"])
    jq = JQ.quantize_tree(tree, min_elems=256)
    flat_j = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jq, is_leaf=lambda x: isinstance(x, JQ.QuantLeaf))[0]:
        flat_j[".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)] = leaf
    sd = from_jax_tree(tree)
    pq = quantize_tree(sd, min_elems=256)
    assert set(pq) == set(flat_j)
    n = 0
    for name, leaf in pq.items():
        want = flat_j[name]
        assert isinstance(leaf, QuantLeaf) == isinstance(want, JQ.QuantLeaf), name
        if isinstance(leaf, QuantLeaf):
            n += 1
            assert leaf.q.dtype == torch.int8 and leaf.dtype == want.dtype == "float32"
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(want.q), err_msg=name)
            np.testing.assert_array_equal(leaf.scale.numpy(), np.asarray(want.scale),
                                          err_msg=name)
            np.testing.assert_array_equal(leaf.dequantize().numpy(),
                                          np.asarray(want.dequantize()), err_msg=name)
    assert n >= 8


def test_roundtrip_error_bound():
    w = torch.from_numpy(np.random.default_rng(0).standard_normal((96, 48)).astype(np.float32)
                         * 3.0)
    leaf = quantize_leaf(w)
    deq = leaf.dequantize()
    bound = w.abs().amax(0) / 254.0 + 1e-7
    assert leaf.q.dtype == torch.int8 and deq.dtype == w.dtype
    assert bool(((w - deq).abs() <= bound[None, :]).all())
    assert int(leaf.q.abs().max()) == 127 and int(leaf.q.min()) >= -127


def test_negation_is_exact():
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 64)).astype(np.float32))
    a, b = quantize_leaf(w), quantize_leaf(-w)
    assert torch.equal(a.q, -b.q) and torch.equal(a.scale, b.scale)


def test_tree_pass_through_rules_and_modes():
    tree = {"w_big": torch.ones(64, 64), "bias": torch.ones(64), "w_small": torch.ones(4, 4),
            "step": torch.tensor(7), "nested": {"emb": torch.ones(128, 32)},
            "layers": [{"w": torch.zeros(32, 64)}]}
    q = quantize_tree(tree, min_elems=1024)
    assert isinstance(q["w_big"], QuantLeaf) and isinstance(q["nested"]["emb"], QuantLeaf)
    assert isinstance(q["layers"][0]["w"], QuantLeaf)
    assert float(q["layers"][0]["w"].scale.min()) == 1.0  # all-zero channels: scale 1
    assert q["bias"] is tree["bias"] and q["w_small"] is tree["w_small"]
    assert q["step"] is tree["step"]
    assert quantize_tree(q)["w_big"] is q["w_big"]  # idempotent
    d = dequantize_tree(q)
    assert d["w_big"].shape == (64, 64) and d["w_big"].dtype == torch.float32
    assert d["bias"] is tree["bias"]
    assert dequantize_tree(q, torch.bfloat16)["w_big"].dtype == torch.bfloat16
    plain = {"a": torch.ones(8, 8)}
    assert dequantize_tree(plain)["a"] is plain["a"]
    assert maybe_quantize(plain, None) is plain and maybe_quantize(plain, "none") is plain
    assert isinstance(maybe_quantize({"w": torch.ones(64, 64)}, "int8")["w"], QuantLeaf)
    with pytest.raises(ValueError, match="unknown quantization"):
        maybe_quantize(plain, "int4")


def test_quantized_bytes_shrink():
    tree = {"w": torch.ones(256, 256), "b": torch.ones(256)}
    stored, dense = quantized_bytes(quantize_tree(tree))
    assert dense == (256 * 256 + 256) * 4
    assert stored == 256 * 256 + 256 * 4 + 256 * 4
    assert (stored, dense) == JQ.quantized_bytes(JQ.quantize_tree(
        {"w": np.ones((256, 256), np.float32), "b": np.ones(256, np.float32)}))


@pytest.mark.parametrize("family", ["v2", "mlp", "dcgan"])
def test_sampler_parity_and_reproducibility(family):
    cfg = C.smoke_config(family)
    gan = build_gan(cfg)
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    g_float = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    native = SamplerService(cfg, gan, g_float, batch=8)
    svc = SamplerService(cfg, gan, g, batch=8, quantize="int8")
    assert all(p.device.type == "meta" for p in g.parameters())  # no float copy kept
    info = svc.info()
    assert info["quantize"] == "int8" and native.info()["quantize"] == "none"
    assert info["weight_bytes"] < native.info()["weight_bytes"] / 3
    assert info["weight_bytes"] == quantized_bytes(svc.weights)[0]
    a, b = svc.sample_quantized(8, seed=5), svc.sample_quantized(8, seed=5)
    ref = native.sample_quantized(8, seed=5)
    assert a.dtype == np.uint8 and a.shape == ref.shape == (8, 32, 32, 3)
    assert np.array_equal(a, b)
    diff = np.abs(a.astype(np.int32) - ref.astype(np.int32))
    assert diff.mean() <= 4.0, f"mean u8 drift {diff.mean():.2f}"
    assert np.quantile(diff, 0.99) <= 24, f"p99 u8 drift {np.quantile(diff, 0.99)}"
    out = svc.sample(4, seed=3)
    assert out.shape == (4, 32, 32, 3) and out.min() >= -1.0 and out.max() <= 1.0
