"""The port's LN->MLP with each activation of the JAX package's `_ACTS` (gelu,
relu, tanh, sigmoid), on the CPU.

- ``fused_ln_mlp`` (CPU tensors: its plain version) and ``dispatch_ln_mlp``
  under use_pallas='always' against the JAX ``fused_ln_mlp`` in interpret
  mode, forward and the gradients of all seven inputs through the recompute
  backward, with and without the residual;
- the fc1 stage's plain versions (resident and wide) with each activation;
- each activation's id reaching ln_mlp_fwd.cu's fc1 entries (resident and
  wide) with the argument count of ops/build.SIGNATURES, and the ids equal
  to the kernel's Act enum;
- an unknown activation raises.

Tolerance: f32 on both sides (JAX at 'highest' matmul precision,
tests/conftest.py): 1e-5 forward, 1e-4 gradients (the sums run in another
order; the JAX GELU's erf polynomial is within 1.5e-7 of erf).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu.ops.fused_mlp import fused_ln_mlp as jax_fused_ln_mlp
from vitgan_tpu_torch.ops import build, policy
from vitgan_tpu_torch.ops import fused_mlp as FM

torch.set_num_threads(1)
ACTS = ["gelu", "relu", "tanh", "sigmoid"]
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
E, HIDDEN = 32, 64


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _inputs(seed=0):
    """x (2, 9, E) and the LN->MLP parameters, LN and biases perturbed so that
    each enters the result."""
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return [rn(2, 9, E), 1.0 + rn(E, scale=0.1), rn(E, scale=0.1), rn(E, HIDDEN, scale=0.2),
            rn(HIDDEN, scale=0.1), rn(HIDDEN, E, scale=0.2), rn(E, scale=0.1)]


@pytest.mark.parametrize("residual", [True, False], ids=["residual", "no_residual"])
@pytest.mark.parametrize("activation", ACTS)
def test_ln_mlp_matches_jax_with_each_activation(activation, residual):
    args = _inputs()
    g = np.random.default_rng(1).standard_normal(args[0].shape).astype(np.float32)

    def jf(*a):
        return jax_fused_ln_mlp(*a, activation, 1e-5, residual, 256, True)

    want, vjp = jax.vjp(jf, *map(jnp.asarray, args))
    want_grads = vjp(jnp.asarray(g))
    policy.set_policy(mode="always")
    for route in ("fused_ln_mlp", "dispatch_ln_mlp"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        if route == "fused_ln_mlp":
            out = FM.fused_ln_mlp(*leaves, activation, 1e-5, residual)
        else:
            out = FM.dispatch_ln_mlp(*leaves, activation, residual)
            assert type(out.grad_fn).__name__ == "_LnMlpBackward"
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **FWD_TOL,
                                   err_msg=route)
        grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
        for i, (a, b) in enumerate(zip(grads, want_grads)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                       err_msg=f"{route} input {i}")


@pytest.mark.parametrize("activation", ACTS)
def test_fc1_stage_plain_versions_take_the_activation(activation):
    """LN -> fc1 -> act stage, resident and wide (ln_rows then fc1), in f32:
    h = act(z1), z1 = LN(x) . w1 + b1."""
    x, ln_s, ln_b, w1, b1, _, _ = map(torch.from_numpy, _inputs(2))
    rows = x.reshape(-1, E)
    f32 = torch.float32
    h, z1 = FM.ln_fc1_stage_reference(rows, ln_s, ln_b, w1, b1, dtype=f32, activation=activation)
    torch.testing.assert_close(h, FM.ACTIVATIONS[activation](z1))
    wh, wz = FM.fc1_stage_reference(FM.ln_rows_reference(rows, ln_s, ln_b, dtype=f32), w1, b1,
                                    dtype=f32, activation=activation)
    torch.testing.assert_close(wh, h, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wz, z1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wide", [False, True], ids=["resident", "wide"])
def test_fc1_entries_get_the_activation_id(monkeypatch, wide):
    """Each activation's id is the `act` argument of the fc1 entry (resident
    ln_mlp_fc1, wide ln_mlp_fc1_wide after ln_rows), every call with the
    argument count of its C signature; the ids are the kernels' Act enum
    (csrc/common.cuh)."""
    calls = []

    def fake_entry(name):
        def fn(*args):
            assert len(args) == len(build.SIGNATURES[name]), name
            calls.append((name, args))
            return 0
        fn.__name__ = name
        return fn

    monkeypatch.setattr(FM, "_kernel_rows", lambda t, what: t.contiguous())
    monkeypatch.setattr(build, "entry", fake_entry)
    monkeypatch.setattr(build, "stream_ptr", lambda device: None)
    x, ln_s, ln_b, w1, b1, _, _ = map(torch.from_numpy, _inputs(3))
    a = x.reshape(-1, E).to(torch.bfloat16)
    for activation in ACTS:
        FM.ln_fc1_stage(a, ln_s, ln_b, w1, b1, activation=activation, wide=wide)
        name, args = calls.pop()
        assert name == ("ln_mlp_fc1_wide" if wide else "ln_mlp_fc1")
        assert args[-2] == FM.ACT_ID[activation]
    src = open(os.path.join(build.CSRC, "common.cuh")).read()  # shared by the bf16 and f32 fc1
    enum = re.search(r"enum Act : int \{([^}]*)\}", src).group(1)
    ids = {m.group(1).lower(): int(m.group(2)) for m in re.finditer(r"k(\w+) = (\d+)", enum)}
    assert ids == FM.ACT_ID


def test_unknown_activation_raises():
    args = [torch.from_numpy(a) for a in _inputs()]
    with pytest.raises(ValueError, match="activation"):
        FM.fused_ln_mlp(*args, "swish")
    with pytest.raises(ValueError, match="activation"):
        FM._reference(*args, "swish")
