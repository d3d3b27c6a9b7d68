"""utils/benchutil and the measuring commands of the port's CLI, on the CPU.

- build_preset_cfg equal to the JAX package's for every name and spelling,
  on every field the port carries;
- the step's FLOP model (FlopCounterMode on the meta device) equal to a
  count written out from the config's shapes, for v2 at smoke size, deit64,
  highres128 and highres256p4 (above 1,024 tokens the plain route's chunked
  attention recomputes its scores, Q.K^T, in the backward: the count has
  that term);
- measure_scanned_train and warmup_compile at smoke size, the warm-up's run
  directory under $SCRATCH/warmup and none under $SCRATCH/output (the JAX
  tests/test_benchutil.py's regression);
- `cli bench`, `warmup`, `doctor` (exit 0 with --allow-no-device, 1
  without a card) and `profile` at smoke size.
"""

import json

import pytest

from vitgan_tpu.utils import benchutil as JB
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.cli import main
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.utils import benchutil as B

NAMES = ("v1", "v2", "dcgan", "cnn", "mlp", "deit64", "hires128", "hires256", "hires256p4",
         "highres128", "highres256", "highres256p4")


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _same_fields(port: dict, jax_: dict, path=""):
    for k, v in port.items():
        assert k in jax_, f"{path}{k} is not in the JAX schema"
        if isinstance(v, dict):
            _same_fields(v, jax_[k], f"{path}{k}.")
        else:
            assert v == jax_[k], f"{path}{k}: port {v!r} != JAX {jax_[k]!r}"


@pytest.mark.parametrize("name", NAMES)
def test_build_preset_cfg_equals_the_jax_one(name):
    from vitgan_tpu import config as JC

    port = B.build_preset_cfg(name)
    assert port.data.dataset == "synthetic"
    _same_fields(C.to_dict(port), JC.to_dict(JB.build_preset_cfg(name)))
    if name.endswith("p4"):
        assert port.v2.image_size == 256 and port.v2.patch_size == 4


def test_build_preset_cfg_refuses_unknown_names():
    with pytest.raises(KeyError, match="hires256p4"):
        B.build_preset_cfg("nope")


def _analytic_gflops(cfg) -> float:
    """Products of one v2 step (bce, one critic update, no R1), 2 m n k each:
    G's forward and backward (no product for z's gradient); D's forward on
    [real; fake] and its backward (no product for its input's gradient), D's
    forward on the fake and its backward with D frozen (the input gradients
    only); over 1,024 tokens the chunked attention's Q.K^T again in each
    backward through it."""
    m = cfg.v2
    n = (m.image_size // m.patch_size) ** 2
    n1, e, r = n + 1, m.embed_dim, m.mlp_ratio
    pd, lat, depth, b = m.patch_size ** 2 * m.channels, m.latent_dim, m.depth, m.batch_size
    extra = 1 if m.minibatch_std else 0

    def weights(t):  # qkv, out-projection, fc1, fc2 of one block at t tokens
        return 8 * t * e * e + 4 * r * t * e * e

    def scores(t):  # Q.K^T of every head of one block
        return 2 * t * t * e

    g_fwd = 2 * lat * n * e + depth * (weights(n) + 2 * scores(n)) + 2 * n * e * pd
    d_w = 2 * n * pd * e + depth * weights(n1) + 2 * (e + extra) * e + 2 * e
    d_a = depth * 2 * scores(n1)
    d_fwd = d_w + d_a
    total = (3 * b * g_fwd - 2 * b * lat * n * e + 7 * b * d_fwd - 4 * b * n * pd * e
             + b * d_w + 2 * b * d_a)
    if n1 > 1024:  # D's backward through [real; fake] and through the fake
        total += 3 * b * depth * scores(n1)
    if n > 1024:
        total += b * depth * scores(n)
    return total / 1e9


@pytest.mark.parametrize("name", ["smoke", "deit64", "highres128", "highres256p4"])
def test_step_flops_equal_a_count_from_the_shapes(name):
    cfg = C.smoke_config() if name == "smoke" else B.build_preset_cfg(name)
    before = policy.get_policy()
    got = B.step_gflops(cfg)
    assert got == pytest.approx(_analytic_gflops(cfg), rel=1e-12)
    assert policy.get_policy() == before  # the count leaves the policy as it found it
    if name == "highres256p4":
        assert 40e3 < got < 60e3  # about 50 TFLOP a step


def test_measure_scanned_train_smoke():
    ips = B.measure_scanned_train(C.smoke_config("mlp"), scan_steps=2, iters=1,
                                  dataset_images=32, device="cpu")
    assert ips > 0


def test_warmup_compile_keeps_output_dir_clean(tmp_path, monkeypatch):
    monkeypatch.setenv("SCRATCH", str(tmp_path))
    secs = B.warmup_compile(C.smoke_config("mlp"), scan_steps=2, device="cpu")
    assert secs >= 0
    assert not (tmp_path / "output").exists()
    assert any((tmp_path / "warmup").iterdir())


def test_cli_bench_warmup_doctor_profile(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("SCRATCH", str(tmp_path))
    assert main(["bench", "--preset", "mlp", "--scan", "2", "--iters", "1", "--flops",
                 "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["unit"] == "images/sec" and rec["value"] > 0
    want = B.step_gflops(B.build_preset_cfg("mlp"))
    assert rec["step_gflops"] == pytest.approx(want, abs=0.01)
    assert rec["sustained_tflops"] >= 0
    assert main(["warmup", "mlp", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec["compile_seconds"]) == {"mlp"} and rec["scan"] == 0
    assert (tmp_path / "warmup" / "warmup_mlp" / "config.json").exists()
    assert not (tmp_path / "output").exists()
    assert main(["doctor", "--allow-no-device", "--device-timeout", "60"]) == 0
    checks = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"devices", "nvcc", "kernel_build", "native_loader",
            "inception_weights"} <= set(checks)
    if not checks["devices"]["ok"]:  # this machine has no card: without the flag, 1
        assert main(["doctor", "--device-timeout", "60"]) == 1
    monkeypatch.setenv("DEV", "1")
    assert main(["profile", "--device", "cpu", "--steps", "1", "--run-dir",
                 str(tmp_path / "prof")]) == 0
    assert (tmp_path / "prof" / "logs" / "profile").is_dir()
