"""Import hygiene of the PyTorch port: vitgan_tpu_torch and chip_smoke.py
import nothing of JAX and nothing of the JAX package (vitgan_tpu), and
importing them builds no kernel and imports no triton."""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "vitgan_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "vitgan_tpu", "triton")


def _forbidden(module: str) -> bool:
    """True for jax, jax.*, vitgan_tpu, vitgan_tpu.* and the like — but not
    for vitgan_tpu_torch, which shares the prefix."""
    return module.split(".")[0] in FORBIDDEN


def test_forbidden_matches_by_package_not_prefix():
    assert _forbidden("jax") and _forbidden("jax.numpy") and _forbidden("jaxlib.xla_client")
    assert _forbidden("vitgan_tpu") and _forbidden("vitgan_tpu.ops.attention")
    assert not _forbidden("vitgan_tpu_torch") and not _forbidden("vitgan_tpu_torch.ops.build")


def test_importing_every_port_module_loads_no_jax():
    code = r"""
import json, pkgutil, sys
import vitgan_tpu_torch
names = ["vitgan_tpu_torch"]
for m in pkgutil.walk_packages(vitgan_tpu_torch.__path__, "vitgan_tpu_torch."):
    __import__(m.name)
    names.append(m.name)
from vitgan_tpu_torch.ops import build
print(json.dumps({"imported": names, "loaded": sorted(sys.modules),
                  "libs": len(build._LIBS)}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    for name in ("serve", "ops.fused_block", "ops.wgrad", "train.step", "train.trainer",
                 "ops.augment", "data.datasets", "models.vitgan_v1", "models.layers",
                 "utils.checkpoint", "utils.logging", "utils.manifest", "utils.preemption",
                 "utils.timing", "utils.profiling", "utils.run_dirs", "models.inception",
                 "train.fid", "train.metrics"):
        assert f"vitgan_tpu_torch.{name}" in res["imported"]
    bad = [m for m in res["loaded"] if _forbidden(m)]
    assert not bad, f"importing the port loaded {bad}"
    assert res["libs"] == 0  # no kernel library built or loaded at import


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_names_jax_or_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = {os.path.relpath(f, REPO): m for f in files for m in _imports(f) if _forbidden(m)}
    assert not bad, f"port files import {bad}"


def test_every_hopper_source_is_a_built_source():
    """chip_smoke.py counts wgmma and TMA instructions in the library of each
    source of HOPPER_SOURCES: each must be a source ops/build.py builds."""
    import chip_smoke
    from vitgan_tpu_torch.ops import build

    assert set(chip_smoke.HOPPER_SOURCES) <= set(build.SOURCES)
    for name in chip_smoke.HOPPER_SOURCES:
        assert os.path.exists(os.path.join(build.CSRC, f"{name}.cu"))
