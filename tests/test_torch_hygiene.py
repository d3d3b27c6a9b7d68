"""Import hygiene of the PyTorch port: vitgan_tpu_torch and chip_smoke.py
import nothing of JAX and nothing of the JAX package (vitgan_tpu), name
nothing of the repo's native/ directory (the JAX package's C++ loader and
its library), and importing them builds no kernel, builds or loads no
loader library, starts no process group and imports no triton; every C entry
of the kernel sources has the ctypes signature ops/build.py binds it with."""

import ast
import json
import os
import re
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
from vitgan_tpu_torch.data import native
import torch.distributed as dist
print(json.dumps({"imported": names, "loaded": sorted(sys.modules),
                  "libs": len(build._LIBS), "loader": native._LIB is not None,
                  "group": dist.is_available() and dist.is_initialized()}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    res = json.loads(out.strip().splitlines()[-1])
    for name in ("serve", "ops.fused_block", "ops.wgrad", "train.step", "train.trainer",
                 "ops.augment", "data.datasets", "models.vitgan_v1", "models.layers",
                 "utils.checkpoint", "utils.logging", "utils.manifest", "utils.preemption",
                 "utils.timing", "utils.profiling", "utils.run_dirs", "models.inception",
                 "train.fid", "train.metrics", "data.native", "data.pipeline",
                 "data.transforms", "hpo.sweep", "parallel.mesh", "parallel.sharding",
                 "train.vstep", "ops.draws", "parallel.pipeline", "parallel.context_parallel"):
        assert f"vitgan_tpu_torch.{name}" in res["imported"]
    bad = [m for m in res["loaded"] if _forbidden(m)]
    assert not bad, f"importing the port loaded {bad}"
    assert res["libs"] == 0  # no kernel library built or loaded at import
    assert not res["loader"]  # nor the C++ batch assembler
    assert not res["group"]  # nor a process group


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


def test_no_port_file_names_the_jax_loader_directory():
    """The port keeps its own copy of the C++ loader (data/csrc/loader.cpp)
    and builds it into ops/_build/; no port file names the repo's native/
    directory, where the JAX package builds its libvitgan_loader.so."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cpp", ".cu", ".cuh", ".h"))]
    pattern = re.compile(r"(?<![\w.])native/|[\"']native[\"']\s*\)|libvitgan_loader\.so")
    bad = {}
    for path in files:
        with open(path) as f:
            hits = [line.strip() for line in f if pattern.search(line)]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, f"port files name the JAX loader's directory: {bad}"
    from vitgan_tpu_torch.data import native

    jax_dir = os.path.join(REPO, "native")
    for path in (native.SOURCE, native.BUILD_DIR, native.library_path()):
        assert os.path.commonpath([os.path.abspath(path), jax_dir]) != jax_dir, path
        assert os.path.commonpath([os.path.abspath(path), PORT]) == PORT, path


def _c_entries(path):
    """{name: [parameter types]} of the `extern "C" int` entries of a source."""
    with open(path) as f:
        src = f.read()
    out = {}
    for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)\s*\{', src):
        params = [" ".join(p.split()) for p in m.group(2).split(",")]
        out[m.group(1)] = params
    return out


def test_every_c_entry_matches_its_ctypes_signature():
    """Each C entry of csrc/*.cu lies in the source ops/build.py builds it
    from, with as many parameters as its SIGNATURES entry and of the same
    kinds (pointer, int, float, uint32): the kernels build only on the card,
    so a mismatch would show there first.  The f32 flash sources among them
    are built sources, and nothing builds at import (above)."""
    import ctypes

    from vitgan_tpu_torch.ops import build

    found = {}
    for fn in sorted(os.listdir(build.CSRC)):
        if fn.endswith(".cu"):
            for name, params in _c_entries(os.path.join(build.CSRC, fn)).items():
                found[name] = (fn[:-3], params)
    assert set(found) == set(build.SIGNATURES)
    kinds = {ctypes.c_void_p: "*", ctypes.c_int: "int", ctypes.c_float: "float",
             ctypes.c_uint32: "unsigned"}
    for name, (source, params) in found.items():
        assert source == build.SOURCE.get(name, name), name
        want = [kinds[t] for t in build.SIGNATURES[name]]
        got = ["*" if "*" in p else p.split()[0].replace("uint32_t", "unsigned") for p in params]
        assert got == want, name
    for name in build.F32_FLASH:
        assert name in build.SOURCES and found[name][0] == name
