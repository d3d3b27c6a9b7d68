"""Builds the port's CUDA kernels at first use and binds them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, under ``ops/_build/`` (listed in
.gitignore), named by a hash of the sources and flags so that an edited
kernel is rebuilt.  Nothing here runs at import time: a CPU tensor never
reaches this module, and this module never imports ``triton``.

Every C entry takes device pointers and the stream as ``c_void_p`` and
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code.  ``LAUNCHES`` counts the launches of each kernel wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# C signature of each entry point.  An entry lives in the library of the same
# name unless SOURCE names another.
SIGNATURES = {
    # q, k, v, o, lse, bh, n, d, heads, inv_scale, out_bnhd, mode, stream
    # (mode: 0 dot, 1 l2, 2 l2ref; the backward entries take 0 or 1)
    "flash_attn_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _P],
    # x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2, out,
    # m, e, hd, hidden, eps, residual, stream
    "ln_mlp_fwd": [_P] * 11 + [_I] * 4 + [_F, _I, _P],
    # x, ln_s, ln_b, w, bias, qkv, batch, n, e, heads, dh, eps, stream
    "ln_qkv_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, rs_acc, bh, n, d, inv_scale,
    # mode, stream
    "flash_attn_bwd_fused": [_P] * 11 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, mode, stream
    "flash_attn_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, bh, n, d, inv_scale, mode, stream
    "flash_attn_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _P],
    # x, attn, wout, bout, ln_s, ln_b, w1, b1, w2, b2, seed, out, m1, m2, x1, z1,
    # m, e, hd, hidden, eps, threshold, inv_keep, stream
    "ln_mlp_train_fwd": [_P] * 16 + [_I] * 4 + [_F, _U, _F, _P],
    # g, m1, m2, x1, z1, ao, w1, w2, wout, ln_s, ln_b, dmlp, dz1, h1, y2, dx1, da,
    # dao, delta, part, batch, n, e, heads, dh, hidden, eps, stream
    "megablock_bwd_mlp": [_P] * 20 + [_I] * 6 + [_F, _P],
    # dqkv, wqkv, x, dx1, ln_s, ln_b, dx, y1, part, m, e, k, eps, stream
    "megablock_bwd_ln1": [_P] * 9 + [_I] * 3 + [_F, _P],
    # a, b, dw, db, scratch, m, ka, nb, rows_per_split, stream
    "wgrad_gemm": [_P] * 5 + [_I] * 4 + [_P],
    # part, out, splits, count, stream
    "sum_partials": [_P] * 2 + [_I] * 2 + [_P],
}
SOURCE = {"ln_mlp_train_fwd": "ln_mlp_fwd", "sum_partials": "wgrad_gemm"}
SOURCES = sorted({SOURCE.get(name, name) for name in SIGNATURES})

# Launch counts by wrapper.  ln_mlp_fwd.cu serves three wrappers: the plain
# LN->MLP ("ln_mlp_fwd"), the megablock's out-projection form
# ("proj_ln_mlp_fwd") and its training form ("ln_mlp_train_fwd").  The flash
# kernels count their `dot` launches under their name and the other score
# modes apart, as "flash_attn_fwd[l2]" (ops/attention.launch_key).
LAUNCHES = {name: 0 for name in SIGNATURES}
LAUNCHES["proj_ln_mlp_fwd"] = 0
LAUNCHES.update({f"{name}[{mode}]": 0 for name, modes in (
    ("flash_attn_fwd", ("l2", "l2ref")), ("flash_attn_bwd_fused", ("l2",)),
    ("flash_attn_bwd_dq", ("l2",)), ("flash_attn_bwd_dkv", ("l2",))) for mode in modes})

_LIBS: dict = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from "
        "vitgan_tpu_torch/ops/csrc at first use on a machine with the CUDA "
        "toolkit; CPU tensors take the plain PyTorch versions instead")


def lib_path(name: str) -> str:
    """The library's path, named by a hash of the flags, the source and every
    header in csrc/."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(fn for fn in os.listdir(CSRC) if fn.endswith(".cuh"))
    for fn in (f"{name}.cu", *headers):
        with open(os.path.join(CSRC, fn), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names=None) -> dict:
    """Compile the named sources (default: all) in parallel, one ``nvcc`` per
    source.  Returns {name: seconds}; 0.0 for a library already built.
    Raises RuntimeError with nvcc's output when a build fails."""
    names = SOURCES if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.{os.getpid()}.tmp"
        log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       log, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, log, tmp, out, t0) in procs.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        log.close()
        if rc == 0:
            os.replace(tmp, out)  # atomic: another process building too sees all or nothing
        else:
            failed.append(f"{name} (nvcc rc {rc}):\n{build_log(name)}")
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) of the last build."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def entry(name: str):
    """The bound C entry point ``name``, its library built if needed."""
    with _LOCK:
        fn = _LIBS.get(name)
        if fn is None:
            source = SOURCE.get(name, name)
            path = lib_path(source)
            if not os.path.exists(path):
                build([source])
            lib = ctypes.CDLL(path)
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            fn.error_string = err
            _LIBS[name] = fn
    return fn


def check(fn, code: int) -> None:
    if code != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {code}: "
                           f"{fn.error_string(code).decode()}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def aligned16(t):
    """``t`` if its base address is 16-byte aligned (the kernels copy 16 bytes
    at a time), else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()
