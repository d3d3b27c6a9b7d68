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
    # q, k, v, o, lse, bh, n, d, heads, inv_scale, out_bnhd, mode, grid, stream
    # (mode: 0 dot, 1 l2, 2 l2ref; the backward entries take 0 or 1; grid: the
    # `l2` kernels' persistent blocks, ops/attention.l2_grid)
    "flash_attn_fwd": [_P] * 5 + [_I] * 4 + [_F, _I, _I, _I, _P],
    # a, ln_s, ln_b, w1, b1, h, z1, m, e, hidden, eps, act, stream (act:
    # ops/fused_mlp.ACT_ID)
    "ln_mlp_fc1": [_P] * 7 + [_I] * 3 + [_F, _I, _P],
    # a, w, bias, res, seed, out, mask, m, k, n, mask_id, threshold, inv_keep,
    # rows_per_sample, local_batch, global_batch, first_sample, stream
    "ln_mlp_linear": [_P] * 7 + [_I] * 4 + [_U, _F] + [_I] * 4 + [_P],
    # x, ln_s, ln_b, w, bias, qkv, batch, n, e, heads, dh, eps, stream
    "ln_qkv_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, dout, lse, delta, dq, dk, dv, dq_acc, dq_order, bh, n, d,
    # inv_scale, mode, grid, stream
    "flash_attn_bwd_fused": [_P] * 11 + [_I] * 3 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, bh, n, d, inv_scale, mode, grid, stream
    "flash_attn_bwd_dq": [_P] * 7 + [_I] * 3 + [_F, _I, _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, bh, n, d, inv_scale, mode, grid, stream
    "flash_attn_bwd_dkv": [_P] * 8 + [_I] * 3 + [_F, _I, _I, _P],
    # g, m2, z1, w2, dmlp, dz1, h1, m, e, hidden, stream
    "megablock_bwd_mlp_dz1": [_P] * 7 + [_I] * 3 + [_P],
    # dz1, g, m1, x1, w1, ln_s, ln_b, dx1, da, y2, part, m, e, hidden, eps, stream
    "megablock_bwd_mlp_dx1": [_P] * 11 + [_I] * 3 + [_F, _P],
    # da, ao, wout, dao, delta, batch, n, e, heads, dh, stream
    "megablock_bwd_mlp_dao": [_P] * 5 + [_I] * 5 + [_P],
    # dqkv, wqkv, x, dx1, ln_s, ln_b, dx, y1, part, m, e, k, eps, stream
    "megablock_bwd_ln1": [_P] * 9 + [_I] * 3 + [_F, _P],
    # a, b, dw, db, scratch, m, ka, nb, rows_per_split, stream
    "wgrad_gemm": [_P] * 5 + [_I] * 4 + [_P],
    # part, out, splits, count, stream
    "sum_partials": [_P] * 2 + [_I] * 2 + [_P],
    # The wide variants (E > 384, or forced): csrc/ln_rows.cuh's row kernels
    # beside products that stream their activations.
    # x, ln_s, ln_b, y, m, e, eps, stream
    "ln_rows": [_P] * 4 + [_I] * 2 + [_F, _P],
    # y, w1, b1, h, z1, m, e, hidden, act, stream
    "ln_mlp_fc1_wide": [_P] * 5 + [_I] * 4 + [_P],
    # y, w, bias, qkv, batch, n, e, heads, dh, stream
    "ln_qkv_fwd_wide": [_P] * 4 + [_I] * 5 + [_P],
    # g, m2, dmlp, m, e, stream
    "megablock_bwd_mask_rows": [_P] * 3 + [_I] * 2 + [_P],
    # dmlp, z1, w2, dz1, h1, m, e, hidden, stream
    "megablock_bwd_mlp_dz1_wide": [_P] * 5 + [_I] * 3 + [_P],
    # a, w, dy, m, k, n, stream
    "megablock_bwd_dy": [_P] * 3 + [_I] * 3 + [_P],
    # dy2, g, m1, x1, ln_s, ln_b, dx1, da, y2, part, m, e, eps, stream
    "megablock_bwd_mlp_dx1_rows": [_P] * 10 + [_I] * 2 + [_F, _P],
    # da, ao, wout, dao, delta, batch, n, e, heads, dh, stream
    "megablock_bwd_mlp_dao_wide": [_P] * 5 + [_I] * 5 + [_P],
    # dy1, x, dx1, ln_s, ln_b, dx, y1, part, m, e, eps, stream
    "megablock_bwd_ln1_rows": [_P] * 8 + [_I] * 2 + [_F, _P],
    # The flash kernels in f32 (csrc/flash_f32.cuh), each entry its own source:
    # q, k, v, o, lse, bh, n, d, inv_scale, mode, heads, out_bnhd, stream
    "flash_attn_fwd_f32": [_P] * 5 + [_I] * 3 + [_F, _I, _I, _I, _P],
}
# The f32 flash backward entries take their bf16 entry's arguments (grid
# unread); so does the f32 linear stage, its weight K-major (N, K).  The
# LayerNorm family's f32 forward entries (csrc/ln_f32.cuh on
# csrc/tile_f32.cuh's tile, each its own source) stream any E: they have no
# wide variant.
SIGNATURES.update({f"{name}_f32": SIGNATURES[name] for name in (
    "flash_attn_bwd_dq", "flash_attn_bwd_dkv", "flash_attn_bwd_fused", "ln_mlp_linear")})
# The LayerNorm entries take their weight K-major and add the LayerNorm rows'
# f32 scratch y (M, E) after the outputs:
# a, ln_s, ln_b, w1t, b1, h, z1, y, m, e, hidden, eps, act, stream
SIGNATURES["ln_mlp_fc1_f32"] = [_P] * 8 + [_I] * 3 + [_F, _I, _P]
# x, ln_s, ln_b, wt, bias, qkv, y, batch, n, e, heads, dh, eps, stream
SIGNATURES["ln_qkv_fwd_f32"] = [_P] * 7 + [_I] * 5 + [_F, _P]
# The saved backward's f32 entries (csrc/tile_f32.cuh's A . W^T tile,
# wgrad_gemm_f32.cu and ln_rows.cuh's rows on f32, each entry its own source) take their bf16
# entry's arguments, the dz1 entry the wide dz1's (dmlp formed first by the
# mask rows): every E in one kernel, no wide variant.
SIGNATURES.update({f"{name}_f32": SIGNATURES[name] for name in (
    "megablock_bwd_mask_rows", "megablock_bwd_dy", "megablock_bwd_mlp_dx1_rows",
    "megablock_bwd_mlp_dao", "megablock_bwd_ln1_rows", "wgrad_gemm")})
SIGNATURES["megablock_bwd_mlp_dz1_f32"] = SIGNATURES["megablock_bwd_mlp_dz1_wide"]
# The f32 flash entries, whose launches count by score mode only.
F32_FLASH = ("flash_attn_fwd_f32", "flash_attn_bwd_fused_f32", "flash_attn_bwd_dq_f32",
             "flash_attn_bwd_dkv_f32")
SOURCE = {"ln_mlp_fc1": "ln_mlp_fwd", "ln_mlp_linear": "ln_mlp_fwd", "ln_rows": "ln_mlp_fwd",
          "ln_mlp_fc1_wide": "ln_mlp_fwd", "ln_qkv_fwd_wide": "ln_qkv_fwd",
          **{f"megablock_bwd_mlp_{stage}": "megablock_bwd_mlp"
             for stage in ("dz1", "dx1", "dao", "dz1_wide", "dx1_rows", "dao_wide")},
          "megablock_bwd_mask_rows": "megablock_bwd_mlp", "megablock_bwd_dy": "megablock_bwd_mlp",
          "megablock_bwd_ln1_rows": "megablock_bwd_ln1", "sum_partials": "wgrad_gemm"}
SOURCES = sorted({SOURCE.get(name, name) for name in SIGNATURES})

# Launch counts by wrapper, each added to where its kernel launches.  The two
# stage kernels of ln_mlp_fwd.cu count their own launches ("ln_mlp_fc1",
# "ln_mlp_linear"); the three LN->MLP forms that compose them count their
# calls besides: the plain LN->MLP ("ln_mlp_fwd", a fc1 and a linear launch a
# call), the megablock's out-projection form ("proj_ln_mlp_fwd", a fc1 and
# two linear) and its training form ("ln_mlp_train_fwd", the same).  So do
# the three stage kernels of megablock_bwd_mlp.cu ("megablock_bwd_mlp_dz1",
# "_dx1", "_dao") and the backward's MLP half that composes them
# ("megablock_bwd_mlp", one launch of each a call).  At E > 384 (or
# forced) the same calls launch the wide variants instead, each counted
# under its own name: LN->fc1 as "ln_rows" and "ln_mlp_fc1_wide", LN->qkv as
# "ln_rows" and "ln_qkv_fwd_wide", the MLP half as "megablock_bwd_mask_rows"
# (with dropout), "megablock_bwd_mlp_dz1_wide", "megablock_bwd_dy",
# "megablock_bwd_mlp_dx1_rows" and "megablock_bwd_mlp_dao_wide" (the calls
# still counted as "megablock_bwd_mlp"), the LN1 half as "megablock_bwd_dy"
# and "megablock_bwd_ln1_rows" (no "megablock_bwd_ln1").  The flash kernels
# count their `dot` launches under their name and the other score modes
# apart, as "flash_attn_fwd[l2]"; the f32 kernels every mode apart, as
# "flash_attn_fwd_f32[dot]" (ops/attention.launch_key).  The LayerNorm
# family's f32 entries count under their own names ("ln_mlp_fc1_f32",
# "ln_mlp_linear_f32", "ln_qkv_fwd_f32"), and the three LN->MLP forms count
# their f32 calls as their bf16 ones.  So do the saved backward's f32 entries
# ("megablock_bwd_mask_rows_f32" with dropout, "megablock_bwd_mlp_dz1_f32",
# "megablock_bwd_dy_f32" twice a block, "megablock_bwd_mlp_dx1_rows_f32",
# "megablock_bwd_mlp_dao_f32", "megablock_bwd_ln1_rows_f32", "wgrad_gemm_f32"
# four times), the MLP half's f32 calls counted as "megablock_bwd_mlp" too.
LAUNCHES = {name: 0 for name in SIGNATURES if name not in F32_FLASH}
LAUNCHES.update(ln_mlp_fwd=0, proj_ln_mlp_fwd=0, ln_mlp_train_fwd=0, megablock_bwd_mlp=0)
LAUNCHES.update({f"{name}[{mode}]": 0 for name, modes in (
    ("flash_attn_fwd", ("l2", "l2ref")), ("flash_attn_bwd_fused", ("l2",)),
    ("flash_attn_bwd_dq", ("l2",)), ("flash_attn_bwd_dkv", ("l2",)),
    ("flash_attn_fwd_f32", ("dot", "l2", "l2ref")), ("flash_attn_bwd_fused_f32", ("dot", "l2")),
    ("flash_attn_bwd_dq_f32", ("dot", "l2")), ("flash_attn_bwd_dkv_f32", ("dot", "l2")))
    for mode in modes})

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
