#!/usr/bin/env python3
"""Cycles of each phase inside the LN->qkv kernel, the megablock backward's
LN1 half and the persistent `l2` flash kernels (the forward, the single pass,
dq and dk/dv), on the card.

    python scripts/phase_trace.py [--blocks 0 77]

No profiler below the kernel level works on the card's machine (`ncu` does
not), so this reads the SM's own clock.  It copies the kernels' sources
(ops/csrc: ln_qkv_fwd.cu, megablock_bwd_ln1.cu, the flash sources and the
headers they include) to build/phase_trace/, inserts `clock64()` marks at the phase
boundaries of the first consumer warpgroup's first thread in the blocks
named by ``--blocks`` (anchored on the sources' own lines: the script fails
when an anchor is missing, so a changed kernel is never traced at the wrong
place), compiles each copy with ops/build.NVCC_FLAGS, binds it in place of
the package's library and calls the package's wrapper three times at the
kernel's main shape (LN->qkv at the serving shape, 65,536 rows of E 384 into
6 heads of 64; the LN1 half at G's, 32,768 rows, E 384, K 1,152; the `l2`
forward, single pass, dq and dk/dv at the v1 discriminator's, 256 x 4 heads,
50 tokens, Dh 108).
Phases of a 128-row LN->qkv unit: the wait for its x, the LayerNorm, then
for each 192-column tile the products, the epilogue's staging and the
copy-out; of a 64-row LN1 tile: the products, the wait for x, the row
statistics, the LayerNorm sums, the epilogue and the stores with the column
partials; of an `l2` backward unit (one head, on the second consumer
warpgroup, which takes every other head): the time since its previous unit,
the wait for its resident rows, their fragments and norms, the wait for its
tile, the tile's re-layout, S, P, dP and dS, the output boxes (staged as
they are formed), the entry's release (in the single pass with K's layout)
and the single pass's dQ; of an `l2` forward unit: the same up to the re-layout, then S and the
softmax, O = P V and the staging of O.
The first unit of each block (its wait holds the launch's first loads) is
left out of the means.  Prints one JSON line: the mean cycles of each phase per
unit and their shares of the unit.  The marks cost a few cycles each and
one register; the kernels are otherwise those of the tree.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "phase_trace")
SLOTS = 2048  # marks a traced block

_TRACE_DEF = ("__device__ unsigned long long g_trace[{n}];\n"
              "extern \"C\" int trace_read(void* dst) {{\n"
              "  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace));\n}}\n")
_TRACE_ON = ("  int ti = -1;\n"
             "  if (threadIdx.x == 128) {{\n"
             "    const int blocks[] = {{{blocks}}};\n"
             "    for (int k = 0; k < {nb}; ++k) if ((int)blockIdx.x == blocks[k]) ti = k * {slots};\n"
             "  }}\n"
             "#define TR() do {{ if (ti >= 0) ::g_trace[ti++] = clock64(); }} while (0)\n"
             "  TR();\n")

# (file, anchor, where the mark goes: "after" or "before" the anchor)
QKV_MARKS = (
    ("ln_qkv_fwd.cu", "    mbar_wait(afull, i & 1);\n", "after"),
    ("ln_qkv_fwd.cu", "    named_bar_sync(1 + w, 128);    // this warpgroup reads only its own 64 rows\n",
     "after"),
    ("ln_qkv_fwd.cu", "      wgmma_wait<0>();\n      fence_regs(acc);\n", "after"),
    ("ln_qkv_fwd.cu", "      named_bar_sync(1 + w, 128);\n      // to (3, B, H, N, Dh)", "before"),
    ("ln_qkv_fwd.cu", "    }  // the tile\n", "before"),
)
LN1_MARKS = (
    ("ln_bwd_tile.cuh", "    const int m0 = u * BM;\n", "after"),
    ("ln_bwd_tile.cuh", "    fence_regs(acc);\n", "after"),
    ("ln_bwd_tile.cuh", "    mbar_wait(tfull, i & 1);\n", "after"),
    ("ln_bwd_tile.cuh", "      if ((lane & 7) == 0) stats[r] = make_float2(mean, rstd);\n    }\n"
                        "    named_bar_sync(3, 256);\n", "after"),
    ("ln_bwd_tile.cuh", "make_float2(st[h], sty[h]);\n    }\n    named_bar_sync(3, 256);\n", "after"),
    ("ln_bwd_tile.cuh", "    fence_proxy_async();  // y and the bf16 output, to the TMA unit\n", "before"),
)
L2_MARKS = (
    ("flash_l2_bwd.cuh", "    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);\n"
                         "    const int bh = sh.unit(i);\n", "before"),
    ("flash_l2_bwd.cuh", "    unsigned char* x1 = sh.rent(i) + off;  // the unit's R1 rows, then R2\n",
     "before"),
    ("flash_l2_bwd.cuh", "    if constexpr (!DKV) {  // dq: the rows' LSE (log2 units) and delta\n",
     "before"),
    ("flash_l2_bwd.cuh", "    mbar_wait(sh.tfull(i % sh.g.tn), (i / sh.g.tn) & 1);\n", "after"),
    ("flash_l2_bwd.cuh", "    if (ct == 0) mbar_arrive(sh.tfree(i % sh.g.tn));\n", "after"),
    ("flash_l2_bwd.cuh", "    uint32_t pf[4][4], df[4][4];\n    pack_frags(pf, sa);\n", "before"),
    ("flash_l2_bwd.cuh", "    fence_frags(pf);\n    fence_frags(df);\n    if constexpr (FUSED) {\n",
     "before"),
    ("flash_l2_bwd.cuh", "    if constexpr (FUSED) {\n      // dQ = 2 inv (dS K", "before"),
    ("flash_l2_bwd.cuh", "  }\n  if (FUSED && ct == 0) hopper::bulk_wait<0>();\n", "before"),
)
L2_FWD_MARKS = (
    ("flash_attn_fwd.cu", "    mbar_wait(sh.rfull(i % sh.g.rn), (i / sh.g.rn) & 1);\n"
                          "    const int bh = sh.unit(i);\n", "before"),
    ("flash_attn_fwd.cu", "    unsigned char* xq = sh.rent(i) + off;\n    uint32_t qa[DP / 16][4];\n"
                          "    load_frags<DP>(qa, xq, lrow, n, d);\n", "before"),
    ("flash_attn_fwd.cu", "    mbar_wait(sh.tfull(i % sh.g.tn), (i / sh.g.tn) & 1);\n", "before"),
    ("flash_attn_fwd.cu", "    mbar_wait(sh.tfull(i % sh.g.tn), (i / sh.g.tn) & 1);\n", "after"),
    ("flash_attn_fwd.cu", "    if (ct == 0) mbar_arrive(sh.tfree(i % sh.g.tn));\n", "after"),
    ("flash_attn_fwd.cu", "    uint32_t pf[4][4];\n    pack_frags(pf, sa);\n", "before"),
    ("flash_attn_fwd.cu", "    fence_frags(pf);\n#pragma unroll\n    for (int b = 0; b < NB; ++b)\n"
                          "      stage_box(", "before"),
    ("flash_attn_fwd.cu", "    mbar_arrive(sh.rfree(i % sh.g.rn));\n  }\n}\n\n// Lockstep", "after"),
)
# where each kernel's marks switch on (the consumers' register hand-over; the
# `l2` kernels' ping-pong consumer)
START = {"ln_qkv_fwd.cu": "  reg_alloc<232>();\n", "ln_bwd_tile.cuh": "  reg_alloc<232>();\n",
         "flash_l2_bwd.cuh": "  const bool row_ok[2] = {lrow < n, lrow + 8 < n};\n",
         "flash_attn_fwd.cu": "  float* nk = sh.trows + w * 3 * TILE + 2 * TILE;\n"}
# each traced library and the line of its source the trace's buffer goes before
LIBS = {"ln_qkv_fwd": '#include "hopper.cuh"\n', "megablock_bwd_ln1": '#include "hopper.cuh"\n',
        "flash_attn_fwd": '#include "flash_l2.cuh"\n',
        "flash_attn_bwd_fused": '#include "flash_attn_bwd.cuh"\n',
        "flash_attn_bwd_dq": '#include "flash_attn_bwd.cuh"\n',
        "flash_attn_bwd_dkv": '#include "flash_attn_bwd.cuh"\n'}


def _insert(src: str, anchor: str, how: str) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"phase_trace: anchor not found once in the source: {anchor!r}")
    if how == "after" and anchor.endswith("// Lockstep"):  # the mark before the loop's end
        head = anchor[:anchor.index("  }\n}")]
        return src.replace(anchor, head + "TR();\n" + anchor[len(head):])
    return src.replace(anchor, anchor + "TR();\n" if how == "after" else "TR();\n" + anchor)


def instrument(blocks) -> dict:
    """Instrumented copies of the libraries' sources under OUT; returns
    {library: path of its .cu}."""
    from vitgan_tpu_torch.ops import build

    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    for fn in os.listdir(build.CSRC):
        shutil.copy(os.path.join(build.CSRC, fn), OUT)
    on = _TRACE_ON.format(blocks=", ".join(map(str, blocks)), nb=len(blocks), slots=SLOTS)
    for marks in (QKV_MARKS, LN1_MARKS, L2_MARKS, L2_FWD_MARKS):
        path = os.path.join(OUT, marks[0][0])
        with open(path) as f:
            src = f.read()
        start = START[marks[0][0]]
        if src.count(start) != 1:
            raise RuntimeError(f"phase_trace: no single {start!r} in {marks[0][0]}")
        src = src.replace(start, start + on)
        for _, anchor, how in marks:
            src = _insert(src, anchor, how)
        with open(path, "w") as f:
            f.write(src)
    sources = {}
    for lib, anchor in LIBS.items():
        path = os.path.join(OUT, f"{lib}.cu")
        with open(path) as f:
            src = f.read()
        if src.count(anchor) != 1:
            raise RuntimeError(f"phase_trace: no single {anchor!r} in {lib}.cu")
        src = src.replace(anchor, _TRACE_DEF.format(n=SLOTS * len(blocks)) + anchor, 1)
        with open(path, "w") as f:
            f.write(src)
        sources[lib] = path
    return sources


def bind(lib_name: str, so: str):
    from vitgan_tpu_torch.ops import build

    lib = ctypes.CDLL(so)
    fn = getattr(lib, lib_name)
    fn.argtypes, fn.restype = build.SIGNATURES[lib_name], ctypes.c_int
    err = lib.kernel_error_string
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    fn.error_string = err
    build._LIBS[lib_name] = fn
    lib.trace_read.argtypes, lib.trace_read.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


def summarise(units: list, labels: list) -> dict:
    mean = [sum(u[k] for u in units) / len(units) for k in range(len(labels))]
    total = sum(mean)
    cycles, share = {}, {}
    for lab, v in zip(labels, mean):
        cycles[lab] = cycles.get(lab, 0.0) + v
    for lab, v in cycles.items():
        share[lab] = v / total
    return {"units": len(units), "cycles_per_unit": cycles, "share": share,
            "cycles_total": total}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", type=int, nargs="+", default=[0, 77])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("phase_trace: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vitgan_tpu_torch.ops import attention as A
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.ops import fused_block as FB

    sources = instrument(args.blocks)
    procs = {lib: subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", f"{src[:-3]}.so",
                                    src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for lib, src in sources.items()}
    for lib, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"phase_trace: nvcc failed for {lib}:\n{log}")
    gen = torch.Generator(device="cuda").manual_seed(11)

    def rn(*s, scale=1.0, dtype=torch.bfloat16):
        return (scale * torch.randn(s, generator=gen, device="cuda")).to(dtype)

    f32 = torch.float32
    out = {"device": torch.cuda.get_device_name(0), "blocks": args.blocks}
    runs = {
        "ln_qkv_fwd": (lambda: FB.ln_qkv_forward(*qkv), (64, 1024, 384, 6, 64)),
        "megablock_bwd_ln1": (lambda: FB.megablock_bwd_ln1(*ln1), (32768, 384, 1152)),
        "flash_attn_fwd": (lambda: A.flash_forward(*l2[:3], l2[-1], score_mode="l2"),
                           (256, 4, 50, 108)),
        "flash_attn_bwd_fused": (lambda: A.flash_backward_fused(*l2, score_mode="l2"),
                                 (256, 4, 50, 108)),
        "flash_attn_bwd_dq": (lambda: A.flash_backward_dq(*l2, score_mode="l2"), (256, 4, 50, 108)),
        "flash_attn_bwd_dkv": (lambda: A.flash_backward_dkv(*l2, score_mode="l2"),
                               (256, 4, 50, 108)),
    }
    b, n, e, h, dh = runs["ln_qkv_fwd"][1]
    qkv = (rn(b, n, e), 1 + rn(e, scale=0.1, dtype=f32), rn(e, scale=0.1, dtype=f32),
           rn(3, h, e, dh, scale=0.02), rn(3 * h * dh, scale=0.1, dtype=f32))
    m, e1, k = runs["megablock_bwd_ln1"][1]
    ln1 = (rn(m, k), rn(3, k // 192, e1, 64, scale=0.02), rn(m, e1), rn(m, e1, dtype=f32),
           1 + rn(e1, scale=0.1, dtype=f32), rn(e1, scale=0.1, dtype=f32))
    shape = runs["flash_attn_bwd_dq"][1]
    q_, k_, v_, do_ = (rn(*shape) for _ in range(4))
    scale = float(shape[1] * shape[3])
    o_, lse_ = A.flash_forward(q_, k_, v_, scale, score_mode="l2")
    l2 = (q_, k_, v_, o_, lse_, do_, scale)
    for lib, (call, shape) in runs.items():
        handle = bind(lib, f"{sources[lib][:-3]}.so")
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        buf = torch.zeros(SLOTS * len(args.blocks), dtype=torch.int64)
        if handle.trace_read(ctypes.c_void_p(buf.data_ptr())) != 0:
            raise RuntimeError("phase_trace: reading the marks failed")
        if lib == "ln_qkv_fwd":
            # marks: the consumers' start, then a unit: x landed, LayerNorm
            # done, then a tile: products, staging, copy-out done
            labels = ["wait_x", "layernorm"] + ["products", "staging", "copy_out"] * (
                -(-3 * h * dh // 192))
        elif lib == "flash_attn_fwd":
            # marks: the consumer's start, then a unit: its start, resident
            # rows landed, fragments and norms, tile landed, tile re-laid, S
            # and softmax done, O = P V done, O staged and the entry released
            labels = ["between_units", "wait_resident", "fragments", "wait_tile", "relayout",
                      "scores_softmax", "pv", "staging"]
        elif lib.startswith("flash"):
            # marks: the consumer's start, then a unit: its start, resident
            # rows landed, fragments and norms, tile landed, tile re-laid,
            # S/P/dP/dS done, boxes done and staged, the entry released (the
            # single pass: K laid out too), the single pass's dQ formed,
            # staged and stored (none in the two-pass kernels)
            labels = ["between_units", "wait_resident", "fragments", "wait_tile", "relayout",
                      "scores_softmax", "boxes", "release", "single_pass_dq"]
        else:
            # marks: the consumers' start, then a tile: its start, products,
            # x landed, statistics, sums, epilogue done (the stores and
            # partials run to the next tile's start)
            labels = ["products", "wait_x", "statistics", "ln_sums", "epilogue",
                      "stores_partials"]
        units = []
        for blk in range(len(args.blocks)):
            t = buf[blk * SLOTS:(blk + 1) * SLOTS].tolist()
            t = t[:next((i for i, v in enumerate(t) if v == 0), len(t))]
            if lib == "ln_qkv_fwd" or lib.startswith("flash"):
                per = len(labels)
                for u in range(1, (len(t) - 1) // per):
                    seg = t[u * per:(u + 1) * per + 1]
                    units.append([b_ - a_ for a_, b_ in zip(seg, seg[1:])])
            else:
                groups = [t[i:i + 6] for i in range(1, len(t) - 5, 6)]
                for u in range(1, len(groups) - 1):
                    seg = groups[u] + [groups[u + 1][0]]
                    units.append([b_ - a_ for a_, b_ in zip(seg, seg[1:])])
        if not units:
            raise RuntimeError(f"phase_trace: {lib}: no whole unit traced in blocks {args.blocks}")
        out[lib] = {"shape": shape, **summarise(units, labels)}
        print(f"[phase_trace] {lib} {shape}: {out[lib]['units']} units; cycles a unit "
              + ", ".join(f"{k_} {v:.0f} ({100 * out[lib]['share'][k_]:.1f}%)"
                          for k_, v in out[lib]["cycles_per_unit"].items()))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
