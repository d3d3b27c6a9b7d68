#!/usr/bin/env python3
"""Check and time the flash kernels, the LN->MLP forms, LN->qkv and the
megablock's training kernels (the backward's LN1 half, wgrad_gemm and
sum_partials among them) of one tree of the port on the card, with
chip_smoke.py's own phases, so that two trees can be compared in one call.

    python scripts/kernel_ab.py [--root DIR] [--label NAME]
        [--splits | --host | --megablock | --l2 | --ticket | --v1-fused | --f32-bwd
         | --f32-ln | --f32-step | --f32-flash-bwd]

``--root`` is the repository root whose ``vitgan_tpu_torch`` is imported
(default: this script's repository).  The phases, shapes, tolerances,
bounds and timing are always this repository's chip_smoke.py:
``check_kernels`` for the flash forward (the serving shape with its
out_bnhd layout, a ragged and a long shape; the wrapper's time and its
kernel's device time beside SDPA and the bound), the two LN->MLP forms
of the serving path, the plain LN->MLP and the megablock's out-projection
form, and LN->qkv (the serving and a ragged shape; wrapper and device time
beside the bound; LN->qkv beside torch.matmul of its product), ``check_bwd_kernels`` (the
single pass, dq and dk/dv at G's, D's, a ragged and a long shape; each
kernel's outputs across two calls; the wrapper's time and, at the main
shape, its kernels' own device time beside SDPA's backward and the bound),
the single pass twice at the v1 generator's shape (`dot`) and the v1
discriminator's (`l2`, bwd_fusion=fused), and ``check_megablock_kernels``
(at G's, D's, a ragged and deit64's shape: LN->qkv and the training forward
with their device times, the backward's MLP half and LN1 half with theirs,
the LN1 half's dln1 partials row for row on a tree whose plain version
gives a row a 64-row tile (else by their sums), LN->qkv and the LN1 half
beside torch.matmul of their products, wgrad_gemm with bit-equal dW and db
across two calls, and sum_partials with its device time and
part.sum(0)'s, beside torch.matmul and the bound; sum_partials also
bit-equal to sum_partials_reference on a tree that has it).  Two calls that are not bit-equal are recorded (max |d| per
output), not raised, so that a tree whose kernel is not deterministic can be
measured.  Run it for two trees in turns (parent, change, change, parent) in
one call on one card.  Prints one JSON line, last.

``--megablock`` runs only ``check_megablock_kernels``: the way to A/B
LN->qkv and the backward's MLP and LN1 halves in one call (with this
tree's package, the MLP half's three stages too).

``--host`` runs only the host phase instead: the CPU time of one call of
each LN->MLP form's wrapper at its main shape (``host_times``).

``--l2`` runs only the `l2` phase: ``check_l2_kernels`` (the `l2`/`l2ref`
forward and the `l2` single pass, dq and dk/dv at chip_smoke.L2_SHAPES; at
the v1 discriminator's shape each wrapper's own kernels' device time and its
other device work, such as delta and a parent's pads; every output's layout
recorded, not raised) and the single pass twice at the v1 shapes.

``--ticket`` runs only the single pass's order phase (``ticket_times``): the
`dot` and `l2` single passes at G's shape and at one head x 16,385 tokens,
each wrapper's time, its kernels' device time and two calls compared.

``--v1-fused`` runs only ``train_v1_fused``: the v1 defaults trained under
use_pallas=always and bwd_fusion=fused (D's backward on the `l2` single
pass), with the device time of 2 profiled steps by kernel group.

``--f32-bwd`` runs only ``check_f32_bwd_kernels``: the saved backward's f32
entries (the A . W^T tile's dz1, dy2 and dy1, dao with delta; the mask and
LayerNorm-backward rows; wgrad_gemm_f32's four products) at highres128's G
and D rows, deit64's ragged batch and DeiT-B's G, each against its plain
version in full f32 and the bf16 kernel's error, timed beside its bound and
torch.matmul in TF32 (device time at G), with the card's name and power
limit; then ``bwd_tile_digest`` (below), so that a change to wgrad_gemm_f32
can be shown to leave the A . W^T tile's bits as they were.

``--f32-ln`` runs only ``check_f32_ln_kernels``: the LayerNorm family's
f32 forward entries (LN -> fc1 with z1, the linear stage with the residual
and a 0.1 mask, LN1 -> qkv) at highres128's serving, G and D rows,
highres256p4's G, DeiT-B's G and a ragged deit64 batch, each against its
plain version in full f32 and the bf16 kernel's error, the masks bit-equal,
timed beside its bound and F.layer_norm + torch.matmul in f32 and TF32
(device time at G), with the card's name and power limit; then the SHA-256
of the outputs of the saved backward's three A . W^T tile entries (dz1
with h1, dy, dao with delta) at highres128's G on seeded inputs
(``bwd_tile_digest``), so that two trees whose tile code is shared can be
shown to give the backward the same bits.

``--f32-step`` runs only chip_smoke's ``_saved_f32_fit``: highres128 at its
preset in f32 (the saved backward, remat attn, dropout 0.1) through
Trainer.fit, launches a step asserted, captured against eager, and the
captured step's device time by kernel group (its weight-gradient groups
among them), with the card's name and power limit.

``--f32-flash-bwd`` runs only ``f32_flash_bwd``: the f32 single pass and
dk/dv (the k-block kernel) at highres128's G and D, highres256p4's G, one
head of 16,385 tokens and the v1 generator's and discriminator's shapes,
each wrapper's time and its kernel's device time beside its TF32 bound and
scaled_dot_product_attention's f32 backward in the same run, its error
against the plain version in full f32 and two calls compared, with the
card's name and power limit.

``--splits`` then times wgrad_gemm at G's and D's four products of one block
backward for each rows_per_split of a sweep, beside ops/wgrad.plan's choice
(the tree must have ``plan``; it is replaced for the sweep only).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (Ka, Nb) of one block backward's four weight-gradient products at
# highres128's widths: dw2, dw1, dwout, dwqkv
WGRAD_PAIRS = ((1536, 384), (384, 1536), (384, 384), (384, 1152))
WGRAD_ROWS = {"G": 32 * 1024, "D": 64 * 1025}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sweep_splits(cs) -> dict:
    """{"G (1536, 384)": {"plan": rps, "ms": {rps: ms}}, ...} over rows_per_split
    = 64 * 2**i, each product timed by chip_smoke's _time_ms."""
    import torch

    from vitgan_tpu_torch.ops import wgrad as WG

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 7)
    planned, out = WG.plan, {}
    try:
        for label, m in WGRAD_ROWS.items():
            for ka, nb in WGRAD_PAIRS:
                a = torch.randn(m, ka, generator=gen, device="cuda").to(torch.bfloat16)
                b = torch.randn(m, nb, generator=gen, device="cuda").to(torch.bfloat16)
                chosen = planned(m, ka, nb, torch.cuda.get_device_properties(0).multi_processor_count)
                times = {}
                for rps in sorted({64 << i for i in range(int(math.log2(m / 64)) + 1)} | {chosen}):
                    WG.plan = lambda *_, r=rps: r
                    times[rps] = cs._time_ms(lambda: WG.wgrad_gemm(a, b), 10)
                WG.plan = planned
                best = min(times, key=times.get)
                out[f"{label} ({ka}, {nb})"] = {"plan": chosen, "best": best, "ms": times}
                print(f"[splits] {label} ({ka}, {nb}): plan {chosen} rows a split "
                      f"{times[chosen]:.4f} ms, best {best} rows {times[best]:.4f} ms")
                del a, b
    finally:
        WG.plan = planned
    return out


def single_pass_repeats(cs) -> dict:
    """The single pass twice at the v1 generator's shape (`dot`, scale 384)
    and the v1 discriminator's (`l2`, scale 432): max |d| per output (dq, dk,
    dv) between the two calls, by chip_smoke's _repeat."""
    import torch

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 8)
    out = {}
    for label, shape, scale, mode in (("v1 G", cs.V1_G_SHAPE, cs.V1_G_SCALE, "dot"),
                                      ("l2 D", (256, 4, 50, 108), 432.0, "l2")):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
        out[label] = cs._repeat(lambda: A.flash_backward_fused(q, k, v, o, lse, do, scale,
                                                                score_mode=mode),
                                f"flash_attn_bwd_fused {label} ({mode})")
    return out


# The single pass where its ticket counts most: G's grid (1,536 `dot` blocks,
# 3,072 `l2` ones) and one head's chain of k-blocks at 16,385 tokens.
TICKET_SHAPES = (("G", (32, 6, 1024, 64)), ("long", (1, 1, 16385, 64)))


def ticket_times(cs) -> dict:
    """{"mode shape": {"ms", "device_ms", "other_device_ms", "repeat"}} of the
    single pass (`dot` at scale Dh, `l2` at H * Dh) at TICKET_SHAPES: the
    wrapper by chip_smoke's _time_ms, its kernels' device time by _device_ms,
    and the max |d| per output (dq, dk, dv) between two calls by _repeat."""
    import torch

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 11)
    out = {}
    for label, shape in TICKET_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        for mode in ("dot", "l2"):
            scale = float(shape[3] * (shape[1] if mode == "l2" else 1))
            o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
            fn = lambda: A.flash_backward_fused(q, k, v, o, lse, do, scale,  # noqa: E731
                                                score_mode=mode)
            iters = 5 if shape[2] > 8192 else 20
            rec = {"ms": cs._time_ms(fn, iters)}
            rec["device_ms"], rec["other_device_ms"] = cs._device_ms(
                fn, iters, cs.FLASH_SYMBOLS["flash_attn_bwd_fused"])
            rec["repeat"] = cs._repeat(fn, f"flash_attn_bwd_fused {mode} {label}")
            out[f"{mode} {label}"] = rec
            print(f"[ticket] {mode} {label}: {rec['ms']:.4f} ms, device {rec['device_ms']} ms "
                  f"(other {rec['other_device_ms']} ms)")
            del o, lse
        del q, k, v, do
        torch.cuda.empty_cache()
    return out


# The f32 k-block kernel's shapes (label, (B, H, N, Dh), score mode): the f32
# highres128 step's G (the single pass) and D (dk/dv after dq), highres256p4's
# G, one head of 16,385 tokens, the v1 generator's (`dot`) and discriminator's
# (`l2`) attention at the reference defaults.
F32_FLASH_BWD_SHAPES = (("highres128 G", (32, 6, 1024, 64), "dot"),
                        ("highres128 D", (32, 6, 1025, 64), "dot"),
                        ("highres256p4 G", (8, 6, 4096, 64), "dot"),
                        ("long", (1, 1, 16385, 64), "dot"),
                        ("v1 G", (128, 4, 32, 96), "dot"),
                        ("v1 D", (256, 4, 50, 108), "l2"))


def f32_flash_bwd(cs) -> dict:
    """{"entry mode shape": record} of the f32 single pass and dk/dv at
    F32_FLASH_BWD_SHAPES (scale Dh for `dot`, H * Dh for `l2`, as the models
    call them) on the f32 forward's o and LSE: the wrapper's time and its
    k-block kernel's device time (its other device work apart: delta, a
    memset, pads) by chip_smoke's _time_ms and _device_ms, each output's
    max |kernel - plain| over its max|plain| (the plain version in full f32;
    skipped past 8,192 tokens, where chip_smoke.py [f32 kernels] holds it),
    the two calls' max |d| per output by _repeat, the bound at TF32 and
    scaled_dot_product_attention's f32 backward (`l2` through its key mask)
    in the same run."""
    import torch
    import torch.nn.functional as F

    from vitgan_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 27)
    entries = (("flash_attn_bwd_fused", A.flash_backward_fused, A.flash_bwd_fused_reference, 5, 3),
               ("flash_attn_bwd_dkv", A.flash_backward_dkv, A.flash_bwd_dkv_reference, 4, 2))
    out = {}
    for label, shape, mode in F32_FLASH_BWD_SHAPES:
        b, h, n, dh = shape
        scale = float(dh * (h if mode == "l2" else 1))
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda") for _ in range(4))
        o, lse = A.flash_forward(q, k, v, scale, score_mode=mode)
        iters = 20 if n < 512 else 5
        xs = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib = (F.scaled_dot_product_attention(*xs, scale=1.0 / math.sqrt(scale)) if mode == "dot"
               else cs._l2_library(*xs, 1.0 / math.sqrt(scale))())
        library_ms = cs._time_ms(lambda: torch.autograd.grad(lib, xs, do, retain_graph=True),
                                 iters)
        del xs, lib
        elem, rows = b * h * n * dh * 4, b * h * n * 4
        for base, fn, plain, products, writes in entries:
            call = lambda fn=fn: fn(q, k, v, o, lse, do, scale, score_mode=mode)  # noqa: E731
            rec = {"shape": list(shape), "mode": mode, "ms": cs._time_ms(call, iters),
                   "library_ms": library_ms}
            rec["device_ms"], rec["other_device_ms"] = cs._device_ms(
                call, iters, cs.F32_SYMBOLS[base])
            rec["bound_ms"], rec["bound_by"] = cs._bound_f32(
                2.0 * products * b * h * n * n * dh, (5 + writes) * elem + rows)
            if n <= 8192:
                got, want = call(), plain(q, k, v, o, lse, do, scale, score_mode=mode)
                rec["rel_err_per_output"] = [err / peak for err, peak in (
                    cs._rel_err(g_, w_, own=True) for g_, w_ in zip(got, want))]
                del got, want
            rec["repeat"] = cs._repeat(call, f"{base}_f32[{mode}] {label}")
            out[f"{base} {mode} {label}"] = rec
            print(f"[f32 flash bwd] {base}_f32[{mode}] {label} {shape}: {rec['ms']:.4f} ms, "
                  f"device {rec['device_ms']} + {rec['other_device_ms']} ms; SDPA f32 backward "
                  f"{library_ms:.4f} ms; bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}; "
                  f"errors {rec.get('rel_err_per_output')}", flush=True)
            torch.cuda.empty_cache()
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    return out


def bwd_tile_digest(cs) -> dict:
    """{entry: SHA-256 of its outputs' bytes} of the saved backward's three
    f32 A . W^T tile entries at highres128's G (32,768 rows, E 384, hidden
    1,536, 6 heads of 64) on inputs made from chip_smoke's seed."""
    import hashlib

    import torch

    from vitgan_tpu_torch.ops import fused_block as FB

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 31)
    b, n, e, heads, hidden = 32, 1024, 384, 6, 1536
    m = b * n

    def rn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    dmlp, z1, w2 = rn(m, e), rn(m, hidden), rn(hidden, e, scale=hidden ** -0.5)
    dz1, w1 = rn(m, hidden, scale=0.1), rn(e, hidden, scale=e ** -0.5)
    da, ao, wout = rn(m, e), rn(m, e), rn(e, e, scale=e ** -0.5)
    calls = {"megablock_bwd_mlp_dz1_f32": lambda: FB.bwd_dz1_stage(dmlp, None, z1, w2)[1:],
             "megablock_bwd_dy_f32": lambda: (FB.bwd_dy(dz1, w1),),
             "megablock_bwd_mlp_dao_f32": lambda: FB.bwd_dao_stage(da, ao, wout, b, n, heads)}
    out = {}
    for name, call in calls.items():
        h = hashlib.sha256()
        for t in call():
            torch.cuda.synchronize()
            h.update(t.contiguous().cpu().numpy().tobytes())
        out[name] = h.hexdigest()
        print(f"[bwd tile digest] {name}: {out[name]}")
    return out


def host_times(cs, calls: int = 36) -> dict:
    """{form: {"host_ms", "wall_ms"}} for the three LN->MLP forms at their
    main shapes (chip_smoke.LN_MLP_MAIN): with the device synchronised, the
    CPU clock around ``calls`` wrapper calls issued back to back (their host
    work: checks, casts, allocations, the launches queued and not waited
    for), and until the device has run them, each over ``calls``; after as
    many calls to warm up.  36 is one highres128 step's calls of a form."""
    import time

    import torch

    from vitgan_tpu_torch.ops import fused_block as FB
    from vitgan_tpu_torch.ops import fused_mlp as FM

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 10)
    shapes = dict(cs.LN_MLP_SHAPES)
    out = {}
    for name, main in cs.LN_MLP_MAIN.items():
        m, e, hidden, hd = shapes[main]
        c = cs._case(1, m, e, e // 64, hidden, gen)
        x, attn = c["x"].reshape(m, e), c["attn"].reshape(m, hd)
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device="cuda")
        mlp = (c["ln_s"], c["ln_b"], c["w1"], c["b1"], c["w2"], c["b2"])
        call = {"ln_mlp_fwd": lambda: FM.ln_mlp_forward(x, *mlp, residual=True),
                "proj_ln_mlp_fwd": lambda: FM.ln_mlp_forward(x, *mlp, attn=attn, wout=c["wout"],
                                                             bout=c["bout"]),
                "ln_mlp_train_fwd": lambda: FB.ln_mlp_train_forward(
                    x, attn, c["wout"], c["bout"], *mlp, seed, cs.MB_RATE)}[name]
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out[name] = {"shape": main, "host_ms": 1e3 * (t1 - t0) / calls,
                     "wall_ms": 1e3 * (t2 - t0) / calls}
        print(f"[host] {name} at {main}: host {out[name]['host_ms']:.4f} ms a call, wall "
              f"{out[name]['wall_ms']:.4f} ms a call over {calls} calls")
        del c, x, attn, call
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true")
    ap.add_argument("--host", action="store_true")
    ap.add_argument("--megablock", action="store_true")
    ap.add_argument("--l2", action="store_true")
    ap.add_argument("--ticket", action="store_true")
    ap.add_argument("--v1-fused", action="store_true")
    ap.add_argument("--f32-bwd", action="store_true")
    ap.add_argument("--f32-ln", action="store_true")
    ap.add_argument("--f32-step", action="store_true")
    ap.add_argument("--f32-flash-bwd", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    cs = _chip_smoke()
    from vitgan_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    cs.STRICT = False  # record how far apart two calls are, and the outputs' layout
    label = args.label or args.root
    print(f"[build] {label}: {build.build()}")
    if args.host:
        print(json.dumps({"label": label, "host": host_times(cs)}))
        return 0
    if args.megablock:
        print(json.dumps({"label": label, "megablock": cs.check_megablock_kernels()[0]}))
        return 0
    if args.l2:
        print(json.dumps({"label": label, "l2": cs.check_l2_kernels(),
                          "single_pass_repeats": single_pass_repeats(cs)}))
        return 0
    if args.ticket:
        print(json.dumps({"label": label, "ticket": ticket_times(cs)}))
        return 0
    if args.v1_fused:
        print(json.dumps({"label": label, "v1_fused": cs.train_v1_fused()[1]}))
        return 0
    if args.f32_bwd:
        print(json.dumps({"label": label, "card": cs._smi(),
                          "f32_bwd": cs.check_f32_bwd_kernels(),
                          "bwd_tile_digest": bwd_tile_digest(cs)}))
        return 0
    if args.f32_flash_bwd:
        print(json.dumps({"label": label, "card": cs._smi(), "f32_flash_bwd": f32_flash_bwd(cs)}))
        return 0
    if args.f32_step:
        run_dir = os.path.join(REPO, "build", f"ab_f32_step_{os.getpid()}")
        try:
            rec = cs._saved_f32_fit(run_dir)
        finally:
            cs._remove_run_dir(run_dir)
        print(json.dumps({"label": label, "card": cs._smi(), "f32_step": rec}, default=str))
        return 0
    if args.f32_ln:
        print(json.dumps({"label": label, "card": cs._smi(), "f32_ln": cs.check_f32_ln_kernels(),
                          "bwd_tile_digest": bwd_tile_digest(cs)}))
        return 0
    rec = {"label": label,
           "fwd": cs.check_kernels(only=("flash_attn_fwd", "ln_mlp_fwd", "proj_ln_mlp_fwd",
                                         "ln_qkv_fwd")),
           "bwd": cs.check_bwd_kernels(), "single_pass_repeats": single_pass_repeats(cs),
           "megablock": cs.check_megablock_kernels()[0]}
    if args.splits:
        rec["splits"] = sweep_splits(cs)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
