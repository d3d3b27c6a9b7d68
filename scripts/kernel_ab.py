#!/usr/bin/env python3
"""Check and time the flash backward kernels and the megablock's training
kernels (wgrad_gemm among them) of one tree of the port on the card, with
chip_smoke.py's own phases, so that two trees can be compared in one call.

    python scripts/kernel_ab.py [--root DIR] [--label NAME] [--splits]

``--root`` is the repository root whose ``vitgan_tpu_torch`` is imported
(default: this script's repository).  The phases, shapes, tolerances,
bounds and timing are always this repository's chip_smoke.py:
``check_bwd_kernels`` (the single pass, dq and dk/dv at G's, D's, a ragged
and a long shape; dk/dv bit-equal across two calls; the wrapper's time and,
at the main shape, its kernels' own device time beside SDPA's backward and
the bound) and ``check_megablock_kernels`` (the training forward, the two
backward row kernels, wgrad_gemm with bit-equal dW and db across two calls,
and sum_partials at G's, D's and a ragged shape, beside torch.matmul and the
bound).  Run it for two trees in turns (parent, change, change, parent) in
one call on one card.  Prints one JSON line, last.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--label", default="")
    ap.add_argument("--splits", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    cs = _chip_smoke()
    from vitgan_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    label = args.label or args.root
    print(f"[build] {label}: {build.build()}")
    rec = {"label": label, "bwd": cs.check_bwd_kernels(),
           "megablock": cs.check_megablock_kernels()[0]}
    if args.splits:
        rec["splits"] = sweep_splits(cs)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
