#!/usr/bin/env python3
"""How far one v1 train step's gradients move with the arithmetic of the route.

Runs chip_smoke.compare_v1_train_routes at each batch given, with its two
diagnostic routes: the flash forward kernels with the backward's plain
versions, dS rounded to bf16 before its products (as the backward kernels
round it) and dS in f32 (as autograd through the plain attention keeps it).
Prints, beside the kernel routes and the bf16 plain route, each scalar
leaf's f32 gradient, the sum of its per-sample terms' magnitudes and each
route's distance from the f32 plain route in units of that sum.  Needs one
CUDA card; the kernels are built at first use.

    python scripts/v1_route_precision.py --batch 8 32

Nothing here measures time.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8])
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32
    torch.backends.cudnn.allow_tf32 = False
    print(f"{chip_smoke._smi()}; torch {torch.__version__}")
    for batch in args.batch:
        chip_smoke.compare_v1_train_routes(batch, diagnose=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
