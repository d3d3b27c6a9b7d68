#!/usr/bin/env python3
"""Device time of the flash kernels of one tree of the port at the main path's
shapes, for comparing trees, or variants of one, in turns in one call.

    python scripts/flash_probe.py [--root DIR] [--label NAME]

Run from the repository root: the timers are this repository's chip_smoke.py
(_time_ms, CUDA events; _device_ms, torch.profiler); ``--root`` is the tree
whose ``vitgan_tpu_torch`` is imported (default: this one).  Cases: the `dot`
forward at the serving shape (64 x 6 heads, 1,024 tokens, Dh 64), the single
pass at G's (32 x 6, 1,024), the long (1 x 1, 16,385) and the v1 generator's
(128 x 4, 32, Dh 96, scale 384) shape, the dq kernel at D's (64 x 6, 1,025),
and the forward at the v1 generator's and D's shapes.  Each record: "ms" (the
wrapper), "dev" (its own kernels' device time; for the single pass the kernel
and the parent's scale-and-cast, chip_smoke.FLASH_SYMBOLS), "other" (the rest
of its device time) and "err" (forward: max |kernel - plain|; backward: each
output's max |kernel - plain| / max|plain|, none at the long shape, then
whether two calls are bit-equal).  Prints one JSON line, last.
"""
import argparse
import importlib.util
import json
import os
import sys

REPO = os.getcwd()
ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--root", default=REPO)
ap.add_argument("--label", default="")
args = ap.parse_args()
sys.path.insert(0, os.path.abspath(args.root))
spec = importlib.util.spec_from_file_location("cs", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import torch  # noqa: E402

from vitgan_tpu_torch.ops import attention as A  # noqa: E402
from vitgan_tpu_torch.ops import build  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
build.build()
gen = torch.Generator(device="cuda").manual_seed(3)


def rn(shape):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


out = {"label": args.label}
q, k, v = rn((64, 6, 1024, 64)), rn((64, 6, 1024, 64)), rn((64, 6, 1024, 64))
f = lambda: A.flash_forward(q, k, v, 64.0)  # noqa: E731
o, _ = f()
err = (o.float() - A.attention_reference(q, k, v).float()).abs().max().item()
out["fwd_serving"] = {"ms": cs._time_ms(f, 20),
                      "dev": cs._device_ms(f, 20, ("flash_attn_fwd_kernel",))[0], "err": err}
del q, k, v, o
for label, shape, scale, which in (("fused_G", (32, 6, 1024, 64), 64.0, "fused"),
                                   ("fused_long", (1, 1, 16385, 64), 64.0, "fused"),
                                   ("fused_v1G", (128, 4, 32, 96), 384.0, "fused"),
                                   ("dq_D", (64, 6, 1025, 64), 64.0, "dq"),
                                   ("fwd_v1G", (128, 4, 32, 96), 384.0, "fwd"),
                                   ("fwd_D", (64, 6, 1025, 64), 64.0, "fwd")):
    q, k, v, do = (rn(shape) for _ in range(4))
    o, lse = A.flash_forward(q, k, v, scale)
    a = (q, k, v, o, lse, do, scale)
    if which == "fwd":
        fn, sym = (lambda: A.flash_forward(q, k, v, scale)), ("flash_attn_fwd_kernel",)
        ref = A.attention_reference(q, k, v, "dot", scale)
        got = fn()[0]
        errs = [(got.float() - ref.float()).abs().max().item()]
    else:
        kern, plain = {"fused": (A.flash_backward_fused, A.flash_bwd_fused_reference),
                       "dq": (A.flash_backward_dq, A.flash_bwd_dq_reference)}[which]
        fn = lambda: kern(*a)  # noqa: E731
        sym = cs.FLASH_SYMBOLS[{"fused": "flash_attn_bwd_fused", "dq": "flash_attn_bwd_dq"}[which]]
        got, want = fn(), (plain(*a) if shape[2] < 8192 else None)
        got = got if isinstance(got, tuple) else (got,)
        errs = []
        if want is not None:
            want = want if isinstance(want, tuple) else (want,)
            errs = [(g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
                    for g, w in zip(got, want)]
        again = fn()
        again = again if isinstance(again, tuple) else (again,)
        errs.append(all(torch.equal(x, y) for x, y in zip(got, again)))
    own, other = cs._device_ms(fn, 10, sym)
    out[label] = {"ms": cs._time_ms(fn, 10), "dev": own, "other": other, "err": errs}
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
print(json.dumps(out))
