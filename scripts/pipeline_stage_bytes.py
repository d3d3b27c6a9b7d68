"""The train state's bytes a pipe rank holds under pipeline parallelism, from
the port's own stage rule (vitgan_tpu_torch/parallel/pipeline.stage_of), for
a preset's G and D at S = 1, 2 and 4 stages.

    python scripts/pipeline_stage_bytes.py [--preset highres128] [--stages 1 2 4]

Counts, from the modules built on the meta device (nothing allocated), what
the placement leaves a stage (parallel/sharding.place_train_state): its
blocks' leaves and every leaf outside the stacks, each as f32 parameter,
gradient and two Adam moments (16 bytes a parameter), plus G's EMA (4 bytes a
G parameter).  The stage that holds the most prints; activations are not
counted.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.parallel.pipeline import module_depth, stage_of

    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="highres128")
    ap.add_argument("--stages", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()
    cfg = {"highres128": lambda: C.highres_config(128), "highres256": lambda: C.highres_config(256),
           "highres256p4": C.highres256p4_config}[args.preset]()
    gan = build_gan(cfg)
    with torch.device("meta"):
        nets = {"g": gan.generator_init(None, device="meta"),
                "d": gan.discriminator_init(None, device="meta")}
    for stages in args.stages:
        worst = 0
        for stage in range(stages):
            total = 0
            for net, module in nets.items():
                depth = module_depth(module)
                held = sum(p.numel() for name, p in module.named_parameters()
                           if stages == 1 or stage_of(name, depth, stages) in (None, stage))
                total += held * (16 + (4 if net == "g" and cfg.run.ema_decay > 0 else 0))
            worst = max(worst, total)
        print(f"{args.preset} S={stages}: {worst} bytes a rank ({worst / 2 ** 30:.3f} GiB) of "
              "f32 parameters, gradients, Adam moments and G's EMA")
    return 0


if __name__ == "__main__":
    sys.exit(main())
