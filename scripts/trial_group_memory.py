"""Peak device memory and step time of the vectorized sweep's trial group
(train/vstep.TrialGroup) against the in-place plain step, at the reference
search space's widest trial shape (32 px, depth 6, embed 512, 8 heads,
batch 256, Adam(0, 0.99), runtime.use_pallas=never).

    python scripts/trial_group_memory.py [--trials 1 2 4]

Prints one line per measurement with the card's name and power limit: ms a
step (host clock to a synchronize, 2 timed steps after one warm-up) and the
peak of torch.cuda.max_memory_allocated.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.hpo import sweep as SW
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import host_metrics, make_train_step
    from vitgan_tpu_torch.train.vstep import TrialGroup

    p = argparse.ArgumentParser()
    p.add_argument("--trials", type=int, nargs="+", default=[1, 2, 4])
    args = p.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    widest = {"embed_dim": 512, "num_heads": 8, "batch_size": 256}
    base = C.replace(C.ExperimentConfig(family="v2", data=C.DataConfig(dataset="synthetic")),
                     **{"run.epochs": 1})
    cfg = C.replace(SW._trial_config(base, dict(gen_lr=1e-4, disc_lr=2e-4, **widest)), **{
        "v2.gen_optim.inject_lr": True, "v2.disc_optim.inject_lr": True,
        "runtime.use_pallas": "never"})
    apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    real = torch.rand((256, 32, 32, 3), generator=torch.Generator().manual_seed(0)) * 2 - 1

    def measure(fn, n=2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / n, torch.cuda.max_memory_allocated() / 2 ** 30

    st, step = create_train_state(gan, cfg), make_train_step(gan, cfg)
    ms, peak = measure(lambda: host_metrics(step(st, real)))
    print(f"{smi}: in-place plain step {ms:.1f} ms, peak {peak:.2f} GiB", flush=True)
    del st, step
    torch.cuda.empty_cache()
    for k in args.trials:
        try:
            g = TrialGroup(gan, cfg, [create_train_state(gan, cfg) for _ in range(k)],
                           [1e-4] * k, [2e-4] * k)
            ms, peak = measure(lambda: g.step(real))
            print(f"{smi}: group of {k}: {ms:.1f} ms a step, peak {peak:.2f} GiB", flush=True)
            del g
        except torch.OutOfMemoryError:
            print(f"{smi}: group of {k}: out of memory", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
