"""Where the time of a fit that follows another fit goes, on the card.

    python scripts/fit_settle_probe.py

Trains highres128 (synthetic, 256 samples, 5 captured steps an epoch, the
preset's megablock=auto) through Trainer: a warm-up fit of one epoch (the
capture), then seven fits of one epoch each, every one after the epilogue of
the last (its checkpoint and generator, 2.2 GB written), with nothing, a
sleep, os.sync() or gc.collect() between them, and prints each fit's ms a
step by its own clock.  A fit that starts while the last one's files are
still being written back reads slower; chip_smoke.py's timed fits flush them
first (_settle).
"""

import gc
import os
import sys
import time


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.ops import build
    from vitgan_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    over = {"data.dataset": "synthetic", "data.synthetic_samples": 256, "run.epochs": 2,
            "run.steps_per_epoch": 5, "run.log_every_steps": 0,
            "run.sample_grid_every_epochs": 0, "run.fid_every_epochs": 0,
            "run.keep_checkpoints": 1}
    cfg = C.replace(C.highres_config(128), **over)
    t = Trainer(cfg, run_dir="build/fit_settle_probe", device="cuda")
    t.fit(epochs=1)
    cases = [("immediate", None), ("after sleep 3 s", lambda: time.sleep(3)),
             ("after os.sync()", os.sync), ("after gc.collect()", gc.collect),
             ("immediate", None), ("after 20 ms sleep", lambda: time.sleep(0.02)),
             ("after torch.cuda.synchronize + 0.3 s",
              lambda: (torch.cuda.synchronize(), time.sleep(0.3)))]
    for e, (label, before) in enumerate(cases, start=2):
        a = time.perf_counter()
        if before:
            before()
        pre = time.perf_counter() - a
        m = t.fit(epochs=e)
        print(f"DIAGFIT epoch {e} {label} ({pre:.3f} s): "
              f"{1e3 * cfg.v2.batch_size / m['images_per_sec']:.2f} ms/step", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
