"""Command-line interface of the port: ``train``, and ``serve`` and
``generate`` over a run directory (utils/run_dirs.py), with the JAX CLI's
flags for these commands (vitgan_tpu/cli.py) that the port carries, and
``--device`` (default cuda).

    python -m vitgan_tpu_torch.cli train --preset highres128 [--epochs 1 --run-name RUN]
    python -m vitgan_tpu_torch.cli train --family v1 --dataset synthetic \
        --set runtime.use_pallas=always
    python -m vitgan_tpu_torch.cli train --run-dir RUN --epochs 4 --resume
    python -m vitgan_tpu_torch.cli serve --run-dir RUN [--port 8000 --batch 64]
    python -m vitgan_tpu_torch.cli generate --run-dir RUN [--num-images 64 --seed 0]

``train`` writes the run directory to ``--run-dir``, else
$SCRATCH/output/<run name> (./output/<run name> without SCRATCH): its
full-state checkpoints under ``checkpoints/``, grids, logs and env.json, and
the generator that ``serve`` and ``generate`` read.  ``--resume`` continues
from the latest checkpoint, exactly; SIGTERM stops at the next device call
and checkpoints.  DEV=1
shrinks a preset-less run to the smoke config, as in the JAX CLI.  On the
card, highres128 and deit64 train under their default runtime.megablock=auto
through the megablock's training kernels, as the JAX package's gate routes
them; ``--set runtime.megablock=off`` trains them on the flash and LN->MLP
kernels instead.  ``--family v1`` trains the paper's ViTGAN at its reference
defaults; at its 32 and 50 tokens the JAX package's `auto` keeps attention
on the plain route, and ``runtime.use_pallas=always`` sends every attention
through the flash kernels (`dot` in G, `l2` in D).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional


def _overrides(args) -> dict:
    out = {}
    for kv in args.set or []:
        key, val = kv.split("=", 1)
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val  # bare string
    return out


PRESETS = ("deit64", "highres128", "highres256")


def build_cfg(args):
    """The preset (or DEV=1's smoke config, or the family's defaults) with the
    command line's overrides (vitgan_tpu/cli.py:_build_cfg)."""
    from vitgan_tpu_torch import config as C

    if args.preset:
        cfg = {"deit64": C.deit64_config, "highres128": lambda: C.highres_config(128),
               "highres256": lambda: C.highres_config(256)}[args.preset]()
    elif os.environ.get("DEV", "").lower() in ("1", "true", "yes"):
        cfg = C.smoke_config(args.family)
    else:
        cfg = C.ExperimentConfig(family=args.family)
    over = _overrides(args)
    if args.dataset:
        over["data.dataset"] = args.dataset
    if args.epochs is not None:
        over["run.epochs"] = args.epochs
    if args.run_name:
        over["run_name"] = args.run_name
    return C.replace(cfg, **over) if over else cfg


def cmd_train(args) -> int:
    """Train and write the run directory (train/trainer.py); ``--resume``
    continues it from its latest checkpoint."""
    import logging

    from vitgan_tpu_torch.train.trainer import Trainer

    from vitgan_tpu_torch.utils.preemption import graceful_preemption

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    trainer = Trainer(build_cfg(args), run_dir=args.run_dir, device=args.device)
    if args.resume:
        trainer.resume()
    # SIGTERM stops at the next device call and goes through fit's
    # checkpoint epilogue; `train --resume` re-runs the interrupted epoch.
    with graceful_preemption():
        means = trainer.fit()
    print(json.dumps({"run_dir": trainer.run_dir, "step": trainer.state.step, **means}))
    return 0


def cmd_generate(args) -> int:
    """Sample a grid from a run directory: <run>/test/generated_images.png and
    the latents as <run>/test/noise.npy."""
    import numpy as np

    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.utils.images import make_grid, save_png
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    cfg, gan, g, meta = restore_run(args.run_dir, best=args.best, overrides=_overrides(args),
                                    device=args.device)
    z = gan.sample_latent(latent_rng(args.seed or 0, 0), args.num_images)
    imgs = make_sample_fn(gan, cfg)(g, z).cpu().numpy()
    out_dir = os.path.join(args.run_dir, "test")
    save_png(os.path.join(out_dir, "generated_images.png"), make_grid(imgs))
    np.save(os.path.join(out_dir, "noise.npy"), z.numpy())
    print(f"wrote {args.num_images} samples to {out_dir} (step {meta.get('step')})")
    return 0


def cmd_serve(args) -> int:
    """Long-lived batched sampling server (serve.py)."""
    import signal

    from vitgan_tpu_torch.serve import serve

    httpd = serve(args.run_dir, host=args.host, port=args.port, batch=args.batch,
                  best=args.best, device=args.device)
    print(f"serving {args.run_dir} on http://{args.host}:{httpd.server_address[1]} "
          f"(GET /healthz, /metrics, POST /sample)")

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)  # drain like Ctrl-C
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()  # joins in-flight handler threads
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vitgan-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train a GAN and write its run directory")
    t.add_argument("--preset", choices=PRESETS, default=None)
    t.add_argument("--family", default="v2")
    t.add_argument("--dataset", default=None, help="synthetic (others: ROADMAP.md)")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--run-name", default=None)
    t.add_argument("--run-dir", default=None, help="where to write the run directory")
    t.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="config override, e.g. --set run.steps_per_epoch=5")
    t.add_argument("--resume", action="store_true",
                   help="continue the run directory from its latest checkpoint")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("generate", help="sample images from a run directory")
    g.add_argument("--run-dir", required=True)
    g.add_argument("--best", action="store_true", help="use the best checkpoint")
    g.add_argument("--num-images", type=int, default=64)
    g.add_argument("--seed", type=int, default=None)
    g.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="config override, e.g. --set runtime.megablock=off")
    g.add_argument("--device", default="cuda")
    g.set_defaults(fn=cmd_generate)

    v = sub.add_parser("serve", help="batched sampling server over HTTP")
    v.add_argument("--run-dir", action="append", required=True,
                   help="repeatable: several run dirs form a multi-model registry "
                        "(POST {'model': <basename>})")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8000)
    v.add_argument("--batch", type=int, default=64, help="fixed device batch per call")
    v.add_argument("--best", action="store_true", help="use the best checkpoint")
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_serve)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
