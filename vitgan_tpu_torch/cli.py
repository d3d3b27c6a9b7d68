"""Command-line interface of the port: ``train``, and ``serve``,
``generate`` and ``eval`` over a run directory (utils/run_dirs.py), with the
JAX CLI's flags for these commands (vitgan_tpu/cli.py) that the port
carries, and ``--device`` (default cuda).

    python -m vitgan_tpu_torch.cli train --preset highres128 [--epochs 1 --run-name RUN]
    python -m vitgan_tpu_torch.cli train --preset highres128 --dataset cifar10 \
        --set data.data_dir=DIR
    python -m vitgan_tpu_torch.cli train --family v1 --dataset synthetic \
        --set runtime.use_pallas=always
    python -m vitgan_tpu_torch.cli train --run-dir RUN --epochs 4 --resume
    python -m vitgan_tpu_torch.cli serve --run-dir RUN [--port 8000 --batch 64]
    python -m vitgan_tpu_torch.cli generate --run-dir RUN [--num-images 64 --seed 0 --best]
    python -m vitgan_tpu_torch.cli eval --run-dir RUN [--best --num-samples 2048 \
        --extractor auto --dataset cifar10 --set data.data_dir=DIR]

``--dataset`` (cifar10, mnist or synthetic; every preset defaults to
cifar10) reads CIFAR-10's ``cifar-10-batches-py/`` or
``cifar-10-python.tar.gz``, or MNIST's IDX files, from ``data.data_dir``,
else $SCRATCH/data/<name> (./data/<name> without SCRATCH); nothing is
downloaded, and a missing file raises naming the files it looked for.  A
dataset of another size than the model's is resized by the reference's
Resize -> CenterCrop.  The trainer keeps it on the device when it fits
``data.on_device_max_bytes``, else (highres128 over CIFAR-10: 2.46 GB) it
takes the host pipeline.

``train`` writes the run directory to ``--run-dir``, else
$SCRATCH/output/<run name> (./output/<run name> without SCRATCH): its
full-state checkpoints under ``checkpoints/``, grids, logs and env.json, and
the generator that ``serve`` and ``generate`` read.  ``--resume`` continues
from the latest checkpoint, exactly; SIGTERM stops at the next device call
and checkpoints.  Every epoch's FID (run.fid_every_epochs) keeps the best
checkpoint and ``generator_best.pt``, which ``--best`` reads.  ``eval``
writes FID, KID, precision/recall (and the Inception Score when the
extractor has a classifier head) to <run>/metrics.json and prints them as
one JSON line.  DEV=1
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
# train/fid.EXTRACTORS, kept here so that building the parser imports no torch
EXTRACTORS = ("auto", "inception", "inception_jax", "inception_torch", "random_conv")
DATASETS = ("cifar10", "mnist", "synthetic")


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


def cmd_eval(args) -> int:
    """FID, KID and precision/recall of a run directory's generator against
    its dataset (vitgan_tpu/cli.py:cmd_eval): one JSON line and
    <run>/metrics.json."""
    import numpy as np

    from vitgan_tpu_torch.data.datasets import load_dataset
    from vitgan_tpu_torch.train.fid import make_feature_extractor, to_uint8
    from vitgan_tpu_torch.train.metrics import (collect_features, evaluate_generative_metrics,
                                                inception_score)
    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.utils.run_dirs import latest_run, restore_run

    run_dir = args.run_dir or latest_run()
    if run_dir is None:
        print("no run directory found", file=sys.stderr)
        return 1
    over = _overrides(args)
    if args.dataset:
        over["data.dataset"] = args.dataset
    cfg, gan, g, meta = restore_run(run_dir, best=args.best, overrides=over,
                                    device=args.device)
    m, data = cfg.model, cfg.data
    b = m.batch_size
    # Clean reals: load_dataset never flips (data.augment_flip acts in the pipeline or the step).
    imgs, _ = load_dataset(data.dataset, root=data.data_dir, image_size=m.image_size,
                           channels=m.channels, synthetic_samples=data.synthetic_samples,
                           seed=m.seed)
    num = min(args.num_samples, len(imgs))
    extractor = make_feature_extractor(args.extractor, m.channels, args.device)
    real_feats = collect_features(extractor, (imgs[i:i + b] for i in range(0, len(imgs), b)),
                                  num)
    # One fake set, for the features and (with a classifier head) the IS.
    sample = make_sample_fn(gan, cfg)
    seed = args.seed or 0
    fakes, got, call = [], 0, 0
    while got < num:
        z = gan.sample_latent(latent_rng(seed, call), b)
        fakes.append(to_uint8(sample(g, z).cpu().numpy())[:num - got])
        got += len(fakes[-1])
        call += 1
    fakes_u8 = np.concatenate(fakes, 0)
    fake_feats = np.asarray(extractor(fakes_u8), np.float64)
    result = evaluate_generative_metrics(
        real_feats, fake_feats, kid_subset_size=min(args.kid_subset_size, num),
        kid_subsets=args.kid_subsets, pr_k=args.pr_k, seed=seed)
    if extractor.logits_fn is not None:
        result["inception_score_mean"], result["inception_score_std"] = inception_score(
            extractor.logits_fn(fakes_u8))
    result.update({"run_dir": run_dir, "ckpt_step": meta.get("step"),
                   "extractor": args.extractor, "feature_dim": extractor.feature_dim,
                   "dataset": data.dataset})
    with open(os.path.join(run_dir, "metrics.json"), "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result))
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
    t.add_argument("--dataset", choices=DATASETS, default=None,
                   help="default: the preset's (cifar10); files from data.data_dir")
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

    e = sub.add_parser("eval", help="FID/KID/precision-recall of a run directory")
    e.add_argument("--run-dir", default=None,
                   help="defaults to the latest under $SCRATCH/output")
    e.add_argument("--best", action="store_true", help="use the best checkpoint's generator")
    e.add_argument("--num-samples", type=int, default=2048,
                   help="evaluation budget per side (real and generated)")
    e.add_argument("--extractor", default="auto", choices=EXTRACTORS)
    e.add_argument("--kid-subset-size", type=int, default=1000)
    e.add_argument("--kid-subsets", type=int, default=100)
    e.add_argument("--pr-k", type=int, default=3,
                   help="k-NN order for the precision/recall manifolds")
    e.add_argument("--seed", type=int, default=None)
    e.add_argument("--dataset", choices=DATASETS, default=None,
                   help="the reals (default: the run's); files from data.data_dir")
    e.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="config override, e.g. --set runtime.megablock=off")
    e.add_argument("--device", default="cuda")
    e.set_defaults(fn=cmd_eval)

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
