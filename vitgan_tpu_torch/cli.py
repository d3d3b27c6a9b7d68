"""Command-line interface of the port: ``train``, and ``serve``,
``generate`` and ``eval`` over a run directory (utils/run_dirs.py), and the
reference-checkpoint commands ``import-torch`` and ``export-torch``, with the
JAX CLI's flags for these commands (vitgan_tpu/cli.py) that the port
carries, and ``--device`` (default cuda).  ``--family`` is v1, v2, dcgan,
cnn or mlp.

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
    python -m vitgan_tpu_torch.cli train --family dcgan --dataset synthetic
    python -m vitgan_tpu_torch.cli import-torch REF.pth --family cnn --run-dir RUN
    python -m vitgan_tpu_torch.cli export-torch --run-dir RUN --role generator [--out G.pth]
    python -m vitgan_tpu_torch.cli generate --from-torch REF_G.pth --family dcgan
    python -m vitgan_tpu_torch.cli train --preset highres128 --warm-start-d REF_D.pth
    python -m vitgan_tpu_torch.cli serve --run-dir RUN --quantize int8

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

Reference checkpoints (utils/torch_port.py, utils/torch_export.py): the
reference's ``state_dict``s of the v2 ViT discriminator, the v2 CNNGAN and
the notebook DCGAN, ``.pth``/``.pt``/``.ckpt`` files read from a local path
only (nothing is downloaded).  ``import-torch`` writes a run directory
(config, a step-0 checkpoint, the generator) that ``generate``, ``serve``,
``eval``, ``export-torch`` and ``train --resume`` read; ``export-torch``
writes a run's D (its latest or best checkpoint) or G (generator.pt, the EMA
weights) back in the reference's names; ``generate --from-torch`` samples a
reference cnn or dcgan generator without a run directory; ``train
--warm-start-d`` loads D from a reference checkpoint or from another run
directory's latest checkpoint before the first step (ignored with
``--resume``).  ``serve --quantize int8`` serves weight-only int8
(utils/quantize.py).
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
FAMILIES = ("v1", "v2", "dcgan", "cnn", "mlp")
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
    if getattr(args, "dataset", None):
        over["data.dataset"] = args.dataset
    if getattr(args, "epochs", None) is not None:
        over["run.epochs"] = args.epochs
    if getattr(args, "run_name", None):
        over["run_name"] = args.run_name
    return C.replace(cfg, **over) if over else cfg


def _num_heads(cfg) -> int:
    """Attention heads for the reference's q/k/v Linears (v2 families; the
    reference default is 4)."""
    return getattr(cfg.model, "num_heads", 4)


def _copy_in(module, flat: dict, what: str) -> None:
    """Load every leaf of ``flat`` into ``module`` in place; all must match."""
    import torch

    from vitgan_tpu_torch.utils.checkpoint import partial_load

    own = module.state_dict()
    merged, n, total = partial_load(own, flat)
    if n != total:
        raise ValueError(f"{what}: only {n}/{total} leaves matched - model shape mismatch "
                         "(check --family, --preset and --set)")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(merged[name])


def _warm_start_d(trainer, path: str, cfg) -> int:
    """D from a reference .pth/.pt/.ckpt (utils/torch_port) or from another
    run directory's latest checkpoint (vitgan_tpu/cli.py:112-134)."""
    from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
    from vitgan_tpu_torch.utils.torch_port import TORCH_SUFFIXES, import_checkpoint

    if path.endswith(TORCH_SUFFIXES):
        source = import_checkpoint(path, cfg.family, role="discriminator",
                                   num_heads=_num_heads(cfg))
    else:
        source = CheckpointManager(os.path.join(path, "checkpoints")).restore()[0]["state"]["d"]
    loaded = trainer.warm_start_discriminator(source)
    if loaded == 0:
        raise ValueError(f"warm start from {path} matched no leaves - wrong family or model "
                         "shape?")
    return loaded


def cmd_train(args) -> int:
    """Train and write the run directory (train/trainer.py); ``--resume``
    continues it from its latest checkpoint."""
    import logging

    from vitgan_tpu_torch.train.trainer import Trainer

    from vitgan_tpu_torch.utils.preemption import graceful_preemption

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    cfg = build_cfg(args)
    trainer = Trainer(cfg, run_dir=args.run_dir, device=args.device)
    if args.resume:
        trainer.resume()
        if args.warm_start_d:
            # The resumed checkpoint carries the trained D and its moments;
            # a warm start would roll D back while G keeps its weights.
            print("--warm-start-d ignored on --resume (the resumed checkpoint already carries "
                  "the trained D)", file=sys.stderr)
    elif args.warm_start_d:
        n = _warm_start_d(trainer, args.warm_start_d, cfg)
        print(f"warm-started D from {args.warm_start_d}: {n} leaves", file=sys.stderr)
    # SIGTERM stops at the next device call and goes through fit's
    # checkpoint epilogue; `train --resume` re-runs the interrupted epoch.
    with graceful_preemption():
        means = trainer.fit()
    print(json.dumps({"run_dir": trainer.run_dir, "step": trainer.state.step, **means}))
    return 0


def _generate_from_torch(args) -> int:
    """Sample a reference generator checkpoint (families cnn and dcgan; the
    reference v2 generator is broken) with no run directory: a grid at
    <checkpoint's directory>/vitgan_tpu_samples/generated_images.png
    (vitgan_tpu/cli.py:136-162)."""
    import torch

    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.utils.images import make_grid, save_png
    from vitgan_tpu_torch.utils.torch_port import import_checkpoint
    from vitgan_tpu_torch.weights import from_jax_tree, load_into

    cfg = build_cfg(args)
    apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    variables = import_checkpoint(args.from_torch, cfg.family, role="generator",
                                  num_heads=_num_heads(cfg))
    with torch.device("meta"):
        g = gan.generator_init(None, device="meta")
    load_into(g, from_jax_tree(variables), assign=True)
    g.to(args.device)
    z = gan.sample_latent(latent_rng(args.seed or 0, 0), args.num_images)
    imgs = make_sample_fn(gan, cfg)(g, z).cpu().numpy()
    out_dir = os.path.join(os.path.dirname(os.path.abspath(args.from_torch)),
                           "vitgan_tpu_samples")
    save_png(os.path.join(out_dir, "generated_images.png"), make_grid(imgs))
    print(f"wrote {args.num_images} samples to {out_dir} (imported "
          f"{os.path.basename(args.from_torch)}, family {cfg.family})")
    return 0


def cmd_generate(args) -> int:
    """Sample a grid from a run directory: <run>/test/generated_images.png and
    the latents as <run>/test/noise.npy; or, with ``--from-torch``, from a
    reference generator checkpoint."""
    import numpy as np

    from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn
    from vitgan_tpu_torch.utils.images import make_grid, save_png
    from vitgan_tpu_torch.utils.run_dirs import restore_run

    if args.from_torch:
        return _generate_from_torch(args)
    if not args.run_dir:
        print("generate needs --run-dir or --from-torch", file=sys.stderr)
        return 1
    cfg, gan, g, meta = restore_run(args.run_dir, best=args.best, overrides=_overrides(args),
                                    device=args.device)
    z = gan.sample_latent(latent_rng(args.seed or 0, 0), args.num_images)
    imgs = make_sample_fn(gan, cfg)(g, z).cpu().numpy()
    out_dir = os.path.join(args.run_dir, "test")
    save_png(os.path.join(out_dir, "generated_images.png"), make_grid(imgs))
    np.save(os.path.join(out_dir, "noise.npy"), z.numpy())
    print(f"wrote {args.num_images} samples to {out_dir} (step {meta.get('step')})")
    return 0


def cmd_import_torch(args) -> int:
    """Write a reference torch checkpoint as a run directory: config.json, a
    full-state checkpoint at step 0 and the generator, which ``generate``,
    ``serve``, ``eval``, ``export-torch`` and ``train --resume`` read
    (vitgan_tpu/cli.py:165-243).  Roles default to the discriminator for v2
    and to whatever the state_dict carries for cnn and dcgan."""
    import numpy as np

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.ops.policy import apply_from_runtime
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.trainer import default_run_dir
    from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
    from vitgan_tpu_torch.utils.run_dirs import construct_directories, save_run
    from vitgan_tpu_torch.utils.torch_port import import_checkpoint, load_torch_state_dict
    from vitgan_tpu_torch.weights import from_jax_tree

    cfg = build_cfg(args)
    apply_from_runtime(cfg.runtime)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device=args.device)
    sd = load_torch_state_dict(args.path)
    if args.roles:
        roles = [r.strip() for r in args.roles.split(",")]
        bad = [r for r in roles if r not in ("generator", "discriminator")]
        if bad:
            raise ValueError(f"unknown role(s) {bad}; valid: generator, discriminator")
    else:
        roles = ["discriminator"] if cfg.family == "v2" else ["generator", "discriminator"]
    imported = []
    for role in roles:
        try:
            variables = import_checkpoint(sd, cfg.family, role=role, num_heads=_num_heads(cfg))
            module = state.d if role == "discriminator" else state.g
            _copy_in(module, from_jax_tree(variables), role)
        except (KeyError, ValueError) as e:
            # KeyError: the role's keys are absent; ValueError: present but
            # another module's (a DCGAN G-only dict also has main.0.weight).
            if args.roles:
                raise
            print(f"[import-torch] {role} does not fit this state_dict "
                  f"({type(e).__name__}: {e}); skipped", file=sys.stderr)
            continue
        if role == "generator" and state.g_ema is not None:
            for e, p in zip(state.g_ema, state.g.parameters()):
                e.copy_(p.detach())
        imported.append(role)
    if not imported:
        print("no role could be imported from this state_dict", file=sys.stderr)
        return 1
    run_name = args.run_name or f"imported_{os.path.splitext(os.path.basename(args.path))[0]}"
    cfg = C.replace(cfg, run_name=run_name)
    root = os.path.abspath(args.run_dir or default_run_dir(run_name))
    dirs = construct_directories(os.path.basename(root), base=os.path.dirname(root))
    meta = {"step": 0, "epoch": 0, "seed": state.seed,
            "imported_from": os.path.abspath(args.path), "imported_roles": imported}
    CheckpointManager(dirs.checkpoints, keep=cfg.run.keep_checkpoints).save(
        0, {"state": state.state_dict(),
            "data_order": np.random.default_rng(cfg.model.seed).bit_generator.state},
        {"epoch": 0, "imported_from": meta["imported_from"], "imported_roles": imported})
    save_run(dirs.root, cfg, state.ema_state_dict(), meta=meta)
    print(f"imported {cfg.family} {'+'.join(imported)} from {args.path} -> {dirs.root}")
    return 0


def cmd_export_torch(args) -> int:
    """Write a run's D (its latest or ``--best`` checkpoint) or G (its
    generator weights, the EMA's where tracked) as a reference-format .pth
    (vitgan_tpu/cli.py:246-264)."""
    import torch

    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.utils.checkpoint import CheckpointManager
    from vitgan_tpu_torch.utils.run_dirs import BEST_FILE, GENERATOR_FILE
    from vitgan_tpu_torch.utils.torch_export import save_torch_checkpoint
    from vitgan_tpu_torch.weights import to_jax_tree

    cfg = C.load_config(os.path.join(args.run_dir, "config.json"))
    gan = build_gan(cfg)
    with torch.device("meta"):
        module = (gan.generator_init(None, device="meta") if args.role == "generator"
                  else gan.discriminator_init(None, device="meta"))
    if args.role == "generator":
        path = os.path.join(args.run_dir, BEST_FILE if args.best else GENERATOR_FILE)
        sd = torch.load(path, map_location="cpu", weights_only=True)
        step = None
    else:
        ckpt, meta = CheckpointManager(os.path.join(args.run_dir, "checkpoints")).restore(
            best=args.best)
        sd, step = ckpt["state"]["d"], meta.get("step")
    out = args.out or os.path.join(args.run_dir, f"{cfg.family}_{args.role}.pth")
    save_torch_checkpoint(out, to_jax_tree(module, sd), cfg.family, role=args.role,
                          channels=cfg.model.channels)
    print(f"exported {cfg.family} {args.role} (step {step}) -> {out}")
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
                  best=args.best, device=args.device, quantize=args.quantize)
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
    t.add_argument("--family", choices=FAMILIES, default="v2")
    t.add_argument("--dataset", choices=DATASETS, default=None,
                   help="default: the preset's (cifar10); files from data.data_dir")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--run-name", default=None)
    t.add_argument("--run-dir", default=None, help="where to write the run directory")
    t.add_argument("--set", action="append", metavar="dotted.key=value",
                   help="config override, e.g. --set run.steps_per_epoch=5")
    t.add_argument("--resume", action="store_true",
                   help="continue the run directory from its latest checkpoint")
    t.add_argument("--warm-start-d", default=None, metavar="PATH",
                   help="load D before training from a reference .pth/.pt/.ckpt state_dict "
                        "(a local file) or another run directory; ignored with --resume")
    t.add_argument("--device", default="cuda")
    t.set_defaults(fn=cmd_train)

    g = sub.add_parser("generate", help="sample images from a run directory")
    g.add_argument("--run-dir", default=None)
    g.add_argument("--from-torch", default=None, metavar="PATH",
                   help="sample a reference generator state_dict (.pth/.pt/.ckpt, a local "
                        "file; families cnn and dcgan) instead of a run directory")
    g.add_argument("--family", choices=FAMILIES, default="v2", help="with --from-torch")
    g.add_argument("--preset", choices=PRESETS, default=None, help="with --from-torch")
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
    v.add_argument("--quantize", choices=["int8"], default=None,
                   help="weight-only int8: the card keeps int8 weights and scales, "
                        "dequantized for each call (utils/quantize.py)")
    v.add_argument("--device", default="cuda")
    v.set_defaults(fn=cmd_serve)

    i = sub.add_parser("import-torch", help="write a reference torch checkpoint as a run "
                       "directory")
    i.add_argument("path", help="the reference .pth/.pt/.ckpt state_dict (a local file)")
    i.add_argument("--family", choices=FAMILIES, default="v2")
    i.add_argument("--preset", choices=PRESETS, default=None)
    i.add_argument("--roles", default=None,
                   help="comma list of generator,discriminator; default: discriminator "
                        "for v2, whatever the state_dict carries for cnn and dcgan")
    i.add_argument("--run-name", default=None)
    i.add_argument("--run-dir", default=None, help="where to write the run directory")
    i.add_argument("--set", action="append", metavar="dotted.key=value")
    i.add_argument("--device", default="cuda")
    i.set_defaults(fn=cmd_import_torch)

    x = sub.add_parser("export-torch", help="write a run's D or G as a reference-format "
                       "torch state_dict (.pth)")
    x.add_argument("--run-dir", required=True)
    x.add_argument("--best", action="store_true")
    x.add_argument("--role", choices=("generator", "discriminator"), default="discriminator",
                   help="v2 exports the discriminator only; cnn and dcgan both")
    x.add_argument("--out", default=None, help="default: <run-dir>/<family>_<role>.pth")
    x.set_defaults(fn=cmd_export_torch)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
