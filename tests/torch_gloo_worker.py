"""One rank of a multi-process CPU check of the port's mesh
(tests/test_torch_parallel_gloo.py): ``python tests/torch_gloo_worker.py
SPEC.json``.  It starts a gloo group through a FileStore, builds the case's
config, runs its steps (or a Trainer.fit) on this rank's rows and writes
the gathered train state and the metrics to ``<out>.rank<r>.npz``.  It
imports torch and the port only; the parent compares."""

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from vitgan_tpu_torch import config as C  # noqa: E402

CASES = {
    # name: (family, config overrides, mesh overrides)
    "dp_v2": ("v2", {"v2.loss": "wgan-gp", "v2.diversity_weight": 0.5, "v2.dropout": 0.1,
                     "run.diff_augment": "color,translation"}, {}),
    "dp_v2_plain": ("v2", {"v2.loss": "wgan-gp", "v2.diversity_weight": 0.5,
                           "v2.dropout": 0.0}, {}),
    "dp_v1": ("v1", {}, {}),
    "dp_dcgan": ("dcgan", {}, {}),
    "fsdp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.fsdp": True, "mesh.fsdp_min_size": 256}),
    "rep_v2": ("v2", {"v2.dropout": 0.1}, {}),
    "tp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.model_parallel": 2}),
    "fsdp_tp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.model_parallel": 2, "mesh.fsdp": True,
                                               "mesh.fsdp_min_size": 256}),
}
STEPS = 2


def case_config(name: str):
    family, over, mesh = CASES[name]
    return C.replace(C.smoke_config(family),
                     **{"runtime.compute_dtype": "float32", **over, **mesh})


def reals(cfg, steps: int = STEPS) -> np.ndarray:
    m = cfg.model
    return np.random.default_rng(0).uniform(
        -1, 1, (steps, m.batch_size, m.image_size, m.image_size, m.channels)).astype(np.float32)


def flat_state(sd: dict) -> dict:
    """A TrainState.state_dict as flat numpy arrays (the generator's state
    and the step counters dropped)."""
    out = {}
    for net in ("g", "d"):
        for k, v in sd[net].items():
            out[f"{net}/{k}"] = v.numpy()
        for i, st in sd[f"{net}_opt"]["state"].items():
            for k, v in st.items():
                if v.dim():
                    out[f"{net}_opt/{i}/{k}"] = v.numpy()
    for i, e in enumerate(sd["g_ema"] or []):
        out[f"g_ema/{i}"] = e.numpy()
    return out


def one_way_specs(shapes, mesh, tensor_parallel: bool, fsdp: bool, min_size: int):
    """The placement plan of a data axis of 2 and a model axis of 1, on
    ``mesh``'s axis names: at one rank each slice is a whole leaf, and
    every gather, reduce-scatter and norm reduction of the placement runs
    (parallel/sharding.place_train_state)."""
    from vitgan_tpu_torch.parallel.sharding import placement_specs

    names = dict(zip(("data", "model"), mesh.axis_names))
    specs = placement_specs(shapes, {"data": 2, "model": 1}, tensor_parallel,
                            "data" if fsdp else None, min_size)
    return {k: tuple(names[a] if a else None for a in s) for k, s in specs.items()}


def run_steps(cfg, mesh=None, z=None, draws=None, init=None, one_way=False):
    """STEPS train steps from the case's state: (state, metrics of each
    step).  ``z`` (steps, B, latent) and ``draws`` (a list of dicts) are
    global; under a mesh each rank takes its rows.  ``init`` ({'g/<name>',
    'd/<name>'} arrays) replaces the initial parameters; ``one_way`` places
    the state on axes of one rank too (parallel/sharding.py)."""
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.parallel.mesh import shard_batch
    from vitgan_tpu_torch.parallel.sharding import place_train_state, shard_train_state
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    if init is not None:
        with torch.no_grad():
            for net in ("g", "d"):
                for name, p in getattr(state, net).named_parameters():
                    p.copy_(torch.from_numpy(init[f"{net}/{name}"]))
    cut = (lambda x: x) if mesh is None else (lambda x: shard_batch(mesh, x))
    if mesh is not None and one_way:
        place_train_state(state, mesh, {
            net: one_way_specs({k: tuple(p.shape) for k, p in getattr(state, net)
                                .named_parameters()}, mesh, True, True, cfg.mesh.fsdp_min_size)
            for net in ("g", "d")})
    elif mesh is not None:
        shard_train_state(state, mesh, tensor_parallel=cfg.mesh.model_parallel > 1,
                          fsdp=cfg.mesh.fsdp, fsdp_min_size=cfg.mesh.fsdp_min_size)
    step = make_train_step(gan, cfg, mesh=mesh)
    metrics = []
    for i, real in enumerate(reals(cfg)):
        kw = {}
        if z is not None:
            kw["z"] = cut(torch.from_numpy(z[i]))
        if draws is not None:
            kw["draws"] = {k: cut(torch.from_numpy(v)) for k, v in draws[i].items()}
        m = step(state, cut(torch.from_numpy(real)), **kw)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    rank, world = spec["rank"], spec["world"]
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"], world), rank=rank,
                            world_size=world)
    from vitgan_tpu_torch.parallel.mesh import make_mesh

    cfg = case_config(spec["case"])
    mesh = make_mesh(cfg.mesh)
    out = {}
    if spec.get("fit"):
        from vitgan_tpu_torch.train.trainer import Trainer

        cfg = C.replace(cfg, **{"run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
                                "run.steps_per_epoch": 2, "data.synthetic_samples": 64})
        trainer = Trainer(cfg, run_dir=spec["run_dir"], device="cpu", mesh=mesh)
        means = trainer.fit(epochs=1)
        sd = trainer.state.state_dict()
        out["metric/d_loss"] = np.float64(means["d_loss"])
    else:
        extra = {"one_way": bool(spec.get("one_way"))}
        if spec.get("inputs"):
            inp = dict(np.load(spec["inputs"]))
            extra["z"] = inp["z"]
            extra["draws"] = [{k: inp[f"{k}_{i}"] for k in ("noise_real", "noise_fake",
                                                             "gp_eps")} for i in range(STEPS)]
            extra["init"] = inp
        state, metrics = run_steps(cfg, mesh, **extra)
        sd = state.state_dict()
        for k in metrics[-1]:
            out[f"metric/{k}"] = np.array([m[k] for m in metrics])
        # the placement: the optimizer's leaves, slices where sharded
        out["placed"] = np.array([sum(p.numel() for p in opt.leaves)
                                  for opt in (state.g_opt, state.d_opt)])
        out["moment_numel"] = np.array([sum(s["exp_avg"].numel() for s in opt.opt.state.values())
                                        for opt in (state.g_opt, state.d_opt)])
    out.update(flat_state(sd))
    np.savez(f"{spec['out']}.rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
