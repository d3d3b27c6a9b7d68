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
    # v2's minibatch-std feature over the data axis, against the JAX mesh step
    "dp_mbstd_v2": ("v2", {"v2.loss": "wgan-gp", "v2.diversity_weight": 0.5, "v2.dropout": 0.0,
                           "v2.minibatch_std": True}, {}),
    # pipeline parallelism: stages x microbatches, alone and composed
    "pp_v2_plain": ("v2", {"v2.loss": "wgan-gp", "v2.diversity_weight": 0.5, "v2.dropout": 0.0},
                    {"mesh.pipeline_parallel": 2}),
    "rep4_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16}, {}),
    "pp_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
              {"mesh.pipeline_parallel": 2}),
    "pp4_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
               {"mesh.pipeline_parallel": 4, "mesh.pipeline_microbatches": 4}),
    "pp_dp_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
                 {"mesh.pipeline_parallel": 2}),
    "pp_tp_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
                 {"mesh.pipeline_parallel": 2, "mesh.model_parallel": 2}),
    "pp_fsdp_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
                   {"mesh.pipeline_parallel": 2, "mesh.fsdp": True, "mesh.fsdp_min_size": 256}),
    "fsdp_tp_pp_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16},
                      {"mesh.pipeline_parallel": 2, "mesh.model_parallel": 2, "mesh.fsdp": True,
                       "mesh.fsdp_min_size": 256}),
    "pp_v1": ("v1", {"v1.generator.depth": 4, "v1.discriminator.depth": 4},
              {"mesh.pipeline_parallel": 2}),
    "rep_v1": ("v1", {"v1.generator.depth": 4, "v1.discriminator.depth": 4}, {}),
    "pp_r1_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16,
                        "v2.r1_gamma": 1.0, "v2.r1_interval": 1},
                 {"mesh.pipeline_parallel": 4, "mesh.pipeline_microbatches": 4}),
    "rep_r1_v2": ("v2", {"v2.dropout": 0.1, "v2.depth": 4, "v2.batch_size": 16,
                         "v2.r1_gamma": 1.0, "v2.r1_interval": 1}, {}),
    # sequence parallelism over the v2 stacks' tokens (D's 65 over 2 ranks: uneven)
    "sp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.context_parallel": 2}),
    "sp_tp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.context_parallel": 2,
                                             "mesh.model_parallel": 2}),
    "sp_fsdp_v2": ("v2", {"v2.dropout": 0.1}, {"mesh.context_parallel": 2, "mesh.fsdp": True,
                                               "mesh.fsdp_min_size": 256}),
}
# Each case of the pipelined or sequence-parallel layouts again at dropout 0,
# held against the JAX package's step on the same mesh from its parameters
# and its own draws (the dropout streams of the two packages differ)
NO_DROPOUT = {"v2": {"v2.dropout": 0.0},
              "v1": {f"v1.{net}.transformer.{k}": 0.0 for net in ("generator", "discriminator")
                     for k in ("attn_dropout", "mlp_dropout")}}
for _name in ("pp4_v2", "pp_dp_v2", "pp_tp_v2", "pp_fsdp_v2", "fsdp_tp_pp_v2", "pp_v1", "pp_r1_v2",
              "sp_v2", "sp_tp_v2", "sp_fsdp_v2"):
    _family, _over, _mesh = CASES[_name]
    CASES[f"{_name}_plain"] = (_family, {**_over, **NO_DROPOUT[_family]}, _mesh)
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
    'd/<name>'} arrays) replaces the initial parameters and the buffers it
    names; ``one_way`` places
    the state on axes of one rank too (parallel/sharding.py)."""
    from vitgan_tpu_torch.models import build_gan
    from vitgan_tpu_torch.parallel.mesh import shard_batch
    from vitgan_tpu_torch.parallel.sharding import place_train_state, shard_train_state
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    gan = build_gan(cfg)
    if mesh is not None and mesh.pipe_axis is not None:
        from vitgan_tpu_torch.parallel.pipeline import pp_bundle

        gan = pp_bundle(gan, cfg, mesh=mesh, microbatches=cfg.mesh.pipeline_microbatches)
    from vitgan_tpu_torch.ops.policy import set_sequence_parallel

    set_sequence_parallel(mesh if mesh is not None and mesh.n_seq > 1 else None, "data", "seq")
    state = create_train_state(gan, cfg, device="cpu")
    if init is not None:
        with torch.no_grad():
            for net in ("g", "d"):
                for name, p in getattr(state, net).named_parameters():
                    p.copy_(torch.from_numpy(init[f"{net}/{name}"]))
                for name, b in getattr(state, net).named_buffers():
                    if f"{net}/{name}" in init:  # the v1 ISR state
                        b.copy_(torch.from_numpy(init[f"{net}/{name}"]))
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


class ToyBlock(torch.nn.Module):
    """h -> tanh(h w + b) + h (tests/test_pipeline_parallel.py's toy block)."""

    def __init__(self, w: np.ndarray, b: np.ndarray):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(w))
        self.b = torch.nn.Parameter(torch.from_numpy(b))


def toy_block(blk, h):
    return torch.tanh(h @ blk.w + blk.b) + h


def toy_inputs(depth: int, batch: int = 8, tok: int = 6, dim: int = 16):
    """Seeded toy blocks' (w, b), the input and a cotangent."""
    rng = np.random.default_rng(7)
    blocks = [(0.5 * rng.standard_normal((dim, dim)).astype(np.float32),
               0.01 * np.arange(dim, dtype=np.float32)) for _ in range(depth)]
    x = rng.standard_normal((batch, tok, dim)).astype(np.float32)
    cot = rng.standard_normal((batch, tok, dim)).astype(np.float32)
    return blocks, x, cot


def toy_grads(blocks, x, cot, run, second: bool) -> dict:
    """run(blocks, x) -> out: the output, and the gradients of sum(out * cot)
    (or, ``second``, of the squared norm of its input gradient, a double
    backward) with respect to the input and the blocks that hold storage."""
    mods = torch.nn.ModuleList(ToyBlock(w, b) for w, b in blocks)
    xt = torch.from_numpy(x).requires_grad_()
    out = run(mods, xt)
    loss = (out * torch.from_numpy(cot)).sum()
    if second:
        (g,) = torch.autograd.grad(loss, xt, create_graph=True)
        loss = (g * g).sum()
    leaves = [xt] + [p for m in mods for p in (m.w, m.b)]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    res = {"out": out.detach().numpy(), "dx": grads[0].numpy()}
    for i in range(len(blocks)):
        for k, g in zip(("w", "b"), grads[1 + 2 * i:3 + 2 * i]):
            if g is not None:
                res[f"d{k}/{i}"] = g.numpy()
    return res


def run_toy(spec: dict, mesh) -> dict:
    """The toy stack through pipeline_blocks on this rank's stage."""
    from vitgan_tpu_torch.parallel.pipeline import pipeline_blocks

    blocks, x, cot = toy_inputs(spec["depth"])

    def run(mods, xt):
        return pipeline_blocks(mods, xt, mesh=mesh, microbatches=spec["microbatches"],
                               block_fn=lambda i, blk, h, j: toy_block(blk, h))

    return toy_grads(blocks, x, cot, run, spec.get("second", False))


def cp_inputs(mode_seed: int = 0, shape=(2, 2, 64, 16)):
    """Seeded (q, k, v) for the context-parallel attentions."""
    rng = np.random.default_rng(mode_seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def run_cp(spec: dict, mesh) -> dict:
    """cp_attention and ring_cp_attention over the model axis on this rank's
    token shards: each output shard and the gradients of sum(out ** 2) with
    respect to the q, k, v shards, per score mode."""
    from vitgan_tpu_torch.parallel.context_parallel import (cp_attention, ring_cp_attention,
                                                            shard_sequence)

    out = {}
    for mode in spec["modes"]:
        for name, fn in (("gather", cp_attention), ("ring", ring_cp_attention)):
            qkv = [shard_sequence(torch.from_numpy(t), mesh, "model").requires_grad_()
                   for t in cp_inputs()]
            o = fn(*qkv, mesh, axis="model", score_mode=mode, scale=16.0)
            grads = torch.autograd.grad((o * o).sum(), qkv)
            out[f"{name}/{mode}/out"] = o.detach().numpy()
            for k, g in zip("qkv", grads):
                out[f"{name}/{mode}/d{k}"] = g.numpy()
    return out


def main(spec_path: str) -> None:
    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(1)
    rank, world = spec["rank"], spec["world"]
    dist.init_process_group("gloo", store=dist.FileStore(spec["store"], world), rank=rank,
                            world_size=world)
    from vitgan_tpu_torch.parallel.mesh import make_mesh

    if spec["case"] in ("toy", "cp"):
        if spec["case"] == "toy":
            out = run_toy(spec["toy"], make_mesh(C.MeshConfig(pipeline_parallel=world)))
        else:
            out = run_cp(spec["cp"], make_mesh(C.MeshConfig(model_parallel=world)))
        np.savez(f"{spec['out']}.rank{rank}.npz", **out)
        dist.barrier()
        dist.destroy_process_group()
        return
    cfg = case_config(spec["case"])
    mesh = make_mesh(cfg.mesh)
    out = {}
    if spec.get("fit"):
        from vitgan_tpu_torch.train.trainer import Trainer

        fid = bool(spec.get("fid"))
        cfg = C.replace(cfg, **{"run.fid_every_epochs": int(fid),
                                "run.sample_grid_every_epochs": int(fid),
                                "run.fid_num_samples": 16,
                                "run.steps_per_epoch": 2, "data.synthetic_samples": 64})
        trainer = Trainer(cfg, run_dir=spec["run_dir"], device="cpu", mesh=mesh,
                          fid_extractor="random_conv")
        means = trainer.fit(epochs=1)
        sd = trainer.state.state_dict()
        out["metric/d_loss"] = np.float64(means["d_loss"])
        if fid:
            out["metric/fid"] = np.float64(means["fid"])
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
        # the blocks whose parameters this rank holds (a pipe stage's own)
        for net in ("g", "d"):
            held = sorted({int(k.split(".")[1]) for k, p in getattr(state, net)
                           .named_parameters() if k.startswith("blocks.") and p.numel()})
            out[f"held_blocks/{net}"] = np.array(held)
    out.update(flat_state(sd))
    np.savez(f"{spec['out']}.rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
