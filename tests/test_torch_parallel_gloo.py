"""The port's mesh across processes on the CPU: gloo groups of 2 (and one of
2 x 2) ranks, each a process of tests/torch_gloo_worker.py started through
a FileStore under tmp_path, one thread each, every launch bounded by
LIMIT seconds (then killed and failed).  The children import torch and the
port only; the JAX side runs here and is handed over as .npz.

- DP (2 ranks) against the single-process step on the global batch: v2
  under WGAN-GP with the diversity term (the fakes gathered over the data
  axis) and dropout 0.1 with DiffAugment (every draw global, then sliced);
  v1 (the ISR state); dcgan (BatchNorm's statistics of the global batch,
  running statistics included).  Metrics to rtol 1e-5; parameters to
  1e-5 plus 2 learning rates a step (Adam's sign on a near-zero gradient,
  as tests/test_torch_v2_train.py bounds the port against the JAX step);
  the first moments to 1e-4 of each leaf's largest magnitude; both ranks
  bit-equal.
- DP against the JAX package's step on its 2-device CPU mesh, from the
  JAX parameters and the JAX step's own draws (dropout 0): the same bounds,
  the first moments at tests/test_torch_v2_train.py's (rtol and atol 1e-5)
  (held_to_the_jax_mesh_step, which the pipeline and sequence-parallel
  tests use on meshes of their layouts).
- FSDP against the replicated step on the same two ranks, at the JAX
  package's bar (tests/test_fsdp.py: rtol 2e-5, atol 1e-6), with the
  placement surviving the step (each rank steps and keeps slices, moments
  included); TP (model axis 2) and FSDP x TP (2 x 2) against the single
  process at the TP bar (tests/test_tensor_parallel.py: rtol 1e-4).
- A world-1 group: the step bit-equal to the step without a mesh.
- A 2-step Trainer.fit under DP whose checkpoint resumes in one process
  bit for bit.
- v2's minibatch-std feature under DP against the JAX mesh step, first
  moments included.

The pipeline and sequence-parallel launches of the same worker are in
tests/test_torch_pipeline.py and tests/test_torch_context_parallel.py.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_gloo_worker as W

LIMIT = 240  # seconds for one launch of every rank
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_gloo_worker.py")


def launch(tmp_path, case: str, world: int, **spec) -> list:
    """Run the case on ``world`` ranks; returns each rank's arrays."""
    d = tmp_path / f"{case}_{world}_{len(os.listdir(tmp_path))}"
    d.mkdir()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    for r in range(world):
        path = d / f"spec{r}.json"
        path.write_text(json.dumps({"case": case, "rank": r, "world": world,
                                    "store": str(d / "store"), "out": str(d / "out"), **spec}))
        log = open(d / f"rank{r}.log", "w")
        procs.append((subprocess.Popen([sys.executable, WORKER, str(path)], env=env,
                                       stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.time() + LIMIT
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p, _ in procs:
            p.kill()
        pytest.fail(f"{case} on {world} ranks ran past {LIMIT} s: "
                    + (d / "rank0.log").read_text()[-2000:])
    finally:
        for p, log in procs:
            p.wait()
            log.close()
    for r, (p, _) in enumerate(procs):
        assert p.returncode == 0, (d / f"rank{r}.log").read_text()[-4000:]
    return [dict(np.load(d / f"out.rank{r}.npz")) for r in range(world)]


def reference(case: str, **kw) -> dict:
    """The case's steps in this process, without a mesh, on one thread as
    the ranks run (the CPU's reductions split by thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state, metrics = W.run_steps(W.case_config(case), **kw)
    finally:
        torch.set_num_threads(threads)
    out = W.flat_state(state.state_dict())
    for k in metrics[-1]:
        out[f"metric/{k}"] = np.array([m[k] for m in metrics])
    return out


def lr_of(cfg, key: str) -> float:
    m = cfg.model
    if hasattr(m, "gen_optim"):
        return (m.gen_optim if key.startswith("g") else m.disc_optim).learning_rate
    return (m.generator if key.startswith("g") else m.discriminator).optim.learning_rate


def close(got: dict, want: dict, cfg, rtol=1e-5, moments_rtol=1e-4, atol=None):
    """Metrics to rtol; parameters and buffers to ``atol`` (default 1e-5
    plus 2 learning rates a step); first moments to ``moments_rtol`` of the
    leaf's largest magnitude (the sums' order moves small entries most)."""
    assert set(got) >= set(want)
    for k, v in want.items():
        g = got[k]
        if k.startswith("metric/"):
            np.testing.assert_allclose(g, v, rtol=rtol, atol=1e-6, err_msg=k)
        elif k.endswith("/exp_avg"):
            np.testing.assert_allclose(g, v, rtol=0, atol=moments_rtol * np.abs(v).max(),
                                       err_msg=k)
        elif k.endswith("/exp_avg_sq"):
            continue  # squares of the gradients the first moments already hold
        else:
            a = atol if atol is not None else 1e-5 + 2 * W.STEPS * lr_of(cfg, k)
            np.testing.assert_allclose(g, v, rtol=0, atol=a, err_msg=k)


def same_on_every_rank(outs: list):
    for o in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith(("g/", "d/", "g_ema/", "metric/")):
                np.testing.assert_array_equal(o[k], v, err_msg=k)


@pytest.mark.parametrize("case", ["dp_v2", "dp_v1", "dp_dcgan"])
def test_data_parallel_step_equals_the_single_process_step(tmp_path, case):
    outs = launch(tmp_path, case, 2)
    same_on_every_rank(outs)
    close(outs[0], reference(case), W.case_config(case))


def test_batchnorm_statistics_are_the_global_batch_s(tmp_path):
    """dcgan's running statistics after two steps: the global batch's
    (rtol 1e-5), not a rank's half."""
    outs = launch(tmp_path, "dp_dcgan", 2)
    want = reference("dp_dcgan")
    stats = [k for k in want if k.endswith((".mean", ".var"))]
    assert stats
    for k in stats:
        np.testing.assert_allclose(outs[0][k], want[k], rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_array_equal(outs[0][k], outs[1][k])


def _jax_mesh_steps(case: str, world: int = 2):
    """Two steps of the JAX package's step from its own init on a CPU mesh
    of ``world`` devices laid out as the case's (data, model, and pipe or
    seq axes; FSDP), its block stacks pipelined and its sequence-parallel
    policy set as the JAX Trainer sets them (vitgan_tpu/train/trainer.py:
    55-122): (inputs for the port: init parameters and state, latents and
    draws per step; flat results by port name; Adam's first moments)."""
    import jax

    from vitgan_tpu import config as JC
    from vitgan_tpu.models import build_gan as jax_build_gan
    from vitgan_tpu.ops.policy import set_sequence_parallel
    from vitgan_tpu.parallel import make_mesh as jax_make_mesh

    family, over, mesh_over = W.CASES[case]
    jcfg = JC.replace(JC.smoke_config(family),
                      **{"runtime.compute_dtype": "float32", **over, **mesh_over})
    mc = jcfg.mesh
    mesh = jax_make_mesh(mc, devices=jax.devices()[:world])
    gan = jax_build_gan(jcfg)
    if mc.pipeline_parallel > 1:
        from vitgan_tpu.parallel.pipeline import pp_bundle

        dp = mc.data_axis if mesh.shape[mc.data_axis] > 1 else None
        auto = [mc.model_axis] if mesh.shape[mc.model_axis] > 1 else []
        if mc.fsdp and dp:
            auto, dp = auto + [dp], None
        gan = pp_bundle(gan, jcfg, mesh=mesh, axis=mc.pipe_axis,
                        microbatches=mc.pipeline_microbatches, dp_axis=dp,
                        tp_axis=tuple(auto) or None)
    # the draws taken here equal the step's own under threefry2x32 (the JAX
    # package's apply_from_runtime may have left a process on rbg)
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    set_sequence_parallel(mesh if mc.context_parallel > 1 else None, mc.data_axis, mc.seq_axis)
    try:
        return _jax_steps(jcfg, gan, mesh)
    finally:
        set_sequence_parallel(None)
        jax.config.update("jax_default_prng_impl", prev)


def _jax_steps(jcfg, gan, mesh):
    import jax
    import jax.numpy as jnp
    import optax

    from vitgan_tpu.parallel import shard_batch
    from vitgan_tpu.parallel.sharding import shard_train_state
    from vitgan_tpu.train.state import create_train_state
    from vitgan_tpu.train.step import make_train_step
    from vitgan_tpu_torch.weights import from_jax_tree

    mc = jcfg.mesh
    st = shard_train_state(create_train_state(jax.random.PRNGKey(0), gan, jcfg), mesh,
                           tensor_parallel=mc.model_parallel > 1, fsdp=mc.fsdp,
                           fsdp_min_size=mc.fsdp_min_size, data_axis=mc.data_axis)

    def flat(st, out):
        for net in ("g", "d"):
            tree = {"params": getattr(st, f"{net}_params"), "state": getattr(st, f"{net}_state")}
            for k, v in from_jax_tree(jax.tree.map(np.asarray, tree)).items():
                out[f"{net}/{k}"] = v.numpy()
        return out

    inputs = flat(st, {})
    step = make_train_step(gan, jcfg, donate=False, state_shardings=jax.tree.map(
        lambda x: x.sharding, st) if mc.fsdp else None)
    zs, metrics = [], []
    for i, real in enumerate(W.reals(jcfg)):
        (_, k_noise, _, _, _, _, k_gp, k_in, _, _, _) = jax.random.split(st.rng, 11)
        b = real.shape[0]
        zs.append(np.array(gan.sample_latent(k_noise, b), np.float32))
        n1, n2 = jax.random.split(k_in)
        inputs[f"noise_real_{i}"] = np.array(jax.random.normal(n1, real.shape, jnp.float32))
        inputs[f"noise_fake_{i}"] = np.array(jax.random.normal(n2, real.shape, jnp.float32))
        inputs[f"gp_eps_{i}"] = np.array(jax.random.uniform(jax.random.split(k_gp)[0],
                                                            (b, 1, 1, 1), jnp.float32))
        st, m = step(st, shard_batch(mesh, jnp.asarray(real)))
        metrics.append({k: float(v) for k, v in m.items()})
    inputs["z"] = np.stack(zs)
    want = flat(st, {f"metric/{k}": np.array([m[k] for m in metrics]) for k in metrics[-1]})
    mus = {}
    for net, opt in (("g", st.g_opt), ("d", st.d_opt)):
        adam = [s for s in jax.tree.leaves(opt, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState)) if isinstance(s, optax.ScaleByAdamState)][0]
        mus[net] = from_jax_tree(jax.tree.map(np.asarray, adam.mu))
    return inputs, want, mus


def held_to_the_jax_mesh_step(tmp_path, case: str, world: int = 2, **close_kw) -> list:
    """The case on ``world`` gloo ranks from the JAX step's parameters and
    draws, against the JAX step on a mesh of as many devices: every rank
    alike, the state and metrics at :func:`close`'s bounds, Adam's first
    moments at tests/test_torch_v2_train.py's (rtol and atol 1e-5)."""
    inputs, want, mus = _jax_mesh_steps(case, world)
    np.savez(tmp_path / "inputs.npz", **inputs)
    outs = launch(tmp_path, case, world, inputs=str(tmp_path / "inputs.npz"))
    same_on_every_rank(outs)
    cfg = W.case_config(case)
    close(outs[0], want, cfg, **close_kw)
    from vitgan_tpu_torch.models import build_gan

    gan = build_gan(cfg)
    for net, module in (("g", gan.generator_init(None, device="meta")),
                        ("d", gan.discriminator_init(None, device="meta"))):
        for i, (name, _) in enumerate(module.named_parameters()):
            np.testing.assert_allclose(outs[0][f"{net}_opt/{i}/exp_avg"],
                                       mus[net][name].numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    return outs


def test_data_parallel_step_equals_the_jax_mesh_step(tmp_path):
    held_to_the_jax_mesh_step(tmp_path, "dp_v2_plain")


def test_minibatch_std_step_equals_the_jax_mesh_step(tmp_path):
    """v2.minibatch_std under a data axis of 2: the D head's CLS features
    gathered over the data group, put in the global [real; fake] order, the
    feature taken over the global batch's groups and this rank's rows kept,
    against the JAX package's step on its 2-device mesh (dropout 0, the JAX
    step's own draws), at the bounds of the DP test above."""
    held_to_the_jax_mesh_step(tmp_path, "dp_mbstd_v2")


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    """The replicated step on two ranks, shared by the FSDP and TP tests."""
    return launch(tmp_path_factory.mktemp("rep"), "rep_v2", 2)


def test_fsdp_step_equals_the_replicated_step_and_keeps_its_slices(tmp_path, replicated):
    outs = launch(tmp_path, "fsdp_v2", 2)
    same_on_every_rank(outs)
    for k, v in replicated[0].items():
        if k.startswith(("g/", "d/", "metric/")) or k.endswith("/exp_avg"):
            np.testing.assert_allclose(outs[0][k], v, rtol=2e-5, atol=1e-6, err_msg=k)
    full = replicated[0]["placed"]
    assert (outs[0]["placed"] < full).all()  # each rank steps slices of G and D
    np.testing.assert_array_equal(outs[0]["moment_numel"], outs[0]["placed"])
    np.testing.assert_array_equal(replicated[0]["moment_numel"], full)


@pytest.mark.parametrize("case,world", [("tp_v2", 2), ("fsdp_tp_v2", 4)])
def test_tensor_parallel_steps_equal_the_unsharded_step(tmp_path, replicated, case, world):
    """TP on a model axis of 2 against the single process (every rank steps
    the whole batch); 2 x 2 FSDP x TP against the replicated 2-rank step
    (the data axis splits the batch alike)."""
    outs = launch(tmp_path, case, world)
    same_on_every_rank(outs)
    assert (outs[0]["placed"] < replicated[0]["placed"]).all()  # slices on the model axis
    np.testing.assert_array_equal(outs[0]["moment_numel"], outs[0]["placed"])
    if world == 2:
        close(outs[0], reference("rep_v2"), W.case_config(case), rtol=1e-4, atol=1e-6)
    else:
        for k, v in replicated[0].items():
            if k.startswith(("g/", "d/", "metric/")):
                np.testing.assert_allclose(outs[0][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("one_way", [False, True])
def test_a_world_one_group_steps_as_without_a_mesh(tmp_path, one_way):
    """At one rank the group's collectives change nothing: bit-equal, also
    with the plan kept on axes of one rank (each slice a whole leaf, its
    gathers, reduce-scatters and the norm's reductions all run)."""
    outs = launch(tmp_path, "rep_v2", 1, one_way=one_way)
    want = reference("rep_v2")
    for k, v in want.items():
        np.testing.assert_array_equal(outs[0][k], v, err_msg=k)


def test_fit_under_dp_resumes_in_one_process(tmp_path):
    """Rank 0 writes the single-device checkpoint format: a 2-step fit on 2
    ranks, restored by a one-process Trainer, holds the ranks' state bit
    for bit (moments gathered from the ranks' slices under FSDP)."""
    from vitgan_tpu_torch import config as C
    from vitgan_tpu_torch.train.trainer import Trainer

    run_dir = tmp_path / "run"
    outs = launch(tmp_path, "fsdp_v2", 2, fit=True, run_dir=str(run_dir))
    same_on_every_rank(outs)
    assert os.path.isdir(run_dir / "checkpoints") and not os.path.isdir(
        run_dir / "ranks" / "1" / "checkpoints" / "step_0000000002")
    cfg = C.replace(W.case_config("fsdp_v2"), **{
        "run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
        "run.steps_per_epoch": 2, "data.synthetic_samples": 64})
    t = Trainer(cfg, run_dir=str(run_dir), device="cpu")
    t.resume()
    assert t.state.step == 2
    mine = W.flat_state(t.state.state_dict())
    assert set(mine) == {k for k in outs[0] if "/" in k and not k.startswith("metric/")}
    for k, v in mine.items():
        np.testing.assert_array_equal(v, outs[0][k], err_msg=k)
