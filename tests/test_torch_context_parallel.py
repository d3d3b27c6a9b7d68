"""The port's context (sequence) parallelism (vitgan_tpu_torch/parallel/
context_parallel.py, ops/policy.set_sequence_parallel, the v2 stacks under
SP) against the JAX package, on the CPU.

- tests/test_context_parallel.py's cases: the gather (`cp_attention`) and
  ring (`ring_cp_attention`) schedules in `dot` and `l2` over 2 and 4 ranks
  (gloo processes of tests/torch_gloo_worker.py), outputs and the gradients
  of sum(out ** 2), against the JAX `attention_reference` and jax.grad of
  it; the two schedules against each other; `cp_attention` under a forced
  kernel policy (cross shapes take the plain route); the indivisible error.
- tests/test_sequence_parallel.py's cases: the mesh's seq axis, SP with PP
  refused, the policy (no-op off, the seq axis required, every kernel route
  off under SP, as the JAX policy decides), uneven tokens (D's 65 over 2 and
  4 ranks) round-tripped exactly, the v2-only trainer error, a fresh trainer
  clearing the policy.
- Multi-rank steps (gloo): SP at 2 ranks, SP x TP (2 x 2) and SP x FSDP
  (data 2 x seq 2) against the single-process step, with dropout (each
  block's masks drawn at the whole sequence and sliced), and again at
  dropout 0 from the JAX parameters and draws against the JAX package's
  GSPMD step on a CPU mesh of the same layout; a Trainer fit under
  context_parallel=2 and its checkpoint resumed in one process.

Tolerances: the JAX test's (rtol 2e-5, atol 3e-6 on the outputs, 5e-5 and
5e-6 on the gradients); the gloo steps at tests/test_torch_parallel_gloo.py's
bounds; everything else exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.ops.attention import attention_reference
from vitgan_tpu.ops import policy as JPOL
from vitgan_tpu.parallel import make_mesh as jax_make_mesh
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.ops import attention as A
from vitgan_tpu_torch.ops import fused_mlp as FM
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.parallel import context_parallel as CP
from vitgan_tpu_torch.parallel import mesh as M

import test_torch_parallel_gloo as G
import torch_gloo_worker as W

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)
    policy.set_sequence_parallel(None)
    JPOL.set_sequence_parallel(None)


def _error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


# --- the attention schedules across ranks --------------------------------------------


@pytest.fixture(scope="module")
def cp_ranks(tmp_path_factory):
    """Both schedules in both modes over 2 and 4 ranks, one launch each."""
    return {world: G.launch(tmp_path_factory.mktemp(f"cp{world}"), "cp", world,
                            cp={"modes": ["dot", "l2"]}) for world in (2, 4)}


def _jax_reference(mode: str):
    q, k, v = (jnp.asarray(t) for t in W.cp_inputs())
    out = attention_reference(q, k, v, mode, 16.0)
    grads = jax.grad(lambda q, k, v: jnp.sum(attention_reference(q, k, v, mode, 16.0) ** 2),
                     argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("schedule", ["gather", "ring"])
@pytest.mark.parametrize("mode", ["dot", "l2"])
def test_cp_matches_the_jax_reference(cp_ranks, world, schedule, mode):
    """Each rank's output shard and q/k/v gradient shards, stacked along the
    tokens, equal the JAX reference on the whole sequence."""
    outs = cp_ranks[world]
    want, grads = _jax_reference(mode)
    got = np.concatenate([o[f"{schedule}/{mode}/out"] for o in outs], axis=2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=3e-6)
    for k, g in zip("qkv", grads):
        mine = np.concatenate([o[f"{schedule}/{mode}/d{k}"] for o in outs], axis=2)
        np.testing.assert_allclose(mine, g, rtol=5e-5, atol=5e-6, err_msg=k)


def test_ring_matches_gather_cp(cp_ranks):
    """The two schedules are interchangeable to numerical precision."""
    for o in cp_ranks[4]:
        np.testing.assert_allclose(o["ring/dot/out"], o["gather/dot/out"], rtol=2e-5, atol=3e-6)


def test_cp_with_the_kernel_policy_forced():
    """On one rank the gather schedule is dispatch_attention itself; its
    cross shapes (local queries over gathered keys) take the plain route
    even where the policy would take the kernel (the JAX test's live crash
    at >= 256 local tokens)."""
    policy.set_policy(mode="always", min_seq_len=1)
    q, k, v = (torch.from_numpy(t[:1]) for t in W.cp_inputs())
    want = A.attention_reference(q, k[:, :, :32], v[:, :, :32], "dot", 16.0)
    got = A.dispatch_attention(q, k[:, :, :32], v[:, :, :32], "dot", 16.0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = M.make_mesh(C.MeshConfig(), world_size=1)
    torch.testing.assert_close(CP.cp_attention(q, k, v, one, scale=16.0),
                               A.attention_reference(q, k, v, "dot", 16.0), rtol=2e-5,
                               atol=3e-6)


def test_cp_rejects_indivisible():
    """A sequence of 30 over a model axis of 4: the JAX error."""
    jmesh = jax_make_mesh(JC.MeshConfig(model_parallel=4))
    from vitgan_tpu.parallel.context_parallel import cp_attention as jax_cp

    q = jnp.zeros((1, 1, 30, 8))
    want = _error(lambda: jax_cp(q, q, q, jmesh))
    mesh = M.make_mesh(C.MeshConfig(model_parallel=4), world_size=8)
    assert _error(lambda: CP.shard_sequence(torch.zeros(1, 1, 30, 8), mesh, "model")) == want


# --- the mesh and the policy ----------------------------------------------------------


@pytest.mark.parametrize("sp,mp", [(4, 1), (2, 2), (2, 1)])
def test_mesh_gains_a_seq_axis(sp, mp):
    """The JAX mesh's axis names and shape, and each rank where its device
    sits."""
    jm = jax_make_mesh(JC.MeshConfig(context_parallel=sp, model_parallel=mp))
    assert jm.axis_names == ("data", "model", "seq")
    devs = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for r in range(8):
        pm = M.make_mesh(C.MeshConfig(context_parallel=sp, model_parallel=mp), world_size=8,
                         rank=r)
        assert pm.axis_names == tuple(jm.axis_names) and pm.shape == dict(jm.shape)
        where = np.argwhere(devs == jax.devices()[r].id)[0]
        assert (pm.data_index, pm.model_index, pm.seq_index) == tuple(where)


def test_sp_does_not_compose_with_pp():
    want = _error(lambda: jax_make_mesh(JC.MeshConfig(context_parallel=2, pipeline_parallel=2)))
    assert _error(lambda: M.make_mesh(C.MeshConfig(context_parallel=2, pipeline_parallel=2),
                                      world_size=8)) == want


def test_constraint_is_a_no_op_when_off():
    assert not policy.sequence_parallel_active()
    x = torch.ones(2, 5, 4)
    assert policy.sequence_constraint(x) is x


def test_sp_requires_a_seq_axis():
    want = _error(lambda: JPOL.set_sequence_parallel(jax_make_mesh(JC.MeshConfig()), "data",
                                                     "seq"))
    plain = M.make_mesh(C.MeshConfig(), world_size=8)
    assert _error(lambda: policy.set_sequence_parallel(plain, "data", "seq")) == want


def test_sp_routes_every_block_off_the_kernels(monkeypatch):
    """Under SP the flash and LN->MLP routes and the megablock are off even
    under use_pallas='always' and megablock='on', as the JAX policy decides;
    clearing SP restores them."""
    from vitgan_tpu.ops.attention import use_pallas_attention

    jm = jax_make_mesh(JC.MeshConfig(context_parallel=2))
    JPOL.set_sequence_parallel(jm, "data", "seq")
    JPOL.set_policy(mode="always", megablock="on")
    try:
        jax_says = (use_pallas_attention(seq_len=4096), JPOL.megablock_enabled())
    finally:
        JPOL.set_policy(mode="auto", megablock="auto")
    mesh = M.make_mesh(C.MeshConfig(context_parallel=2), world_size=2)
    policy.set_sequence_parallel(mesh, "data", "seq")
    policy.set_policy(mode="always", megablock="on")
    q = torch.zeros(1, 1, 4096, 8)
    assert (A.use_flash_attention(q, 4096), policy.megablock_mode() != "off") == jax_says == (
        False, False)
    monkeypatch.setattr(FM, "fused_ln_mlp", lambda *a, **k: pytest.fail("a kernel route"))
    x, e, h = torch.randn(2, 3, 8), 8, 16
    FM.dispatch_ln_mlp(x, torch.ones(e), torch.zeros(e), torch.randn(e, h), torch.zeros(h),
                       torch.randn(h, e), torch.zeros(e))
    policy.set_sequence_parallel(None)
    assert A.use_flash_attention(q, 4096) and policy.megablock_mode() == "on"


@pytest.mark.parametrize("n,ranks", [(65, 2), (65, 4), (64, 4), (5, 4)])
def test_token_slices_cover_an_uneven_sequence(n, ranks):
    """ceil(n / P) tokens a rank, the last fewer (D's N + 1), in order and
    without overlap, as GSPMD's padded last shard holds them."""
    sl = [CP.token_slice(n, M.make_mesh(C.MeshConfig(context_parallel=ranks), world_size=ranks,
                                        rank=r)) for r in range(ranks)]
    c = -(-n // ranks)
    assert [s.stop - s.start for s in sl] == [min(c, max(0, n - r * c)) for r in range(ranks)]
    assert np.array_equal(np.concatenate([np.arange(n)[s] for s in sl]), np.arange(n))


def test_the_trainer_refuses_sp_for_non_v2(tmp_path):
    from vitgan_tpu.train.trainer import Trainer as JaxTrainer
    from vitgan_tpu_torch.train.trainer import Trainer

    want = _error(lambda: JaxTrainer(JC.replace(JC.smoke_config("v1"),
                                                **{"mesh.context_parallel": 2}),
                                     run_base=str(tmp_path / "jax")))
    cfg = C.replace(C.smoke_config("v1"), **{"mesh.context_parallel": 2})
    assert _error(lambda: Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")) == want


def test_a_trainer_without_sp_clears_it(tmp_path):
    from vitgan_tpu_torch.train.trainer import Trainer

    policy.set_sequence_parallel(M.make_mesh(C.MeshConfig(context_parallel=2), world_size=2),
                                 "data", "seq")
    cfg = C.replace(C.smoke_config("v2"), **{"data.synthetic_samples": 16})
    Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    assert not policy.sequence_parallel_active()


# --- the v2 steps across ranks -----------------------------------------------------------


@pytest.fixture(scope="module")
def rep():
    return G.reference("rep_v2")


@pytest.mark.parametrize("case,world", [("sp_v2", 2), ("sp_tp_v2", 4), ("sp_fsdp_v2", 4)])
def test_sequence_parallel_steps_equal_the_unsharded_step(tmp_path, rep, case, world):
    """SP over 2 ranks (G's 64 tokens even, D's 65 uneven), SP x TP and SP x
    FSDP, dropout 0.1: the single-process step; every rank alike."""
    outs = G.launch(tmp_path, case, world)
    G.same_on_every_rank(outs)
    G.close(outs[0], rep, W.case_config(case), rtol=1e-4)


@pytest.mark.parametrize("case,world", [("sp_v2_plain", 2), ("sp_tp_v2_plain", 4),
                                        ("sp_fsdp_v2_plain", 4)])
def test_sequence_parallel_steps_equal_the_jax_mesh_step(tmp_path, case, world):
    """The same layouts at dropout 0, from the JAX parameters and the JAX
    step's own draws, against the JAX package's GSPMD step on a mesh of the
    same layout (D's 65 tokens padded on its last seq shard there)."""
    G.held_to_the_jax_mesh_step(tmp_path, case, world, rtol=1e-4)


def test_trainer_fit_under_sp(tmp_path):
    """mesh.context_parallel=2 through the trainer's fit with sample grids
    and FID; rank 0's checkpoint resumes in one process bit for bit."""
    from vitgan_tpu_torch.train.trainer import Trainer

    run_dir = tmp_path / "run"
    outs = G.launch(tmp_path, "sp_v2", 2, fit=True, fid=True, run_dir=str(run_dir))
    G.same_on_every_rank(outs)
    assert np.isfinite(outs[0]["metric/d_loss"]) and np.isfinite(outs[0]["metric/fid"])
    cfg = C.replace(W.case_config("sp_v2"), **{
        "run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
        "run.steps_per_epoch": 2, "data.synthetic_samples": 64, "mesh.context_parallel": 1})
    t = Trainer(cfg, run_dir=str(run_dir), device="cpu")
    t.resume()
    assert t.state.step == 2
    for k, v in W.flat_state(t.state.state_dict()).items():
        np.testing.assert_array_equal(v, outs[0][k], err_msg=k)
