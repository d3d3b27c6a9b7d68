"""The port's pipeline parallelism (vitgan_tpu_torch/parallel/pipeline.py)
against the sequential block loop and the JAX package's `pp_bundle`, on the
CPU.

- `pipeline_blocks` on one stage: the toy stack (tests/test_pipeline_parallel.py's)
  at M = 1, 2, 4 and with a tuple activation, forward and gradients, against
  the sequential loop; across 2 and 4 stages (gloo processes of
  tests/torch_gloo_worker.py), forward, gradients and a double backward.
- `pp_bundle` G and D applies (v2, v1 G, v1 D with its ISR refresh) against
  the JAX `pp_bundle` on a 4-stage pipe of the 8-device CPU mesh, from the
  same numpy-seeded weights, and their gradients against jax.grad of it.
- The errors (indivisible batch, depth, family) equal to the JAX strings;
  eval batches that do not divide run as one microbatch.
- The draws: the megablock's microbatch dropout bits are the whole batch's
  rows (with and without a data row map, D's [real; fake] forward too); a
  one-stage pipelined train step against the unpipelined one.
- Multi-rank steps (gloo): 2 and 4 stages, PP x DP's draws, PP x TP, PP x
  FSDP, FSDP x TP x PP, v1, R1 through 4 stages x 4 microbatches, each
  against the single-process step at dropout 0.1 (the port's draw rule);
  2 stages and each of those layouts again at dropout 0 from the JAX
  parameters and draws against the JAX step on a CPU mesh of the same
  layout (its pp_bundle as the JAX Trainer builds it); the leaves each
  stage holds; a Trainer fit under pipeline_parallel=4 with FID and its
  checkpoint resumed in one process.

Tolerances: rtol/atol 1e-5 in f32 against JAX (tests/test_torch_v1.py's; a
v1 generator through SIREN's sin(30 x) at 1e-4), the sequential loop's
output at 1e-6 and its gradients, which sum the microbatches' parts in
another order, at rtol 1e-5 and 1e-6 of each leaf's largest magnitude, and
the gloo steps at tests/test_torch_parallel_gloo.py's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.parallel import pipeline as JP
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import draws, policy
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.parallel import mesh as M
from vitgan_tpu_torch.parallel import pipeline as P
from vitgan_tpu_torch.weights import from_jax_tree

import test_torch_parallel_gloo as G
import torch_gloo_worker as W

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def one_stage():
    return M.Mesh({"data": 1, "model": 1, "pipe": 1}, axis_names=("data", "model", "pipe"),
                  pipe_axis="pipe")


@pytest.fixture(scope="module")
def jax_pipe():
    return JMesh(np.array(jax.devices()[:4]).reshape(4), axis_names=("pipe",))


# --- pipeline_blocks ----------------------------------------------------------------


def _tol(key: str, want: np.ndarray) -> dict:
    """The output to 1e-6; gradients, which sum the microbatches' parts in
    another order than the loop, to 1e-5 relative and 1e-6 of the leaf's
    largest magnitude (the double backward's reach 1e5)."""
    if key == "out":
        return dict(rtol=1e-6, atol=1e-6)
    return dict(rtol=1e-5, atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _sequential(mods, xt):
    for m in mods:
        xt = W.toy_block(m, xt)
    return xt


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("second", [False, True])
def test_pipeline_blocks_equal_the_sequential_loop(microbatches, second):
    """One stage: every microbatch through the blocks, forward, gradients
    and a double backward equal to the loop."""
    blocks, x, cot = W.toy_inputs(8)
    want = W.toy_grads(blocks, x, cot, _sequential, second)
    got = W.toy_grads(blocks, x, cot, lambda mods, xt: P.pipeline_blocks(
        mods, xt, mesh=one_stage(), microbatches=microbatches,
        block_fn=lambda i, blk, h, j: W.toy_block(blk, h)), second)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, **_tol(k, v), err_msg=k)


def test_pipeline_blocks_carry_a_tuple():
    """The v1 generator's (h, w) pair: w rides the microbatches unchanged."""
    blocks, x, _ = W.toy_inputs(4)
    mods = torch.nn.ModuleList(W.ToyBlock(w, b) for w, b in blocks)
    xt, wt = torch.from_numpy(x), torch.from_numpy(x[::-1].copy())
    h, w = P.pipeline_blocks(mods, (xt, wt), mesh=one_stage(), microbatches=2,
                             block_fn=lambda i, blk, hw, j: (W.toy_block(blk, hw[0]) + hw[1],
                                                             hw[1]))
    want = xt
    for m in mods:
        want = W.toy_block(m, want) + wt
    torch.testing.assert_close(h, want, rtol=1e-6, atol=1e-6)
    assert torch.equal(w, wt)


@pytest.mark.parametrize("stages,microbatches,second", [(2, 2, False), (4, 4, False),
                                                        (4, 4, True)])
def test_pipeline_blocks_across_stages(tmp_path, stages, microbatches, second):
    """2 and 4 stages, each a process: the output and the input gradient on
    every rank, each stage's block gradients, against the sequential loop;
    with ``second`` the gradients of the input gradient's squared norm (a
    double backward through the hops)."""
    depth = 8
    outs = G.launch(tmp_path, "toy", stages,
                    toy={"depth": depth, "microbatches": microbatches, "second": second})
    blocks, x, cot = W.toy_inputs(depth)
    want = W.toy_grads(blocks, x, cot, _sequential, second)
    per = depth // stages
    for r, o in enumerate(outs):
        for k in ("out", "dx"):
            np.testing.assert_allclose(o[k], want[k], **_tol(k, want[k]), err_msg=k)
        mine = {int(k.split("/")[1]) for k in o if k.startswith("dw/")}
        assert mine == set(range(r * per, (r + 1) * per))  # a stage runs only its blocks
        for i in mine:
            for k in ("dw", "db"):
                w = want[f"{k}/{i}"]
                np.testing.assert_allclose(o[f"{k}/{i}"], w, **_tol(k, w), err_msg=f"{k}/{i}")


def test_stage_blocks_and_owners():
    assert list(P.stage_blocks(12, 4, 1)) == [3, 4, 5]
    assert P.stage_of("blocks.7.msha.qkv", 12, 4) == 2
    assert P.stage_of("mapping.w", 12, 4) is None
    with pytest.raises(ValueError, match="not divisible by pipeline stages"):
        P.stage_blocks(6, 4, 0)


# --- pp_bundle against the JAX pp_bundle ------------------------------------------------


def _cfgs(family: str):
    if family == "v2":
        over = {"v2.depth": 4, "v2.dropout": 0.0, "runtime.compute_dtype": "float32",
                "runtime.use_pallas": "never"}
    else:
        over = {"v1.generator.depth": 4, "v1.discriminator.depth": 4,
                "v1.generator.transformer.attn_dropout": 0.0,
                "v1.generator.transformer.mlp_dropout": 0.0,
                "v1.discriminator.transformer.attn_dropout": 0.0,
                "v1.discriminator.transformer.mlp_dropout": 0.0,
                "runtime.compute_dtype": "float32", "runtime.use_pallas": "never"}
    return JC.replace(JC.smoke_config(family), **over), C.replace(C.smoke_config(family), **over)


def _port_module(gan, net: str, variables):
    module = (gan.generator_init if net == "g" else gan.discriminator_init)(None, device="meta")
    module = module.to_empty(device="cpu")
    module.load_state_dict(from_jax_tree(jax.tree.map(np.asarray, variables)))
    return module


@pytest.mark.parametrize("family,net", [("v2", "g"), ("v2", "d"), ("v1", "g"), ("v1", "d")])
def test_pp_bundle_applies_equal_the_jax_pp_bundle(jax_pipe, family, net):
    """The same weights through the JAX pp_bundle (4 stages, 2 microbatches)
    and the port's (one stage, 2 microbatches): outputs, v1 D's refreshed ISR
    state, and the gradients of sum(out * cot) for every parameter."""
    jcfg, cfg = _cfgs(family)
    jgan = JP.pp_bundle(jax_build_gan(jcfg), jcfg, mesh=jax_pipe, microbatches=2)
    variables = (jgan.generator_init if net == "g" else jgan.discriminator_init)(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(11)
    m = cfg.model
    if net == "g":
        inp = rng.standard_normal((8, m.latent_dim)).astype(np.float32)
    else:
        inp = rng.uniform(-1, 1, (8, m.image_size, m.image_size, m.channels)).astype(np.float32)

    def japply(params):
        v = {"params": params, "state": variables["state"]}
        if net == "g":
            return jgan.generator_apply(v, jnp.asarray(inp))
        return jgan.discriminator_apply(v, jnp.asarray(inp), update_state=True)

    jout, jstate = jax.jit(japply)(variables["params"])
    cot = rng.standard_normal(jout.shape).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(japply(p)[0] * cot)))(variables["params"])

    gan = P.pp_bundle(build_gan(cfg), cfg, mesh=one_stage(), microbatches=2)
    module = _port_module(gan, net, variables)
    if net == "g":
        out = gan.generator_apply(module, torch.from_numpy(inp))
    else:
        out = gan.discriminator_apply(module, torch.from_numpy(inp), update_state=True)
    tol = TOL if family == "v2" or net == "d" else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **tol)
    (out * torch.from_numpy(cot)).sum().backward()
    want = from_jax_tree(jax.tree.map(np.asarray, jgrads))
    for name, p in module.named_parameters():  # atol on the leaf's scale (SIREN's reach 1e2)
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=tol["rtol"],
                                   atol=tol["atol"] * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)
    if family == "v1" and net == "d":
        for name, b in module.named_buffers():
            want_b = from_jax_tree({"params": {}, "state": jax.tree.map(np.asarray, jstate)})
            np.testing.assert_allclose(b.numpy(), want_b[name].numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_one_stage_one_microbatch_is_the_sequential_stack():
    """M = 1 on one stage: the module's forward bit-equal to no runner's."""
    _, cfg = _cfgs("v2")
    gan = build_gan(cfg)
    pgan = P.pp_bundle(gan, cfg, mesh=one_stage(), microbatches=1)
    g0 = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    g1 = pgan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    z = torch.randn(4, cfg.model.latent_dim)
    assert g1.blocks_runner is not None and g0.blocks_runner is None
    assert torch.equal(g0(z), g1(z))


# --- errors and the eval fallback -------------------------------------------------------


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_equal_the_jax_errors(jax_pipe):
    """Depth, family and an indivisible training batch: the JAX strings."""
    pipe4 = M.make_mesh(C.MeshConfig(pipeline_parallel=4), world_size=4)
    jcfg = JC.replace(JC.smoke_config("v2"), **{"v2.depth": 6})
    cfg = C.replace(C.smoke_config("v2"), **{"v2.depth": 6})
    want = _jax_error(lambda: JP.pp_bundle(jax_build_gan(jcfg), jcfg, mesh=jax_pipe,
                                           microbatches=2))
    assert _jax_error(lambda: P.pp_bundle(build_gan(cfg), cfg, mesh=pipe4,
                                          microbatches=2)) == want
    jcfg, cfg = JC.smoke_config("mlp"), C.smoke_config("mlp")
    want = _jax_error(lambda: JP.pp_bundle(jax_build_gan(jcfg), jcfg, mesh=jax_pipe,
                                           microbatches=2))
    assert _jax_error(lambda: P.pp_bundle(build_gan(cfg), cfg, mesh=pipe4,
                                          microbatches=2)) == want
    jcfg, cfg = _cfgs("v2")
    jgan = jax_build_gan(jcfg)
    g_vars = jgan.generator_init(jax.random.PRNGKey(0))
    z = jgan.sample_latent(jax.random.PRNGKey(7), 5)  # 5 % 2 microbatches != 0
    runner = JP.make_pp_block_runner(jcfg.model, mesh=jax_pipe, axis="pipe", microbatches=2,
                                     train=True)
    from vitgan_tpu.models.vitgan_v2 import generator_apply

    want = _jax_error(lambda: generator_apply(g_vars, z, jcfg.model, rng=jax.random.PRNGKey(0),
                                              train=True, blocks_runner=runner))
    gan = P.pp_bundle(build_gan(cfg), cfg, mesh=one_stage(), microbatches=2)
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    got = _jax_error(lambda: g(torch.randn(5, cfg.model.latent_dim), train=True,
                               generator=torch.Generator().manual_seed(1)))
    assert got == want


def test_an_indivisible_eval_batch_runs_as_one_microbatch():
    """Eval paths call with any batch (grids, FID chunks): 5 rows at M = 2
    run as one microbatch, equal to the stack without a runner."""
    _, cfg = _cfgs("v2")
    gan = build_gan(cfg)
    pgan = P.pp_bundle(gan, cfg, mesh=one_stage(), microbatches=2)
    g0 = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    g1 = pgan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    z = torch.randn(5, cfg.model.latent_dim)
    assert torch.equal(g0(z), g1(z))


# --- the draws ----------------------------------------------------------------------------


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("blocks,microbatches", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_megablock_microbatch_bits_are_the_whole_batch_rows(mapped, blocks, microbatches):
    """The linear stage's plain Philox masks of each microbatch (rows of a
    local batch of ``blocks`` blocks of 4 samples x 5 tokens, D's [real;
    fake] at 2) equal the whole local batch's rows, with and without a data
    row map (this rank the second of two)."""
    seed = torch.tensor([98765432101], dtype=torch.int64)
    n, e, local = 5, 8, 4
    total = blocks * local
    rows = draws.RowMap(local, 2 * local, local) if mapped else None
    with draws.global_rows(rows):
        whole = FB.row_mask(seed, 1, (total * n, e), 0.25, FB.mask_rows(total, n))
    whole = whole.reshape(total, n, e)
    mb = total // microbatches
    for j in range(microbatches):
        with draws.global_rows(rows), draws.microbatch(j * mb, total):
            mine = FB.row_mask(seed, 1, (mb * n, e), 0.25, FB.mask_rows(mb, n))
        assert torch.equal(mine.reshape(mb, n, e), whole[j * mb:(j + 1) * mb])


def test_a_microbatch_across_the_real_fake_boundary_raises():
    """Under a data row map, rows 2..5 of [real 4; fake 4] sit in two places
    of the global batch: no one offset keys them."""
    with draws.global_rows(draws.RowMap(4, 8, 0)), draws.microbatch(2, 8):
        with pytest.raises(ValueError, match="straddle"):
            FB.mask_rows(4, 5)


@pytest.mark.parametrize("family,microbatches", [("v2", 2), ("v2", 4), ("v1", 2)])
def test_a_one_stage_pipelined_step_equals_the_unpipelined_step(family, microbatches):
    """Two train steps with dropout on (every draw made before the stack, in
    block order): the metrics, parameters and first moments of the
    unpipelined steps (the gloo bounds)."""
    over = {"runtime.compute_dtype": "float32"}
    if family == "v2":
        over["v2.dropout"] = 0.1
    cfg = C.replace(C.smoke_config(family), **over)
    from vitgan_tpu_torch.train.state import create_train_state
    from vitgan_tpu_torch.train.step import make_train_step

    def run(pipelined: bool):
        gan = build_gan(cfg)
        if pipelined:
            gan = P.pp_bundle(gan, cfg, mesh=one_stage(), microbatches=microbatches)
        state = create_train_state(gan, cfg, device="cpu")
        step = make_train_step(gan, cfg)
        ms = [step(state, torch.from_numpy(r)) for r in W.reals(cfg)]
        out = W.flat_state(state.state_dict())
        for k in ms[-1]:
            out[f"metric/{k}"] = np.array([float(m[k]) for m in ms])
        return out

    G.close(run(True), run(False), cfg)


# --- across processes (gloo) --------------------------------------------------------------


@pytest.fixture(scope="module")
def rep4():
    return G.reference("rep4_v2")


def _held(outs, stages: int, depth: int = 4):
    per = depth // stages
    for r, o in enumerate(outs):
        s = r % stages  # the pipe axis is innermost
        for net in ("g", "d"):
            assert list(o[f"held_blocks/{net}"]) == list(range(s * per, (s + 1) * per)), (r, net)
        np.testing.assert_array_equal(o["moment_numel"], o["placed"])


@pytest.mark.parametrize("case,world,stages", [("pp_v2", 2, 2), ("pp4_v2", 4, 4)])
def test_pipeline_steps_equal_the_unpipelined_step(tmp_path, rep4, case, world, stages):
    """2 stages x 2 microbatches and 4 x 4, dropout 0.1 (the plain route's
    masks drawn before the stack): the single-process step's state; each
    stage holds and steps only its blocks (parameters and moments), the
    other leaves on every stage."""
    outs = G.launch(tmp_path, case, world)
    G.same_on_every_rank(outs)
    G.close(outs[0], rep4, W.case_config(case))
    _held(outs, stages)
    # the parameters a stage steps: all but the other stages' blocks'
    cfg = W.case_config(case)
    gan = build_gan(cfg)
    for net, i in (("g", 0), ("d", 1)):
        module = (gan.generator_init if net == "g" else gan.discriminator_init)(
            None, device="meta")
        total = sum(p.numel() for p in module.parameters())
        blocks = sum(p.numel() for p in module.blocks.parameters())
        assert outs[0]["placed"][i] == total - blocks + blocks // stages


def test_pipeline_step_equals_the_jax_mesh_step(tmp_path):
    """2 stages from the JAX parameters and the JAX step's own draws
    (dropout 0) against the JAX package's step on its 2-stage CPU pipe
    (pp_bundle, as its Trainer builds it)."""
    G.held_to_the_jax_mesh_step(tmp_path, "pp_v2_plain")


@pytest.mark.parametrize("case,world,rtol", [
    ("pp4_v2_plain", 4, 1e-5), ("pp_dp_v2_plain", 4, 1e-4), ("pp_tp_v2_plain", 4, 1e-4),
    ("pp_fsdp_v2_plain", 4, 1e-4), ("fsdp_tp_pp_v2_plain", 8, 1e-4), ("pp_v1_plain", 2, 1e-5),
    ("pp_r1_v2_plain", 4, 1e-5)])
def test_pipeline_layouts_equal_the_jax_mesh_step(tmp_path, case, world, rtol):
    """4 stages x 4 microbatches, PP x DP, PP x TP, PP x FSDP, FSDP x TP x
    PP, v1 over 2 stages (its ISR state from the JAX init) and R1 through 4
    stages x 4 microbatches, each at dropout 0 from the JAX parameters and
    the JAX step's own draws, against the JAX package's step on a mesh of
    the same layout: metrics at the bounds of the port-held cases, the rest
    at the DP bounds."""
    outs = G.held_to_the_jax_mesh_step(tmp_path, case, world, rtol=rtol)
    _held(outs, W.case_config(case).mesh.pipeline_parallel)


@pytest.mark.parametrize("case,world", [("pp_dp_v2", 4), ("pp_tp_v2", 4), ("pp_fsdp_v2", 4),
                                        ("fsdp_tp_pp_v2", 8)])
def test_pipeline_compositions_equal_the_unpipelined_step(tmp_path, rep4, case, world):
    """PP x DP (data 2 x pipe 2: each data rank's draws the global batch's
    rows), PP x TP (2 x 2), PP x FSDP (data 2 x pipe 2) and the FSDP x TP x PP
    triple (2 x 2 x 2): the single-process step, metrics at the TP bar (rtol
    1e-4), parameters and moments at the DP bounds."""
    outs = G.launch(tmp_path, case, world)
    G.same_on_every_rank(outs)
    G.close(outs[0], rep4, W.case_config(case), rtol=1e-4)
    _held(outs, 2)


def test_v1_pipeline_step_equals_the_unpipelined_step(tmp_path):
    """v1 over 2 stages: the SLN generator's (h, w) pair on the ring, the
    ISR discriminator refreshed per stage; the ISR buffers gathered."""
    outs = G.launch(tmp_path, "pp_v1", 2)
    G.same_on_every_rank(outs)
    G.close(outs[0], G.reference("rep_v1"), W.case_config("pp_v1"))


def test_r1_through_four_stages(tmp_path):
    """R1 every step through 4 stages x 4 microbatches: its double backward
    crosses the hops both ways without a deadlock (the launch is bounded)
    and equals the single-process step."""
    outs = G.launch(tmp_path, "pp_r1_v2", 4)
    G.same_on_every_rank(outs)
    G.close(outs[0], G.reference("rep_r1_v2"), W.case_config("pp_r1_v2"))


def test_trainer_pipeline_parallel(tmp_path):
    """mesh.pipeline_parallel=4 through the trainer's fit (dropout on, sample
    grids and FID every epoch over the pipelined generator); rank 0's
    checkpoint, gathered from the stages, resumes in one process bit for
    bit."""
    from vitgan_tpu_torch.train.trainer import Trainer

    run_dir = tmp_path / "run"
    outs = G.launch(tmp_path, "pp4_v2", 4, fit=True, fid=True, run_dir=str(run_dir))
    G.same_on_every_rank(outs)
    assert np.isfinite(outs[0]["metric/d_loss"]) and np.isfinite(outs[0]["metric/fid"])
    cfg = C.replace(W.case_config("pp4_v2"), **{
        "run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
        "run.steps_per_epoch": 2, "data.synthetic_samples": 64, "mesh.pipeline_parallel": 1})
    t = Trainer(cfg, run_dir=str(run_dir), device="cpu")
    t.resume()
    assert t.state.step == 2
    for k, v in W.flat_state(t.state.state_dict()).items():
        np.testing.assert_array_equal(v, outs[0][k], err_msg=k)
