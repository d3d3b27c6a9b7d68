"""The port's mesh and placement plans in one process, against the JAX
package's (vitgan_tpu/parallel/{mesh, sharding}.py on its 8-device CPU
mesh): mesh shapes and errors, local_batch_size, the TP and FSDP plans
leaf for leaf for v1, v2 and dcgan, the mesh config section, the pipe and
seq layouts' meshes and errors, and the data-parallel draws (every draw and the
megablock's in-kernel dropout bits keyed by the global row).  Everything
is compared exactly."""

import json

import jax
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.parallel import mesh as JM
from vitgan_tpu.parallel import sharding as JS
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import layers as L
from vitgan_tpu_torch.ops import augment, draws
from vitgan_tpu_torch.ops import fused_block as FB
from vitgan_tpu_torch.parallel import mesh as M
from vitgan_tpu_torch.parallel import sharding as S
from vitgan_tpu_torch.weights import _flatten, from_jax_tree

import torch_gloo_worker as W


@pytest.mark.parametrize("n,mp", [(1, 1), (2, 1), (8, 1), (8, 2), (8, 4), (4, 4)])
def test_mesh_shapes_equal_the_jax_meshes(n, mp):
    jm = JM.make_mesh(JC.MeshConfig(model_parallel=mp), devices=jax.devices()[:n])
    pm = M.make_mesh(C.MeshConfig(model_parallel=mp), world_size=n)
    assert pm.shape == dict(jm.shape) and pm.axis_names == tuple(jm.axis_names)
    devs = np.asarray(jm.devices)
    for r in range(n):  # rank r sits where device r sits in the JAX mesh
        pm = M.make_mesh(C.MeshConfig(model_parallel=mp), world_size=n, rank=r)
        where = np.argwhere(np.vectorize(lambda d: d.id)(devs) == jax.devices()[r].id)[0]
        assert (pm.data_index, pm.model_index) == tuple(where)


def test_mesh_errors_equal_the_jax_errors():
    """Indivisible device counts (the model axis, the pipe axis, the seq
    axis) and SP with PP: the JAX strings; a pipe or seq axis that divides
    builds the JAX mesh's shape and axis names."""
    for over in ({"model_parallel": 3}, {"pipeline_parallel": 3}, {"context_parallel": 3},
                 {"pipeline_parallel": 2, "context_parallel": 2}):
        with pytest.raises(ValueError) as jerr:
            JM.make_mesh(JC.MeshConfig(**over), devices=jax.devices()[:8])
        with pytest.raises(ValueError) as perr:
            M.make_mesh(C.MeshConfig(**over), world_size=8)
        assert str(perr.value) == str(jerr.value)
    for over in ({"pipeline_parallel": 2}, {"context_parallel": 2}):
        jm = JM.make_mesh(JC.MeshConfig(**over), devices=jax.devices()[:8])
        pm = M.make_mesh(C.MeshConfig(**over), world_size=8)
        assert pm.shape == dict(jm.shape) and pm.axis_names == tuple(jm.axis_names)


@pytest.mark.parametrize("batch,n,mp,pc", [(8, 8, 1, 1), (8, 2, 1, 2), (6, 4, 1, 1),
                                           (8, 4, 2, 3), (16, 8, 2, 4)])
def test_local_batch_size_equals_the_jax_one(batch, n, mp, pc):
    jm = JM.make_mesh(JC.MeshConfig(model_parallel=mp), devices=jax.devices()[:n])
    pm = M.make_mesh(C.MeshConfig(model_parallel=mp), world_size=n)
    try:
        want = JM.local_batch_size(batch, jm, process_count=pc)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            M.local_batch_size(batch, pm, process_count=pc)
        assert str(err.value) == str(e)
    else:
        assert M.local_batch_size(batch, pm, process_count=pc) == want


def test_batch_rows_take_the_rank_s_share():
    x = np.arange(16).reshape(8, 2)
    for r in range(4):
        pm = M.make_mesh(C.MeshConfig(model_parallel=2), world_size=8, rank=r)
        assert M.batch_rows(pm, 8) == ((r // 2) * 2, 2)
        np.testing.assert_array_equal(M.shard_batch(pm, x), x[(r // 2) * 2:(r // 2) * 2 + 2])


def _jax_variables(family: str):
    cfg = JC.replace(JC.smoke_config(family), **({"v2.num_heads": 4} if family == "v2" else {}))
    gan = jax_build_gan(cfg)
    kg, kd = jax.random.split(jax.random.PRNGKey(0))
    return {"g": gan.generator_init(kg), "d": gan.discriminator_init(kd)}


def _padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("family", ["v1", "v2", "dcgan"])
@pytest.mark.parametrize("plan", ["tp", "fsdp", "fsdp_tp"])
def test_placement_plans_equal_the_jax_partition_specs(family, plan):
    """The JAX plan of every parameter and state leaf (v1's ISR vectors
    included) on the 4 x 2 CPU mesh, by the port's state_dict names."""
    mesh = JM.make_mesh(JC.MeshConfig(model_parallel=2), devices=jax.devices()[:8])
    sizes = dict(mesh.shape)
    for net, variables in _jax_variables(family).items():
        if plan == "tp":
            jsh = JS.tp_shardings(variables, mesh)
        else:
            jsh = JS.fsdp_shardings(variables, mesh, tensor_parallel=plan == "fsdp_tp",
                                    min_size=256)
        leaves = from_jax_tree(jax.tree.map(np.asarray, variables))
        specs = {}  # the shardings by the port's names, as from_jax_tree names the leaves
        for part in ("params", "state"):
            _flatten(jsh.get(part, {}), "", specs)
        shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        if plan == "tp":
            mine = S.tp_specs(shapes, sizes)
        else:
            mine = S.fsdp_specs(shapes, sizes, tensor_parallel=plan == "fsdp_tp", min_size=256)
        assert set(mine) == set(shapes)
        sharded = 0
        for k, shape in shapes.items():
            want = _padded(specs[k].spec, len(shape))
            assert mine[k] == want, (net, k)
            sharded += any(mine[k])
        # dcgan's convolutions match no TP rule: TP alone leaves it whole
        assert sharded or (family, plan) == ("dcgan", "tp"), (family, net, plan)


def test_train_state_plan_keeps_one_rank_axes_whole():
    """shard_train_state's rule: TP only on a model axis above one, FSDP
    only on a data axis above one; the one-way plan (tests/torch_gloo_worker.py)
    keeps it there."""
    shapes = {"blocks.0.msha.qkv": (3, 4, 32, 8), "blocks.0.fc1.w": (32, 64)}
    one = M.make_mesh(C.MeshConfig(), world_size=1)
    assert all(not any(s) for s in S.train_state_specs(shapes, one, True, True, 16).values())
    kept = W.one_way_specs(shapes, one, True, True, 16)
    assert kept["blocks.0.msha.qkv"][1] == "model" and "data" in kept["blocks.0.fc1.w"]


def test_mesh_section_survives_the_config_round_trip(tmp_path):
    """A JAX config.json with FSDP, a model axis of 2 and 4 pipeline
    microbatches loads in the port and writes back equal."""
    jcfg = JC.replace(JC.ExperimentConfig(), **{"mesh.fsdp": True, "mesh.model_parallel": 2,
                                               "mesh.pipeline_microbatches": 4})
    JC.save_config(jcfg, str(tmp_path / "config.json"))
    cfg = C.load_config(str(tmp_path / "config.json"))
    assert (cfg.mesh.fsdp, cfg.mesh.model_parallel, cfg.mesh.pipeline_microbatches) == (
        True, 2, 4)
    assert C.to_dict(cfg)["mesh"] == json.load(open(tmp_path / "config.json"))["mesh"]
    assert set(C.to_dict(C.ExperimentConfig())["mesh"]) == set(
        JC.to_dict(JC.ExperimentConfig())["mesh"])
    C.save_config(cfg, str(tmp_path / "port.json"))
    assert JC.load_config(str(tmp_path / "port.json")).mesh == jcfg.mesh


@pytest.mark.parametrize("over", [{"mesh.pipeline_parallel": 2}, {"mesh.context_parallel": 2}])
def test_the_trainer_raises_for_an_unported_layout(tmp_path, over):
    """A PP or CP layout without a process group: the trainer plans the
    layout's ranks and asks for a started group."""
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = C.replace(C.smoke_config(), **over)
    with pytest.raises(ValueError, match="a mesh of 2 ranks needs a started process group"):
        Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")


@pytest.mark.parametrize("n,mp,pp", [(8, 1, 4), (8, 2, 2), (4, 1, 2), (8, 1, 8)])
def test_pipe_mesh_shapes_equal_the_jax_meshes(n, mp, pp):
    """The (data, model, pipe) grid in the JAX device order: rank r at data
    r // (mp pp), model (r // pp) % mp, pipe r % pp (tests/test_pipeline_parallel.py
    asserts {"data": 2, "model": 1, "pipe": 4})."""
    jm = JM.make_mesh(JC.MeshConfig(model_parallel=mp, pipeline_parallel=pp),
                      devices=jax.devices()[:n])
    devs = np.vectorize(lambda d: d.id)(np.asarray(jm.devices))
    for r in range(n):
        pm = M.make_mesh(C.MeshConfig(model_parallel=mp, pipeline_parallel=pp), world_size=n,
                         rank=r)
        assert pm.shape == dict(jm.shape) and pm.axis_names == tuple(jm.axis_names)
        where = np.argwhere(devs == jax.devices()[r].id)[0]
        assert (pm.data_index, pm.model_index, pm.pipe_index) == tuple(where)
        assert pm.pipe_rank(0) == r - pm.pipe_index and pm.n_pipe == pp and pm.n_seq == 1


def _rows(first):
    return draws.RowMap(local=4, global_=8, first=first)


def test_draws_under_a_row_map_are_the_global_draws_rows():
    """Dropout masks, augment and flip draws of a rank's 4 rows (and of
    D's [real; fake] forward, two blocks) equal the global draw's rows."""
    x = torch.zeros(4, 5, 6)
    for first in (0, 4):
        for n_blocks in (1, 2):
            gen_all = torch.Generator().manual_seed(3)
            full = L.dropout_mask(torch.zeros(8 * n_blocks, 5, 6), 0.1, True, gen_all)
            gen = torch.Generator().manual_seed(3)
            with draws.global_rows(_rows(first)):
                mine = L.dropout_mask(x.repeat(n_blocks, 1, 1), 0.1, True, gen)
            idx = [j * 8 + first + i for j in range(n_blocks) for i in range(4)]
            assert torch.equal(mine, full[idx])
            assert gen.get_state().equal(gen_all.get_state())  # streams advance alike
        img = torch.zeros(4, 16, 16, 3)
        g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
        want = augment.draw_augment(g1, torch.zeros(8, 16, 16, 3), "color,translation,cutout")
        with draws.global_rows(_rows(first)):
            got = augment.draw_augment(g2, img, "color,translation,cutout")
        for (n1, a), (n2, b) in zip(want, got):
            for ta, tb in zip(a if isinstance(a, tuple) else (a,),
                              b if isinstance(b, tuple) else (b,)):
                assert torch.equal(tb, ta[first:first + 4]), n1


def test_megablock_dropout_bits_are_keyed_by_the_global_row():
    """The plain version of the linear stage's in-kernel Philox masks: a
    rank's (2 x 4 samples x 5 tokens, 8) rows equal the global mask's rows."""
    seed = torch.tensor([98765432101], dtype=torch.int64)
    n, e = 5, 8
    full = FB.dropout_mask(seed, 1, (2 * 8 * n, e), 0.25).reshape(16, n, e)
    for first in (0, 4):
        with draws.global_rows(_rows(first)):
            rows = FB.mask_rows(8, n)
        mine = FB.row_mask(seed, 1, (8 * n, e), 0.25, rows).reshape(8, n, e)
        assert torch.equal(mine, torch.cat([full[first:first + 4], full[8 + first:12 + first]]))
    with draws.global_rows(draws.RowMap(8, 8, 0)):
        assert FB.mask_rows(8, n) is None
