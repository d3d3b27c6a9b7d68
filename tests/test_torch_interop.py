"""Reference torch checkpoints (utils/torch_port.py, utils/torch_export.py)
against the JAX package's, on the CPU.

Reference ``state_dict``s are built in memory from seeded numpy, as the JAX
package's own tests/test_torch_port.py builds them (no reference checkpoint
file exists): the JAX package's exports of seeded trees, a v2 discriminator
with the reference's 10-class head, under each of its prefixes.

- For every family and role (v2 D; cnn and dcgan G and D) the port's
  import_checkpoint equals the JAX one leaf for leaf, bit for bit, and loads
  into the port's module whole (BatchNorm's running statistics as buffers);
  the port's export of that module equals the JAX export_checkpoint of the
  same tree, key for key, bit for bit; v2 G and v1 are refused in both;
- a .pth file round trip, the v1 trainer's {"lr", "epoch", "state_dict"}
  wrapper unwrapped;
- the CLI on the CPU: import-torch (a run directory that generate and
  export-torch read), export-torch, generate --from-torch and train
  --warm-start-d (ignored with --resume).
"""

import os

import jax
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.utils import torch_export as JE
from vitgan_tpu.utils import torch_port as JP
from vitgan_tpu_torch import cli
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.utils import torch_export as TE
from vitgan_tpu_torch.utils import torch_port as TP
from vitgan_tpu_torch.weights import from_jax_tree, load_into, to_jax_tree

torch.set_num_threads(1)
CASES = [("v2", "discriminator", ""), ("v2", "discriminator", "vit."),
         ("v2", "discriminator", "discriminator.vit."), ("cnn", "generator", None),
         ("cnn", "discriminator", None), ("dcgan", "generator", None),
         ("dcgan", "discriminator", None)]
IDS = ["v2-D", "v2-D-vit", "v2-D-gan", "cnn-G", "cnn-D", "dcgan-G", "dcgan-D"]


def _seeded_tree(family, role, seed=0):
    """A JAX init tree of (family, role) with every leaf perturbed by seeded numpy."""
    gan = jax_build_gan(JC.smoke_config(family))
    init = gan.generator_init if role == "generator" else gan.discriminator_init
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
                        if a.dtype.kind == "f" else a, tree)


def _reference_sd(family, role, prefix):
    """A reference state_dict (numpy) of (family, role): the v2 discriminator
    with a 10-class head, as the reference's ViT carries."""
    tree = _seeded_tree(family, role)
    sd = JE.export_checkpoint(tree, family, role, prefix=prefix, channels=3)
    if family == "v2":
        p = prefix or ""
        e = sd[p + "classifier.fc2.weight"].shape[1]
        rng = np.random.default_rng(9)
        sd[p + "classifier.fc2.weight"] = rng.standard_normal((10, e)).astype(np.float32)
        sd[p + "classifier.fc2.bias"] = rng.standard_normal(10).astype(np.float32)
    return sd


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _module(family, role):
    gan = build_gan(C.smoke_config(family))
    init = gan.generator_init if role == "generator" else gan.discriminator_init
    return init(torch.Generator().manual_seed(0), device="cpu")


@pytest.mark.parametrize("family,role,prefix", CASES, ids=IDS)
def test_import_and_export_equal_the_jax_package(family, role, prefix):
    sd = _reference_sd(family, role, prefix)
    num_heads = JC.smoke_config(family).model.num_heads if family == "v2" else 4
    want = JP.import_checkpoint(dict(sd), family, role, num_heads=num_heads)
    got = TP.import_checkpoint(dict(sd), family, role, num_heads=num_heads)
    fw, fg = _flat(want), _flat(got)
    assert set(fw) == set(fg)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and np.array_equal(fg[k], fw[k]), k
    module = _module(family, role)
    load_into(module, from_jax_tree(got))  # every leaf, BN statistics among them
    exported = TE.export_checkpoint(to_jax_tree(module), family, role, prefix=prefix,
                                    channels=3)
    jexported = JE.export_checkpoint(want, family, role, prefix=prefix, channels=3)
    assert set(exported) == set(jexported)
    for k in jexported:
        assert np.array_equal(np.asarray(exported[k]), np.asarray(jexported[k])), k


def test_unmappable_families_are_refused_in_both():
    sd = _reference_sd("v2", "discriminator", "vit.")
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="dimensionally broken"):
            mod.import_checkpoint(sd, "v2", role="generator")
        with pytest.raises(ValueError, match="no torch importer"):
            mod.import_checkpoint(sd, "v1")
    for mod in (TE, JE):
        with pytest.raises(ValueError, match="no torch exporter"):
            mod.export_checkpoint({"params": {}}, "mlp")


def test_pth_file_and_v1_wrapper(tmp_path):
    sd = _reference_sd("dcgan", "generator", None)
    raw, wrapped = str(tmp_path / "g.pth"), str(tmp_path / "g_v1.ckpt")
    tensors = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    torch.save(tensors, raw)
    torch.save({"lr": 2e-4, "epoch": 3, "state_dict": tensors}, wrapped)
    for path in (raw, wrapped):
        got = TP.load_torch_state_dict(path)
        assert set(got) == set(sd) and all(np.array_equal(got[k], sd[k]) for k in sd)
        assert all(np.array_equal(a, b) for a, b in zip(
            _flat(TP.import_checkpoint(path, "dcgan", "generator")).values(),
            _flat(JP.import_checkpoint(path, "dcgan", "generator")).values()))
    TE.save_torch_checkpoint(str(tmp_path / "back.pth"), TP.import_checkpoint(raw, "dcgan",
                                                                              "generator"),
                             "dcgan", role="generator")
    back = torch.load(str(tmp_path / "back.pth"), weights_only=True)
    # num_batches_tracked comes back 1-d, as from the JAX package's writer
    assert all(torch.equal(back[k].reshape(tensors[k].shape), tensors[k]) for k in tensors)


def _save_pth(path, sd):
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)


def test_cli_import_export_generate_and_warm_start(tmp_path, monkeypatch):
    monkeypatch.setenv("DEV", "1")
    gsd = _reference_sd("cnn", "generator", None)
    dsd = _reference_sd("cnn", "discriminator", None)
    both = str(tmp_path / "cnn_gan.pth")
    _save_pth(both, {**gsd, **dsd})
    run = str(tmp_path / "imported")
    assert cli.main(["import-torch", both, "--family", "cnn", "--device", "cpu",
                     "--run-dir", run]) == 0
    g_out, d_out = str(tmp_path / "g.pth"), str(tmp_path / "d.pth")
    assert cli.main(["export-torch", "--run-dir", run, "--role", "generator",
                     "--out", g_out]) == 0
    assert cli.main(["export-torch", "--run-dir", run, "--out", d_out]) == 0
    for path, sd in ((g_out, gsd), (d_out, dsd)):
        back = torch.load(path, weights_only=True)
        for k, v in sd.items():
            assert np.array_equal(back[k].numpy().reshape(np.shape(v)), v), k
    assert cli.main(["generate", "--run-dir", run, "--device", "cpu", "--num-images", "4"]) == 0
    assert cli.main(["generate", "--from-torch", g_out, "--family", "cnn", "--device", "cpu",
                     "--num-images", "4"]) == 0
    assert os.path.exists(tmp_path / "vitgan_tpu_samples" / "generated_images.png")
    # train --warm-start-d: D starts from the imported weights
    ws = str(tmp_path / "ws")
    common = ["train", "--family", "cnn", "--device", "cpu", "--run-dir", ws,
              "--set", "run.fid_every_epochs=0", "--set", "run.steps_per_epoch=1"]
    loaded = {}
    real_warm = cli._warm_start_d

    def spy(trainer, path, cfg):
        loaded["n"] = real_warm(trainer, path, cfg)
        loaded["d"] = {k: v.clone() for k, v in trainer.state.d.state_dict().items()}
        return loaded["n"]

    monkeypatch.setattr(cli, "_warm_start_d", spy)
    assert cli.main(common + ["--warm-start-d", d_out]) == 0
    want = from_jax_tree(JP.import_checkpoint(dsd, "cnn", "discriminator"))
    assert loaded["n"] == len(want)
    for k, v in want.items():
        assert torch.equal(loaded["d"][k], v), k
    loaded.clear()
    assert cli.main(common + ["--warm-start-d", d_out, "--resume", "--epochs", "2"]) == 0
    assert not loaded  # ignored on --resume
    assert cli.main(common[:-4] + ["--run-dir", str(tmp_path / "ws2"), "--set",
                                   "run.fid_every_epochs=0", "--warm-start-d", run]) == 0
    assert loaded["n"] == len(want)  # from another run directory's checkpoint


def test_v2_discriminator_warm_start_through_the_trainer(tmp_path):
    from vitgan_tpu_torch.train.trainer import Trainer

    cfg = C.replace(C.smoke_config("v2"), **{"run.fid_every_epochs": 0})
    trainer = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    variables = TP.import_checkpoint(_reference_sd("v2", "discriminator", "vit."), "v2",
                                     num_heads=cfg.v2.num_heads)
    n = trainer.warm_start_discriminator(variables)
    assert n == len(trainer.state.d.state_dict())
    got = TE.export_checkpoint(to_jax_tree(trainer.state.d), "v2", channels=3)
    want = JE.export_checkpoint(variables, "v2", channels=3)
    assert all(np.array_equal(got[k], want[k]) for k in want)
