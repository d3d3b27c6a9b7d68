"""The evaluation slice as a whole on the CPU.

- FID parity: a small v2 generator (depth 2, embed 32, f32) carried from the
  JAX package by weights.from_jax_tree; the port's Trainer.evaluate_fid with
  the random-conv extractor (the JAX weights carried across) against the FID
  the JAX functions compute on the same fakes (the JAX generator on latents
  from latent_rng(step, i)) and reals (default_rng(step)'s indices), within
  rtol 1e-3 (f32 features, f64 Frechet math on both sides);
- ``fit`` with FID on: the best checkpoint, best.json and generator_best.pt;
  early stopping trips at the JAX trainer's epoch on the same FID sequence
  and advances the epoch cursor; resume(best=True) keeps best_metric; a run
  with FID on trains bit-equal to one with it off;
- the CLI: ``eval`` writes metrics.json with the JAX keys, and ``generate
  --best`` and ``serve --best`` read the best generator.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.train import fid as JF
from vitgan_tpu.train import make_sample_fn as jax_make_sample_fn
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.trainer import Trainer as JaxTrainer
from vitgan_tpu_torch import cli
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import inception as I
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.serve import load_service
from vitgan_tpu_torch.train import fid as F
from vitgan_tpu_torch.train.sample import latent_rng
from vitgan_tpu_torch.train.trainer import Trainer
from vitgan_tpu_torch.utils.run_dirs import restore_run
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)

SMALL = {"data.synthetic_samples": 32, "run.fid_num_samples": 16}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


@pytest.fixture(scope="module")
def jax_conv_params():
    return [np.asarray(w) for w in JF._random_conv_params(jax.random.PRNGKey(42), 3)]


def test_evaluate_fid_matches_jax(tmp_path, jax_conv_params):
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0,
            "data.synthetic_samples": 40, "run.fid_num_samples": 32}
    jcfg = JC.replace(JC.smoke_config(), **over)
    cfg = C.replace(C.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(5), jgan, jcfg)
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu", fid_extractor="random_conv")
    load_into(t.state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    t._extractor = F.make_random_conv_extractor(device="cpu", params=jax_conv_params)
    for step in (3, 11):
        t.state.step = step
        got = t.evaluate_fid()
        # The JAX side on the same reals and fakes: 4 batches of 8 a side.
        b, n_batches = 8, 4
        dataset = t.dataset.numpy()
        idx = np.random.default_rng(step).choice(len(dataset), size=(n_batches, b),
                                                 replace=False)
        sample = jax_make_sample_fn(jgan, jcfg)
        feats = jax.jit(lambda x: JF.random_conv_features(jax_conv_params, x))
        real, fake = JF.FeatureStats(512), JF.FeatureStats(512)
        for i in range(n_batches):
            real.update(feats(dataset[idx[i]]))
            z = t.gan.sample_latent(latent_rng(step, i), b).numpy()
            fake.update(feats(JF.to_uint8(np.asarray(sample(jst.g_vars_ema, z)))))
        want = JF.frechet_distance(*real.moments(), *fake.moments())
        np.testing.assert_allclose(got, want, rtol=1e-3)
    # more draws than the dataset holds: with replacement, as in JAX
    assert np.isfinite(t.evaluate_fid(num_samples=10_000))


def _scripted(trainer, values):
    it = iter(values)
    trainer.evaluate_fid = lambda num_samples=None, spans=None: next(it)


FIDS = [5.0, 4.0, 4.5, 4.4, 3.0, 2.0]


def test_early_stopping_trips_at_the_jax_epoch(tmp_path):
    over = {"run.early_stop_patience": 2, "run.early_stop_min_delta": 0.25,
            "run.checkpoint_every_epochs": 1, "run.sample_grid_every_epochs": 0}
    jt = JaxTrainer(JC.replace(JC.smoke_config("mlp"), run_name="j", **over),
                    run_base=str(tmp_path), fid_extractor="random_conv")
    _scripted(jt, FIDS)
    jt.fit(epochs=len(FIDS))
    t = Trainer(C.replace(C.smoke_config(), **{**SMALL, **over}), run_dir=str(tmp_path / "p"),
                device="cpu")
    _scripted(t, FIDS)
    means = t.fit(epochs=len(FIDS))
    assert t.epoch == jt.epoch == 4 and means["fid"] == 4.4
    assert t.best_metric == jt.best_metric == 4.0
    _, meta = t.ckpts.restore()
    assert meta["epoch"] == 4 and meta["step"] == 8  # the cursor advanced past the stop
    with open(tmp_path / "p" / "checkpoints" / "best.json") as f:
        best = json.load(f)
    with open(tmp_path / "j" / "checkpoints" / "best.json") as f:
        jbest = json.load(f)
    assert best == {"step": 4, "metric": "fid", "value": 4.0, "epoch": 2, "best_metric": 4.0}
    assert {k: jbest[k] for k in ("metric", "value", "epoch", "best_metric")} == {
        k: best[k] for k in ("metric", "value", "epoch", "best_metric")}


def test_fit_writes_the_best_and_resume_best_keeps_it(tmp_path):
    cfg = C.replace(C.smoke_config(), **{**SMALL, "run.ema_decay": 0.9})
    root = tmp_path / "run"
    t = Trainer(cfg, run_dir=str(root), device="cpu")
    _scripted(t, [3.0, 5.0])
    t.fit(epochs=2)
    for f in ("checkpoints/best/state.pt", "checkpoints/best.json", "generator_best.pt",
              "generator.pt"):
        assert (root / f).exists(), f
    scalars = [json.loads(line) for line in open(root / "logs" / "scalars.jsonl")]
    assert [s["value"] for s in scalars if s["tag"] == "eval/fid"] == [3.0, 5.0]
    assert len([s for s in scalars if s["tag"] == "eval/fid_seconds"]) == 2
    best_sd, _ = t.ckpts.restore(best=True)
    g_best = torch.load(root / "generator_best.pt")
    # generator_best.pt is the best checkpoint's EMA generator, not the final one
    for (name, _), e in zip(t.state.g.named_parameters(), best_sd["state"]["g_ema"]):
        assert torch.equal(g_best[name], e), name
    final = torch.load(root / "generator.pt")
    assert any(not torch.equal(final[k], g_best[k]) for k in final)
    r = Trainer(cfg, run_dir=str(root), device="cpu")
    r.resume(best=True)
    assert (r.best_metric, r.epoch, r.state.step) == (3.0, 1, 2)


def _flat_state(trainer):
    sd = trainer.checkpoint_state()["state"]
    out = {"rng": sd["rng"], **{f"g.{k}": v for k, v in sd["g"].items()},
           **{f"d.{k}": v for k, v in sd["d"].items()}}
    out.update({f"ema.{i}": e for i, e in enumerate(sd["g_ema"] or ())})
    for net in ("g_opt", "d_opt"):
        for i, entry in sd[net]["state"].items():
            out.update({f"{net}.{i}.{k}": v for k, v in entry.items()})
    return out, sd["step"]


def test_fid_on_trains_bit_equal_to_fid_off(tmp_path, jax_conv_params):
    over = {**SMALL, "run.ema_decay": 0.9, "run.diff_augment": "color,translation",
            "data.augment_flip": True}
    runs = {}
    for every in (1, 0):
        t = Trainer(C.replace(C.smoke_config(), **{**over, "run.fid_every_epochs": every}),
                    run_dir=str(tmp_path / f"fid{every}"), device="cpu",
                    fid_extractor="random_conv")
        means = t.fit(epochs=3)
        assert ("fid" in means) == bool(every)
        runs[every] = _flat_state(t)
    (on, on_step), (off, off_step) = runs[1], runs[0]
    assert on_step == off_step == 6 and set(on) == set(off)
    for k in on:
        assert torch.equal(on[k], off[k]), k


def test_cli_eval_and_best(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "fid_inception.npz")
    I.save_params(path, I.convert_torch_state_dict(I.random_torch_state_dict(0)))
    monkeypatch.setenv("INCEPTION_WEIGHTS", path)
    run = str(tmp_path / "run")
    t = Trainer(C.replace(C.smoke_config(), **SMALL), run_dir=run, device="cpu",
                fid_extractor="random_conv")
    _scripted(t, [3.0, 5.0])
    t.fit(epochs=2)
    capsys.readouterr()
    assert cli.main(["eval", "--run-dir", run, "--device", "cpu", "--best", "--num-samples",
                     "8", "--extractor", "inception", "--kid-subset-size", "4",
                     "--kid-subsets", "2", "--seed", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(run, "metrics.json")) as f:
        assert json.load(f) == out
    jax_keys = {"fid", "kid_mean", "kid_std", "precision", "recall", "num_real", "num_fake",
                "run_dir", "ckpt_step", "extractor", "feature_dim", "dataset",
                "inception_score_mean", "inception_score_std"}
    assert set(out) == jax_keys
    assert out["num_real"] == out["num_fake"] == 8 and out["ckpt_step"] == 2
    assert out["feature_dim"] == I.FEATURE_DIM and out["extractor"] == "inception"
    for k in ("fid", "kid_mean", "kid_std", "precision", "recall", "inception_score_mean"):
        assert np.isfinite(out[k]), k
    # generate --best and serve --best read generator_best.pt (the epoch-0 weights)
    assert cli.main(["generate", "--run-dir", run, "--device", "cpu", "--best",
                     "--num-images", "4"]) == 0
    assert "(step 2)" in capsys.readouterr().out
    _, _, g, meta = restore_run(run, best=True, device="cpu")
    best = torch.load(os.path.join(run, "generator_best.pt"))
    assert meta["step"] == 2 and all(torch.equal(v, best[k]) for k, v in g.state_dict().items())
    assert load_service(run, batch=4, best=True, device="cpu").sample(2, seed=0).shape == (
        2, 32, 32, 3)
    os.remove(os.path.join(run, "generator_best.pt"))
    with pytest.raises(FileNotFoundError):
        restore_run(run, best=True, device="cpu")
