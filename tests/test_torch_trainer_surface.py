"""The port trainer's surface on the CPU: collapse detection, the files of a
run (the JSONL scalars, env.json, sample grids, the eval noise), SIGTERM
inside graceful_preemption, validate and profile, make_eval_step against the
JAX make_eval_step, the trainer's config fields through a JAX config.json
and back, and the timing, profiling and tracker utilities.  Tolerance of the
eval step: 1e-5 relative and absolute (f32 on both sides)."""

import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import build_gan as jax_build_gan
from vitgan_tpu.train.state import create_train_state as jax_create_train_state
from vitgan_tpu.train.step import make_eval_step as jax_make_eval_step
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.state import create_train_state
from vitgan_tpu_torch.train.step import make_eval_step
from vitgan_tpu_torch.train.trainer import Trainer
from vitgan_tpu_torch.utils import preemption
from vitgan_tpu_torch.weights import from_jax_tree, load_into

torch.set_num_threads(1)
SMALL = {"data.synthetic_samples": 32}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _scalars(trainer):
    with open(os.path.join(trainer.dirs.logs, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("abort", [False, True])
def test_collapse_detection(tmp_path, abort):
    cfg = C.replace(C.smoke_config(), **{**SMALL, "run.collapse_window": 2,
                                         "run.collapse_abort": abort})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    accs = iter([0.5, 1.0, 1.0, 1.0, 1.0])
    one = torch.ones(2)

    def won(state, data, idx):  # D wins from epoch 1 on
        a = next(accs)
        return {"d_loss": 0.01 * one, "g_loss": 5 * one, "d_real_acc": a * one,
                "d_fake_acc": a * one}

    t._device_train_fn = won
    t.fit(epochs=5)
    flags = [s["value"] for s in _scalars(t) if s["tag"] == "train/collapse"]
    assert t.collapsed
    _, meta = t.ckpts.restore()
    if abort:  # stops after epoch 2, which it completed
        assert flags == [0.0, 0.0, 1.0] and t.epoch == 3 and meta["epoch"] == 3
    else:
        assert flags == [0.0, 0.0, 1.0, 1.0, 1.0] and t.epoch == 5 and meta["epoch"] == 5


def test_run_files(tmp_path):
    cfg = C.replace(C.smoke_config(), **SMALL)
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    t.fit(epochs=2)
    root = tmp_path / "run"
    for f in ("config.json", "env.json", "training.log", "generator.pt", "input/real.png",
              "noise/eval_noise.npy", "images/epoch_0000.png", "images/epoch_0001.png"):
        assert (root / f).exists(), f
    np.testing.assert_array_equal(np.load(root / "noise" / "eval_noise.npy"),
                                  t.eval_noise.numpy())
    with open(root / "env.json") as f:
        env = json.load(f)
    assert env["torch_version"] == torch.__version__ and env["backend"] == "cpu"
    assert not any("jax" in k or "flax" in k for k in env)
    tags = {(s["tag"], s["step"]) for s in _scalars(t)}
    assert {("train/d_loss", 2), ("train/d_loss", 4), ("train/images_per_sec", 4)} <= tags
    val = t.validate(num_batches=2)
    assert sorted(val) == ["val_d_loss_fake", "val_d_loss_real", "val_fake_acc", "val_g_loss",
                           "val_real_acc"] and all(np.isfinite(list(val.values())))
    assert os.path.exists(os.path.join(t.profile(n_steps=1), "trace.json"))


def test_sigterm_stops_fit_and_checkpoints(tmp_path):
    cfg = C.replace(C.smoke_config(), **{**SMALL, "run.steps_per_call": 2,
                                         "run.steps_per_epoch": 4})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    fn = t._device_train_fn

    def terminated(state, data, idx):
        out = fn(state, data, idx)
        if signal.getsignal(signal.SIGTERM) is preemption._handler:
            signal.raise_signal(signal.SIGTERM)
        else:  # a worker thread cannot install the handler: run it as SIGTERM would
            preemption._handler(signal.SIGTERM, None)
        return out

    t._device_train_fn = terminated
    with preemption.graceful_preemption():
        t.fit(epochs=3)
    _, meta = t.ckpts.restore()
    assert t.state.step == 2 and meta["step"] == 2 and meta["epoch"] == 0


def test_eval_step_matches_jax():
    over = {"runtime.compute_dtype": "float32", "v2.dropout": 0.0}
    jcfg = JC.replace(JC.smoke_config(), **over)
    cfg = C.replace(C.smoke_config(), **over)
    jgan = jax_build_gan(jcfg)
    jst = jax_create_train_state(jax.random.PRNGKey(3), jgan, jcfg)
    real = np.random.default_rng(7).uniform(-1, 1, (8, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(1000)
    z = np.asarray(jgan.sample_latent(key, 8), np.float32)
    jm = jax_make_eval_step(jgan, jcfg)(jst, jnp.asarray(real), key)
    gan = build_gan(cfg)
    state = create_train_state(gan, cfg, device="cpu")
    load_into(state.g, from_jax_tree(jax.tree.map(np.asarray, jst.g_params)))
    load_into(state.d, from_jax_tree(jax.tree.map(np.asarray, jst.d_params)))
    m = make_eval_step(gan, cfg)(state, torch.from_numpy(real), torch.from_numpy(z))
    assert set(m) == set(jm) and len(m) == 5
    for k in jm:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, atol=1e-5, err_msg=k)


def test_jax_config_json_carries_the_trainer_fields(tmp_path):
    fields = {"run.checkpoint_every_epochs": 7, "run.keep_checkpoints": 5,
              "run.sample_grid_every_epochs": 2, "run.steps_per_call": 4,
              "run.collapse_window": 3, "run.collapse_acc": 0.9, "run.collapse_abort": True,
              "run.fid_every_epochs": 0, "run.fid_num_samples": 64, "run.best_metric": "kid",
              "run.early_stop_patience": 2, "run.early_stop_min_delta": 0.5,
              "data.on_device": False, "data.on_device_max_bytes": 123,
              "runtime.scan_unroll": 2, "runtime.donate_state": False}
    jcfg = JC.replace(JC.smoke_config(), **fields)
    JC.save_config(jcfg, str(tmp_path / "jax.json"))
    cfg = C.load_config(str(tmp_path / "jax.json"))
    for key, want in fields.items():
        section, name = key.split(".")
        assert getattr(getattr(cfg, section), name) == want, key
    C.save_config(cfg, str(tmp_path / "port.json"))
    back = JC.load_config(str(tmp_path / "port.json"))
    for section in ("run", "data", "runtime"):
        assert getattr(back, section) == getattr(jcfg, section), section


def test_timing_profiling_and_trackers(tmp_path):
    from vitgan_tpu_torch.utils.logging import EarlyStopping, MovingAverage
    from vitgan_tpu_torch.utils.profiling import StepTimer, annotate, trace
    from vitgan_tpu_torch.utils.timing import sync_timeit

    calls = []
    sec = sync_timeit(lambda x: calls.append(x), 1, iters=3, warmup=2, device="cpu")
    assert sec >= 0 and len(calls) == 5
    timer = StepTimer()
    for _ in range(2):
        with timer:
            pass
    summary = timer.summary(batch_size=8)
    assert summary["steps"] == 2.0 and summary["images_per_sec"] > 0
    with trace(str(tmp_path / "prof")):
        with annotate("region"):
            torch.ones(3).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "region" in f.read()
    avg = MovingAverage(alpha=0.5)
    assert avg.update(2.0) == 2.0 and avg.update(4.0) == 3.0
    stop = EarlyStopping(patience=2, min_delta=1.0)
    assert [stop.step(v) for v in (10.0, 9.5, 9.4, 8.0)] == [False, False, True, False]
