"""The port's full-state checkpoints and exact resume, on the CPU.

- CheckpointManager: keep-N retention, the JSON sidecars, the best
  checkpoint, latest_step, restore by step and by best; partial_load's
  counts;
- a round trip through the Trainer: 2 steps, the final checkpoint, a fresh
  Trainer's resume(), 2 more, bit-equal to 4 uninterrupted steps, for v2
  with dropout, DiffAugment, flips and the EMA (the device generator's state
  matters) and for v1 with its ISR buffers;
- fit's epilogue: the final checkpoint is written when an exception ends the
  run and skipped when the state is non-finite; after a preemption in the
  middle of an epoch the persisted epoch is that epoch.
"""

import json
import os

import numpy as np
import pytest
import torch

from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train.trainer import Trainer
from vitgan_tpu_torch.utils import preemption
from vitgan_tpu_torch.utils.checkpoint import CheckpointManager, partial_load

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def test_manager_retention_sidecars_best_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    for step in (1, 2, 3, 4):
        mgr.save(step, {"w": torch.full((2,), float(step)), "step": step}, {"epoch": step})
    mgr.wait()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == ["step_0000000003", "step_0000000003.json", "step_0000000004",
                     "step_0000000004.json"]
    with open(tmp_path / "ck" / "step_0000000003.json") as f:
        assert json.load(f) == {"step": 3, "epoch": 3}
    sd, meta = mgr.restore()
    assert sd["step"] == 4 and torch.equal(sd["w"], torch.full((2,), 4.0))
    assert meta == {"step": 4, "epoch": 4}
    sd, meta = mgr.restore(step=3)
    assert sd["step"] == 3 and meta["epoch"] == 3
    mgr.save_best(3, {"w": torch.zeros(1)}, "fid", 12.5, {"epoch": 3})
    sd, meta = mgr.restore(best=True)
    assert meta == {"step": 3, "metric": "fid", "value": 12.5, "epoch": 3}
    assert mgr.all_steps() == [3, 4]  # best is not a step
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore()
    with pytest.raises(FileNotFoundError):
        mgr.restore(step=1)


def test_partial_load_matches_by_name_and_shape():
    target = {"a": torch.zeros(2), "b": torch.zeros(3), "c": torch.zeros(1)}
    source = {"a": torch.ones(2), "b": torch.ones(4), "d": torch.ones(1)}
    merged, loaded, total = partial_load(target, source)
    assert (loaded, total) == (1, 3)
    assert torch.equal(merged["a"], torch.ones(2)) and torch.equal(merged["b"], torch.zeros(3))
    assert merged["c"] is target["c"]


def _flat(trainer):
    sd = trainer.checkpoint_state()
    st = sd["state"]
    out = {"step": torch.tensor(st["step"]), "rng": st["rng"]}
    for net in ("g", "d"):
        out.update({f"{net}.{k}": v for k, v in st[net].items()})
        out[f"{net}_opt.count"] = torch.tensor(st[f"{net}_opt"]["count"])
        for i, entry in st[f"{net}_opt"]["state"].items():
            out.update({f"{net}_opt.{i}.{k}": v for k, v in entry.items()})
    for i, e in enumerate(st["g_ema"] or ()):
        out[f"ema.{i}"] = e
    return out, sd["data_order"]


RESUME_CFGS = {
    "v2": C.replace(C.smoke_config(), **{"run.diff_augment": "color,translation",
                                         "run.ema_decay": 0.9, "data.augment_flip": True,
                                         "data.synthetic_samples": 32}),
    "v1": C.replace(C.smoke_config("v1"), **{"data.synthetic_samples": 32}),
}


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_resume_continues_bit_for_bit(tmp_path, family):
    cfg = RESUME_CFGS[family]
    a = Trainer(cfg, run_dir=str(tmp_path / "a"), device="cpu")
    a.fit(epochs=2)
    b = Trainer(cfg, run_dir=str(tmp_path / "b"), device="cpu")
    b.fit(epochs=1)
    c = Trainer(cfg, run_dir=str(tmp_path / "b"), device="cpu")
    c.resume()
    assert c.epoch == 1 and c.state.step == 2
    c.fit(epochs=2)
    want, want_order = _flat(a)
    got, got_order = _flat(c)
    assert set(want) == set(got) and want_order == got_order
    for k in want:
        assert torch.equal(want[k], got[k]), k
    if family == "v1":
        assert any(k.endswith(".u") for k in want)
    assert c.ckpts.all_steps() == [2, 4]


class _Boom(RuntimeError):
    pass


def test_epilogue_saves_on_an_exception_and_skips_a_poisoned_state(tmp_path):
    cfg = C.replace(C.smoke_config(), **{"data.synthetic_samples": 32})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    t.fit(epochs=1)
    fn = t._device_train_fn

    def boom(state, data, idx):
        fn(state, data, idx)
        raise _Boom("mid-epoch")

    t._device_train_fn = boom
    with pytest.raises(_Boom):
        t.fit(epochs=3)
    _, meta = t.ckpts.restore()
    assert meta["step"] == 4 and meta["epoch"] == 1 and meta["final"]  # re-run epoch 1

    def poison(state, data, idx):
        with torch.no_grad():
            next(state.g.parameters()).fill_(float("nan"))
        raise _Boom("poisoned")

    t._device_train_fn = poison
    with pytest.raises(_Boom):
        t.fit(epochs=3)
    assert t.ckpts.latest_step() == 4  # the non-finite state was not saved


def test_preemption_mid_epoch_persists_that_epoch(tmp_path):
    cfg = C.replace(C.smoke_config(), **{"data.synthetic_samples": 32,
                                         "run.steps_per_call": 2, "run.steps_per_epoch": 4})
    t = Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    fn, calls = t._device_train_fn, []

    def preempted(state, data, idx):
        calls.append(state.step)
        out = fn(state, data, idx)
        if state.step == 6:  # after the first of epoch 1's two calls
            preemption._handler(15, None)  # what SIGTERM runs
        return out

    t._device_train_fn = preempted
    with preemption.graceful_preemption():
        t.fit(epochs=3)
    assert calls == [0, 2, 4]
    _, meta = t.ckpts.restore()
    assert meta["step"] == 6 and meta["epoch"] == 1
    assert not preemption.requested()  # the scope cleared the flag on exit
    np.testing.assert_equal(t.epoch, 1)


def test_cli_train_resume_continues_the_run(tmp_path, monkeypatch):
    """`cli train` for one epoch, then `--resume --epochs 2`: the same
    generator, bit for bit, as one `cli train --epochs 2`."""
    from vitgan_tpu_torch.cli import main

    monkeypatch.setenv("DEV", "1")
    args = ["train", "--device", "cpu", "--set", "run.diff_augment=color,translation"]
    full, run = str(tmp_path / "full"), str(tmp_path / "run")
    assert main(args + ["--run-dir", full, "--epochs", "2"]) == 0
    assert main(args + ["--run-dir", run, "--epochs", "1"]) == 0
    assert main(args + ["--run-dir", run, "--epochs", "2", "--resume"]) == 0
    _, meta = CheckpointManager(os.path.join(run, "checkpoints")).restore()
    assert (meta["step"], meta["epoch"]) == (4, 2)
    want, got = (torch.load(os.path.join(d, "generator.pt")) for d in (full, run))
    assert set(want) == set(got) and all(torch.equal(want[k], got[k]) for k in want)
