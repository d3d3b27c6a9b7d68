"""The port's sweep (vitgan_tpu_torch/hpo/sweep.py and ``cli sweep``) against
the JAX package's (vitgan_tpu/hpo/sweep.py): the search space bit for bit,
the trial configs, the collapse-aware ranking, torn lines, resume and
striding, two workers on one JSONL, the CLI's flags, and a 2-trial run of
2 steps each through the port's Trainer on the CPU.

Tolerances: the search space, the configs and the rankings are compared
exactly; the end-to-end run checks finite FIDs only."""

import json
import os

import numpy as np
import pytest

from vitgan_tpu import config as JC
from vitgan_tpu.hpo import sweep as JS
from vitgan_tpu_torch import cli
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.hpo import sweep as S


@pytest.mark.parametrize("seed", range(20))
def test_search_space_draws_equal_the_jax_draws(seed):
    """Ten trials from default_rng(seed) in each package, bit-equal."""
    a, b = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(10):
        assert S.sample_search_space(a) == JS.sample_search_space(b)


def _common(port: dict, jax_: dict):
    """The port's fields, each equal to the JAX package's."""
    for k, v in port.items():
        if isinstance(v, dict):
            _common(v, jax_[k])
        else:
            assert v == (tuple(jax_[k]) if isinstance(jax_[k], list) else jax_[k]), k


@pytest.mark.parametrize("extended", [False, True])
def test_trial_config_equals_the_jax_trial_config(extended):
    trial = JS.sample_search_space(np.random.default_rng(3))
    if not extended:  # the reference's space: no loss, no diversity weight
        trial = {k: trial[k] for k in ("gen_lr", "disc_lr", "embed_dim", "num_heads",
                                       "batch_size")}
    port = S._trial_config(S._sweep_base(None, 2, "synthetic"), trial)
    jax_ = JS._trial_config(JS._sweep_base(None, 2, "synthetic"), trial)
    assert port.run.collapse_abort and port.run.epochs == 2
    _common(C.to_dict(port), json.loads(json.dumps(JC.to_dict(jax_))))


RECORDS = [
    {"trial": 0, "params": {"gen_lr": 1e-4}, "fid": 1.0, "collapsed": True},
    {"trial": 1, "params": {"gen_lr": 2e-4}, "fid": 5.0, "collapsed": False},
    {"trial": 2, "params": {"gen_lr": 3e-4}, "fid": 7.0, "collapsed": False},
    {"trial": 3, "params": {"gen_lr": 4e-4}, "fid": float("nan"), "collapsed": False},
]


@pytest.mark.parametrize("records", [RECORDS, [dict(r, collapsed=True) for r in RECORDS[:2]],
                                     [{"trial": 3, "params": {}, "fid": 4.0}], []])
def test_finish_sweep_ranks_as_the_jax_package(tmp_path, records):
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "j")
    port = S._finish_sweep(records, str(tmp_path / "p"))
    jax_ = JS._finish_sweep(records, str(tmp_path / "j"))
    assert json.dumps(port, sort_keys=True) == json.dumps(jax_, sort_keys=True)
    if records is RECORDS:
        assert port["trial"] == 1 and port["excluded_collapsed_trials"] == 1
        on_disk = json.load(open(tmp_path / "p" / "best_config.json"))
        assert on_disk["trial"] == 1 and not on_disk["all_trials_collapsed"]


def test_a_torn_last_line_is_skipped(tmp_path):
    path = tmp_path / "sweep_results.jsonl"
    path.write_text(json.dumps({"trial": 0, "params": {}, "fid": 2.0}) + "\n"
                    + json.dumps({"trial": 1, "params": {}, "fid": 3.0}) + "\n"
                    + '{"trial": 2, "par')
    assert sorted(S._load_recorded_trials(str(path))) == [0, 1]
    assert S._load_recorded_trials(str(path)) == JS._load_recorded_trials(str(path))


class _FakeTrainer:
    """Trainer stand-in: a trial's FID is a function of its rates."""

    runs = []

    def __init__(self, cfg, run_dir=None, device="cuda", fid_extractor="auto"):
        assert fid_extractor == "random_conv" and os.path.basename(run_dir) == cfg.run_name
        self.cfg, self.collapsed = cfg, cfg.v2.gen_optim.learning_rate > 2e-4
        _FakeTrainer.runs.append(cfg.run_name)

    def fit(self, epochs=None):
        return {"fid": 1e4 * self.cfg.v2.gen_optim.learning_rate, "d_loss": 1.0}


@pytest.fixture
def fake_trainer(monkeypatch):
    from vitgan_tpu_torch.train import trainer

    _FakeTrainer.runs = []
    monkeypatch.setattr(trainer, "Trainer", _FakeTrainer)
    return _FakeTrainer


def test_striding_runs_its_slice_and_a_bad_offset_raises(tmp_path, fake_trainer):
    with pytest.raises(ValueError, match="trial_offset"):
        S.run_sweep(num_trials=4, trial_offset=2, trial_stride=2, run_base=str(tmp_path))
    S.run_sweep(num_trials=5, seed=1, trial_offset=1, trial_stride=2, run_base=str(tmp_path))
    assert fake_trainer.runs == ["trial_001", "trial_003"]


def test_two_workers_merge_one_jsonl(tmp_path, fake_trainer):
    """Worker A (trials 0, 2, 4) then worker B (1, 3): B, finishing last,
    ranks all five, and its best is the best of every drawn trial."""
    d = str(tmp_path)
    S.run_sweep(num_trials=5, seed=4, trial_offset=0, trial_stride=2, run_base=d)
    best = S.run_sweep(num_trials=5, seed=4, trial_offset=1, trial_stride=2, run_base=d)
    recs = [json.loads(x) for x in open(os.path.join(d, "sweep_results.jsonl"))]
    assert sorted(r["trial"] for r in recs) == [0, 1, 2, 3, 4]
    viable = [r for r in recs if not r["collapsed"]]
    assert best["trial"] == min(viable or recs, key=lambda r: r["fid"])["trial"]
    assert json.load(open(os.path.join(d, "best_config.json")))["trial"] == best["trial"]
    rng = np.random.default_rng(4)
    assert [r["params"] for r in sorted(recs, key=lambda r: r["trial"])] == [
        JS.sample_search_space(rng) for _ in range(5)]


def test_resume_skips_recorded_trials_and_a_mismatch_raises(tmp_path, fake_trainer):
    d = str(tmp_path)
    S.run_sweep(num_trials=2, seed=5, run_base=d)
    fake_trainer.runs = []
    best = S.run_sweep(num_trials=3, seed=5, run_base=d, resume=True)
    assert fake_trainer.runs == ["trial_002"]
    assert best["trial"] in (0, 1, 2)
    with pytest.raises(ValueError, match="resume mismatch"):
        S.run_sweep(num_trials=3, seed=6, run_base=d, resume=True)
    with pytest.raises(ValueError, match="resume mismatch"):
        S.run_sweep_vectorized(num_trials=3, seed=6, run_base=d, resume=True, device="cpu")


def test_cli_sweep_flags(tmp_path, monkeypatch):
    """The JAX CLI's sweep flags parse; DEV, --set and --dataset reach the
    base config; --vectorize with striding raises."""
    args = cli.build_parser().parse_args([
        "sweep", "--num-trials", "3", "--trial-offset", "1", "--trial-stride", "2", "--resume",
        "--epochs", "2", "--seed", "7", "--set", "v2.depth=3", "--dataset", "synthetic",
        "--run-dir", str(tmp_path), "--device", "cpu"])
    assert (args.num_trials, args.trial_offset, args.trial_stride, args.resume) == (3, 1, 2, True)
    monkeypatch.setenv("DEV", "1")
    base, epochs = cli._sweep_base_from_args(args)
    assert epochs == 2 and base.family == "v2" and base.v2.depth == 3 and base.v2.seed == 7
    assert base.v2.embed_dim == C.smoke_config().v2.embed_dim  # DEV's smoke config
    assert base.run.checkpoint_every_epochs == 0 and base.data.dataset == "synthetic"
    bad = cli.build_parser().parse_args(["sweep", "--vectorize", "--trial-stride", "2",
                                         "--device", "cpu", "--run-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--vectorize replaces host striding"):
        bad.fn(bad)


def _tiny_space(rng):
    return {"gen_lr": float(rng.uniform(1e-5, 1e-4)), "disc_lr": 1e-4, "embed_dim": 32,
            "num_heads": 2, "batch_size": 8}


def test_run_sweep_end_to_end_on_the_cpu(tmp_path, monkeypatch, capsys):
    """``cli sweep``: two trials of two steps each through the port's
    Trainer, FID with the random conv; the JSONL and best_config.json."""
    monkeypatch.setattr(S, "sample_search_space", _tiny_space)
    monkeypatch.setenv("DEV", "1")
    assert cli.main(["sweep", "--num-trials", "2", "--device", "cpu", "--run-dir",
                     str(tmp_path), "--set", "run.fid_num_samples=16",
                     "--set", "data.synthetic_samples=64"]) == 0
    out = capsys.readouterr().out
    best = json.load(open(tmp_path / "best_config.json"))
    assert json.loads(out[out.index("{\n"):]) == best
    recs = [json.loads(x) for x in open(tmp_path / "sweep_results.jsonl")]
    assert [r["trial"] for r in recs] == [0, 1]
    assert all(np.isfinite(r["fid"]) for r in recs)
    assert best["trial"] == min(recs, key=lambda r: r["fid"])["trial"]
    assert os.path.isdir(tmp_path / "trial_000" / "checkpoints")


def test_a_vectorized_sweep_trains_each_shape_as_one_group(tmp_path, monkeypatch):
    """Three trials of one shape and one of another: two groups, each
    trained by one call of _train_group; every trial scored once with its
    group's size, in trial order, and the rates part the same-shape trials."""
    it = iter([(1e-4, 32), (3e-4, 32), (2e-4, 48), (5e-5, 32)])

    def space(rng):
        lr, e = next(it)
        return {"gen_lr": lr, "disc_lr": 1e-4, "embed_dim": e, "num_heads": 2, "batch_size": 8}

    monkeypatch.setattr(S, "sample_search_space", space)
    real_group, sizes = S._train_group, []

    def spy(key, members, *a):
        sizes.append([i for i, _ in members])
        return real_group(key, members, *a)

    monkeypatch.setattr(S, "_train_group", spy)
    base = C.replace(C.smoke_config("v2"), **{
        "run.steps_per_epoch": 1, "run.fid_num_samples": 16, "data.synthetic_samples": 32,
        "run.checkpoint_every_epochs": 0, "run.sample_grid_every_epochs": 0})
    timings = []
    S.run_sweep_vectorized(num_trials=4, base_cfg=base, run_base=str(tmp_path), device="cpu",
                           timings=timings)
    recs = [json.loads(x) for x in open(tmp_path / "sweep_results.jsonl")]
    assert sorted(sizes) == [[0, 1, 3], [2]]
    assert sorted((r["trial"], r["group_size"]) for r in recs) == [(0, 3), (1, 3), (2, 1), (3, 3)]
    assert all(np.isfinite(r["fid"]) for r in recs)
    fids = {r["trial"]: r["fid"] for r in recs}
    assert len({fids[0], fids[1], fids[3]}) == 3
    assert sorted(t["trials"] for t in timings) == [1, 3] and all(t["steps"] == 1
                                                                  for t in timings)
