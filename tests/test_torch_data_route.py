"""The trainer's two data routes on the CPU, against each other and against
the JAX trainer:

- a partial last batch (data.drop_last=False) takes the host route and its
  epoch trains every image;
- the host route and the device route train to bit-equal states over an
  epoch (data.augment_flip=False, dropout and DiffAugment on), v2 and v1;
- the host route's calls (one a batch, or k stacked batches and the rest
  one each) are the JAX trainer's _epoch_steps';
- the epoch orders of fit (the input grid's draw, then one an epoch) are
  the JAX trainer's pipeline._epoch_order() sequence, on both routes;
- a host-route run resumed from its checkpoint is bit-equal to an
  uninterrupted one (flips from the pipeline, a partial batch);
- `cli train --dataset cifar10` and `cli eval --dataset cifar10` over files
  in data.data_dir.
"""

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import write_cifar
from vitgan_tpu import config as JC
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.train import trainer as T

torch.set_num_threads(1)
QUIET = {"run.fid_every_epochs": 0, "run.sample_grid_every_epochs": 0,
         "run.checkpoint_every_epochs": 0, "run.log_every_steps": 0}


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _state_tensors(trainer) -> dict:
    sd = trainer.checkpoint_state()
    st = sd["state"]
    out = {"step": torch.tensor(st["step"]), "rng": st["rng"]}
    for net in ("g", "d"):
        out.update({f"{net}.{k}": v for k, v in st[net].items()})
        for i, entry in st[f"{net}_opt"]["state"].items():
            out.update({f"{net}_opt.{i}.{k}": v for k, v in entry.items()})
    return out, sd["data_order"]


def _assert_bit_equal(a, b):
    (ta, oa), (tb, ob) = _state_tensors(a), _state_tensors(b)
    assert set(ta) == set(tb) and oa == ob
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k


def test_partial_batch_epoch_trains_every_image(tmp_path):
    cfg = C.replace(C.smoke_config(), **QUIET, **{
        "data.drop_last": False, "data.synthetic_samples": 20, "run.steps_per_epoch": None})
    t = T.Trainer(cfg, run_dir=str(tmp_path / "run"), device="cpu")
    assert t.route == "host"
    seen, epoch = [], t.pipeline.epoch

    def recording(max_batches=None):
        for x, y in epoch(max_batches):
            seen.append(y.numpy().copy())
            yield x, y

    t.pipeline.epoch = recording
    t.pipeline.labels = np.arange(20, dtype=np.int32)  # each image's label its index
    means = t.fit(epochs=1)
    assert [len(y) for y in seen] == [8, 8, 4] and t.state.step == 3
    assert sorted(np.concatenate(seen).tolist()) == list(range(20))
    assert np.isfinite(means["d_loss"]) and sorted(t._host_step_fns) == [4, 8]


@pytest.mark.parametrize("family", ["v2", "v1"])
def test_host_and_device_routes_train_bit_equal(tmp_path, family):
    over = {**QUIET, "data.synthetic_samples": 40, "run.steps_per_epoch": None,
            "data.augment_flip": False}
    if family == "v2":
        over["run.diff_augment"] = "color,translation"
    cfg = C.replace(C.smoke_config(family), **over)
    dev = T.Trainer(cfg, run_dir=str(tmp_path / "dev"), device="cpu")
    host = T.Trainer(C.replace(cfg, **{"data.on_device": False}),
                     run_dir=str(tmp_path / "host"), device="cpu")
    assert (dev.route, host.route) == ("device", "host")
    assert dev.steps_per_call == 5 and host.steps_per_call == 1
    for t in (dev, host):
        t.fit(epochs=2)
        assert t.state.step == 10
    _assert_bit_equal(dev, host)


@pytest.mark.parametrize("samples,spe,spc,drop_last", [(40, None, 1, True), (40, 3, 1, True),
                                                       (40, None, 2, True), (44, None, 4, False),
                                                       (44, None, 1, False), (56, 5, 3, True)])
def test_host_route_calls_follow_the_jax_epoch_steps(tmp_path, monkeypatch, samples, spe, spc,
                                                     drop_last):
    """The JAX Trainer on its host route (data.on_device=False; its train
    state, step factories and scalar sink stubbed) and the port's: the same
    sequence of calls, each a stack of k batches or one batch."""
    from vitgan_tpu.parallel import make_mesh
    from vitgan_tpu.train import step as JS
    from vitgan_tpu.train import trainer as JT

    jax_calls, calls = [], []

    def jax_single(state, real):
        jax_calls.append(("single", real.shape[0]))
        return state, {}

    def jax_multi(state, reals):
        jax_calls.append(("stack", *reals.shape[:2]))
        return state, {}

    monkeypatch.setattr(JT, "create_train_state",
                        lambda *a, **k: SimpleNamespace(g_params=None, d_params=None))
    monkeypatch.setattr(JT, "count_params", lambda *a, **k: 0)
    monkeypatch.setattr("vitgan_tpu.parallel.sharding.shard_train_state", lambda s, *a, **k: s)
    monkeypatch.setattr(JT, "MetricLogger", lambda *a, **k: None)
    monkeypatch.setattr(JT, "make_train_step", lambda *a, **k: jax_single)
    monkeypatch.setattr(JS, "make_multi_train_step", lambda *a, **k: jax_multi)
    over = {"data.synthetic_samples": samples, "run.steps_per_epoch": spe,
            "run.steps_per_call": spc, "data.drop_last": drop_last, "data.on_device": False}
    jcfg = JC.replace(JC.smoke_config(), **over)
    jt = JT.Trainer(jcfg, mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
                    run_base=str(tmp_path / "jax"))
    assert jt._device_dataset is None
    list(jt._epoch_steps(jcfg.run))

    def build(gan, cfg, n):
        def call(state, reals):
            calls.append(("single", reals.shape[1]) if n == 1 else ("stack", *reals.shape[:2]))
            assert reals.shape[0] == n
            return {}
        return call

    monkeypatch.setattr(T, "make_multi_train_step", build)
    monkeypatch.setattr(T, "MetricLogger", lambda *a, **k: None)
    t = T.Trainer(C.replace(C.smoke_config(), **over), run_dir=str(tmp_path / "port"),
                  device="cpu")
    assert t.route == "host" and t.steps_per_call == jt.steps_per_call
    list(t._epoch_calls())
    assert calls == jax_calls and len(calls) > 0


@pytest.mark.parametrize("on_device", [True, False])
def test_epoch_orders_equal_the_jax_trainers(tmp_path, monkeypatch, on_device):
    """Every order fit draws, JAX's through its own fit (the grid's
    next(iter(pipeline.epoch())) then one an epoch; its train state,
    device calls, checkpoints and scalar sink stubbed) and the port's
    through a real fit: the same permutations in the same sequence.  Before
    the port's grid drew from the pipeline, its epoch e trained on JAX's
    epoch e - 1's order."""
    from vitgan_tpu.parallel import make_mesh
    from vitgan_tpu.train import trainer as JT

    over = {**QUIET, "data.synthetic_samples": 40, "data.on_device": on_device,
            "data.augment_flip": False}

    def recorder(pipeline, into):
        draw = pipeline._epoch_order

        def record():
            into.append(draw().copy())
            return into[-1]

        pipeline._epoch_order = record

    def zeros(n):
        return {"d_loss": jnp.zeros(n), "g_loss": jnp.zeros(n)}

    sink = SimpleNamespace(scalars=lambda *a, **k: None, scalar=lambda *a, **k: None,
                           save_figures=lambda *a, **k: None, image_grid=lambda *a, **k: None)
    monkeypatch.setattr(JT, "create_train_state",
                        lambda *a, **k: SimpleNamespace(g_params=None, d_params=None, step=0))
    monkeypatch.setattr(JT, "count_params", lambda *a, **k: 0)
    monkeypatch.setattr("vitgan_tpu.parallel.sharding.shard_train_state", lambda s, *a, **k: s)
    monkeypatch.setattr(JT, "MetricLogger", lambda *a, **k: sink)
    monkeypatch.setattr(JT, "make_train_step", lambda *a, **k: lambda st, real: (st, zeros(1)))
    jcfg = JC.replace(JC.smoke_config(), **over)
    jt = JT.Trainer(jcfg, mesh=make_mesh(jcfg.mesh, devices=jax.devices()[:1]),
                    run_base=str(tmp_path / "jax"))
    assert (jt._device_dataset is not None) == on_device
    jt._device_train_fn = lambda st, data, idx: (st, zeros(len(idx)))
    jt.ckpts = SimpleNamespace(save=lambda *a, **k: None, wait=lambda: None,
                               latest_step=lambda: None)
    jax_orders, orders = [], []
    recorder(jt.pipeline, jax_orders)
    jt.fit(epochs=3)

    t = T.Trainer(C.replace(C.smoke_config(), **over), run_dir=str(tmp_path / "port"),
                  device="cpu")
    assert t.route == ("device" if on_device else "host")
    recorder(t.pipeline, orders)
    t.fit(epochs=2)
    t.fit(epochs=3)  # a later fit continues the orders: no second grid draw
    assert len(jax_orders) == len(orders) == 4
    for want, got in zip(jax_orders, orders):
        np.testing.assert_array_equal(got, want)


def test_host_route_resume_is_bit_equal(tmp_path):
    cfg = C.replace(C.smoke_config(), **QUIET, **{
        "data.on_device": False, "data.augment_flip": True, "data.drop_last": False,
        "data.synthetic_samples": 20, "run.steps_per_epoch": None})
    a = T.Trainer(cfg, run_dir=str(tmp_path / "a"), device="cpu")
    a.fit(epochs=2)
    b = T.Trainer(cfg, run_dir=str(tmp_path / "b"), device="cpu")
    b.fit(epochs=1)
    c = T.Trainer(cfg, run_dir=str(tmp_path / "b"), device="cpu")
    c.resume()
    assert c.route == "host" and c.epoch == 1 and c.state.step == 3
    c.fit(epochs=2)
    assert c.state.step == 6
    _assert_bit_equal(a, c)


def test_cli_train_and_eval_read_cifar10_files(tmp_path, monkeypatch, capsys):
    from vitgan_tpu_torch.cli import main

    data = tmp_path / "cifar"
    write_cifar(str(data), 8, archive=True)
    monkeypatch.setenv("DEV", "1")
    run = tmp_path / "run"
    where = f"data.data_dir={data}"
    assert main(["train", "--device", "cpu", "--dataset", "cifar10", "--run-dir", str(run),
                 "--set", where, "--set", "run.fid_every_epochs=0"]) == 0
    cfg = C.load_config(str(run / "config.json"))
    assert cfg.data.dataset == "cifar10" and cfg.data.data_dir == str(data)
    with open(run / "training.log") as f:
        assert "device route, 122880-byte dataset of 40" in f.read()
    capsys.readouterr()
    assert main(["eval", "--run-dir", str(run), "--device", "cpu", "--dataset", "cifar10",
                 "--set", where, "--num-samples", "16", "--extractor", "random_conv",
                 "--kid-subset-size", "8", "--kid-subsets", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["dataset"] == "cifar10" and np.isfinite(out["fid"])
    with pytest.raises(FileNotFoundError, match="data_batch_1"):
        main(["eval", "--run-dir", str(run), "--device", "cpu", "--dataset", "cifar10",
              "--set", f"data.data_dir={tmp_path / 'nothing'}", "--extractor", "random_conv"])
