"""The port's v2 generator and serving path against the JAX package, on the CPU.

- the depth-2 generator, weights carried by weights.from_jax_tree, against
  vitgan_v2.generator_apply (f32, tolerance 1e-5), on the standard route and
  on the megablock route;
- the serving sampler's uint8 formula against train/step.py:418-419;
- SamplerService and the HTTP handler: seeded repeats, coalescing, priority
  pre-emption, /healthz, /metrics and bad requests as tests/test_serve.py
  checks them for the JAX server;
- the stdlib PNG encoder, the config schema shared with the JAX package, run
  directories and the CLI.
"""

import io
import json
import threading
import time
import urllib.request
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vitgan_tpu import config as JC
from vitgan_tpu.models import vitgan_v2 as JV
from vitgan_tpu.utils.images import make_grid as jax_make_grid
from vitgan_tpu_torch import config as C
from vitgan_tpu_torch.models import build_gan
from vitgan_tpu_torch.models.vitgan_v2 import patchify, unpatchify
from vitgan_tpu_torch.ops import policy
from vitgan_tpu_torch.serve import PriorityGate, SamplerService, _make_handler, parse_priority
from vitgan_tpu_torch.train.sample import latent_rng, make_sample_fn, make_serve_sample_fn
from vitgan_tpu_torch.utils.images import make_grid, to_png_bytes
from vitgan_tpu_torch.utils.run_dirs import restore_run, save_run
from vitgan_tpu_torch.weights import from_jax_tree, load_into, load_npz

torch.set_num_threads(1)
GEN_TOL = dict(rtol=1e-5, atol=1e-5)  # f32 on both sides, 2 blocks


@pytest.fixture(autouse=True)
def _restore_policy():
    saved = policy.get_policy()
    yield
    policy.set_policy(**saved)


def _cfg(**over):
    return C.replace(C.smoke_config(), **{"runtime.compute_dtype": "float32", **over})


@pytest.fixture(scope="module")
def jax_generator():
    """The JAX smoke-size v2 generator (depth 2, embed 32, 2 heads) with its
    LN parameters and biases perturbed, and the port's copy of it."""
    jcfg = JC.smoke_config().v2
    tree = jax.tree.map(np.asarray, JV.generator_init(jax.random.PRNGKey(0), jcfg)["params"])
    rng = np.random.default_rng(0)

    def perturb(d):
        for k, v in d.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("b", "bias", "qkv_b"):
                d[k] = (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
            elif k == "scale":
                d[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)

    perturb(tree)
    for blk in tree["blocks"]:
        perturb(blk)
    gan = build_gan(_cfg())
    g = gan.generator_init(torch.Generator().manual_seed(0), device="cpu")
    load_into(g, from_jax_tree(tree))
    return jcfg, tree, gan, g


@pytest.mark.parametrize("megablock", ["off", "on"])
def test_generator_depth2_matches_jax(jax_generator, megablock):
    jcfg, tree, _, g = jax_generator
    z = np.random.default_rng(3).standard_normal((4, jcfg.latent_dim)).astype(np.float32)
    want, _ = JV.generator_apply({"params": jax.tree.map(jnp.asarray, tree)}, jnp.asarray(z), jcfg)
    policy.set_policy(mode="auto", megablock=megablock)
    with torch.inference_mode():
        got = g(torch.from_numpy(z))
    assert got.shape == (4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GEN_TOL)


def test_patchify_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = patchify(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(t.numpy(), np.asarray(JV.patchify(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(unpatchify(t, 4, 16, 3).numpy(), x)


def test_npz_loader_matches_from_jax_tree(jax_generator, tmp_path):
    _, tree, _, g = jax_generator
    flat = {"/".join(str(p.key if hasattr(p, "key") else p.idx) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    np.savez(tmp_path / "g.npz", **flat)
    sd, want = load_npz(str(tmp_path / "g.npz")), from_jax_tree(tree)
    assert sorted(sd) == sorted(want) == sorted(g.state_dict())
    for k in sd:
        torch.testing.assert_close(sd[k], want[k])
    with pytest.raises(KeyError):
        load_into(g, {k: v for k, v in sd.items() if k != "pos"})


def test_config_json_is_shared_with_jax(tmp_path):
    """A JAX run's config.json loads in the port; the port's loads in JAX."""
    jcfg = JC.highres_config(128)
    JC.save_config(jcfg, str(tmp_path / "jax.json"))
    cfg = C.load_config(str(tmp_path / "jax.json"))
    assert C.to_dict(cfg)["v2"] == JC.to_dict(jcfg)["v2"]
    assert cfg.v2 == C.highres_config(128).v2
    for k in ("compute_dtype", "use_pallas", "megablock"):
        assert getattr(cfg.runtime, k) == getattr(jcfg.runtime, k)
    C.save_config(cfg, str(tmp_path / "port.json"))
    back = JC.load_config(str(tmp_path / "port.json"))
    assert back.v2 == jcfg.v2 and back.runtime.megablock == jcfg.runtime.megablock


def test_serve_sampler_uint8_matches_step_formula(jax_generator):
    """uint8 = round((clip(x, -1, 1) + 1) * 127.5), as step.py:418-419, from
    the latents of (seed, call)."""
    _, _, gan, g = jax_generator
    cfg = _cfg()
    u8 = make_serve_sample_fn(gan, cfg, 8)(g, 7, 3)
    z = gan.sample_latent(latent_rng(7, 3), 8)
    imgs = make_sample_fn(gan, cfg)(g, z).numpy()
    want = np.asarray(jnp.round((jnp.clip(jnp.asarray(imgs), -1.0, 1.0) + 1.0) * 127.5)
                      .astype(jnp.uint8))
    assert u8.dtype == np.uint8 and u8.shape == (8, 32, 32, 3)
    np.testing.assert_array_equal(u8, want)


def test_latent_streams_are_distinct():
    draws = {(s, c): latent_rng(s, c).standard_normal(4)
             for s in (0, 1, 2 ** 31 - 1, -2 ** 31, -0x5E11) for c in (0, 1, 2 ** 32 - 1)}
    assert len({d.tobytes() for d in draws.values()}) == len(draws)
    np.testing.assert_array_equal(latent_rng(5, 2).standard_normal(4),
                                  latent_rng(5, 2).standard_normal(4))
    for bad in ((2 ** 31, 0), (0, -1), (0, 2 ** 32)):
        with pytest.raises(ValueError):
            latent_rng(*bad)


@pytest.fixture(scope="module")
def service(jax_generator):
    _, _, gan, g = jax_generator
    return SamplerService(_cfg(), gan, g, batch=64)


def test_seeded_requests_repeat_and_unseeded_coalesce(service):
    a, b = service.sample(5, seed=11), service.sample(5, seed=11)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, service.sample(5, seed=12))
    service._pool = np.zeros((0,), np.uint8)
    before = service._device_calls
    outs = []
    threads = [threading.Thread(target=lambda: outs.append(service.sample(4)))
               for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 16 and all(o.shape == (4, 32, 32, 3) for o in outs)
    assert service._device_calls - before == 1
    assert len({o.tobytes() for o in outs}) == 16


def test_pool_stream_distinct_from_seeded_streams(service):
    service._pool = np.zeros((0,), np.uint8)
    service._pool_calls = 0
    pool = service.sample(8)
    assert not np.array_equal(pool, service.sample(8, seed=-service._pool_seed))


def test_priority_gate_orders_waiters():
    gate = PriorityGate()
    gate.acquire(0)
    order = []

    def waiter(prio, name, delay):
        time.sleep(delay)
        gate.acquire(prio)
        order.append(name)
        gate.release()

    threads = [threading.Thread(target=waiter, args=(10, "batch", 0.0)),
               threading.Thread(target=waiter, args=(0, "interactive", 0.15))]
    for t in threads:
        t.start()
    time.sleep(0.4)
    gate.release()
    for t in threads:
        t.join(timeout=5)
    assert order == ["interactive", "batch"]
    assert parse_priority(None) == 0 and parse_priority("batch") == 10 and parse_priority(3) == 3
    with pytest.raises(ValueError):
        parse_priority("urgent")


def test_interactive_preempts_long_batch_between_device_calls(jax_generator):
    _, _, gan, g = jax_generator
    svc = SamplerService(_cfg(), gan, g, batch=8)
    calls = []
    real_generate = svc._generate
    batch_in_flight = threading.Event()

    def instrumented(seed, call):
        name = threading.current_thread().name
        calls.append(name)
        out = real_generate(seed, call)
        if name == "batch":
            batch_in_flight.set()
            if calls.count("batch") == 1:
                deadline = time.time() + 10
                while time.time() < deadline:
                    with svc._gate._cond:
                        if any(p == 0 for p, _ in svc._gate._waiting):
                            break
                    time.sleep(0.005)
        return out

    svc._generate = instrumented
    done = {}

    def batch_req():
        done["batch"] = svc.sample(32, seed=1, priority="batch")

    def inter_req():
        batch_in_flight.wait(timeout=10)
        done["inter"] = svc.sample(4, seed=2, priority="interactive")

    tb = threading.Thread(target=batch_req, name="batch")
    ti = threading.Thread(target=inter_req, name="inter")
    tb.start()
    ti.start()
    tb.join(timeout=30)
    ti.join(timeout=30)
    assert not tb.is_alive() and not ti.is_alive()
    assert done["batch"].shape[0] == 32 and done["inter"].shape[0] == 4
    assert 0 < calls.index("inter") < 4, f"no pre-emption: call order {calls}"
    np.testing.assert_array_equal(done["batch"], svc.sample(32, seed=1, priority="batch"))
    text = svc.metrics_text()
    assert 'vitgan_priority_requests{priority="interactive"}' in text
    assert 'vitgan_priority_requests{priority="batch"}' in text


def test_png_decodes_to_make_grid():
    """The stdlib PNG is the exact grid; the port's grid is the JAX package's."""
    from PIL import Image

    u8 = np.random.default_rng(0).integers(0, 256, (5, 9, 7, 3), dtype=np.uint8)
    grid = make_grid(u8)
    np.testing.assert_array_equal(grid, jax_make_grid(u8))
    png = to_png_bytes(grid)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), grid)
    gray = u8[..., :1]
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(to_png_bytes(gray[0])))),
                                  np.repeat(gray[0], 3, axis=-1))
    f = np.random.default_rng(1).uniform(-1, 1, (3, 4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(make_grid(f), jax_make_grid(f))
    assert zlib.crc32(png[-8:-4]) != 0 and png[-8:-4] == b"IEND"


@pytest.fixture(scope="module")
def server(service):
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(service))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, payload):
    req = urllib.request.Request(url + "/sample", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_http_endpoints(server):
    with urllib.request.urlopen(server + "/healthz") as r:
        info = json.loads(r.read())
    assert info["family"] == "v2" and info["batch"] == 64 and info["device"] == "cpu"
    status, ctype, body = _post(server, {"n": 3, "seed": 1, "format": "npy"})
    arr = np.load(io.BytesIO(body))
    assert status == 200 and ctype == "application/octet-stream"
    assert arr.shape == (3, 32, 32, 3) and arr.dtype == np.float32
    assert np.isfinite(arr).all() and arr.min() >= -1.0 and arr.max() <= 1.0
    status, ctype, body = _post(server, {"n": 4, "format": "png", "priority": "batch"})
    assert status == 200 and ctype == "image/png" and body[:8] == b"\x89PNG\r\n\x1a\n"
    with urllib.request.urlopen(server + "/metrics") as r:
        text = r.read().decode()
    assert "vitgan_requests_served" in text and "vitgan_device_calls" in text


def test_http_bad_requests(server):
    for payload in ({"n": 0}, {"n": 5, "format": "bmp"}, {"n": 4, "seed": -1},
                    {"n": 4, "seed": 2 ** 31}, {"n": 2, "priority": "nope"},
                    {"n": 2, "model": "zzz"}, {"n": "many"}):
        status, _, body = _post(server, payload)
        assert status == 400 and b"error" in body, payload
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(server + "/nope")
    assert exc.value.code == 404


def test_run_dir_roundtrip_and_cli(jax_generator, tmp_path):
    from vitgan_tpu_torch.cli import main
    from vitgan_tpu_torch.serve import serve

    _, _, _, g = jax_generator
    run = tmp_path / "run_a"
    save_run(str(run), _cfg(), g, meta={"step": 3})
    cfg, _, g2, meta = restore_run(str(run), device="cpu")
    assert meta == {"step": 3} and cfg.v2 == _cfg().v2
    for k, v in g.state_dict().items():
        torch.testing.assert_close(g2.state_dict()[k], v)
    with pytest.raises(FileNotFoundError):
        restore_run(str(run), best=True, device="cpu")
    assert main(["generate", "--run-dir", str(run), "--num-images", "4", "--device", "cpu"]) == 0
    assert (run / "test" / "generated_images.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert np.load(run / "test" / "noise.npy").shape == (4, 16)
    with pytest.raises(ValueError, match="duplicate"):
        serve([str(run), str(run)], device="cpu")


def test_restore_run_draws_no_initial_weights(jax_generator, tmp_path, monkeypatch):
    """restore_run builds the generator on the meta device and takes the
    loaded tensors as its parameters: no random draw, and a module that runs
    on the asked device as the saved one does."""
    from vitgan_tpu_torch.models import layers as L

    _, _, _, g = jax_generator
    save_run(str(tmp_path / "run"), _cfg(), g)
    draw = L.trunc_normal

    def no_draw(shape, std, bound, generator):
        if generator is not None:
            raise AssertionError("restore_run drew initial weights")
        return draw(shape, std, bound, generator)

    monkeypatch.setattr(L, "trunc_normal", no_draw)
    _, _, g2, _ = restore_run(str(tmp_path / "run"), device="cpu")
    params = dict(g2.named_parameters())
    assert set(params) == set(g.state_dict())
    assert all(isinstance(p, torch.nn.Parameter) and p.device.type == "cpu"
               for p in params.values())
    z = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 16)).astype(np.float32))
    with torch.inference_mode():
        torch.testing.assert_close(g2(z), g(z), rtol=0, atol=0)


def test_other_families_name_the_roadmap():
    """The baselines, ROADMAP.md queue 1 item 11 until they were ported, now
    build (BatchNorm discriminators for dcgan and cnn); a family the JAX
    package does not have raises naming the ones there are."""
    for family, batch_stats in (("dcgan", True), ("cnn", True), ("mlp", False)):
        assert build_gan(C.ExperimentConfig(family=family)).d_has_batch_stats is batch_stats
    with pytest.raises(ValueError, match="dcgan"):
        build_gan(C.ExperimentConfig(family="v3"))
