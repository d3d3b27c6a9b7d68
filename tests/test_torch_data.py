"""The port's data layer against the JAX package's, on the CPU, on the same
bytes written by each test from seeded numpy:

- the decoders: CIFAR-10 from its extracted directory and from the
  .tar.gz archive, MNIST from IDX and IDX.gz files, byte-equal (images and
  labels, train and test splits), and the errors that name missing files;
- reference_transforms, uint8 bit-equal: 32 -> 128, 128 -> 32, 7x11 -> 3,
  non-square inputs and a crop that pads; load_dataset's resize;
- the C++ loader against the numpy versions, bit-equal: the resize and
  gather_normalize with flips (skipped where there is no g++);
- HostDataPipeline against the JAX HostDataPipeline (mesh=None), same images
  and seed, over three epochs: orders, batches bit-equal in float32, flips,
  drop_last=False, each process's slice and len;
- a failed producer fails the epoch.
"""

import gzip
import os
import pickle
import shutil
import struct
import tarfile

import numpy as np
import pytest
import torch

from vitgan_tpu.data import datasets as JD
from vitgan_tpu.data import transforms as JT
from vitgan_tpu.data.pipeline import HostDataPipeline as JaxPipeline
from vitgan_tpu_torch.data import datasets as D
from vitgan_tpu_torch.data import native as N
from vitgan_tpu_torch.data import transforms as T
from vitgan_tpu_torch.data.pipeline import HostDataPipeline, make_pipeline, normalize_to_unit

HAS_GXX = shutil.which("g++") is not None


def write_cifar(root, n_per_batch: int, seed: int = 0, archive: bool = False) -> None:
    """The ``cifar-10-batches-py`` pickles (five train batches and the test
    batch, each a dict of b"data" (n, 3072) uint8 and b"labels" as a list of
    ints, as the real files hold), extracted under ``root`` or, with
    ``archive``, only as ``root/cifar-10-python.tar.gz``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"batch_label": name.encode(),
                         b"data": rng.integers(0, 256, (n_per_batch, 3072), dtype=np.uint8),
                         b"labels": [int(v) for v in rng.integers(0, 10, n_per_batch)]}, f)
    if archive:
        with tarfile.open(os.path.join(root, "cifar-10-python.tar.gz"), "w:gz") as tf:
            tf.add(d, arcname="cifar-10-batches-py")
        shutil.rmtree(d)


def write_mnist(root, n: int, seed: int = 0, gz: bool = False) -> None:
    """MNIST's IDX files (big-endian headers, uint8 payloads), train and t10k."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for prefix in ("train", "t10k"):
        x = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        y = rng.integers(0, 10, n).astype(np.uint8)
        for kind, head, body in (("images-idx3", struct.pack(">IIII", 2051, n, 28, 28), x),
                                 ("labels-idx1", struct.pack(">II", 2049, n), y)):
            path = os.path.join(root, f"{prefix}-{kind}-ubyte" + (".gz" if gz else ""))
            with (gzip.open if gz else open)(path, "wb") as f:
                f.write(head + body.tobytes())


def _same(got, want):
    assert got[0].dtype == want[0].dtype and got[1].dtype == want[1].dtype
    assert got[0].shape == want[0].shape and got[0].tobytes() == want[0].tobytes()
    assert got[1].tobytes() == want[1].tobytes()


# --- decoders ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["root", "batches_dir", "archive"])
def test_cifar10_decodes_byte_equal(tmp_path, form):
    root = str(tmp_path)
    write_cifar(root, 12, archive=form == "archive")
    where = os.path.join(root, "cifar-10-batches-py") if form == "batches_dir" else root
    for train in (True, False):
        got = D.load_cifar10(where, train)
        _same(got, JD.load_cifar10(where, train))
        assert got[0].shape == ((60 if train else 12), 32, 32, 3)
    if form == "archive":  # extracted once, then read from the directory
        assert os.path.isfile(os.path.join(root, "cifar-10-batches-py", "data_batch_5"))


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_decodes_byte_equal(tmp_path, gz):
    write_mnist(str(tmp_path), 7, gz=gz)
    for train in (True, False):
        got = D.load_mnist(str(tmp_path), train)
        _same(got, JD.load_mnist(str(tmp_path), train))
        assert got[0].shape == (7, 32, 32, 3) and (got[0][:, :2] == 0).all()


def test_missing_files_are_named(tmp_path):
    with pytest.raises(FileNotFoundError) as e:
        D.load_cifar10(str(tmp_path))
    for name in ("data_batch_1", "cifar-10-batches-py", "cifar-10-python.tar.gz"):
        assert name in str(e.value)
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte.gz"):
        D.load_mnist(str(tmp_path))
    with pytest.raises(ValueError, match="unknown dataset"):
        D.load_dataset("imagenet", root=str(tmp_path))


def test_data_dir_is_scratch_data_name(monkeypatch, tmp_path):
    from vitgan_tpu_torch.utils.run_dirs import data_dir

    monkeypatch.setenv("SCRATCH", str(tmp_path))
    assert data_dir("cifar10") == os.path.join(str(tmp_path), "data", "cifar10")
    write_cifar(data_dir("cifar10"), 4)
    x, _ = D.load_dataset("cifar10", image_size=32)  # root defaults to data_dir
    assert x.shape == (20, 32, 32, 3)


@pytest.mark.parametrize("name,size", [("cifar10", 64), ("cifar10", 32), ("mnist", 16)])
def test_load_dataset_equals_the_jax_one(tmp_path, name, size):
    (write_cifar if name == "cifar10" else write_mnist)(str(tmp_path), 6)
    got = D.load_dataset(name, root=str(tmp_path), image_size=size)
    _same(got, JD.load_dataset(name, root=str(tmp_path), image_size=size))
    assert got[0].shape[1:] == (size, size, 3)


# --- transforms -------------------------------------------------------------------------


@pytest.mark.parametrize("in_hw,size", [((32, 32), 128), ((128, 128), 32), ((7, 11), 3),
                                        ((11, 7), 3), ((48, 64), 32), ((37, 53), 29),
                                        ((20, 30), 24)])
def test_reference_transforms_bit_equal(in_hw, size):
    """Upscale, downscale, the truncated long side, non-square inputs; at
    (20, 30) -> 24 the resize gives 24x36 and the crop is inside it."""
    imgs = np.random.default_rng(sum(in_hw)).integers(0, 256, (3, *in_hw, 3), dtype=np.uint8)
    got = T.reference_transforms(imgs, size)
    want = JT.reference_transforms(imgs, size)
    assert got.shape == want.shape == (3, size, size, 3) and got.tobytes() == want.tobytes()


def test_center_crop_pads_and_noop_at_size():
    imgs = np.random.default_rng(4).integers(0, 256, (2, 9, 14, 3), dtype=np.uint8)
    for size in (16, 12, 5):  # pads both sides, pads rows only, crops
        got = T.center_crop(imgs, size)
        assert got.tobytes() == JT.center_crop(imgs, size).tobytes()
    assert (T.center_crop(imgs, 16)[:, :3] == 0).all()
    same = imgs[:, :9, :9].copy()
    assert T.reference_transforms(same, 9) is same


def test_triangle_taps_are_the_jax_weights():
    for n_in, n_out in ((32, 128), (128, 32), (11, 4), (300, 17)):
        lo, w = T._triangle_taps(n_in, n_out)
        dense = np.zeros((n_out, n_in))
        for i in range(n_out):
            for j in range(w.shape[1]):
                if w[i, j]:
                    dense[i, lo[i] + j] = w[i, j]
        np.testing.assert_allclose(dense, JT._triangle_matrix(n_in, n_out), rtol=0,
                                   atol=1e-15)


# --- the C++ loader against numpy -------------------------------------------------------


@pytest.fixture(scope="module")
def batcher():
    if not HAS_GXX:
        pytest.skip("no g++ on this host: the C++ loader cannot be built")
    return N.NativeBatcher(num_threads=3)


@pytest.mark.parametrize("in_hw,out_hw", [((32, 32), (128, 128)), ((128, 128), (32, 32)),
                                          ((7, 11), (3, 4)), ((37, 53), (17, 29)),
                                          ((64, 48), (32, 24))])
def test_resize_native_equals_numpy(batcher, in_hw, out_hw):
    imgs = np.random.default_rng(1).integers(0, 256, (5, *in_hw, 3), dtype=np.uint8)
    nat = N.native_resize_bilinear(imgs, *out_hw, num_threads=2)
    assert nat.tobytes() == T._resize_numpy(imgs, *out_hw).tobytes()
    before = dict(T.RESIZES)
    assert T.resize_bilinear(imgs, *out_hw).tobytes() == nat.tobytes()
    assert T.RESIZES["native"] == before["native"] + 1


def test_gather_normalize_native_equals_numpy(batcher):
    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (40, 6, 5, 3), dtype=np.uint8)
    images[0] = np.arange(6 * 5 * 3).reshape(6, 5, 3)  # small values
    images[1] = 255 - images[0]
    idx = rng.permutation(40)[:17]
    flip = rng.integers(0, 2, 17).astype(np.uint8)
    want = normalize_to_unit(images[idx])
    want[flip == 1] = want[flip == 1][:, :, ::-1, :]
    got = batcher.gather_normalize(images, idx, flip)
    assert got.view(np.int32).tobytes() == want.view(np.int32).tobytes()
    out = np.empty_like(want)
    assert batcher.gather_normalize(images, idx, flip, out=out) is out
    assert out.tobytes() == want.tobytes()
    every = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)  # every byte value
    assert (batcher.gather_normalize(every, np.array([0])).tobytes()
            == normalize_to_unit(every).tobytes())
    for bad in ([0, 40], [-1, 3]):
        with pytest.raises(IndexError):
            batcher.gather_normalize(images, np.array(bad))


def test_library_is_built_under_the_port():
    if not HAS_GXX:
        pytest.skip("no g++ on this host: the C++ loader cannot be built")
    N.load_library()
    path = N.library_path()
    assert os.path.isfile(path)
    port = os.path.dirname(os.path.dirname(os.path.abspath(N.__file__)))
    assert os.path.commonpath([path, port]) == port
    assert os.path.dirname(N.SOURCE) == os.path.join(port, "data", "csrc")


# --- the pipeline against the JAX one ---------------------------------------------------


def _epochs(pipe, n: int = 3):
    """[(batches, labels)] of n epochs, numpy."""
    return [[(np.asarray(x), np.asarray(y)) for x, y in pipe.epoch()] for _ in range(n)]


@pytest.mark.parametrize("n,batch,drop_last,flip,shuffle", [
    (50, 16, True, False, True), (50, 16, False, True, True), (48, 16, False, True, True),
    (20, 8, False, False, False), (37, 5, True, True, True)])
def test_pipeline_equals_the_jax_pipeline(n, batch, drop_last, flip, shuffle):
    rng = np.random.default_rng(n + batch)
    images = rng.integers(0, 256, (n, 6, 7, 3), dtype=np.uint8)
    labels = np.arange(n, dtype=np.int32)  # the labels give the order
    kw = dict(batch_size=batch, shuffle=shuffle, drop_last=drop_last, augment_flip=flip,
              seed=11, prefetch=2)
    port = HostDataPipeline(images, labels, device="cpu", **kw)
    jax_pipe = JaxPipeline(images, labels, mesh=None, **kw)
    assert len(port) == len(jax_pipe)
    got, want = _epochs(port), _epochs(jax_pipe)
    flipped = 0
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we) == len(port), e
        for (gx, gy), (wx, wy) in zip(ge, we):
            assert gx.dtype == np.float32 and gx.tobytes() == wx.tobytes()
            assert gy.tobytes() == wy.tobytes()
            base = normalize_to_unit(images[gy])
            is_flip = [not np.array_equal(gx[i], base[i]) for i in range(len(gy))]
            for i in np.flatnonzero(is_flip):
                assert np.array_equal(gx[i], base[i, :, ::-1, :])
            flipped += sum(is_flip)
        order = np.concatenate([y for _, y in ge])
        want_n = n if not drop_last else n - n % batch
        assert len(order) == want_n and len(set(order.tolist())) == want_n
    assert (flipped > 0) == flip
    if shuffle:
        assert not np.array_equal(got[0][0][1], got[1][0][1])


def test_pipeline_process_slices_equal_the_jax_ones():
    images = np.random.default_rng(3).integers(0, 256, (50, 4, 4, 3), dtype=np.uint8)
    labels = np.arange(50, dtype=np.int32)
    shares = []
    for rank in range(2):
        kw = dict(batch_size=16, drop_last=False, augment_flip=True, seed=5,
                  process_index=rank, process_count=2)
        port = HostDataPipeline(images, labels, device="cpu", **kw)
        jax_pipe = JaxPipeline(images, labels, **kw)
        assert len(port) == len(jax_pipe) == 3  # the partial batch dropped
        got, want = _epochs(port), _epochs(jax_pipe)
        for ge, we in zip(got, want):
            assert [x.shape[0] for x, _ in ge] == [8, 8, 8]
            for (gx, gy), (wx, wy) in zip(ge, we):
                assert gx.tobytes() == wx.tobytes() and gy.tobytes() == wy.tobytes()
        shares.append(np.concatenate([y for _, y in got[0]]))
    assert not set(shares[0]) & set(shares[1])  # disjoint halves of each batch
    with pytest.raises(ValueError, match="divisible"):
        HostDataPipeline(images, labels, 15, process_count=2, device="cpu")


def test_pipeline_max_batches_draws_only_its_flips():
    images = np.random.default_rng(6).integers(0, 256, (64, 4, 4, 3), dtype=np.uint8)
    a = HostDataPipeline(images, np.zeros(64), 8, augment_flip=True, seed=2, device="cpu")
    b = HostDataPipeline(images, np.zeros(64), 8, augment_flip=True, seed=2, device="cpu")
    short = [x.numpy() for x, _ in a.epoch(max_batches=3)]
    assert len(short) == 3 and a.stats.batches == 3
    # the cut epoch drew its order and 3 batches' flips, nothing more
    order = b._epoch_order()
    for i in range(3):
        assert short[i].tobytes() == b.assemble(order[i * 8:(i + 1) * 8]).tobytes()
    assert a._rng.bit_generator.state == b._rng.bit_generator.state


def test_pipeline_takes_numpy_when_the_loader_fails(monkeypatch):
    images = np.random.default_rng(7).integers(0, 256, (24, 5, 5, 3), dtype=np.uint8)

    def fail(*a, **k):
        raise OSError("no compiler")

    want = [x.numpy() for x, _ in HostDataPipeline(images, np.zeros(24), 8, augment_flip=True,
                                                   seed=1, device="cpu").epoch()]
    monkeypatch.setattr(N, "load_library", fail)
    pipe = HostDataPipeline(images, np.zeros(24), 8, augment_flip=True, seed=1, device="cpu")
    assert pipe.assembler == "numpy"
    got = [x.numpy() for x, _ in pipe.epoch()]
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]


def test_pipeline_producer_failure_fails_the_epoch():
    images = np.zeros((32, 4, 4, 3), np.uint8)
    pipe = HostDataPipeline(images, np.zeros(32), 8, device="cpu")
    boom = RuntimeError("decode failed")
    calls = []

    def assemble(idx, out=None):
        calls.append(len(idx))
        if len(calls) == 2:
            raise boom
        return np.zeros((len(idx), 4, 4, 3), np.float32)

    pipe.assemble = assemble
    got = []
    with pytest.raises(RuntimeError, match="producer failed") as e:
        for x, _ in pipe.epoch():
            got.append(x)
    assert e.value.__cause__ is boom and len(got) == 1


def test_make_pipeline_reads_the_data_config(tmp_path):
    from vitgan_tpu_torch.config import DataConfig

    write_cifar(str(tmp_path), 10)
    cfg = DataConfig(dataset="cifar10", data_dir=str(tmp_path), drop_last=False, prefetch=3)
    pipe = make_pipeline(cfg, 16, image_size=48, seed=3, device="cpu")
    assert pipe.num_samples == 50 and len(pipe) == 4 and pipe.prefetch == 3
    x, y = next(iter(pipe.epoch()))
    assert x.shape == (16, 48, 48, 3) and x.dtype == torch.float32 and y.dtype == torch.int32


def test_pipeline_under_fast_thread_switching_is_deterministic():
    """The producer thread and the consumer share the order's generator (in
    turn, never at once) and the epoch's stats: with the interpreter
    switching threads every microsecond, 12 epochs (flips, a partial batch,
    prefetch 1) equal the same epochs assembled in one thread, and every
    producer thread has ended when its epoch does."""
    import sys
    import threading

    images = np.random.default_rng(8).integers(0, 256, (45, 4, 5, 3), dtype=np.uint8)
    kw = dict(batch_size=4, drop_last=False, augment_flip=True, seed=9, prefetch=1,
              device="cpu")
    pipe = HostDataPipeline(images, np.arange(45), **kw)
    ref = HostDataPipeline(images, np.arange(45), **kw)
    before = threading.active_count()
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(12):
            got = [x.numpy() for x, _ in pipe.epoch()]
            assert threading.active_count() == before
            order = ref._epoch_order()
            want = [ref.assemble(sl) for sl in ref._slices(order)]
            assert len(got) == len(want) == 12 and pipe.stats.batches == 12
            assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))
    finally:
        sys.setswitchinterval(saved)
