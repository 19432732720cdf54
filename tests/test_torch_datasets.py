"""The port's datasets against the JAX package's: ``split_indices`` over
a grid, the IDX and CIFAR files each package writes read back by the
other (byte-identical files, equal arrays), the synthetic sets, and
``scatter_dataset`` in a real 2-rank gloo world in both storage modes;
the CIFAR example's uint8 generator, the image-folder dataset and the
native prefetching loader against the JAX package's. Everything here is
integer indexing, exact file bytes or the same decode of the same files:
compared exactly."""

import tests.torch_threads  # noqa: F401  (one torch thread a worker)
import importlib.util
import pickle
from pathlib import Path

import numpy as np
import pytest

from chainermn_tpu.datasets import split_indices as jax_split_indices
from chainermn_tpu.datasets import standard_formats as jax_formats
from chainermn_tpu.datasets import toy as jax_toy
from chainermn_torch import datasets as port
from chainermn_torch.datasets import standard_formats as port_formats
from tests.test_torch_mp import assert_ranks_ok, run_world

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n", [1, 7, 64, 101])
@pytest.mark.parametrize("k", [1, 2, 3, 8])
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 0),
                                          (True, 1234)])
@pytest.mark.parametrize("force_equal_length", [True, False])
def test_split_indices_is_the_jax_packages(n, k, shuffle, seed,
                                           force_equal_length):
    got = port.split_indices(n, k, shuffle, seed, force_equal_length)
    want = jax_split_indices(n, k, shuffle, seed, force_equal_length)
    assert len(got) == len(want) == k
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", ["uint8", "int8", "int16", "int32",
                                   "float32", "float64"])
def test_idx_files_cross_read_byte_identical(tmp_path, dtype):
    """An IDX file of each dtype written by one package is the same bytes
    as the other's and reads back equal through the other's parser."""
    rs = np.random.RandomState(3)
    arr = (rs.randn(5, 4, 3) * 100).astype(dtype)
    jp, pp = tmp_path / "jax.idx", tmp_path / "port.idx"
    jax_formats.save_idx(str(jp), arr)
    port_formats.save_idx(str(pp), arr)
    assert jp.read_bytes() == pp.read_bytes()
    for load, path in ((port_formats.load_idx, jp),
                       (jax_formats.load_idx, pp)):
        got = load(str(path))
        assert got.dtype == arr.dtype and got.dtype.isnative
        np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_files_cross_read(tmp_path, gz):
    """``save_mnist`` of either package → ``load_mnist`` of the other:
    float32 in [0, 1] and int32 labels, equal arrays; the plain files are
    byte-identical."""
    xs, ys = port.synth_uint8(40, seed=5)
    for name, mod in (("jax", jax_formats), ("port", port_formats)):
        mod.save_mnist(str(tmp_path / name), xs, ys, train=True, gz=gz)
        mod.save_mnist(str(tmp_path / name), xs[:9], ys[:9], train=False,
                       gz=gz)
    if not gz:   # gzip headers carry a time stamp
        for f in sorted((tmp_path / "jax").iterdir()):
            assert f.read_bytes() == (tmp_path / "port" / f.name
                                      ).read_bytes()
    for reader, writer in ((port_formats, "jax"), (jax_formats, "port")):
        for train, n in ((True, 40), (False, 9)):
            got = reader.load_mnist(str(tmp_path / writer), train=train)
            want = jax_formats.load_mnist(str(tmp_path / "jax"),
                                          train=train)
            assert len(got) == n and got.xs.dtype == np.float32
            assert got.ys.dtype == np.int32
            assert 0.0 <= got.xs.min() and got.xs.max() <= 1.0
            np.testing.assert_array_equal(got.xs, want.xs)
            np.testing.assert_array_equal(got.ys, want.ys)


@pytest.mark.parametrize("n_classes", [10, 100])
def test_cifar_files_cross_read(tmp_path, n_classes):
    rs = np.random.RandomState(n_classes)
    xs = rs.randint(0, 256, (12, 32, 32, 3)).astype(np.uint8)
    ys = rs.randint(0, n_classes, 12).astype(np.uint8)
    for name, mod in (("jax", jax_formats), ("port", port_formats)):
        for train in (True, False):
            mod.save_cifar(str(tmp_path / name), xs, ys, n_classes, train)
    for f in sorted((tmp_path / "jax").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / f.name).read_bytes()
    for train in (True, False):
        got = port_formats.load_cifar(str(tmp_path / "jax"), n_classes,
                                      train)
        want = jax_formats.load_cifar(str(tmp_path / "port"), n_classes,
                                      train)
        np.testing.assert_array_equal(got.xs, want.xs)
        np.testing.assert_array_equal(got.ys, want.ys)
        assert got.xs.shape == (12, 32, 32, 3)


def test_synthetic_sets_are_the_jax_packages():
    """The synthetic sets and ``synth_uint8`` give the JAX package's arrays
    for a seed (``synth_uint8`` against ``examples/mnist``'s generator)."""
    spec = importlib.util.spec_from_file_location(
        "make_mnist_dataset", REPO / "examples/mnist/make_mnist_dataset.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    for a, b in zip(port.synth_uint8(300, seed=4), mk.synth_uint8(300, 4)):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    for fn in ("synthetic_mnist", "synthetic_cifar"):
        got = getattr(port, fn)(64, seed=2)
        want = getattr(jax_toy, fn)(64, seed=2)
        np.testing.assert_array_equal(got.xs, want.xs)
        np.testing.assert_array_equal(got.ys, want.ys)
        assert got.xs.dtype == want.xs.dtype
        assert [len(s) for s in got[3:5]] == [2, 2]
    got = port.synthetic_translation(30, seed=9)
    want = jax_toy.synthetic_translation(30, seed=9)
    assert len(got) == len(want) == 30
    for (gs, gt), (ws, wt) in zip((got[i] for i in range(30)),
                                  (want[i] for i in range(30))):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gt, wt)


def test_subdataset_listdataset_and_empty():
    ds = port.ArrayDataset(np.arange(10) * 10, np.arange(10))
    sub = port.SubDataset(ds, [7, 2, 5])
    assert len(sub) == 3 and sub[0] == (70, 7) and sub[1:] == [(20, 2),
                                                               (50, 5)]
    lst = port.ListDataset(iter([1, 2]))
    assert len(lst) == 2 and lst[1] == 2
    empty = port.create_empty_dataset(ds)
    assert len(empty) == 0
    with pytest.raises(IndexError):
        empty[0]
    with pytest.raises(ValueError, match="inputs but"):
        port.ArrayDataset(np.zeros(3), np.zeros(2))


_SCATTER = r'''
import os, pickle, sys
import numpy as np
from chainermn_torch.comm import create_communicator
from chainermn_torch.datasets import ArrayDataset, scatter_dataset

out, n = sys.argv[1], int(sys.argv[2])
comm = create_communicator("naive", device="cpu")
r = comm.rank
ds = ArrayDataset(np.arange(n * 3, dtype=np.float32).reshape(n, 3),
                  np.arange(n, dtype=np.int32))
sends = []
inner_send = comm.send_obj
def counting_send(obj, dest, tag=0):
    sends.append(dest)
    inner_send(obj, dest, tag)
comm.send_obj = counting_send

shards = {}
for mode, shared in (("shared", True), ("payload", False)):
    for equal in (True, False):
        sh = scatter_dataset(ds if (shared or r == 0) else None, comm,
                             shuffle=True, seed=3, max_buf_len=600,
                             force_equal_length=equal,
                             shared_storage=shared)
        shards[(mode, equal)] = [sh[i] for i in range(len(sh))]
# one rank: the whole dataset, shuffled
with open(os.path.join(out, f"rank{r}.pkl"), "wb") as f:
    pickle.dump({"shards": shards, "sends": sends}, f)
comm.finalize()
print(f"RANK{r} OK", flush=True)
'''


def test_scatter_dataset_two_ranks_both_storage_modes(tmp_path):
    """101 samples over 2 ranks, shuffled with seed 3: in both storage
    modes and with and without ``force_equal_length``, rank r's shard is
    the samples at JAX ``split_indices(101, 2, True, 3, ...)[r]``; the
    shards are disjoint apart from the equal-length wrap and their union
    is the dataset. The payload mode ships rank 1's 51 samples in
    several ``max_buf_len``-bounded messages plus the end marker."""
    n = 101
    assert_ranks_ok(run_world(_SCATTER, 2, timeout=90,
                              args=[str(tmp_path), str(n)]))
    got = [pickle.loads((tmp_path / f"rank{r}.pkl").read_bytes())
           for r in range(2)]
    for mode in ("shared", "payload"):
        for equal in (True, False):
            plans = jax_split_indices(n, 2, True, 3, equal)
            labels = []
            for r in range(2):
                shard = got[r]["shards"][(mode, equal)]
                ys = [int(y) for _, y in shard]
                assert ys == [int(i) for i in plans[r]], (mode, equal, r)
                for x, y in shard:
                    np.testing.assert_array_equal(
                        x, np.arange(3 * y, 3 * y + 3, dtype=np.float32))
                labels += ys
            assert sorted(set(labels)) == list(range(n))
            assert len(labels) == (2 * 51 if equal else n)
    # the root sent rank 1 several chunks and an end marker, per
    # payload scatter; rank 1 sent nothing
    assert got[1]["sends"] == []
    sends = got[0]["sends"]
    assert set(sends) == {1} and len(sends) >= 2 * 3


@pytest.mark.parametrize("n_classes,seed", [(100, 0), (10, 3)])
def test_synth_cifar_uint8_is_the_cifar_examples(n_classes, seed):
    """``synth_cifar_uint8`` gives ``examples/cifar/make_cifar_dataset.py``
    ``synth_uint8``'s images and labels for a seed, exactly."""
    spec = importlib.util.spec_from_file_location(
        "make_cifar_dataset", REPO / "examples/cifar/make_cifar_dataset.py")
    mk = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mk)
    got = port.synth_cifar_uint8(257, n_classes, seed)
    want = mk.synth_uint8(257, n_classes, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (257, 32, 32, 3)


@pytest.mark.parametrize("train", [True, False])
def test_image_folder_reads_what_write_image_folder_wrote(tmp_path, train):
    """``write_image_folder`` writes real JPEG files (3 classes x 4); the
    port's ``ImageFolderDataset`` reads every one with its class label,
    as the JAX package's reads the same folder (equal arrays: the same
    decode, crop and flip for each access)."""
    from chainermn_tpu.datasets import ImageFolderDataset as JaxFolder

    root = str(tmp_path / "imgs")
    assert port.write_image_folder(root, n_classes=3, per_class=4,
                                   image_size=40, seed=1) == 12
    ds = port.ImageFolderDataset(root, image_size=32, train=train, seed=3)
    want = JaxFolder(root, image_size=32, train=train, seed=3)
    assert len(ds) == 12 and ds.classes == want.classes
    assert [int(ds[i][1]) for i in range(12)] == [0] * 4 + [1] * 4 + [2] * 4
    for i in range(12):
        x, y = ds[i]
        assert x.shape == (32, 32, 3) and x.dtype == np.float32
        assert 0.0 <= x.min() and x.max() <= 1.0
        wx, wy = want[i]
        np.testing.assert_array_equal(x, wx)
        assert y == wy
    with pytest.raises(FileNotFoundError):
        port.ImageFolderDataset(str(tmp_path / "missing"))


@pytest.mark.parametrize("shuffle,epochs,depth", [(True, 2, 2),
                                                  (False, 1, 4)])
def test_prefetching_loader_draws_the_jax_loaders_batches(shuffle, epochs,
                                                          depth):
    """The port's ``PrefetchingLoader`` (its own native build, numpy
    batches for the CPU) gives the JAX loader's batches for a seed, in
    order, with the same epoch counters; rows stay paired with their
    labels (uint8 images, int32 labels, a ragged tail dropped)."""
    from chainermn_tpu.training.loader import PrefetchingLoader as JaxLoader
    from chainermn_torch.training.loader import PrefetchingLoader

    rs = np.random.RandomState(0)
    xs = rs.randint(0, 256, size=(70, 4, 4, 3)).astype(np.uint8)
    ys = np.arange(70, dtype=np.int32)
    got = PrefetchingLoader(xs, ys, 16, shuffle=shuffle, seed=7,
                            epochs=epochs, depth=depth, device="cpu")
    want = JaxLoader(xs, ys, 16, shuffle=shuffle, seed=7, epochs=epochs,
                     depth=depth)
    n = 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert isinstance(gx, np.ndarray) and gx.dtype == np.uint8
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, xs[gy])
        assert (got.epoch, got.is_new_epoch) == (want.epoch,
                                                 want.is_new_epoch)
        n += 1
    assert n == 4 * epochs and got.epoch == epochs
    with pytest.raises(StopIteration):
        next(got)
    got.close()
    want.close()
    with pytest.raises(ValueError, match="exceeds"):
        PrefetchingLoader(xs, ys, 71, device="cpu")


def test_the_native_library_builds_into_build_from_the_ports_source():
    """``ops/native.py`` compiles ``csrc/chainermn_native.cpp`` into
    ``build/chainermn_torch/`` under a name that hashes the source, never
    into ``native/``."""
    from chainermn_torch.ops import native

    lib = native.get_lib()
    path = Path(lib._name)
    assert path.parent == REPO / "build" / "chainermn_torch"
    assert path.name.startswith("libchainermn_native-") and path.is_file()
    assert native.get_lib() is lib
