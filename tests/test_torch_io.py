"""The port's ``io`` and ``vision.datasets`` against the JAX package's, on
the CPU.

- The synthetic datasets (MNIST train and test, FashionMNIST, Cifar10/100,
  Flowers) equal the reference's arrays byte for byte; MNIST's idx files
  and the cifar-python archive written to ``tmp_path`` parse to the same
  arrays; ``DatasetFolder`` / ``ImageFolder`` over ``.npy`` files; the
  same refusals of half-given or missing paths.
- Samplers: ``SequenceSampler``, ``RandomSampler`` (with and without
  replacement), ``WeightedRandomSampler``, ``SubsetRandomSampler`` and
  ``random_split`` draw the reference's indices under one
  ``np.random.seed`` (``RandomSampler`` also from a ``RandomState``
  ``generator``);
  ``BatchSampler`` and ``DistributedBatchSampler`` partitions (every rank,
  shuffled epochs, ``drop_last``) equal.
- ``DataLoader``: serial, thread-worker and spawned-process loaders give
  the serial loader's batches (values exact), and a shuffled loader the
  reference's order; ``default_collate_fn`` on tuples, dicts, ints and
  floats; spawned workers see no CUDA device; a worker's error is raised;
  a loader on the default device raises where there is no CUDA.
"""

import gzip
import pickle
import struct
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle  # noqa: F401 (the reference's package init)
from paddle_tpu import io as jio
from paddle_tpu.vision import datasets as jds
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.vision import datasets as tds
from test_torch_io_workers import Boom, EnvDataset, init_worker


@pytest.fixture
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.numpy())


def _batches(loader):
    """Each batch as a tuple of numpy arrays (either package)."""
    out = []
    for b in loader:
        items = b if isinstance(b, (tuple, list)) else (b,)
        out.append(tuple(_np(t) for t in items))
    return out


# -- datasets ----------------------------------------------------------------

@pytest.mark.parametrize("cls,kw", [
    ("MNIST", dict(mode="train")), ("MNIST", dict(mode="test")),
    ("MNIST", dict(mode="train", synthetic_size=300)),
    ("FashionMNIST", dict(mode="test", synthetic_size=50)),
    ("Cifar10", dict(mode="train", synthetic_size=64)),
    ("Cifar100", dict(mode="test", synthetic_size=64)),
    ("Flowers", dict(mode="test", synthetic_size=16)),
])
def test_synthetic_sets_equal_byte_for_byte(cls, kw):
    j, t = getattr(jds, cls)(**kw), getattr(tds, cls)(**kw)
    assert t.synthetic and j.synthetic and len(t) == len(j)
    assert t.images.dtype == j.images.dtype
    assert t.images.tobytes() == j.images.tobytes()
    assert t.labels.tobytes() == j.labels.tobytes()
    for i in (0, len(j) - 1):
        (ti, tl), (ji, jl) = t[i], j[i]
        assert ti.tobytes() == ji.tobytes()
        assert tl.dtype == jl.dtype == np.int64 and tl.shape == jl.shape


def _write_idx(tmp_path, n=7, gz=True):
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labs = rng.randint(0, 10, n).astype(np.uint8)
    op = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = tmp_path / f"images-idx3-ubyte{suffix}"
    lab_path = tmp_path / f"labels-idx1-ubyte{suffix}"
    with op(img_path, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(lab_path, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labs.tobytes())
    return str(img_path), str(lab_path)


@pytest.mark.parametrize("gz", [True, False])
def test_idx_files_parse_alike(tmp_path, gz):
    img, lab = _write_idx(tmp_path, gz=gz)
    j = jds.MNIST(image_path=img, label_path=lab)
    t = tds.MNIST(image_path=img, label_path=lab)
    assert not t.synthetic
    assert t.images.tobytes() == j.images.tobytes()
    assert t.labels.tobytes() == j.labels.tobytes()
    with pytest.raises(ValueError):
        tds.MNIST(image_path=img)
    with pytest.raises(FileNotFoundError):
        tds.MNIST(image_path=img, label_path=str(tmp_path / "missing"))


def test_cifar_archive_and_folders_parse_alike(tmp_path):
    rng = np.random.RandomState(1)
    tar_path = tmp_path / "cifar-10-python.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tf:
        for name, n in (("data_batch_1", 5), ("data_batch_2", 3),
                        ("test_batch", 4)):
            blob = pickle.dumps({
                b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                b"labels": rng.randint(0, 10, n).tolist()})
            p = tmp_path / name
            p.write_bytes(blob)
            tf.add(p, arcname=f"cifar-10-batches-py/{name}")
    for mode in ("train", "test"):
        j = jds.Cifar10(data_file=str(tar_path), mode=mode)
        t = tds.Cifar10(data_file=str(tar_path), mode=mode)
        assert t.images.tobytes() == j.images.tobytes()
        assert t.labels.tobytes() == j.labels.tobytes()
    with pytest.raises(FileNotFoundError):
        tds.Cifar10(data_file=str(tmp_path / "nope.tar.gz"))
    with pytest.raises(NotImplementedError):
        tds.Flowers(data_file=str(tar_path))
    root = tmp_path / "folder"
    for c in ("b", "a"):
        (root / c).mkdir(parents=True)
        for k in range(2):
            np.save(root / c / f"{k}.npy", rng.rand(2, 2).astype(np.float32))
    j, t = jds.DatasetFolder(str(root)), tds.DatasetFolder(str(root))
    assert t.class_to_idx == j.class_to_idx and t.samples == j.samples
    np.testing.assert_array_equal(t[3][0], j[3][0])
    j, t = jds.ImageFolder(str(root / "a")), tds.ImageFolder(str(root / "a"))
    assert t.samples == j.samples
    np.testing.assert_array_equal(t[1][0], j[1][0])


# -- samplers ----------------------------------------------------------------

class Squares(tio.Dataset):
    def __init__(self, n=20):
        self.n = n

    def __getitem__(self, i):
        return np.float32([i]), np.float32([i * i])

    def __len__(self):
        return self.n


def _draws(pkg, make, seed=11):
    np.random.seed(seed)
    return [list(make(pkg)) for _ in range(3)]


@pytest.mark.parametrize("name", ["sequence", "random", "replacement",
                                  "num_samples", "weighted", "subset"])
def test_samplers_draw_the_reference_indices(name):
    data = list(range(23))
    make = {
        "sequence": lambda p: p.SequenceSampler(data),
        "random": lambda p: p.RandomSampler(data),
        "replacement": lambda p: p.RandomSampler(data, replacement=True,
                                                 num_samples=40),
        "num_samples": lambda p: p.RandomSampler(data, num_samples=9),
        "weighted": lambda p: p.WeightedRandomSampler(
            np.linspace(0.1, 2.0, 23), 30),
        "subset": lambda p: p.SubsetRandomSampler([3, 5, 8, 13, 21]),
    }[name]
    assert _draws(tio, make) == _draws(jio, make)
    assert len(make(tio)) == len(make(jio))


def test_generator_draws_like_the_global_state():
    """A ``RandomState(s)`` generator gives what ``np.random.seed(s)``
    gives the reference, and leaves the global state alone."""
    data = list(range(17))
    np.random.seed(5)
    want = list(jio.RandomSampler(data))
    np.random.seed(99)
    before = np.random.get_state()[1].copy()
    got = list(tio.RandomSampler(data,
                                 generator=np.random.RandomState(5)))
    assert got == want
    np.testing.assert_array_equal(np.random.get_state()[1], before)


def test_random_split():
    ds = list(range(30))
    np.random.seed(2)
    j = [list(s.indices) for s in jio.random_split(ds, [10, 15, 5])]
    np.random.seed(2)
    t = [list(s.indices) for s in tio.random_split(ds, [10, 15, 5])]
    assert t == j
    with pytest.raises(ValueError):
        tio.random_split(ds, [10, 10])


@pytest.mark.parametrize("n,bs,drop_last", [(20, 4, False), (23, 5, False),
                                            (23, 5, True), (3, 4, False)])
def test_batch_sampler_partitions(n, bs, drop_last):
    j = jio.BatchSampler(Squares(n), batch_size=bs, drop_last=drop_last)
    t = tio.BatchSampler(Squares(n), batch_size=bs, drop_last=drop_last)
    assert list(t) == list(j) and len(t) == len(j)
    np.random.seed(4)
    js = list(jio.BatchSampler(Squares(n), shuffle=True, batch_size=bs,
                               drop_last=drop_last))
    np.random.seed(4)
    ts = list(tio.BatchSampler(Squares(n), shuffle=True, batch_size=bs,
                               drop_last=drop_last))
    assert ts == js


@pytest.mark.parametrize("n,bs,ranks,shuffle,drop_last", [
    (23, 4, 3, False, False), (23, 4, 3, True, False),
    (23, 4, 3, True, True), (5, 2, 4, False, False)])
def test_distributed_batch_sampler_partitions(n, bs, ranks, shuffle,
                                              drop_last):
    for rank in range(ranks):
        for epoch in (0, 3):
            j = jio.DistributedBatchSampler(Squares(n), bs,
                                            num_replicas=ranks, rank=rank,
                                            shuffle=shuffle,
                                            drop_last=drop_last)
            t = tio.DistributedBatchSampler(Squares(n), bs,
                                            num_replicas=ranks, rank=rank,
                                            shuffle=shuffle,
                                            drop_last=drop_last)
            j.set_epoch(epoch)
            t.set_epoch(epoch)
            assert list(t) == list(j) and len(t) == len(j)
    t = tio.DistributedBatchSampler(Squares(n), bs)  # no process group
    assert (t.nranks, t.local_rank) == (1, 0)


# -- the loader --------------------------------------------------------------

def test_collate_matches_reference(cpu):
    samples = [(np.float32([i, 2 * i]), i, 0.5 * i,
                {"a": np.int64([i]), "b": float(i)}) for i in range(5)]
    t = tio.default_collate_fn(samples)
    j = jio.default_collate_fn(samples)
    assert t[1].dtype == torch.int64 and t[2].dtype == torch.float32
    for a, b in zip(t[:3], j[:3]):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for k in ("a", "b"):
        np.testing.assert_array_equal(t[3][k].numpy(), _np(j[3][k]))
    stacked = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert stacked.shape == (2, 2) and stacked.device.type == "cpu"


def _mnist_pair(n=96):
    return (jds.MNIST(mode="test", synthetic_size=n),
            tds.MNIST(mode="test", synthetic_size=n))


@pytest.mark.parametrize("mode", ["threads", "processes"])
def test_workers_match_the_serial_loader(cpu, mode):
    j_ds, t_ds = _mnist_pair()
    serial = _batches(tio.DataLoader(t_ds, batch_size=20))
    ref = _batches(jio.DataLoader(j_ds, batch_size=20))
    kw = dict(num_workers=2, use_multiprocess=mode == "processes")
    workers = _batches(tio.DataLoader(t_ds, batch_size=20, **kw))
    assert len(serial) == len(ref) == len(workers) == 5
    for s, r, w in zip(serial, ref, workers):
        for a, b, c in zip(s, r, w):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(a, b)


def test_shuffled_loader_follows_the_reference_order(cpu):
    j_ds, t_ds = _mnist_pair(70)
    np.random.seed(21)
    ref = _batches(jio.DataLoader(j_ds, batch_size=16, shuffle=True))
    np.random.seed(21)
    got = _batches(tio.DataLoader(t_ds, batch_size=16, shuffle=True,
                                  num_workers=2))
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)


def test_spawned_workers_see_no_card(cpu):
    out = _batches(tio.DataLoader(EnvDataset(), batch_size=2, num_workers=1,
                                  use_multiprocess=True,
                                  worker_init_fn=init_worker))
    ids, visible, cuda, inits = (np.concatenate([b[k] for b in out]).ravel()
                                 for k in range(4))
    assert ids.tolist() == [0, 0, 0, 0] and inits.tolist() == [0, 0, 0, 0]
    assert visible.tolist() == [0, 0, 0, 0]  # CUDA_VISIBLE_DEVICES=""
    assert cuda.tolist() == [0, 0, 0, 0]
    with pytest.raises(RuntimeError, match="bad sample 2"):
        list(tio.DataLoader(Boom(), batch_size=2, num_workers=1,
                            use_multiprocess=True))
    with pytest.raises(ValueError, match="bad sample 2"):
        list(tio.DataLoader(Boom(), batch_size=2, num_workers=2))


def test_iterable_dataset_and_tensor_dataset(cpu):
    class Stream(tio.IterableDataset):
        def __iter__(self):
            return iter(np.float32([i]) for i in range(7))

    got = _batches(tio.DataLoader(Stream(), batch_size=3))
    assert [b[0].ravel().tolist() for b in got] == [[0, 1, 2], [3, 4, 5],
                                                    [6]]
    with pytest.raises(ValueError):
        list(tio.DataLoader(Stream(), batch_size=3, use_multiprocess=True,
                            num_workers=1))
    ds = tio.TensorDataset([np.arange(6).reshape(3, 2), np.arange(3)])
    assert len(ds) == 3 and ds[1][1] == 1
    chained = tio.ChainDataset([[1, 2], [3]])
    assert list(iter(chained)) == [1, 2, 3]
    composed = tio.ComposeDataset([Squares(4), Squares(3)])
    assert len(composed) == 3 and len(composed[2]) == 4


def test_loader_defaults_to_the_card(monkeypatch):
    """With no ``set_device``, batches are bound for CUDA: without it the
    loader raises instead of yielding CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(iter(tio.DataLoader(Squares(4), batch_size=2)))
