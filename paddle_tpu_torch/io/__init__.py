"""Datasets, samplers and ``DataLoader`` (counterpart of
``paddle_tpu/io``).

Samples and batches are built on the host: ``default_collate_fn`` stacks
numpy samples into CPU tensors, in the consuming thread (serial mode), in
worker threads (``num_workers > 0``) or, with ``use_multiprocess=True``,
from the raw samples spawned worker processes send back. No worker makes a
CUDA call: threads only collate on the CPU, and spawned children start
with ``CUDA_VISIBLE_DEVICES`` empty, so they cannot claim the card. The
consuming thread then moves each batch to the current device
(``device.get_device()``, CUDA unless ``set_device`` named another; the
counterpart of the reference's ``expected_place()``) through pinned memory
with ``non_blocking=True``: a ``DataLoader`` yields tensors on the current
device, as the reference's does.

Shuffling draws ``np.random.permutation`` from numpy's global state, as
the reference does, unless ``RandomSampler`` (or ``random_split``) is
given a ``generator`` (a ``numpy.random.RandomState``): with the same
``np.random.seed`` a shuffled loader visits the reference's order.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
import time
from typing import Any, List, Sequence

import numpy as np
import torch

from ..device import get_device, resolve_device
from ..observability import metrics as _obs_metrics

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split", "Sampler", "SequenceSampler",
    "RandomSampler", "WeightedRandomSampler", "SubsetRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader",
    "get_worker_info", "default_collate_fn", "to_device",
]


def _rng(generator):
    """The numpy random state a sampler draws from: its ``generator`` or
    the module-level one (``np.random``)."""
    return np.random if generator is None else generator


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors: Sequence):
        if len({len(t) for t in tensors}) != 1:
            raise ValueError("TensorDataset tensors must share dim 0")
        self.tensors = list(tensors)

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        return itertools.chain(*self.datasets)


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("random_split lengths must sum to dataset size")
    perm = _rng(generator).permutation(len(dataset))
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n].tolist()))
        offset += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = _rng(self.generator)
        if self.replacement:
            return iter(rng.randint(0, n, self.num_samples).tolist())
        return iter(rng.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.choice(len(self.weights), self.num_samples,
                               replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A random permutation over a fixed index subset."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        perm = np.random.permutation(len(self.indices))
        return iter(self.indices[i] for i in perm)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        if sampler is None:
            sampler = (RandomSampler(dataset) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of the default ``torch.distributed`` group, or
    (1, 0) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Rank-sharded batch sampler: the index list is padded (cycled) to a
    multiple of the world size, so every rank sees the same number of
    batches; a shuffled epoch draws from ``RandomState(epoch)``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = int(np.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        while len(indices) < self.total_size:  # cycle for tiny datasets
            indices += indices[:self.total_size - len(indices)]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in local:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id, num_workers, dataset):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset


_worker_info = threading.local()


def get_worker_info():
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch: List[Any]):
    """Stack a list of samples into batched CPU tensors: arrays and
    tensors stacked, ints as int64, floats as float32; tuples, lists and
    dicts collated field by field."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype="int64"))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype="float32"))
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(items))
                     for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    return torch.as_tensor(np.asarray(batch))


def to_device(batch, device):
    """``batch`` (tensors, numpy arrays, and tuples, lists and dicts of
    them) on ``device``: a CPU tensor bound for the card is pinned and
    copied with ``non_blocking=True``, so the copy waits on nothing the
    host holds."""
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        if batch.device == device:
            return batch
        if device.type == "cuda" and batch.device.type == "cpu":
            return batch.pin_memory().to(device, non_blocking=True)
        return batch.to(device)
    if isinstance(batch, (tuple, list)):
        return type(batch)(to_device(b, device) for b in batch)
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    return batch


def _drain(q) -> None:
    try:
        while True:
            q.get_nowait()
    except queue.Empty:
        pass


def _mp_worker_loop(dataset, index_q, result_q, worker_id, num_workers,
                    worker_init_fn):
    """A spawned worker's body (module-level, so spawn can pickle it): pull
    index batches, build the samples, send the raw samples back; the parent
    collates them."""
    _worker_info.info = _WorkerInfo(worker_id, num_workers, dataset)
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        job = index_q.get()
        if job is None:
            return
        seq, indices = job
        try:
            result_q.put((seq, [dataset[i] for i in indices], None))
        except Exception as e:  # the parent raises it; an interrupt or an
            # exit still ends the worker
            result_q.put((seq, None, repr(e)))


class DataLoader:
    """Batches of ``dataset`` on the current device.

    ``num_workers > 0`` collates in a thread pool with a bounded queue;
    ``use_multiprocess=True`` builds the samples in spawned processes
    instead (for a GIL-bound ``__getitem__``). ``prefetch_factor`` bounds
    the batches in flight either way. Batches arrive in sampler order."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False, use_multiprocess=False):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.use_multiprocess = use_multiprocess
        self.timeout = timeout
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = max(2, prefetch_factor)
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset=dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _iter_iterable(self):
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def _fetch(self, indices):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_threads(self):
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(self.num_workers) as pool:
            futures = queue.Queue()
            batches = iter(self.batch_sampler)

            def submit_next():
                idx = next(batches, None)
                if idx is not None:
                    futures.put(pool.submit(self._fetch, idx))

            for _ in range(self.num_workers * self.prefetch_factor):
                submit_next()
            g_depth = _obs_metrics.gauge("io.prefetch_queue_depth")
            c_batches = _obs_metrics.counter("io.batches")
            while not futures.empty():
                fut = futures.get()
                submit_next()
                # batches still prefetched ahead of the consumer (an empty
                # queue means the input pipeline is the bottleneck)
                g_depth.set(futures.qsize())
                c_batches.inc()
                yield fut.result()

    def _spawn_workers(self, ctx, index_q, result_q):
        workers = [ctx.Process(target=_mp_worker_loop,
                               args=(self.dataset, index_q, result_q, wid,
                                     self.num_workers, self.worker_init_fn),
                               daemon=True)
                   for wid in range(self.num_workers)]
        # a worker must never claim the card (the parent owns it): each
        # child starts with no CUDA device visible
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        try:
            for w in workers:
                w.start()
        finally:
            if saved is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES", None)
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved
        return workers

    def _next_result(self, result_q, workers):
        """The next (seq, samples) from any worker; raises if a worker died
        or failed, or on ``timeout``."""
        deadline = (time.monotonic() + self.timeout if self.timeout
                    else None)
        while True:
            try:
                seq, samples, err = result_q.get(timeout=1.0)
                break
            except queue.Empty:
                dead = [w for w in workers if not w.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"DataLoader worker(s) died unexpectedly (exit codes "
                        f"{[w.exitcode for w in dead]})") from None
                if deadline and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"DataLoader timed out after {self.timeout}s waiting "
                        f"for a worker batch") from None
        if err is not None:
            raise RuntimeError(f"DataLoader worker failed: {err}")
        return seq, samples

    def _iter_multiprocess(self):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        index_q, result_q = ctx.Queue(), ctx.Queue()
        workers = self._spawn_workers(ctx, index_q, result_q)
        try:
            pending, next_out, submitted = {}, 0, 0
            batches = iter(self.batch_sampler)

            def submit():
                nonlocal submitted
                idx = next(batches, None)
                if idx is not None:
                    index_q.put((submitted, list(idx)))
                    submitted += 1

            for _ in range(self.num_workers * self.prefetch_factor):
                submit()
            g_depth = _obs_metrics.gauge("io.prefetch_queue_depth")
            c_batches = _obs_metrics.counter("io.batches")
            while next_out < submitted:
                seq, samples = self._next_result(result_q, workers)
                pending[seq] = samples
                while next_out in pending:  # sampler order
                    g_depth.set(submitted - next_out - 1)
                    c_batches.inc()
                    yield self.collate_fn(pending.pop(next_out))
                    next_out += 1
                    submit()
        finally:
            # drop unserved jobs so the workers reach their sentinel, and
            # drain the results: a worker blocked on a full pipe cannot exit
            _drain(index_q)
            for _ in workers:
                index_q.put(None)
            _drain(result_q)
            for w in workers:
                w.join(timeout=5)
                if w.is_alive():
                    w.terminate()
                    w.join(timeout=5)

    def _host_batches(self):
        if self._iterable:
            if self.use_multiprocess:
                raise ValueError(
                    "use_multiprocess=True is not supported with "
                    "IterableDataset (no index-based sharding); use the "
                    "threaded workers or a map-style Dataset")
            return self._iter_iterable()
        if self.num_workers == 0:
            return (self._fetch(indices) for indices in self.batch_sampler)
        if self.use_multiprocess:
            return self._iter_multiprocess()
        return self._iter_threads()

    def __iter__(self):
        device = resolve_device(get_device())
        for batch in self._host_batches():
            yield to_device(batch, device)
