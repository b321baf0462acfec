"""Datasets for ``test_torch_io.py``'s spawned-worker cases, in a module
that imports only numpy, torch and the port, so a spawned worker that
unpickles them does not import JAX. It holds no tests."""

import os

import numpy as np
import torch

from paddle_tpu_torch import io as tio


class EnvDataset(tio.Dataset):
    """Each sample is what its worker sees: its id, the length of
    ``CUDA_VISIBLE_DEVICES`` (1 when unset), whether CUDA is available and
    the id ``init_worker`` recorded (-1 without it)."""

    def __len__(self):
        return 4

    def __getitem__(self, i):
        info = tio.get_worker_info()
        return (np.int64([info.id if info else -1]),
                np.int64([len(os.environ.get("CUDA_VISIBLE_DEVICES", "x"))]),
                np.int64([torch.cuda.is_available()]),
                np.int64([int(os.environ.get("_PT_TORCH_WORKER", -1))]))


def init_worker(worker_id):
    os.environ["_PT_TORCH_WORKER"] = str(worker_id)


class Boom(tio.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise ValueError("bad sample 2")
        return np.float32([i])
