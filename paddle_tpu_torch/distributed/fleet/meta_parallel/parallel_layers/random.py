"""The RNG state tracker of tensor-parallel dropout.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/
random.py``. Dropout inside a tensor-parallel region draws from a stream
of its own per ``mp`` rank; outside, from one stream shared by the ranks.
The reference keeps each named stream as a JAX key; the port keeps a
``torch.Generator`` per stream and device (the CPU's, and the current
card's where there is one), seeded by the stream's seed. ``rng_state(name)``
swaps the stream's state into the generators the port's random ops draw
from (``framework.random.generator``), runs the body, keeps the advanced
state for the next use and puts the global state back.
"""

from __future__ import annotations

import contextlib
import zlib
from typing import Dict

import torch

from .....framework import random as frandom

__all__ = ["RNGStatesTracker", "get_rng_state_tracker",
           "model_parallel_random_seed", "LOCAL_SEED", "GLOBAL_SEED"]

MODEL_PARALLEL_RNG = "model_parallel_rng"
LOCAL_SEED = "local_seed"
GLOBAL_SEED = "global_seed"


def _devices():
    devs = [torch.device("cpu")]
    if torch.cuda.is_available():
        devs.append(torch.device("cuda", torch.cuda.current_device()))
    return devs


def _stream(seed: int) -> Dict[torch.device, torch.Generator]:
    return {d: torch.Generator(device=d).manual_seed(int(seed))
            for d in _devices()}


class RNGStatesTracker:
    """Named independent streams with a context-manager switch."""

    def __init__(self):
        self.states_: Dict[str, Dict[torch.device, torch.Generator]] = {}
        self.seeds_ = set()

    def reset(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name: str, seed: int):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        if name in self.states_:
            raise ValueError(f"state {name!r} already exists")
        self.seeds_.add(seed)
        self.states_[name] = _stream(seed)

    def get_states_tracker(self):
        """Each stream's generator states (a copy)."""
        return {n: {d: g.get_state() for d, g in s.items()}
                for n, s in self.states_.items()}

    def set_states_tracker(self, states):
        for name, by_dev in states.items():
            stream = self.states_.setdefault(name, _stream(0))
            for d, st in by_dev.items():
                stream.setdefault(d, torch.Generator(device=d)).set_state(st)

    @contextlib.contextmanager
    def rng_state(self, name: str = MODEL_PARALLEL_RNG):
        """Run the body drawing from the named stream instead of the
        global one (a stream not added yet is seeded from the crc32 of its
        name, so every process derives the same one)."""
        if name not in self.states_:
            self.states_[name] = _stream(zlib.crc32(name.encode()) % 2 ** 31)
        stream = self.states_[name]
        saved = {}
        for d, g in stream.items():
            glob = frandom.generator(d)
            saved[d] = glob.get_state()
            glob.set_state(g.get_state())
        try:
            yield
        finally:
            for d, g in stream.items():
                glob = frandom.generator(d)
                g.set_state(glob.get_state())
                glob.set_state(saved[d])


_RNG_STATE_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_STATE_TRACKER


def model_parallel_random_seed(seed: int = 1024):
    """Seed the tracker as the reference does: the global stream ``seed``,
    the local one ``seed + 1 + mp rank``, the model-parallel one ``seed +
    1024 + mp rank``; and the global generators with ``seed``."""
    from ...base.topology import get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    mp_rank = hcg.get_model_parallel_rank() if hcg is not None else 0
    tracker = get_rng_state_tracker()
    tracker.reset()
    frandom.seed(seed)
    tracker.add(GLOBAL_SEED, seed)
    tracker.add(LOCAL_SEED, seed + 1 + mp_rank)
    tracker.add(MODEL_PARALLEL_RNG, seed + 1024 + mp_rank)
