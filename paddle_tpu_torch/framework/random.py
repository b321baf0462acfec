"""Global RNG state: ``seed``, ``get_rng_state`` / ``set_rng_state`` and
their CUDA forms.

Port of ``paddle_tpu/framework/random.py``. The JAX package keeps one
functional key that every draw splits; the port keeps torch generators,
the ones its initializers already draw from
(``nn.initializer.default_generator`` on the CPU and one generator per
card, ``nn.initializer.generator(device)``). ``seed`` reseeds them all, so
the initializers' draws for a seed are what they were before this module
existed; the random ops (``rand``, ``randn``, ``dropout``, ...) draw from
the generator of the device they run on.
"""

from __future__ import annotations

from typing import Any, List

import torch

from ..nn import initializer as _init

__all__ = ["seed", "get_rng_state", "set_rng_state", "get_cuda_rng_state",
           "set_cuda_rng_state", "generator"]


def seed(s: int):
    """``paddle.seed``: reseed the CPU generator and every card's."""
    _init.seed(int(s))
    return s


def generator(device) -> torch.Generator:
    """The generator a random op on ``device`` draws from."""
    return _init.generator(device)


def get_rng_state() -> Any:
    """The CPU generator's state (a uint8 tensor)."""
    return _init.default_generator().get_state()


def set_rng_state(state: Any) -> None:
    _init.default_generator().set_state(state)


def get_cuda_rng_state() -> List[Any]:
    """One generator state per visible card, as the reference's list."""
    return [generator(torch.device("cuda", i)).get_state()
            for i in range(torch.cuda.device_count())]


def set_cuda_rng_state(states: List[Any]) -> None:
    """Inverse of ``get_cuda_rng_state`` (one state per card)."""
    if isinstance(states, (list, tuple)):
        if not states:
            raise ValueError("set_cuda_rng_state: empty state list")
    else:
        states = [states]
    for i, st in enumerate(states):
        generator(torch.device("cuda", i)).set_state(st)
