"""Device resolution and places for the port's entry points.

Entry points (``init_params``, ``generate``, ``ServingEngine``, layer and
model construction, ``to_tensor`` and the creation ops) run on the card
unless the caller names another device, with a ``device=`` / ``place=``
argument or with ``set_device`` (the counterpart of ``paddle.set_device``).
There is no silent CPU fallback: asking for CUDA where there is none
raises.

The places of ``paddle_tpu/core/place.py`` live here too, so the port has
one device state: ``Place``, ``CPUPlace``, ``CUDAPlace`` (Paddle's ``"gpu"``),
``CustomPlace`` and ``TPUPlace``. This port has no TPU: ``TPUPlace`` and the
name ``"tpu"`` raise. ``set_device`` takes Paddle's spellings (``"gpu"``,
``"gpu:0"``, ``"cpu"``, a ``Place``) and torch's (``"cuda"``, ``"cuda:1"``);
it keeps torch's spelling, which ``get_device`` returns (``"cuda"``, where
the JAX package returns ``"tpu:0"``), and returns the previous value so a
caller can restore it.
"""

from __future__ import annotations

from typing import Union

import torch

from .enforce import InvalidArgumentError

__all__ = ["resolve_device", "set_device", "get_device", "Place", "CPUPlace",
           "CUDAPlace", "CustomPlace", "TPUPlace", "expected_place",
           "place_of", "is_compiled_with_cuda", "is_compiled_with_tpu"]

_current = ["cuda"]  # the device layers and tensors are made on


class Place:
    """Base device identity: ``(device_type, device_id)``."""

    device_type: str = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (isinstance(other, Place)
                and other.device_type == self.device_type
                and other.device_id == self.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def get_device_id(self) -> int:
        return self.device_id

    def torch_device(self) -> str:
        """This place in torch's spelling."""
        raise InvalidArgumentError(
            f"No {self.device_type!r} device in this port "
            "(it runs on 'gpu' and 'cpu')")


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self) -> str:
        return "cpu"


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> str:
        return f"cuda:{self.device_id}"


class TPUPlace(Place):
    """Kept for its name: this port has no TPU, so making one raises."""

    device_type = "tpu"

    def __init__(self, device_id: int = 0):
        raise InvalidArgumentError(
            "TPUPlace: this port runs on CUDA GPUs and the CPU, not on TPUs "
            "(use CUDAPlace or 'gpu')")


class CustomPlace(Place):
    """An out-of-tree backend by name; only torch's own device types
    resolve."""

    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type

    def torch_device(self) -> str:
        try:
            torch.device(self.device_type, self.device_id)
        except RuntimeError:
            return super().torch_device()
        return f"{self.device_type}:{self.device_id}"


def _torch_spelling(device) -> str:
    """``device`` (a Place, a ``torch.device`` or a name in Paddle's or
    torch's spelling) as torch names it."""
    if isinstance(device, Place):
        return device.torch_device()
    if isinstance(device, torch.device):
        return str(device)
    if not isinstance(device, str):
        raise InvalidArgumentError(
            f"device must be a str or Place, got {type(device)}")
    kind, sep, idx = device.lower().partition(":")
    if kind == "tpu":
        raise InvalidArgumentError(
            f"set_device({device!r}): this port runs on CUDA GPUs and the "
            "CPU, not on TPUs (use 'gpu')")
    if kind == "gpu":
        kind = "cuda"
    name = kind + sep + idx
    torch.device(name)  # validates the name
    return name


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no
    CUDA device is present."""
    dev = torch.device(_torch_spelling(device))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the CPU")
        if dev.index is None:  # tensors report their device with an index
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def set_device(device: Union[str, Place]) -> str:
    """Set the device new layers, parameters and tensors are made on
    (default ``"cuda"``); returns the previous one, so a caller can
    restore it."""
    prev, _current[0] = _current[0], _torch_spelling(device)
    return prev


def get_device() -> str:
    """The device new layers and tensors are made on, as ``set_device``
    left it, in torch's spelling."""
    return _current[0]


def place_of(device) -> Place:
    """The Place of a ``torch.device`` (or of a name)."""
    dev = torch.device(_torch_spelling(device))
    if dev.type == "cpu":
        return CPUPlace(0)
    if dev.type == "cuda":
        return CUDAPlace(dev.index or 0)
    return CustomPlace(dev.type, dev.index or 0)


def expected_place() -> Place:
    """The Place new tensors are made on."""
    return place_of(_current[0])


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def is_compiled_with_tpu() -> bool:
    return False
