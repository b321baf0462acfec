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

``paddle.device``'s surface (``paddle_tpu/device/__init__.py``) is here
too: device counts, ``synchronize``, the memory statistics (torch's CUDA
allocator counters; 0 on the CPU, as the JAX package's PJRT statistics
there), ``empty_cache``, the ``cuda`` namespace, and ``Stream``,
``Event``, ``current_stream`` and ``stream_guard`` over
``torch.cuda.Stream`` and ``torch.cuda.Event``: on the card ``wait_event``
and ``wait_stream`` order real streams and ``query`` polls without
blocking, which is what the JAX package's docstrings name as the API's
meaning and XLA could not give. On the CPU they keep the JAX package's
in-order model: work is done when the call returns, so ``query`` is True
and ``synchronize`` returns. Divergences: ``max_memory_reserved`` reads
torch's peak of reserved memory (PJRT has none, so the JAX package returns
the peak allocated); the ``tpu`` namespace raises, as ``TPUPlace`` does;
``register_pjrt_plugin`` raises (PyTorch loads no PJRT plugin) and
``get_all_custom_device_type`` is empty.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from .enforce import InvalidArgumentError

__all__ = ["resolve_device", "set_device", "get_device", "Place", "CPUPlace",
           "CUDAPlace", "CustomPlace", "TPUPlace", "expected_place",
           "place_of", "is_compiled_with_cuda", "is_compiled_with_tpu",
           "get_all_devices", "device_count", "synchronize",
           "max_memory_allocated", "max_memory_reserved", "memory_allocated",
           "memory_reserved", "empty_cache", "tpu", "cuda", "Stream",
           "Event", "current_stream", "stream_guard",
           "get_all_custom_device_type", "is_compiled_with_custom_device",
           "register_pjrt_plugin"]

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


# ---------------------------------------------------------------------------
# paddle.device: counts, synchronisation, memory statistics, streams, events
# ---------------------------------------------------------------------------

def get_all_devices() -> List[str]:
    """Every device in Paddle's spelling: ``gpu:i`` for each CUDA device,
    ``cpu:0`` where there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return [f"gpu:{i}" for i in range(n)] or ["cpu:0"]


def device_count(device_type: Optional[str] = None) -> int:
    """Devices of ``device_type`` (default: the current device's type)."""
    kind = device_type or expected_place().device_type
    if kind in ("gpu", "cuda"):
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    return 1 if kind == "cpu" else 0


def _cuda_or_none(device) -> Optional[torch.device]:
    """``device`` (default: the current one) as a CUDA ``torch.device``,
    or None for the CPU."""
    dev = resolve_device(_current[0] if device is None else device)
    return dev if dev.type == "cuda" else None


def synchronize(device: Union[str, Place, None] = None) -> None:
    """Wait for all queued work on the device (the CPU's is done)."""
    dev = _cuda_or_none(device)
    if dev is not None:
        torch.cuda.synchronize(dev)


def _mem(counter: str, device) -> int:
    dev = _cuda_or_none(device)
    return 0 if dev is None else int(getattr(torch.cuda, counter)(dev))


def memory_allocated(device=None) -> int:
    return _mem("memory_allocated", device)


def max_memory_allocated(device=None) -> int:
    return _mem("max_memory_allocated", device)


def memory_reserved(device=None) -> int:
    return _mem("memory_reserved", device)


def max_memory_reserved(device=None) -> int:
    return _mem("max_memory_reserved", device)


def empty_cache() -> None:
    """Release the CUDA allocator's unused cached blocks."""
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


class _DeviceNamespace:
    """``paddle.device.cuda``."""

    def device_count(self) -> int:
        return device_count("gpu")

    def synchronize(self, device=None) -> None:
        synchronize(device)

    def max_memory_allocated(self, device=None) -> int:
        return max_memory_allocated(device)

    def max_memory_reserved(self, device=None) -> int:
        return max_memory_reserved(device)

    def memory_allocated(self, device=None) -> int:
        return memory_allocated(device)

    def memory_reserved(self, device=None) -> int:
        return memory_reserved(device)

    def empty_cache(self) -> None:
        empty_cache()


class _TPUNamespace:
    """``paddle.device.tpu``: every use raises, as ``TPUPlace`` does."""

    def __getattr__(self, name):
        raise InvalidArgumentError(
            f"paddle.device.tpu.{name}: this port runs on CUDA GPUs and the "
            "CPU, not on TPUs (use paddle.device.cuda)")


class Stream:
    """``paddle.device.Stream``: a ``torch.cuda.Stream`` on the card; on
    the CPU the in-order stream, whose work is done when a call returns.
    ``priority`` 1 is high and 2 normal, as in Paddle."""

    def __init__(self, device=None, priority=2, _stream=None):
        self.device = device
        dev = _cuda_or_none(device)
        if _stream is not None or dev is None:
            self._s = _stream
        else:
            self._s = torch.cuda.Stream(dev, priority=-1 if priority == 1
                                        else 0)

    def record_event(self, event=None) -> "Event":
        event = event or Event(self.device)
        event.record(self)
        return event

    def wait_event(self, event) -> None:
        """Work queued on this stream after the call waits for ``event``."""
        if self._s is not None and event._e is not None:
            self._s.wait_event(event._e)

    def wait_stream(self, stream) -> None:
        """Work queued on this stream after the call waits for the work
        queued on ``stream`` before it."""
        if self._s is not None and stream._s is not None:
            self._s.wait_stream(stream._s)

    def synchronize(self) -> None:
        if self._s is not None:
            self._s.synchronize()

    def query(self) -> bool:
        """Whether the stream's work is done, without blocking."""
        return True if self._s is None else self._s.query()


class Event:
    """``paddle.device.Event``: a ``torch.cuda.Event`` on the card; on the
    CPU done once recorded."""

    def __init__(self, device=None, enable_timing=False, blocking=False,
                 interprocess=False):
        self.device = device
        self._e = None if _cuda_or_none(device) is None else torch.cuda.Event(
            enable_timing=enable_timing, blocking=blocking,
            interprocess=interprocess)

    def record(self, stream=None) -> None:
        if self._e is not None:
            stream = stream or current_stream(self.device)
            self._e.record(stream._s)

    def query(self) -> bool:
        """Whether the recorded work is done, without blocking (True
        before a record, as ``cudaEventQuery``)."""
        return True if self._e is None else self._e.query()

    def synchronize(self) -> None:
        if self._e is not None:
            self._e.synchronize()


_CPU_STREAM = Stream(_stream=None, device="cpu")


def current_stream(device=None) -> Stream:
    """The stream new work on ``device`` is queued on."""
    dev = _cuda_or_none(device)
    if dev is None:
        return _CPU_STREAM
    return Stream(device, _stream=torch.cuda.current_stream(dev))


class stream_guard:
    """Queue the work of the ``with`` body on ``stream``
    (``torch.cuda.stream`` on the card)."""

    def __init__(self, stream: Stream):
        self._stream = stream
        self._ctx = None

    def __enter__(self):
        if self._stream._s is not None:
            self._ctx = torch.cuda.stream(self._stream._s)
            self._ctx.__enter__()
        return self._stream

    def __exit__(self, *exc):
        if self._ctx is not None:
            self._ctx.__exit__(*exc)
            self._ctx = None
        return False


cuda = _DeviceNamespace()
tpu = _TPUNamespace()


def get_all_custom_device_type() -> List[str]:
    """Out-of-tree device types: none (the JAX package lists its PJRT
    plugins; PyTorch loads none)."""
    return []


def is_compiled_with_custom_device(device_type: str) -> bool:
    return device_type in get_all_custom_device_type()


def register_pjrt_plugin(name: str, library_path: str, options=None):
    raise NotImplementedError(
        "register_pjrt_plugin: PyTorch loads no PJRT plugin; this port's "
        "devices are CUDA GPUs and the CPU")
