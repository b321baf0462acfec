"""``paddle.distributed.communication`` (port of
``paddle_tpu/distributed/communication/__init__.py``): the plain
collectives of ``collective.py`` and their ``stream`` forms."""

from ..collective import (  # noqa: F401
    ReduceOp,
    all_gather,
    all_reduce,
    alltoall,
    barrier,
    broadcast,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
)
from . import stream  # noqa: F401

__all__ = ["ReduceOp", "all_gather", "all_reduce", "alltoall", "barrier",
           "broadcast", "recv", "reduce", "reduce_scatter", "scatter",
           "send", "stream"]
