"""``paddle.distributed.communication.stream``: the collectives with
``sync_op`` and ``use_calc_stream``.

Port of ``paddle_tpu/distributed/communication/stream.py``. Each call
runs the collective of ``collective.py`` (its result where that one puts
it) and returns ``None`` with ``sync_op=True``, else a ``Task`` whose
``wait()`` joins the device's work on the result. A collective here
completes on the host before it returns (gloo on the host, and NCCL's
calls ordered on the current stream), so ``use_calc_stream`` changes
nothing: the result is ordered on the stream that computes with it.
Point to point with ``sync_op=False`` returns the operation's own
``Task``, which completes it at ``wait()``.
"""

from __future__ import annotations

from .. import collective as _c
from ..collective import Task

__all__ = ["all_reduce", "all_gather", "reduce_scatter", "broadcast",
           "alltoall", "reduce", "send", "recv", "Task"]


def _maybe_task(result, tensor, sync_op):
    if sync_op:
        return None
    return Task(tensors=[tensor if result is None else result])


def all_reduce(tensor, op=_c.ReduceOp.SUM, group=None, sync_op=True,
               use_calc_stream=False):
    return _maybe_task(_c.all_reduce(tensor, op=op, group=group), tensor,
                       sync_op)


def all_gather(tensor_or_tensor_list, tensor, group=None, sync_op=True,
               use_calc_stream=False):
    out = _c.all_gather(tensor_or_tensor_list, tensor, group=group)
    return _maybe_task(out, tensor, sync_op)


def reduce_scatter(tensor, tensor_or_tensor_list=None, op=_c.ReduceOp.SUM,
                   group=None, sync_op=True, use_calc_stream=False):
    out = _c.reduce_scatter(tensor, tensor_or_tensor_list, op=op, group=group)
    return _maybe_task(out, tensor, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True,
              use_calc_stream=False):
    return _maybe_task(_c.broadcast(tensor, src=src, group=group), tensor,
                       sync_op)


def alltoall(out_tensor_list, in_tensor_list, group=None, sync_op=True,
             use_calc_stream=False):
    # the reference's stream.alltoall takes (out, in)
    out = _c.alltoall(in_tensor_list, out_tensor_list, group=group)
    return _maybe_task(out, out, sync_op)


def reduce(tensor, dst=0, op=_c.ReduceOp.SUM, group=None, sync_op=True,
           use_calc_stream=False):
    return _maybe_task(_c.reduce(tensor, dst=dst, op=op, group=group),
                       tensor, sync_op)


def send(tensor, dst=0, group=None, sync_op=True, use_calc_stream=False):
    task = _c.isend(tensor, dst, group)
    if sync_op:
        task.wait()
        return None
    return task


def recv(tensor, src=0, group=None, sync_op=True, use_calc_stream=False):
    task = _c.irecv(tensor, src, group)
    if sync_op:
        task.wait()
        return None
    return task
