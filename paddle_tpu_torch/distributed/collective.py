"""Eager collectives over ``torch.distributed``.

Port of ``paddle_tpu/distributed/collective.py``. The reference runs a
collective inside ``shard_map`` as an XLA op, or eagerly across the
launcher's processes as a one-op program; a world of one is the identity
(its ``single`` path). The port's ranks are processes that hold their own
tensors, so every collective is a ``torch.distributed`` call over the
group's process group, built on ``_comm`` (gloo takes CUDA tensors only
for the operations in ``_comm.GLOO_TAKES_CUDA``: the others, point to
point included, are staged through the host, chosen by the backend and
the tensor's device and counted in ``_comm.STAGED``).

- A ``Group`` holds its global ranks and the process group over them
  (``None`` for one rank: every collective on it is the identity, as the
  reference's ``single`` path, and touches no backend). ``new_group``
  makes one; as ``torch.distributed.new_group``, every rank of the world
  calls it with the same ranks, in the same order.
- Results land in the caller's tensor where the reference's ``_rewrap``
  puts them (``all_reduce``, ``broadcast``, ``scatter``, ``recv``,
  ``alltoall_single``'s ``out_tensor``), and nowhere else: a result of
  another shape is returned. A tensor inside an autograd graph is not
  written in place (``InvalidArgumentError``, as ``inplace_set``).
- ``ReduceOp.AVG`` is the sum over the group divided by its size (gloo
  has no average). Sums of bf16 and fp16 tensors are taken in fp32 and
  rounded once (``_comm``).
- ``send`` / ``recv`` / ``isend`` / ``irecv`` / ``batch_isend_irecv``
  address global ranks, as Paddle's do (the reference's SPMD forms read a
  peer as a uniform shift, and its eager forms raise).
  ``send_next`` / ``recv_prev`` keep the reference's meaning: each is a
  whole ring shift (every rank sends its ``tensor`` to the next and
  receives the previous rank's), so one call on every rank is matched.
- ``reduce`` and ``gather`` leave the result on every rank (the
  reference's ``all_reduce`` and ``all_gather``); ``gather`` fills
  ``gather_list`` on ``dst`` only.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.tensor import as_port_tensor
from ..enforce import InvalidArgumentError
from . import _comm
from .env import get_rank, get_world_size

__all__ = [
    "ReduceOp", "Group", "Task", "new_group", "get_group",
    "get_default_group", "all_reduce", "all_gather", "all_gather_object",
    "reduce", "reduce_scatter", "broadcast", "scatter", "alltoall",
    "all_to_all", "alltoall_single", "gather", "broadcast_object_list",
    "scatter_object_list", "send", "recv", "send_next", "recv_prev",
    "isend", "irecv", "P2POp", "batch_isend_irecv", "wait", "barrier",
    "destroy_process_group", "get_backend", "split",
]


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.AVG: dist.ReduceOp.SUM,
              ReduceOp.MAX: dist.ReduceOp.MAX, ReduceOp.MIN: dist.ReduceOp.MIN,
              ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """A communicator: global ``ranks`` (group rank i is ``ranks[i]``)
    and the ``process_group`` over them (``None`` for one rank)."""

    def __init__(self, ranks: Sequence[int], id: int = 0,
                 process_group=None, axis_name: Optional[str] = None):
        self.ranks = [int(r) for r in ranks]
        self.nranks = len(self.ranks)
        self.id = id
        self.process_group = process_group
        self.axis_name = axis_name

    @property
    def world_size(self) -> int:
        return self.nranks

    @property
    def rank(self) -> int:
        return self.get_group_rank(get_rank())

    def get_group_rank(self, global_rank: int) -> int:
        try:
            return self.ranks.index(int(global_rank))
        except ValueError:
            return -1

    def __repr__(self):
        return (f"Group(id={self.id}, ranks={self.ranks}, "
                f"axis={self.axis_name!r})")


_groups: dict = {}  # id -> Group
_next_gid = [1]


def _world_group() -> Group:
    world = get_world_size()
    pg = dist.group.WORLD if dist.is_initialized() and world > 1 else None
    return Group(range(world), 0, pg, "dp")


def get_default_group() -> Group:
    """The group of the whole world (made again when the world it was
    made for has changed size)."""
    g = _groups.get(0)
    if g is None or g.nranks != get_world_size():
        g = _groups[0] = _world_group()
    return g


def new_group(ranks: Optional[Sequence[int]] = None, backend=None,
              axis_name: Optional[str] = None) -> Group:
    """A group over ``ranks`` (default: the world). Every rank of the
    world calls it with the same arguments in the same order."""
    if ranks is None:
        ranks = list(range(get_world_size()))
    ranks = [int(r) for r in ranks]
    pg = None
    if len(ranks) > 1:
        if not dist.is_initialized():
            raise InvalidArgumentError(
                f"new_group({ranks}): a group of {len(ranks)} ranks needs "
                "the process group (call init_parallel_env first)")
        pg = dist.new_group(ranks, backend=backend)
    gid = _next_gid[0]
    _next_gid[0] += 1
    g = Group(ranks, gid, pg, axis_name or f"group{gid}")
    _groups[gid] = g
    return g


def from_process_group(pg, axis_name: Optional[str] = None) -> Group:
    """A ``Group`` over a ``torch.distributed`` process group (``None``:
    this rank alone)."""
    if pg is None:
        return Group([get_rank()], -1, None, axis_name)
    return Group(dist.get_process_group_ranks(pg), -1, pg, axis_name)


def get_group(gid: int = 0) -> Group:
    if gid == 0:
        return get_default_group()
    if gid not in _groups:
        raise InvalidArgumentError(f"no group with id {gid} "
                                   f"(destroyed or never created)")
    return _groups[gid]


def _resolve(group):
    """(Group, process group or None): None is the identity."""
    g = group if isinstance(group, Group) else (
        get_default_group() if group is None else from_process_group(group))
    if g.nranks == 1:
        return g, None
    if g.process_group is None:
        raise InvalidArgumentError(
            f"{g!r} spans {g.nranks} ranks but has no process group (call "
            "init_parallel_env first)")
    return g, g.process_group


def _write(tensor: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` into ``tensor``'s storage (the reference's ``_rewrap``)."""
    if tensor.grad_fn is not None:
        raise InvalidArgumentError(
            "In-place update on a non-leaf tensor would invalidate its "
            "autograd graph.")
    with torch.no_grad():
        tensor.copy_(value)
    return tensor


def _reduced(t: torch.Tensor, op, pg, n: int) -> torch.Tensor:
    if op not in _TORCH_OPS:
        raise InvalidArgumentError(f"Unknown reduce op {op}")
    if op == ReduceOp.AVG:
        s = _comm.all_reduce(t.detach().float(), pg)
        return (s / n).to(t.dtype)
    return _comm.all_reduce(t, pg, op=_TORCH_OPS[op])


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """``tensor`` reduced over the group, in place; returns ``tensor``."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _write(tensor, _reduced(tensor, op, pg, g.nranks))


def all_gather(tensor_list, tensor=None, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor`` in group-rank order: appended to
    ``tensor_list`` and returned concatenated along ``axis`` (``out =
    all_gather([], x)`` gives the concatenation)."""
    if tensor is None:
        tensor_list, tensor = [], tensor_list
    g, pg = _resolve(group)
    if pg is None:
        if isinstance(tensor_list, list):
            tensor_list.append(tensor)
        return tensor
    out = as_port_tensor(_comm.all_gather(tensor, pg, dim=axis))
    if isinstance(tensor_list, list):
        tensor_list.extend(as_port_tensor(c.clone())
                           for c in out.chunk(g.nranks, dim=axis))
    return out


def all_gather_object(object_list, obj, group=None):
    g, pg = _resolve(group)
    if pg is None:
        object_list.append(obj)
        return object_list
    got = [None] * g.nranks
    dist.all_gather_object(got, obj, group=pg)
    object_list.extend(got)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """The reference's ``reduce``: the reduction lands on every rank."""
    return all_reduce(tensor, op=op, group=group)


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """This rank's piece (dim 0, group-rank order) of the source reduced
    over the group: the source is ``tensor_list`` concatenated, or
    ``tensor``. Returned; with ``tensor_list`` it also lands in ``tensor``
    (Paddle's output buffer) when the shapes agree."""
    src = tensor_list if tensor_list is not None else tensor
    if isinstance(src, (list, tuple)):
        src = torch.cat(list(src), dim=0)
    g, pg = _resolve(group)
    if pg is None:
        out = src
    elif op == ReduceOp.SUM:
        out = _comm.reduce_scatter(src, pg)
    else:
        full = _reduced(src, op, pg, g.nranks)
        k = full.shape[0] // g.nranks
        out = full.narrow(0, g.rank * k, k).clone()
    out = as_port_tensor(out)
    if tensor_list is not None and tuple(tensor.shape) == tuple(out.shape):
        return _write(tensor, out)
    return out


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor`` on every rank, in place."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _write(tensor, _comm.broadcast(tensor, pg, int(src)))


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Piece i of ``src``'s ``tensor_list`` (a list, or one tensor split
    along dim 0) into group rank i's ``tensor``."""
    g, pg = _resolve(group)
    if pg is None:
        if tensor_list is not None:
            first = (tensor_list[0] if isinstance(tensor_list, (list, tuple))
                     else tensor_list)
            return _write(tensor, first)
        return tensor
    parts = None
    if g.rank == g.get_group_rank(src):
        full = tensor_list if tensor_list is not None else tensor
        parts = (list(full) if isinstance(full, (list, tuple))
                 else list(full.chunk(g.nranks, dim=0)))
    buf, back = _comm.stage(torch.empty_like(tensor), pg, "scatter")
    if parts is not None:
        parts = [(p.detach().cpu() if back is not None else p.detach())
                 .contiguous() for p in parts]
    dist.scatter(buf, parts, src=int(src), group=pg)
    return _write(tensor, buf if back is None else buf.to(back))


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Piece j of the input (a list of one tensor a rank, or a tensor
    split along dim 0) to group rank j; returns the received pieces
    stacked (piece j from group rank j) and appends each to
    ``out_tensor_list``."""
    src = in_tensor_list
    if isinstance(src, (list, tuple)):
        src = torch.stack(list(src), dim=0)
    g, pg = _resolve(group)
    out = src if pg is None else as_port_tensor(_comm.all_to_all(src, pg))
    if isinstance(out_tensor_list, list):
        out_tensor_list.extend(as_port_tensor(c.squeeze(0).clone()) if
                               isinstance(in_tensor_list, (list, tuple))
                               else as_port_tensor(c.clone())
                               for c in out.chunk(g.nranks, dim=0))
    return out


all_to_all = alltoall


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """One-tensor all-to-all with equal splits (unequal ones raise, as the
    reference's): row block j of ``in_tensor`` to group rank j; the blocks
    received, in group-rank order, into ``out_tensor`` (or returned)."""
    for s in (in_split_sizes, out_split_sizes):
        if s is not None and len(set(int(v) for v in s)) > 1:
            raise NotImplementedError(
                "alltoall_single: unequal split sizes are not supported "
                "(the reference's collective is uniform); pad to equal "
                "splits")
    out = alltoall(in_tensor, None, group=group, sync_op=sync_op)
    if isinstance(out_tensor, torch.Tensor):
        if tuple(out.shape) != tuple(out_tensor.shape):
            raise ValueError(
                f"alltoall_single: out_tensor shape {tuple(out_tensor.shape)}"
                f" does not match the result {tuple(out.shape)}")
        return _write(out_tensor, out)
    return out


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor``, in group-rank order, into ``dst``'s
    ``gather_list``; every rank gets the list back."""
    g, _ = _resolve(group)
    chunks: list = []
    all_gather(chunks, tensor, group=group)
    if gather_list is not None and (g.nranks == 1
                                    or g.rank == g.get_group_rank(dst)):
        gather_list.extend(chunks)
    return chunks


def broadcast_object_list(object_list, src=0, group=None):
    g, pg = _resolve(group)
    if pg is not None:
        dist.broadcast_object_list(object_list, src=int(src), group=pg)
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Object i of ``src``'s ``in_object_list`` to group rank i:
    ``out_object_list`` then holds it alone."""
    g, pg = _resolve(group)
    if pg is None:
        got = in_object_list[0] if in_object_list else None
    else:
        box = [None]
        mine = in_object_list if g.rank == g.get_group_rank(src) else None
        dist.scatter_object_list(box, mine, src=int(src), group=pg)
        got = box[0]
    out_object_list.clear()
    out_object_list.append(got)
    return out_object_list


class Task:
    """An issued point-to-point operation (the reference's
    ``ProcessGroup::Task``): ``wait()`` completes it; a receive staged
    through the host lands in its tensor there."""

    def __init__(self, works=(), finish=None, tensors=()):
        self._works = list(works)
        self._finish = finish
        self._tensors = list(tensors)
        self._done = False

    def wait(self) -> bool:
        if not self._done:
            for w in self._works:
                w.wait()
            if self._finish is not None:
                self._finish()
            self._done = True
        for t in self._tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.current_stream(t.device).synchronize()
        return True

    def is_completed(self) -> bool:
        return self._done or all(w.is_completed() for w in self._works)


def isend(tensor, dst=0, group=None) -> Task:
    g, pg = _resolve(group)
    if pg is None:
        return Task(tensors=[tensor])
    x, _ = _comm.stage(tensor.detach().contiguous(), pg, "send")
    return Task([dist.isend(x, int(dst), group=pg)], tensors=[tensor])


def irecv(tensor, src=0, group=None) -> Task:
    g, pg = _resolve(group)
    if pg is None:
        return Task(tensors=[tensor])
    buf, back = _comm.stage(torch.empty_like(tensor).contiguous(), pg,
                            "recv")
    work = dist.irecv(buf, int(src), group=pg)
    return Task([work], lambda: _write(tensor, buf if back is None
                                       else buf.to(back)), [tensor])


def send(tensor, dst=0, group=None, sync_op=True):
    task = isend(tensor, dst, group)
    if not sync_op:
        return task
    task.wait()
    return tensor


def recv(tensor, src=0, group=None, sync_op=True):
    task = irecv(tensor, src, group)
    if not sync_op:
        return task
    task.wait()
    return tensor


def send_next(tensor, group=None):
    """The ring shift to the next rank: returns the previous rank's
    ``tensor`` (the reference's ``send(dst=rank + 1)``)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return as_port_tensor(_comm.ring_shift(tensor, pg, 1))


def recv_prev(tensor, group=None):
    """The ring shift from the previous rank, into ``tensor`` (the
    reference's ``recv(src=rank - 1)``: ``tensor`` holds this rank's
    outgoing payload)."""
    g, pg = _resolve(group)
    if pg is None:
        return tensor
    return _write(tensor, _comm.ring_shift(tensor, pg, 1))


class P2POp:
    """One point-to-point operation for ``batch_isend_irecv``: ``op`` is
    ``isend`` or ``irecv``, ``peer`` a global rank."""

    def __init__(self, op, tensor, peer, group=None):
        if op not in (isend, irecv):
            raise ValueError("P2POp op must be paddle.distributed.isend "
                             "or paddle.distributed.irecv")
        self.op = op
        self.tensor = tensor
        self.peer = peer
        self.group = group


def batch_isend_irecv(p2p_op_list) -> List[Task]:
    """Issue the operations as one batch; one ``Task`` each (an
    ``irecv``'s fills its tensor at ``wait``)."""
    ops, tasks, issued = [], [], []
    for p in p2p_op_list:
        g, pg = _resolve(p.group)
        if pg is None:
            tasks.append(Task(tensors=[p.tensor]))
            continue
        if p.op is isend:
            x, _ = _comm.stage(p.tensor.detach().contiguous(), pg, "send")
            ops.append(dist.P2POp(dist.isend, x, int(p.peer), pg))
            finish = None
        else:
            buf, back = _comm.stage(torch.empty_like(p.tensor).contiguous(),
                                    pg, "recv")
            ops.append(dist.P2POp(dist.irecv, buf, int(p.peer), pg))
            finish = (lambda t=p.tensor, b=buf, d=back:
                      _write(t, b if d is None else b.to(d)))
        tasks.append(Task([], finish, tensors=[p.tensor]))
        issued.append(tasks[-1])
    # one work per issued operation, in order
    for t, w in zip(issued, dist.batch_isend_irecv(ops) if ops else []):
        t._works = [w]
    return tasks


def wait(tensor, group=None, use_calc_stream=True):
    """Block until the work that produces ``tensor`` has run."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.current_stream(tensor.device).synchronize()
    return tensor


def barrier(group=None):
    g, pg = _resolve(group)
    if pg is not None:
        dist.barrier(group=pg)


def destroy_process_group(group=None):
    """Tear down ``group``, or every group and the process group."""
    if group is None:
        _groups.clear()
        _split_layer_cache.clear()
        _split_cache_gen[0] += 1
        if dist.is_initialized():
            dist.destroy_process_group()
        return
    _groups.pop(group.id, None)
    if group.process_group is not None:
        dist.destroy_process_group(group.process_group)


def get_backend(group=None) -> str:
    """``"NCCL"`` or ``"GLOO"`` (the reference answers ``"XLA"``);
    ``"UNDEFINED"`` before the process group is made."""
    if not dist.is_initialized():
        return "UNDEFINED"
    g = group if isinstance(group, Group) else None
    pg = g.process_group if g is not None else group
    return str(dist.get_backend(pg)).upper()


_split_layer_cache = {}
# bumped by destroy_process_group(): per-instance split caches carry the
# generation they were built under and are dropped on a mismatch
_split_cache_gen = [0]


def _attr_key(attr):
    """A value key for a ParamAttr-like object (its repr would hold the
    address, making equal attributes differ)."""
    if attr is None:
        return None
    fields = {}
    if hasattr(attr, "__dict__"):
        for k, v in vars(attr).items():
            if isinstance(v, (str, int, float, bool, type(None))):
                fields[k] = v
            else:
                sub = {sk: sv for sk, sv in getattr(v, "__dict__", {}).items()
                       if isinstance(sv, (str, int, float, bool, type(None)))}
                fields[k] = (type(v).__name__, tuple(sorted(sub.items())))
    return (type(attr).__name__, tuple(sorted(fields.items())))


def split(x, size, operation="linear", axis=0, num_partitions=None,
          gather_out=True, weight_attr=None, bias_attr=None, name=None):
    """Megatron-style distributed linear or embedding (``paddle.distributed
    .split``) on the port's ``fleet.meta_parallel`` layers: the layer is
    made once per ``name`` and cached (without ``name``: per call site,
    and per calling instance where there is one), then applied to ``x``.
    The layers split over the global mesh's ``mp`` axis."""
    from .fleet.meta_parallel import parallel_layers as mp

    cache = _split_layer_cache
    if name is None:
        f = sys._getframe(1)
        name = f"_split_auto:{f.f_code.co_filename}:{f.f_lineno}"
        owner = f.f_locals.get("self")
        if owner is not None and hasattr(owner, "__dict__"):
            cache = owner.__dict__.setdefault("_paddle_split_site_cache", {})
            if cache.get("__gen__") != _split_cache_gen[0]:
                cache.clear()
                cache["__gen__"] = _split_cache_gen[0]
        if name not in cache:
            import warnings

            warnings.warn(
                "paddle.distributed.split called without `name`: the "
                f"created weight is cached per call site ({name}"
                f"{'' if cache is _split_layer_cache else ', per instance'}"
                "); if this line builds several logical layers "
                "(loop/factory), pass an explicit unique name per layer or "
                "they will share one weight", stacklevel=2)
    if operation == "linear" and axis not in (0, 1):
        raise InvalidArgumentError(
            f"split(operation='linear') partitions a 2-D weight: axis must "
            f"be 0 (row-parallel) or 1 (column-parallel), got {axis}")
    config = (operation, tuple(size), axis, bool(gather_out),
              bias_attr is not False, _attr_key(weight_attr), num_partitions)
    cached = cache.get(name)
    if cached is not None and cached[0] != config:
        raise InvalidArgumentError(
            f"split(name={name!r}) called with a different configuration "
            f"than the cached layer ({cached[0]} vs {config}) — use a "
            f"distinct name per logical layer")
    layer = cached[1] if cached else None
    if layer is None:
        in_f, out_f = size
        if operation == "embedding":
            layer = mp.VocabParallelEmbedding(in_f, out_f,
                                              weight_attr=weight_attr)
        elif operation == "linear" and axis == 0:
            layer = mp.RowParallelLinear(in_f, out_f, weight_attr=weight_attr,
                                         has_bias=bias_attr is not False,
                                         input_is_parallel=False)
        elif operation == "linear":
            layer = mp.ColumnParallelLinear(in_f, out_f,
                                            weight_attr=weight_attr,
                                            has_bias=bias_attr is not False,
                                            gather_output=gather_out)
        else:
            raise ValueError(f"unsupported split operation {operation!r}")
        cache[name] = (config, layer)
    return layer(x)
