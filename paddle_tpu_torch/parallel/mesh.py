"""The hybrid device mesh over ``torch.distributed``.

Port of ``paddle_tpu/parallel/mesh.py``. The reference's mesh is one
``jax.sharding.Mesh`` whose named axes are the parallelism axes, and
GSPMD places every shard and inserts every collective. The port holds
explicit per-rank shards: a ``torch.distributed.device_mesh.DeviceMesh``
with the same axis names, rank r at ``np.unravel_index(r, shape)`` (the
reference's ``np.asarray(jax.devices()).reshape(shape)``), so a host
array sharded by a spec lands on rank r exactly as on JAX device r. A
spec (``PartitionSpec``: per dimension ``None``, an axis name or a tuple
of names) decides each rank's slice: a dimension split over axes
``(a, b)`` gives rank piece ``i_a * size_b + i_b`` (row-major, as JAX's).

The collectives run over process groups that span a set of axes
(``axis_group``). They are made when the mesh is, so that every rank
makes them in one order, for the sets the port's spec tables and
trainers name (``AXIS_SETS``), each cut to its axes of size > 1, and
held by the mesh itself.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device
from ..distributed import _comm

__all__ = ["HYBRID_AXES", "PartitionSpec", "P", "NamedSharding",
           "create_hybrid_mesh", "set_mesh", "get_mesh", "mesh_axis_size",
           "named_sharding", "host_to_global", "local_to_global",
           "with_sharding_constraint", "shard_map_compat", "axis_group",
           "axis_index", "axis_size", "local_shard", "spec_axes"]

# the reference's hybrid axis order, outermost first
HYBRID_AXES: Tuple[str, ...] = ("dp", "pp", "sharding", "mp", "sep", "sp",
                                "ep")

_GLOBAL_MESH: Optional[DeviceMesh] = None
# the sets of axes a group is made for: each axis alone, the ZeRO axes
# ("dp", "sharding"), with "mp" (the moments' specs) and with "sep" (the
# batch's rows under sequence parallelism), and the whole mesh
AXIS_SETS: Tuple[Tuple[str, ...], ...] = tuple(
    (a,) for a in HYBRID_AXES) + (("dp", "sharding"),
                                  ("dp", "sharding", "mp"),
                                  ("dp", "sharding", "sep"), HYBRID_AXES)


class PartitionSpec(tuple):
    """Per dimension ``None`` (replicated), an axis name, or a tuple of
    axis names (the dimension split over their product); the reference's
    ``jax.sharding.PartitionSpec`` as a tuple."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    mesh: DeviceMesh
    spec: PartitionSpec


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec) -> Tuple[str, ...]:
    """Every axis ``spec`` names, in the mesh's order."""
    named = {a for e in spec for a in _entry_axes(e)}
    return tuple(a for a in HYBRID_AXES if a in named)


def _shape(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_size(mesh: Optional[DeviceMesh], axes) -> int:
    """The product of ``axes``' sizes (1 without a mesh; an axis the
    mesh lacks counts 1)."""
    if mesh is None:
        return 1
    shape = _shape(mesh)
    return int(np.prod([shape.get(a, 1) for a in _entry_axes(axes)]))


def _coord(mesh: DeviceMesh) -> Dict[str, int]:
    me = dist.get_rank()
    idx = np.argwhere(mesh.mesh.numpy() == me)
    if len(idx) != 1:
        raise ValueError(f"rank {me} is not in the mesh")
    return dict(zip(mesh.mesh_dim_names, (int(i) for i in idx[0])))


def axis_index(mesh: Optional[DeviceMesh], axes) -> int:
    """This rank's row-major index over ``axes`` (0 without a mesh)."""
    if mesh is None:
        return 0
    shape, coord = _shape(mesh), _coord(mesh)
    i = 0
    for a in _entry_axes(axes):
        if a in shape:
            i = i * shape[a] + coord[a]
    return i


def _ordered(axes) -> Tuple[str, ...]:
    axes = _entry_axes(axes)
    order = [a for a in HYBRID_AXES if a in axes]
    if tuple(order) != tuple(a for a in axes if a in HYBRID_AXES):
        raise ValueError(f"axes {axes} are not in the mesh's order "
                         f"{HYBRID_AXES}")
    return tuple(order)


def _live(mesh: DeviceMesh, axes) -> Tuple[str, ...]:
    shape = _shape(mesh)
    return tuple(a for a in _ordered(axes) if shape.get(a, 1) > 1)


def _make_groups(mesh: DeviceMesh) -> Dict[Tuple[str, ...], object]:
    """This rank's group over each set of ``AXIS_SETS`` cut to its axes
    of size > 1 (one group per distinct cut set); every rank makes them
    in the same order."""
    shape = _shape(mesh)
    ranks = mesh.mesh.numpy()
    names = list(mesh.mesh_dim_names)
    groups = {}
    for axes in AXIS_SETS:
        axes = _live(mesh, axes)
        if axes and axes not in groups:
            inner = [names.index(a) for a in axes]
            outer = [i for i in range(len(names)) if i not in inner]
            moved = np.transpose(ranks, outer + inner).reshape(
                -1, int(np.prod([shape[a] for a in axes])))
            mine, _ = dist.new_subgroups_by_enumeration(
                [[int(r) for r in row] for row in moved])
            groups[axes] = mine
    return groups


def axis_group(mesh: Optional[DeviceMesh], axes):
    """The process group over ``axes`` holding this rank, or ``None``
    where they span one rank. Raises for a set of axes whose group the
    mesh did not make (see ``AXIS_SETS``)."""
    if mesh is None:
        return None
    live = _live(mesh, axes)
    if not live:
        return None
    groups = getattr(mesh, "_hybrid_groups", {})
    if live not in groups:
        raise ValueError(f"no process group over the axes {live}: the "
                         f"mesh makes them for {sorted(groups)}")
    return groups[live]


def create_hybrid_mesh(dp: int = 1, pp: int = 1, sharding: int = 1,
                       mp: int = 1, sep: int = 1, ep: int = 1, sp: int = 1,
                       devices: Optional[Sequence[int]] = None,
                       set_as_global: bool = True,
                       device="cuda") -> DeviceMesh:
    """The hybrid mesh over ``devices`` (global ranks; default the whole
    world), on the card unless ``device`` names the CPU. Joins the
    process group first if no one has (``init_parallel_env(device=)``).
    The degrees must multiply to the number of ranks."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        from ..distributed.env import init_parallel_env

        init_parallel_env(device=dev)
    if devices is None:
        devices = range(dist.get_world_size())
    devices = [int(d) for d in devices]
    degrees = {"dp": dp, "pp": pp, "sharding": sharding, "mp": mp,
               "sep": sep, "sp": sp, "ep": ep}
    total = int(np.prod(list(degrees.values())))
    if total != len(devices):
        raise ValueError(
            f"hybrid degrees {degrees} multiply to {total} but "
            f"{len(devices)} devices are available")
    shape = tuple(degrees[a] for a in HYBRID_AXES)
    mesh = DeviceMesh(dev.type, torch.tensor(devices).reshape(shape),
                      mesh_dim_names=HYBRID_AXES)
    mesh._hybrid_groups = _make_groups(mesh)
    if set_as_global:
        set_mesh(mesh)
    return mesh


def set_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_mesh() -> Optional[DeviceMesh]:
    return _GLOBAL_MESH


def mesh_axis_size(axis: str, mesh: Optional[DeviceMesh] = None) -> int:
    mesh = mesh or _GLOBAL_MESH
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 1
    return _shape(mesh)[axis]


def named_sharding(spec, mesh: Optional[DeviceMesh] = None
                   ) -> Optional[NamedSharding]:
    """``(mesh, spec)`` on the given or global mesh; None without one."""
    mesh = mesh or _GLOBAL_MESH
    if mesh is None:
        return None
    return NamedSharding(mesh, PartitionSpec(*spec))


def local_shard(x: torch.Tensor, spec, mesh: Optional[DeviceMesh] = None
                ) -> torch.Tensor:
    """This rank's slice of the full tensor ``x`` under ``spec`` (a view;
    ``x`` itself without a mesh)."""
    mesh = mesh or _GLOBAL_MESH
    if mesh is None:
        return x
    for d, entry in enumerate(spec):
        n = axis_size(mesh, entry)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(
                f"dim {d} of {tuple(x.shape)} does not divide over {entry} "
                f"({n} ranks)")
        k = x.shape[d] // n
        x = x.narrow(d, axis_index(mesh, entry) * k, k)
    return x


def local_to_global(x: torch.Tensor, spec, mesh: Optional[DeviceMesh] = None
                    ) -> torch.Tensor:
    """The full tensor from every rank's shard ``x`` under ``spec`` (an
    all-gather over each sharded dimension's axes)."""
    mesh = mesh or _GLOBAL_MESH
    if mesh is None:
        return x
    for d, entry in enumerate(spec):
        x = _comm.all_gather(x, axis_group(mesh, entry), dim=d)
    return x


def host_to_global(x, spec, mesh: Optional[DeviceMesh] = None, device=None):
    """A host value (the same on every rank) as this rank's shard under
    ``spec``, on the mesh's device (or ``device``)."""
    mesh = mesh or _GLOBAL_MESH
    t = torch.as_tensor(np.asarray(x))
    if device is None:
        device = mesh.device_type if mesh is not None else "cuda"
    return local_shard(t, spec, mesh).contiguous().to(resolve_device(device))


def with_sharding_constraint(x, spec, mesh: Optional[DeviceMesh] = None):
    """The identity: the reference's GSPMD layout hint. Here every tensor
    already is its rank's shard, and the layers call their collectives
    where the layout changes."""
    return x


def shard_map_compat(f, mesh, in_specs, out_specs):
    """``f`` run on each rank's local shards: the returned function takes
    full tensors, slices each by its spec in ``in_specs``, calls ``f`` and
    all-gathers each output by its spec in ``out_specs`` (one spec, or a
    tuple of specs for a tuple of outputs)."""
    from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
        gather_along)

    def g(*args):
        local = [local_shard(a, s, mesh) for a, s in zip(args, in_specs)]
        out = f(*local)
        single = not isinstance(out, tuple)
        outs, specs = ((out,), (out_specs,)) if single else (out, out_specs)
        full = []
        for o, s in zip(outs, specs):
            for d, entry in enumerate(s):
                o = gather_along(o, axis_group(mesh, entry), d)
            full.append(o)
        return full[0] if single else tuple(full)

    return g
