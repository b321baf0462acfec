"""Hybrid-parallel topology: the rank grid and a group per axis.

Port of ``paddle_tpu/distributed/fleet/base/topology.py``.
``CommunicateTopology`` is the reference's coordinate arithmetic over the
rank grid, axis order ``("data", "pipe", "sharding", "model", "sep")``,
rank r at the r-th coordinate of ``itertools.product`` (row-major).
``HybridCommunicateGroup`` builds the port's hybrid mesh
(``parallel.create_hybrid_mesh``), whose rank r sits at the same
coordinate, and takes each axis's group from it (``axis_group``): the
slice through the grid that holds this rank, as the reference's
``get_comm_list`` enumerates it, as a ``collective.Group`` (a group of
one for an axis of size 1).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ....parallel.mesh import axis_group, create_hybrid_mesh
from ...collective import Group, from_process_group
from ...env import get_rank

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]

# the active hybrid group (the reference's _HYBRID_PARALLEL_GROUP global)
_HYBRID_PARALLEL_GROUP: Optional["HybridCommunicateGroup"] = None


def get_hybrid_communicate_group() -> Optional["HybridCommunicateGroup"]:
    return _HYBRID_PARALLEL_GROUP


def set_hybrid_communicate_group(hcg: Optional["HybridCommunicateGroup"]
                                 ) -> None:
    global _HYBRID_PARALLEL_GROUP
    _HYBRID_PARALLEL_GROUP = hcg


# reference name -> mesh axis name
_NAME_TO_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding",
                 "model": "mp", "sep": "sep"}


class CommunicateTopology:
    """N-D coordinate arithmetic over the hybrid rank grid."""

    def __init__(self, hybrid_group_names: Sequence[str] = (
            "data", "pipe", "sharding", "model", "sep"),
            dims: Sequence[int] = (1, 1, 1, 1, 1)):
        if len(hybrid_group_names) != len(dims):
            raise ValueError(f"{len(hybrid_group_names)} axis names for "
                             f"{len(dims)} degrees")
        self._parallel_names = list(hybrid_group_names)
        self._dims = [int(d) for d in dims]
        self.coordinate = list(itertools.product(
            *(range(d) for d in self._dims)))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}
        self._rank2coord = {i: c for c, i in self._coord2rank.items()}
        self._world = int(np.prod(self._dims))

    def get_hybrid_group_names(self) -> List[str]:
        return self._parallel_names

    def get_dim(self, axis_name: str) -> int:
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self) -> int:
        return self._world

    def get_rank(self, **kwargs) -> int:
        return self._coord2rank[tuple(kwargs[n]
                                      for n in self._parallel_names)]

    def get_coord(self, rank: int) -> Tuple[int, ...]:
        return self._rank2coord[rank]

    def get_rank_from_stage(self, global_rank: int, **kwargs) -> int:
        coord = dict(zip(self._parallel_names, self.get_coord(global_rank)))
        coord.update(kwargs)
        return self.get_rank(**coord)

    def get_axis_list(self, axis_name: str, index: int) -> List[int]:
        """Every global rank whose coordinate on ``axis_name`` is
        ``index``."""
        axis = self._parallel_names.index(axis_name)
        return sorted(r for c, r in self._coord2rank.items()
                      if c[axis] == index)

    def get_comm_list(self, axis_name: str) -> List[List[int]]:
        """The rank groups that communicate along ``axis_name``: one list
        per slice through the grid varying only that axis."""
        other = [n for n in self._parallel_names if n != axis_name]
        groups = []
        for fixed in itertools.product(*(range(self.get_dim(n))
                                         for n in other)):
            coord = dict(zip(other, fixed))
            ranks = []
            for i in range(self.get_dim(axis_name)):
                coord[axis_name] = i
                ranks.append(self.get_rank(**coord))
            groups.append(ranks)
        return groups


class HybridCommunicateGroup:
    """A group per axis of the hybrid grid, over the port's mesh.

    Building it builds the mesh over the world's ranks (their degrees
    must multiply to the world size) and sets it as the global one, as
    ``fleet.init`` builds the reference's; every rank builds it, in the
    same order. ``device`` is the mesh's (the card unless the caller
    names the CPU)."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 dp: int = 1, pp: int = 1, sharding: int = 1, mp: int = 1,
                 sep: int = 1, device="cuda"):
        if topology is None:
            topology = CommunicateTopology(
                ("data", "pipe", "sharding", "model", "sep"),
                (dp, pp, sharding, mp, sep))
        self._topo = topology
        self._dp = topology.get_dim("data")
        self._pp = topology.get_dim("pipe")
        self._sharding = topology.get_dim("sharding")
        self._mp = topology.get_dim("model")
        self._sep = topology.get_dim("sep")
        self.nranks = topology.world_size()
        self.mesh = create_hybrid_mesh(dp=self._dp, pp=self._pp,
                                       sharding=self._sharding, mp=self._mp,
                                       sep=self._sep, device=device)
        self.global_rank = get_rank()
        self._coord = dict(zip(topology.get_hybrid_group_names(),
                               topology.get_coord(self.global_rank)))
        self._groups: Dict[str, Group] = {
            name: from_process_group(axis_group(self.mesh, axis), axis)
            for name, axis in _NAME_TO_AXIS.items()}
        set_hybrid_communicate_group(self)

    @property
    def topology(self) -> CommunicateTopology:
        return self._topo

    def get_parallel_mode(self) -> str:
        if (self._mp == 1 and self._pp == 1 and self._sharding == 1
                and self._dp > 1):
            return "data"
        if self._sharding > 1 and self._mp == 1 and self._pp == 1:
            return "sharding"
        if self._pp > 1:
            return "pipeline"
        if self._mp > 1:
            return "model"
        return "single"

    # --- data parallel ---
    def get_data_parallel_world_size(self) -> int:
        return self._dp

    def get_data_parallel_rank(self) -> int:
        return self._coord["data"]

    def get_data_parallel_group(self) -> Group:
        return self._groups["data"]

    def get_data_parallel_group_src_rank(self) -> int:
        return self._groups["data"].ranks[0]

    # --- model (tensor) parallel ---
    def get_model_parallel_world_size(self) -> int:
        return self._mp

    def get_model_parallel_rank(self) -> int:
        return self._coord["model"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["model"]

    def get_model_parallel_group_src_rank(self) -> int:
        return self._groups["model"].ranks[0]

    # --- pipeline parallel ---
    def get_pipe_parallel_world_size(self) -> int:
        return self._pp

    def get_stage_id(self) -> int:
        return self._coord["pipe"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pipe"]

    def is_first_stage(self) -> bool:
        return self.get_stage_id() == 0

    def is_last_stage(self) -> bool:
        return self.get_stage_id() == self._pp - 1

    # --- sharding (ZeRO) ---
    def get_sharding_parallel_world_size(self) -> int:
        return self._sharding

    def get_sharding_parallel_rank(self) -> int:
        return self._coord["sharding"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sharding_parallel_group_src_rank(self) -> int:
        return self._groups["sharding"].ranks[0]

    # --- sep (sequence / context) ---
    def get_sep_parallel_world_size(self) -> int:
        return self._sep

    def get_sep_parallel_rank(self) -> int:
        return self._coord["sep"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_rank_from_stage(self, stage_id: int, **kwargs) -> int:
        return self._topo.get_rank_from_stage(self.global_rank,
                                              pipe=stage_id, **kwargs)
