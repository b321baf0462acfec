"""``paddle.parallel``'s mesh: the hybrid device mesh over
``torch.distributed`` (port of ``paddle_tpu/parallel``)."""

from .mesh import (HYBRID_AXES, NamedSharding, P, PartitionSpec,
                   create_hybrid_mesh, get_mesh, host_to_global,
                   local_to_global, mesh_axis_size, named_sharding, set_mesh,
                   shard_map_compat, with_sharding_constraint)

__all__ = ["HYBRID_AXES", "NamedSharding", "P", "PartitionSpec",
           "create_hybrid_mesh", "get_mesh", "host_to_global",
           "local_to_global", "mesh_axis_size", "named_sharding",
           "set_mesh", "shard_map_compat", "with_sharding_constraint"]
