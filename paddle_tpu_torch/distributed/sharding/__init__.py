from .group_sharded import (
    GroupShardedScaler,
    group_sharded_parallel,
    save_group_sharded_model,
)

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedScaler"]
