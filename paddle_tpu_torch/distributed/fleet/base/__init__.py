from .distributed_strategy import DistributedStrategy
from .topology import (
    CommunicateTopology,
    HybridCommunicateGroup,
    get_hybrid_communicate_group,
    set_hybrid_communicate_group,
)

__all__ = ["DistributedStrategy", "CommunicateTopology",
           "HybridCommunicateGroup", "get_hybrid_communicate_group",
           "set_hybrid_communicate_group"]
