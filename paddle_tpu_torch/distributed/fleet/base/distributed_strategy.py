"""DistributedStrategy: every distributed knob, serializable.

Port of ``paddle_tpu/distributed/fleet/base/distributed_strategy.py``:
typed dataclasses with the reference's field names, serialized as JSON
(``to_json`` / ``from_json``, ``save_to_prototxt`` /
``load_from_prototxt``); a ``*_configs`` field also takes a dict, as the
reference's do.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

__all__ = ["DistributedStrategy"]


@dataclass
class _AmpConfigs:
    init_loss_scaling: float = 32768.0
    incr_every_n_steps: int = 1000
    decr_every_n_nan_or_inf: int = 2
    incr_ratio: float = 2.0
    decr_ratio: float = 0.5
    use_dynamic_loss_scaling: bool = True
    custom_white_list: List[str] = field(default_factory=list)
    custom_black_list: List[str] = field(default_factory=list)
    use_pure_fp16: bool = False
    use_fp16_guard: bool = False
    use_bf16: bool = True  # bf16 needs no loss scaling


@dataclass
class _RecomputeConfigs:
    checkpoints: List[str] = field(default_factory=list)
    enable_offload: bool = False


@dataclass
class _ShardingConfigs:
    sharding_degree: int = 1
    stage: int = 1
    offload: bool = False
    accumulate_steps: int = 1
    comm_overlap: bool = True


@dataclass
class _PipelineConfigs:
    micro_batch_size: int = 1
    accumulate_steps: int = 1
    schedule_mode: str = "1F1B"
    p2p_cache_shape: bool = True


@dataclass
class _HybridConfigs:
    dp_degree: int = -1
    mp_degree: int = 1
    pp_degree: int = 1
    sharding_degree: int = 1
    sep_degree: int = 1


@dataclass
class DistributedStrategy:
    amp: bool = False
    amp_configs: _AmpConfigs = field(default_factory=_AmpConfigs)
    recompute: bool = False
    recompute_configs: _RecomputeConfigs = field(default_factory=_RecomputeConfigs)
    sharding: bool = False
    sharding_configs: _ShardingConfigs = field(default_factory=_ShardingConfigs)
    pipeline: bool = False
    pipeline_configs: _PipelineConfigs = field(default_factory=_PipelineConfigs)
    hybrid_configs: _HybridConfigs = field(default_factory=_HybridConfigs)
    gradient_merge: bool = False
    gradient_merge_configs: Dict[str, Any] = field(default_factory=lambda: {"k_steps": 1, "avg": True})
    lamb: bool = False
    dgc: bool = False
    dgc_configs: Dict[str, Any] = field(default_factory=lambda: {
        "rampup_begin_step": 0, "sparsity": 0.999})
    localsgd: bool = False
    localsgd_configs: Dict[str, Any] = field(default_factory=lambda: {
        "k_steps": 1})
    find_unused_parameters: bool = False
    fuse_all_reduce_ops: bool = True
    fuse_grad_size_in_MB: int = 32
    nccl_comm_num: int = 1  # kept for config compatibility; unused

    def __setattr__(self, name, value):
        # accept dict-style assignment like the reference:
        # strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
        # (also covers dataclass __init__'s own field assignments)
        cfg_types = {
            "amp_configs": _AmpConfigs,
            "recompute_configs": _RecomputeConfigs,
            "sharding_configs": _ShardingConfigs,
            "pipeline_configs": _PipelineConfigs,
            "hybrid_configs": _HybridConfigs,
        }
        if name in cfg_types and isinstance(value, dict):
            value = cfg_types[name](**value)
        object.__setattr__(self, name, value)

    # --- serialization (the reference round-trips through protobuf) ---
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "DistributedStrategy":
        return cls(**json.loads(s))

    def save_to_prototxt(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    def load_from_prototxt(self, path: str) -> None:
        with open(path) as f:
            other = DistributedStrategy.from_json(f.read())
        for f_ in dataclasses.fields(other):
            setattr(self, f_.name, getattr(other, f_.name))
