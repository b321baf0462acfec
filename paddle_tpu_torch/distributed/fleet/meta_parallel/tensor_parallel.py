"""TensorParallel: the model wrapper of tensor parallelism.

Port of ``paddle_tpu/distributed/fleet/meta_parallel/tensor_parallel.py``:
at construction every parameter that is not an ``mp`` shard
(``is_distributed``) is broadcast from the ``mp`` group's first rank, so
replicated state starts bit-identical across the tensor-parallel ranks;
forward delegates.
"""

from __future__ import annotations

from ....nn.layer.layers import Layer

__all__ = ["TensorParallel"]


class TensorParallel(Layer):
    def __init__(self, layers: Layer, hcg=None, strategy=None, **kwargs):
        super().__init__()
        self._layers = layers
        self._strategy = strategy
        if hcg is None:
            from ..base.topology import get_hybrid_communicate_group

            hcg = get_hybrid_communicate_group()
        self._hcg = hcg
        self._sync_params()

    def _sync_params(self) -> None:
        if self._hcg is None or \
                self._hcg.get_model_parallel_world_size() <= 1:
            return
        from ..utils.hybrid_parallel_util import broadcast_mp_parameters

        broadcast_mp_parameters(self._layers, self._hcg)

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)
