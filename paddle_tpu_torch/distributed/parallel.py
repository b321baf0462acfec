"""DataParallel: dygraph data parallelism with bucketed gradient sync.

Port of ``paddle_tpu/distributed/parallel.py`` (the reference's
``Reducer``): the trainable parameters are grouped in reverse
construction order into buckets of about ``comm_buffer_size`` MB (4 bytes
an element: the payload is fp32 whatever the parameters' type), made only
when the group spans more than one rank. A backward that gave this
model's parameters gradients (a hook on each parameter marks it) flushes
them when it ends: per bucket one fp32 ``all_reduce`` (SUM) over the
concatenated gradients, then × 1 / world, then each slice cast back to
its parameter's type and written as its gradient on every rank. With
``find_unused_parameters`` False a parameter without a gradient raises;
with it True zeros take its place, so every rank issues the same
collectives and keeps the same replicas. Every ``SyncBatchNorm`` below
the wrapper takes its group as the ranks that share the batch.

**Which backwards sync.** The flush runs from ``core.autograd``'s
backward-end callbacks, so it runs at the end of ``core.autograd
.backward``: ``Tensor.backward`` on a port tensor, ``paddle.autograd
.backward``, and the optimizers' ``minimize``. The wrapper returns its
model's outputs as port tensors (views, no copy), so a loss computed from
them is a port tensor and ``loss.backward()`` syncs. A ``paddle.grad``
capture (``torch.autograd.grad``) never syncs, as in the reference; nor
does ``torch.autograd.backward`` called directly, nor a ``.backward()``
on a plain ``torch.Tensor`` that does not come from this model's outputs
(torch's own method skips ``core.autograd``). Inside ``no_sync()`` the
gradients accumulate unsynced; the next synced backward reduces the sum.

The model's parameters start equal on every rank only if the ranks make
them so (the same seed, or a ``broadcast``): the wrapper, as the
reference's, does not broadcast them.
"""

from __future__ import annotations

import contextlib
import weakref
from typing import List

import torch

from ..core import autograd
from ..core.tensor import as_port_tensor
from ..nn.layer.layers import Layer
from ..nn.layer.norm import SyncBatchNorm
from . import _comm
from .collective import get_default_group

__all__ = ["DataParallel"]


class _Bucket:
    def __init__(self, params):
        self.params = params  # a reverse-order slice of trainable params


def _as_port(out):
    if isinstance(out, torch.Tensor):
        return as_port_tensor(out)
    if isinstance(out, (list, tuple)):
        return type(out)(_as_port(o) for o in out)
    if isinstance(out, dict):
        return {k: _as_port(v) for k, v in out.items()}
    return out


class DataParallel(Layer):
    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__()
        self._layers = layers
        self._group = group or get_default_group()
        self._grad_sync = True
        self._find_unused = bool(find_unused_parameters)
        self._buckets: List[_Bucket] = []
        self._flush_cb = None
        self._dirty = False  # set by the param hooks in THIS model's backward
        # fp32 all-reduces issued, one per bucket and flush
        self.bucket_syncs = 0
        if self._group.nranks > 1:
            for m in layers.modules():
                if isinstance(m, SyncBatchNorm):
                    m._group = self._group.process_group
            self._build_buckets(float(comm_buffer_size))
            wself = weakref.ref(self)

            def _mark(grad, _w=wself):
                s = _w()
                if s is not None:
                    s._dirty = True
                return grad

            for b in self._buckets:
                for p in b.params:
                    p.register_hook(_mark)

            # the registry holds a weak reference: a dead model's callback
            # unregisters itself at the next backward
            def _cb(_w=wself):
                s = _w()
                if s is None:
                    autograd.unregister_backward_end_callback(_cb)
                    return
                s._flush_buckets()

            self._flush_cb = _cb
            autograd.register_backward_end_callback(_cb)

    def __del__(self):
        if self.__dict__.get("_flush_cb") is not None:
            autograd.unregister_backward_end_callback(self._flush_cb)

    def _build_buckets(self, mb: float):
        """Reverse construction order, split at ~``mb`` MB boundaries of
        the fp32 payload."""
        limit = max(mb, 1e-6) * (1 << 20)
        cur, cur_bytes = [], 0.0
        for p in reversed([p for p in self._layers.parameters()
                           if p.requires_grad]):
            nbytes = float(p.numel()) * 4.0
            if cur and cur_bytes + nbytes > limit:
                self._buckets.append(_Bucket(cur))
                cur, cur_bytes = [], 0.0
            cur.append(p)
            cur_bytes += nbytes
        if cur:
            self._buckets.append(_Bucket(cur))

    @torch.no_grad()
    def _flush_buckets(self):
        # only for backwards that reached THIS model's parameters: a
        # process may hold several models
        if not self._dirty:
            return
        self._dirty = False
        if not self._grad_sync or not self._buckets:
            return
        pg = self._group.process_group
        inv = 1.0 / self._group.nranks
        for b in self._buckets:
            flats = []
            for p in b.params:
                if p.grad is None:
                    if not self._find_unused:
                        raise RuntimeError(
                            f"DataParallel: parameter {p.name!r} received no "
                            "gradient this backward; pass "
                            "find_unused_parameters=True if parts of the "
                            "model are conditionally unused")
                    flats.append(torch.zeros(p.numel(), dtype=torch.float32,
                                             device=p.device))
                else:
                    flats.append(p.grad.detach().reshape(-1).float())
            fused = torch.cat(flats) if len(flats) > 1 else flats[0]
            synced = _comm.all_reduce(fused, pg) * inv
            self.bucket_syncs += 1
            off = 0
            for p in b.params:
                n = p.numel()
                # every rank writes the mean, also where its branch left
                # the parameter without a gradient
                p.grad = synced[off:off + n].view(p.shape).to(p.dtype)
                off += n

    def forward(self, *inputs, **kwargs):
        return _as_port(self._layers(*inputs, **kwargs))

    @contextlib.contextmanager
    def no_sync(self):
        """Skip the gradient sync inside the context (accumulation)."""
        self._grad_sync = False
        try:
            yield
        finally:
            self._grad_sync = True

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.set_state_dict(state_dict, *args, **kwargs)

    def scale_loss(self, loss):
        return loss
