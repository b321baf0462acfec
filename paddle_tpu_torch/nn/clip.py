"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

Each takes and returns ``(param, grad)`` pairs, as an optimizer hands them
over before its update. A parameter whose ``need_clip`` is False keeps its
gradient. Norms are summed in fp32 and the scale is chosen on the device
with ``torch.where``: clipping reads nothing back to the host. A scaled
gradient is computed in fp32 and cast back to its type, as the reference's
promotion of a low-precision gradient against its fp32 scale does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]


def _keeps(p) -> bool:
    return not getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads: List[Tuple]) -> List[Tuple]:
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    """Clamp every gradient into ``[min, max]`` (``min`` defaults to
    ``-max``)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return [(p, g if g is None or _keeps(p)
                 else g.clamp(self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Scale each gradient whose L2 norm exceeds ``clip_norm`` down to
    it."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or _keeps(p):
                out.append((p, g))
                continue
            gf = g.float()
            norm = gf.square().sum().sqrt()
            scale = torch.where(norm > self.clip_norm, self.clip_norm / norm,
                                1.0)
            out.append((p, (gf * scale).to(g.dtype)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every clipped gradient by ``clip_norm / (global_norm + 1e-6)``
    when the global L2 norm of all of them exceeds ``clip_norm``."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def _global_norm(grads):
        return sum(g.float().square().sum() for g in grads).sqrt()

    def __call__(self, params_grads):
        clippable = [g for p, g in params_grads
                     if g is not None and not _keeps(p)]
        if not clippable:
            return params_grads
        gnorm = self._global_norm(clippable)
        scale = torch.where(gnorm > self.clip_norm,
                            self.clip_norm / (gnorm + 1e-6), 1.0)
        return [(p, g if g is None or _keeps(p)
                 else (g.float() * scale).to(g.dtype))
                for p, g in params_grads]
