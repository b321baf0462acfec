"""``paddle.amp.debugging`` (port of ``paddle_tpu/amp/debugging.py``):
numeric-anomaly tooling for mixed precision. The per-op NaN/Inf scan is
``run_op``'s ``check_nan_inf`` flag (Paddle's ``FLAGS_check_nan_inf``);
the tensor checker's op lists are stored and ignored, as in the JAX
package."""

from __future__ import annotations

import torch

from .. import flags as _flags

__all__ = ["enable_operator_stats_collection",
           "disable_operator_stats_collection", "check_numerics",
           "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker"]


class TensorCheckerConfig:
    """Configuration for the tensor checker (Paddle's signature)."""

    def __init__(self, enable=True, debug_mode=None, output_dir=None,
                 checked_op_list=None, skipped_op_list=None,
                 debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list or []
        self.skipped_op_list = skipped_op_list or []


def enable_tensor_checker(config: TensorCheckerConfig) -> None:
    """Turn on ``run_op``'s per-op NaN/Inf scan."""
    _flags.set_flags({"check_nan_inf": bool(config.enable)})


def disable_tensor_checker() -> None:
    _flags.set_flags({"check_nan_inf": False})


def check_numerics(tensor, op_type="", var_name="", debug_mode=None):
    """Raise ``FloatingPointError`` with the NaN and Inf counts if
    ``tensor`` holds any; the counts come back in one device read."""
    t = torch.as_tensor(tensor).detach()
    n_nan, n_inf = torch.stack([torch.isnan(t).sum(),
                                torch.isinf(t).sum()]).tolist()
    if n_nan or n_inf:
        raise FloatingPointError(
            f"check_numerics: {op_type or 'tensor'} {var_name or ''} has "
            f"{n_nan} NaN and {n_inf} Inf values")
    return tensor


_op_stats = [False]


def enable_operator_stats_collection() -> None:
    """Paddle counts each op's calls by dtype under autocast; here the op
    registry serves introspection, so this sets the toggle only, as in the
    JAX package."""
    _op_stats[0] = True


def disable_operator_stats_collection() -> None:
    _op_stats[0] = False
