"""``paddle.utils`` (port of ``paddle_tpu/utils``): extension loading,
DLPack exchange and helpers."""

from . import cpp_extension  # noqa: F401
from . import dlpack  # noqa: F401

__all__ = ["cpp_extension", "dlpack", "deprecated", "try_import",
           "run_check"]


def deprecated(update_to="", since="", reason="", level=0):
    """Decorator marking an API deprecated (Paddle's
    ``paddle.utils.deprecated``): a ``DeprecationWarning`` at each call."""
    import functools
    import warnings

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            msg = f"API {fn.__name__!r} is deprecated"
            if since:
                msg += f" since {since}"
            if update_to:
                msg += f"; use {update_to} instead"
            if reason:
                msg += f" ({reason})"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)

        return inner

    return wrap


def try_import(module_name, err_msg=None):
    """Import a soft dependency or raise a friendly error (Paddle's
    ``paddle.utils.try_import``)."""
    import importlib

    try:
        return importlib.import_module(module_name)
    except ImportError:
        raise ImportError(err_msg or
                          f"Optional dependency {module_name!r} is not "
                          f"installed; this environment is offline — gate "
                          f"the feature or vendor the package")


def run_check():
    """Check the installation end to end: ``nn.Linear(4, 4)`` forward and
    backward on the current device (the card unless the caller set the
    CPU), then print the verdict (Paddle's ``paddle.utils.run_check``)."""
    import numpy as np

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch import nn

    lin = nn.Linear(4, 4)
    x = paddle.to_tensor(np.ones((2, 4), np.float32))
    loss = paddle.mean(lin(x) ** 2)
    loss.backward()
    place = paddle.device.place_of(lin.weight.grad.device)
    n = len(paddle.device.get_all_devices())
    print(f"paddle_tpu_torch is installed successfully! {n} device(s) "
          f"visible, compute verified on {place.device_type}:"
          f"{place.device_id}.")
