"""Build and config introspection (port of ``paddle_tpu/sysconfig.py``,
Paddle's ``paddle.sysconfig``)."""

import os


def get_include() -> str:
    """The directory of ``paddle_ext.h``, the custom C++ op header
    (``utils.cpp_extension``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "utils",
                        "cpp_extension", "include")


def get_lib() -> str:
    """The directory the port's CUDA kernels are built into
    (``ops/kernels/_build.py``'s ``BUILD_DIR``)."""
    from .ops.kernels._build import BUILD_DIR

    return str(BUILD_DIR)
