"""``paddle.utils.cpp_extension``: custom C++ ops compiled at run time.

Port of ``paddle_tpu/utils/cpp_extension`` (Paddle's
``python/paddle/utils/cpp_extension/`` with ``PD_BUILD_OP`` user ops). The
C ABI is the JAX package's, in the port's own copy of
``include/paddle_ext.h``: one ``extern "C"`` function per op over
``PTTensor`` views, built with g++ into a shared library cached by a hash
of its sources, and loaded with ctypes.

The C function runs on the host, as the JAX package's does inside its
``jax.pure_callback``: an input on the card is copied to host memory, the
function is called, and its outputs are copied back to the first input's
device. ``backward=`` (another C function) makes the op a
``torch.autograd.Function`` whose backward calls it. There is no CUDA-side
custom-op API (``CUDAExtension``): the JAX package has none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ...core.tensor import Tensor, as_port_tensor
from ...ops.dispatch import run_op
from ...ops.registry import register_op

__all__ = ["load", "get_include", "CppExtension", "CustomOpModule"]

_DTYPE_CODE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
               np.dtype(np.int32): 2, np.dtype(np.int64): 3,
               np.dtype(np.bool_): 4}


def get_include() -> str:
    """Directory containing ``paddle_ext.h``."""
    return os.path.join(os.path.dirname(__file__), "include")


class _PTTensor(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("shape", ctypes.c_void_p),
                ("ndim", ctypes.c_int32), ("dtype", ctypes.c_int32)]


def _build(name: str, sources: Sequence[str], extra_cflags: Sequence[str],
           build_directory: Optional[str]) -> str:
    """Compile sources (paths or inline source strings) into a shared
    library, cached by a hash of their contents."""
    srcs = []
    tmp_files = []
    for s in sources:
        if os.path.exists(s):
            srcs.append(s)
        else:  # inline source string
            f = tempfile.NamedTemporaryFile(
                "w", suffix=".cc", delete=False, prefix=f"{name}_")
            f.write(s)
            f.close()
            srcs.append(f.name)
            tmp_files.append(f.name)
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            h.update(fh.read())
    build_dir = build_directory or os.path.join(
        tempfile.gettempdir(), "paddle_tpu_torch_extensions")
    os.makedirs(build_dir, exist_ok=True)
    out = os.path.join(build_dir, f"{name}_{h.hexdigest()[:12]}.so")
    try:
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                   f"-I{get_include()}", *extra_cflags, "-o", tmp, *srcs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"cpp_extension build failed:\n"
                                   f"{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, out)
    finally:
        for f in tmp_files:
            os.unlink(f)
    return out


class CustomOpModule:
    """Handle over a compiled extension; ``define_op`` wires its C
    functions into the op registry and autograd."""

    def __init__(self, name: str, lib_path: str):
        self.name = name
        self.lib_path = lib_path
        self._cdll = ctypes.CDLL(lib_path)

    def _call_raw(self, fn_name: str, arrays: List[np.ndarray],
                  out_specs: List[tuple]) -> List[np.ndarray]:
        fn = getattr(self._cdll, fn_name)
        n_in, n_out = len(arrays), len(out_specs)
        ins = (_PTTensor * max(n_in, 1))()
        keep = []  # keep the ctypes buffers alive through the call
        for i, a in enumerate(arrays):
            a = np.ascontiguousarray(a)
            shape = (ctypes.c_int64 * max(a.ndim, 1))(*(a.shape or (0,)))
            keep.append((a, shape))
            ins[i].data = a.ctypes.data_as(ctypes.c_void_p)
            ins[i].shape = ctypes.cast(shape, ctypes.c_void_p)
            ins[i].ndim = a.ndim
            ins[i].dtype = _DTYPE_CODE[a.dtype]
        outs = (_PTTensor * max(n_out, 1))()
        out_arrays = []
        for i, (shp, dt) in enumerate(out_specs):
            o = np.empty(shp, dtype=dt)
            shape = (ctypes.c_int64 * max(o.ndim, 1))(*(o.shape or (0,)))
            keep.append((o, shape))
            outs[i].data = o.ctypes.data_as(ctypes.c_void_p)
            outs[i].shape = ctypes.cast(shape, ctypes.c_void_p)
            outs[i].ndim = o.ndim
            outs[i].dtype = _DTYPE_CODE[o.dtype]
            out_arrays.append(o)
        fn(ins, n_in, outs, n_out)
        return out_arrays

    def _host(self, fn_name: str, xs, specs: Callable) -> List[torch.Tensor]:
        """Call ``fn_name`` on host copies of ``xs``; its outputs (shapes
        and dtypes from ``specs(avals)``) return to ``xs[0]``'s device."""
        arrays = [x.detach().cpu().numpy() for x in xs]
        outs = self._call_raw(fn_name, arrays,
                              specs([(a.shape, a.dtype) for a in arrays]))
        return [torch.from_numpy(o).to(xs[0].device) for o in outs]

    def define_op(self, fn_name: str,
                  out_shape_fn: Optional[Callable] = None,
                  backward: Optional[str] = None,
                  backward_out_shape_fn: Optional[Callable] = None):
        """Create the Python-callable op.

        ``out_shape_fn(*in_shape_dtype) -> [(shape, dtype), ...]`` infers
        the outputs (the InferMeta analog); by default one output shaped
        and typed as the first input. ``backward``: the C gradient
        function, taking (inputs..., grad_outs...) and writing the
        gradients of the leading inputs (``backward_out_shape_fn``, by
        default one shaped as the first input); the trailing inputs get
        none."""

        def infer(avals):
            if out_shape_fn is None:
                return [(avals[0][0], avals[0][1])]
            return out_shape_fn(*avals)

        def one(outs):
            return outs[0] if len(outs) == 1 else tuple(outs)

        if backward is None:
            def impl(*xs):
                return one(self._host(fn_name, xs, infer))
        else:
            bwd_infer = backward_out_shape_fn or (lambda *avals: [avals[0]])
            module = self

            class _CustomOp(torch.autograd.Function):
                @staticmethod
                def forward(ctx, *xs):
                    ctx.save_for_backward(*xs)
                    return one(module._host(fn_name, xs, infer))

                @staticmethod
                def backward(ctx, *gs):
                    xs = ctx.saved_tensors
                    n = len(xs)
                    grads = module._host(
                        backward, list(xs) + list(gs),
                        lambda avals: bwd_infer(*avals[:n]))
                    return tuple(grads) + (None,) * (n - len(grads))

            impl = _CustomOp.apply

        def op(*tensors):
            out = run_op(f"{self.name}.{fn_name}", impl, *tensors)
            if not any(isinstance(t, Tensor) for t in tensors):
                return out
            if isinstance(out, tuple):
                return tuple(as_port_tensor(o) for o in out)
            return as_port_tensor(out)

        op.__name__ = fn_name
        register_op(f"custom_{fn_name}")(op)
        setattr(self, fn_name, op)
        return op


def load(name: str, sources: Sequence[str],
         extra_cflags: Sequence[str] = (),
         build_directory: Optional[str] = None, verbose: bool = False
         ) -> CustomOpModule:
    """Compile and load a custom op extension (Paddle's
    ``paddle.utils.cpp_extension.load``)."""
    lib = _build(name, sources, extra_cflags, build_directory)
    return CustomOpModule(name, lib)


class CppExtension:
    """setuptools-style descriptor (Paddle's ``CppExtension``); with no
    ahead-of-time wheel build, ``.load()`` compiles at run time."""

    def __init__(self, sources: Sequence[str], name: str = "custom_ext",
                 extra_compile_args: Sequence[str] = ()):
        self.name = name
        self.sources = list(sources)
        self.extra_compile_args = list(extra_compile_args)

    def load(self) -> CustomOpModule:
        return load(self.name, self.sources, self.extra_compile_args)
