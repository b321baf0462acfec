"""The port's ``utils.cpp_extension`` against the JAX package's, on the CPU.

tests/test_cpp_extension.py's source (``RELU_SRC``, kept beside phase 6h
in ``experiments/runtime_llama_opts.py``) is compiled for each package
from the same string, each against its own ``paddle_ext.h``, and its ops
run through both: outputs, the gradient through the C backward, a
two-input op, an op with an output shape function, the registry entry and
the build cache. The fixture takes the ops it registers out of both
registries when the module ends, so ``all_ops()`` stays as it was for the
files a worker runs after this one.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu_torch as pt
from paddle_tpu.ops import registry as jreg
from paddle_tpu.utils import cpp_extension as jext
from paddle_tpu_torch.experiments.runtime_llama_opts import RELU_SRC
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.utils import cpp_extension as text

ROW_POS_SRC = r"""
#include "paddle_ext.h"

/* [n, m] float32 -> [n] int32: each row's count of positive values */
extern "C" void row_positives(const PTTensor* ins, int32_t n_in,
                              PTMutableTensor* outs, int32_t n_out) {
  const float* x = static_cast<const float*>(ins[0].data);
  int32_t* y = static_cast<int32_t*>(outs[0].data);
  const int64_t n = ins[0].shape[0], m = ins[0].shape[1];
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = 0;
    for (int64_t j = 0; j < m; ++j) c += x[i * m + j] > 0.f;
    y[i] = c;
  }
}
"""


def _reference_source():
    """``RELU_SRC`` as tests/test_cpp_extension.py defines it."""
    path = Path(__file__).with_name("test_cpp_extension.py")
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "RELU_SRC":
            return ast.literal_eval(node.value)
    raise AssertionError("RELU_SRC not found")


@pytest.fixture(scope="module")
def exts(tmp_path_factory):
    prev = pt.set_device("cpu")
    before = (set(jreg.OPS), set(treg.OPS))
    d = tmp_path_factory.mktemp("ext")
    yield (jext.load(name="test_ext", sources=[RELU_SRC, ROW_POS_SRC],
                     build_directory=str(d / "jax")),
           text.load(name="test_ext", sources=[RELU_SRC, ROW_POS_SRC],
                     build_directory=str(d / "port")))
    for reg, had in zip((jreg.OPS, treg.OPS), before):
        for name in set(reg) - had:
            del reg[name]
    pt.set_device(prev)


def test_same_source_as_the_reference_test():
    assert RELU_SRC == _reference_source()


def test_forward_and_c_backward(exts):
    j, t = exts
    jrelu = j.define_op("custom_relu", backward="custom_relu_grad")
    trelu = t.define_op("custom_relu", backward="custom_relu_grad")
    a = np.random.RandomState(0).randn(6, 5).astype(np.float32)
    w = np.random.RandomState(1).randn(6, 5).astype(np.float32)
    xj = pp.to_tensor(a, stop_gradient=False)
    xt = pt.to_tensor(a, stop_gradient=False)
    yj, yt = jrelu(xj), trelu(xt)
    assert isinstance(yt, pt.Tensor)
    np.testing.assert_array_equal(yt.numpy(), yj.numpy())
    np.testing.assert_array_equal(yt.numpy(), np.maximum(a, 0))
    pp.sum(yj * pp.to_tensor(w)).backward()
    pt.sum(yt * pt.to_tensor(w)).backward()
    np.testing.assert_array_equal(xt.grad.numpy(), xj.grad.numpy())
    np.testing.assert_array_equal(xt.grad.numpy(), np.where(a > 0, w, 0))


def test_multi_input_and_shape_function(exts):
    j, t = exts
    jadd, tadd = j.define_op("pairwise_sum"), t.define_op("pairwise_sum")
    a, b = np.float32([1, 2, 3]), np.float32([10, 20, 30])
    np.testing.assert_array_equal(
        tadd(pt.to_tensor(a), pt.to_tensor(b)).numpy(),
        jadd(pp.to_tensor(a), pp.to_tensor(b)).numpy())

    def shape(x):
        return [((x[0][0],), np.int32)]

    jrs = j.define_op("row_positives", out_shape_fn=shape)
    trs = t.define_op("row_positives", out_shape_fn=shape)
    x = np.random.RandomState(2).randn(4, 7).astype(np.float32)
    out = trs(pt.to_tensor(x))
    assert out.dtype == torch.int32 and tuple(out.shape) == (4,)
    np.testing.assert_array_equal(out.numpy(), jrs(pp.to_tensor(x)).numpy())
    np.testing.assert_array_equal(out.numpy(), (x > 0).sum(1))
    # a plain torch tensor in, a plain torch tensor out
    assert type(trs(torch.from_numpy(x))) is torch.Tensor


def test_registry_and_names(exts):
    _, t = exts
    t.define_op("custom_relu", backward="custom_relu_grad")
    assert "custom_custom_relu" in treg.OPS
    assert treg.get_op("custom_custom_relu").fn is t.custom_relu
    assert t.custom_relu.__name__ == "custom_relu"


def test_build_cache_and_descriptor(exts, tmp_path):
    _, t = exts
    again = text.load(name="test_ext", sources=[RELU_SRC, ROW_POS_SRC],
                      build_directory=str(Path(t.lib_path).parent))
    assert again.lib_path == t.lib_path
    src = tmp_path / "relu.cc"
    src.write_text(RELU_SRC)
    m = text.CppExtension([str(src)], name="desc_ext").load()
    relu = m.define_op("custom_relu")
    np.testing.assert_array_equal(
        relu(torch.tensor([-1.0, 2.0])).numpy(), [0.0, 2.0])
    with pytest.raises(RuntimeError, match="build failed"):
        text.load(name="bad", sources=["int main( {"],
                  build_directory=str(tmp_path))
