"""The runtime modules of the port against the JAX package's, on the CPU:
``version``, ``sysconfig``, ``utils`` (``deprecated``, ``try_import``,
``run_check``), ``utils.dlpack``, ``device`` and ``amp.debugging``.

The numeric cases of tests/test_api_surface.py (streams and events, the
Lion steps, the misc parity APIs) run as one script through both
packages, their values compared. The JAX package's DLPack round trips
fail on its jax (``jax.dlpack`` has no ``to_dlpack`` there), so the port
is held to the DLPack contract and to numpy instead: values and dtypes
survive a round trip, the result shares the producer's storage, and a
numpy producer gives its own values. Phase 6h (a) of ``chip_smoke.py``
runs the same modules on the card (``experiments/runtime_llama_opts``),
rehearsed here on the CPU.
"""

import contextlib
import io
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as pp
import paddle_tpu_torch as pt
from paddle_tpu_torch.amp import debugging as tdbg
from paddle_tpu.amp import debugging as jdbg
from paddle_tpu_torch.experiments import runtime_llama_opts as rlo


@pytest.fixture(autouse=True)
def on_cpu():
    prev = pt.set_device("cpu")
    yield
    pt.set_device(prev)


def test_version_and_sysconfig():
    tv, jv = pt.version, pp.version
    assert tv.full_version == pt.__version__ == jv.full_version
    for k in ("major", "minor", "patch", "rc", "istaged", "with_pip",
              "xpu_version"):
        assert getattr(tv, k) == getattr(jv, k), k
    # no CUDA in this torch: Paddle's "False", as the JAX package's
    assert tv.cuda() == (torch.version.cuda or "False")
    assert tv.cuda() == jv.cuda() and tv.cudnn() == jv.cudnn()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tv.show()
    assert "paddle_tpu_torch 0.1.0" in out.getvalue()
    inc = pt.sysconfig.get_include()
    with open(f"{inc}/paddle_ext.h") as f:
        assert "PTTensor" in f.read()
    assert inc == pt.utils.cpp_extension.get_include()
    from paddle_tpu_torch.ops.kernels._build import BUILD_DIR
    assert pt.sysconfig.get_lib() == str(BUILD_DIR)


def test_utils_helpers():
    """``deprecated`` warns once at every call, with JAX's message;
    ``try_import`` returns a module or raises JAX's error; ``run_check``
    prints JAX's sentence with the port's name."""
    msgs = {}
    for name, P in (("jax", pp), ("port", pt)):
        @P.utils.deprecated(update_to="paddle.new_api", since="2.0",
                            reason="gone")
        def old():
            return 7

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert old() == 7 and old() == 7
        assert [x.category for x in w] == [DeprecationWarning] * 2
        msgs[name] = [str(x.message) for x in w]
        assert P.utils.try_import("math").__name__ == "math"
        with pytest.raises(ImportError) as e:
            P.utils.try_import("no_such_module_here")
        msgs[name].append(str(e.value))
    assert msgs["port"] == msgs["jax"]
    outs = {}
    for name, P in (("jax", pp), ("port", pt)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            P.utils.run_check()
        outs[name] = buf.getvalue()
    # the JAX package counts the virtual CPU devices the tests' XLA flags
    # make; the port sees one CPU
    n = len(pp.device.get_all_devices())
    assert outs["port"] == outs["jax"].replace(
        "paddle_tpu ", "paddle_tpu_torch ").replace(f" {n} device(s)",
                                                   " 1 device(s)")
    assert "cpu:0" in outs["port"]


def _api_surface_script(P, device):
    """tests/test_api_surface.py:251-309's numeric cases, as one script:
    returns what both packages must agree on."""
    s = P.device.Stream()
    ev = s.record_event()
    ev.synchronize()
    assert s.query() and ev.query()
    with P.device.stream_guard(s):
        pass
    assert P.device.current_stream() is not None
    w = P.to_tensor(np.random.RandomState(0).randn(4, 4).astype(np.float32),
                    place=device)
    w.stop_gradient = False
    opt = P.optimizer.Lion(learning_rate=0.01, parameters=[w],
                           weight_decay=0.01)
    x = P.to_tensor(np.random.RandomState(1).randn(8, 4).astype(np.float32),
                    place=device)
    losses = []
    for _ in range(5):
        loss = P.mean((P.matmul(x, w) - 1.0) ** 2)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    assert P.callbacks.EarlyStopping is not None
    assert P.version.full_version == P.__version__
    assert P.sysconfig.get_include()
    P.disable_signal_handler()
    prev = P.vision.get_image_backend()
    P.vision.set_image_backend("numpy")
    backend = P.vision.get_image_backend()
    P.vision.set_image_backend(prev)
    with pytest.raises(ValueError):
        P.vision.set_image_backend("bogus")
    return losses, w.numpy(), backend


def test_api_surface_cases_through_both():
    jl, jw, jb = _api_surface_script(pp, "cpu")
    tl, tw, tb = _api_surface_script(pt, "cpu")
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=1e-7)
    assert tb == jb == "numpy"
    assert all(b < a + 1e-3 for a, b in zip(tl, tl[1:]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.bool_, "bfloat16"])
def test_dlpack_contract(dtype):
    dl = pt.utils.dlpack
    a = np.random.RandomState(0).randn(3, 5) * 4
    if dtype == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a.astype(dtype))
    x = t.as_subclass(pt.Tensor)
    y = dl.from_dlpack(dl.to_dlpack(x))
    assert isinstance(y, pt.Tensor) and y.dtype == t.dtype
    assert y.data_ptr() == x.data_ptr() and torch.equal(y, t)
    if dtype != "bfloat16":
        arr = np.ascontiguousarray(a.astype(dtype))
        z = dl.from_dlpack(arr)
        assert isinstance(z, pt.Tensor)
        np.testing.assert_array_equal(z.numpy(), arr)
        assert z.data_ptr() == arr.ctypes.data
        # a plain torch tensor is a producer too
        assert dl.from_dlpack(t).data_ptr() == t.data_ptr()


def test_device_surface():
    """Counts and statistics as JAX's on the CPU; the CPU's in-order
    streams; the refusals."""
    td, jd = pt.device, pp.device
    # the JAX package lists the virtual CPU devices the tests' XLA flags
    # make (cpu:0 first); the port sees one CPU and no GPU here
    assert td.get_all_devices() == jd.get_all_devices()[:1] == ["cpu:0"]
    assert td.device_count("gpu") == jd.device_count("gpu") == 0
    assert td.device_count("cpu") == td.device_count() == 1
    for name in ("memory_allocated", "max_memory_allocated",
                 "memory_reserved", "max_memory_reserved"):
        assert getattr(td, name)() == getattr(jd, name)() == 0, name
        assert getattr(td.cuda, name)("cpu") == 0
    td.empty_cache()
    td.synchronize()
    s = td.Stream()
    e = td.Event()
    assert e.query() and s.query()
    e.record(s)
    s.wait_event(e)
    s.wait_stream(td.current_stream())
    assert e.query()
    e.synchronize()
    s.synchronize()
    with td.stream_guard(s) as g:
        assert g is s
    assert td.get_all_custom_device_type() == []
    assert not td.is_compiled_with_custom_device("npu")
    with pytest.raises(NotImplementedError, match="PJRT"):
        td.register_pjrt_plugin("x", "/nonexistent.so")
    with pytest.raises(Exception, match="TPU"):
        td.tpu.device_count()
    assert set(jd.__all__) <= set(td.__all__)


def test_amp_debugging():
    a = np.array([1.0, np.nan, np.inf, -np.inf, 2.0], np.float32)
    errs = []
    for dbg, P in ((jdbg, pp), (tdbg, pt)):
        with pytest.raises(FloatingPointError) as e:
            dbg.check_numerics(P.to_tensor(a), "op", "v")
        errs.append(str(e.value))
        ok = P.to_tensor(np.ones(3, np.float32))
        assert dbg.check_numerics(ok) is ok
        cfg = dbg.TensorCheckerConfig(checked_op_list=["log"],
                                      skipped_op_list=["exp"])
        assert (cfg.checked_op_list, cfg.skipped_op_list) == (["log"],
                                                              ["exp"])
        dbg.enable_tensor_checker(cfg)
        try:
            assert P.get_flags("check_nan_inf")["check_nan_inf"]
            with pytest.raises(FloatingPointError, match="log"):
                P.log(P.to_tensor(np.zeros(2, np.float32)))
        finally:
            dbg.disable_tensor_checker()
        assert not P.get_flags("check_nan_inf")["check_nan_inf"]
        P.log(P.to_tensor(np.zeros(2, np.float32)))   # -inf, no raise
        dbg.enable_operator_stats_collection()
        assert dbg._op_stats[0]
        dbg.disable_operator_stats_collection()
        assert not dbg._op_stats[0]
    assert errs[0] == errs[1]


def test_phase_6h_a_rehearsal():
    """Phase 6h (a)'s checks on the CPU: the custom op built and run, the
    dlpack round trip, the tensor checker, run_check."""
    out = rlo.runtime_checks("cpu", alloc_bytes=1 << 20, query_n=32,
                             query_matmuls=2)
    assert out["devices"] == ["cpu:0"] and out["dlpack_shares_memory"]
    assert "custom_custom_relu" not in pt.ops.registry.OPS
    assert out["run_check"].endswith("compute verified on cpu:0.")
