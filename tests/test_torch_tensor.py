"""The port's ``Tensor`` (a ``torch.Tensor`` subclass) and ``to_tensor``
against the JAX package's: the same script through both packages, the
methods the reference adds, its in-place forms, the method table, one
test per divergence (``size``, ``shape``, int64 against int32, complex on
the device), and the port's layers on plain and on port tensors."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu_torch as pp
from torch_ops_common import R, assert_close, on_cpu  # noqa: F401


def _both(script):
    return script(pt), script(pp)


def test_to_tensor_dtypes_and_values():
    for data, dtype in (([1.5, 2.5], None), (np.arange(6.0), None),
                        ([[1, 2], [3, 4]], "float32"), (True, None),
                        (np.float32(2.0), None), ([1.0, 2.0], "float64")):
        r, p = _both(lambda P: P.to_tensor(data, dtype=dtype))
        assert_close(p, r)
    assert pp.to_tensor(np.arange(3.0)).dtype == torch.float32  # f64 data
    assert pp.to_tensor([1.0], dtype="float64").dtype == torch.float64
    assert pp.to_tensor(np.array([1, 2], np.int32)).dtype == torch.int32
    x = pp.to_tensor([1.0, 2.0], stop_gradient=False)
    assert isinstance(x, pp.Tensor) and x.is_leaf and not x.stop_gradient
    y = pp.to_tensor(x)  # a copy, cut from the graph
    assert y.stop_gradient and y.data_ptr() != x.data_ptr()
    z = pp.to_tensor([pp.to_tensor([1.0, 2.0]), pp.to_tensor([3.0, 4.0])])
    assert z.numpy().tolist() == [[1.0, 2.0], [3.0, 4.0]]


def test_divergence_int64_where_the_reference_has_int32():
    r, p = _both(lambda P: P.to_tensor([1, 2, 3]))
    assert str(r.dtype) == "int32" and p.dtype == torch.int64
    assert_close(p, r)
    r, p = _both(lambda P: P.arange(4))
    assert str(r.dtype) == "int32" and p.dtype == torch.int64


def test_divergence_size_is_torchs_method():
    r, p = _both(lambda P: P.to_tensor(np.zeros((2, 3), np.float32)))
    assert r.size == 6  # the reference: an int property
    assert p.size() == torch.Size([2, 3]) and p.numel() == 6 == r.numel()


def test_divergence_shape_is_a_torch_size():
    r, p = _both(lambda P: P.to_tensor(np.zeros((2, 3), np.float32)))
    assert r.shape == [2, 3] and isinstance(r.shape, list)
    assert isinstance(p.shape, torch.Size) and list(p.shape) == r.shape
    assert p.shape == (2, 3) and tuple(r.shape) == (2, 3)


def test_divergence_bfloat16_numpy_is_float32():
    x = pp.to_tensor([1.5, 2.0]).astype("bfloat16")
    assert x.dtype == torch.bfloat16
    a = x.numpy()
    assert a.dtype == np.float32 and a.tolist() == [1.5, 2.0]


def test_reference_methods():
    a = R("methods").n(2, 3)
    for P in (pt, pp):
        x = P.to_tensor(a, stop_gradient=False)
        assert not x.stop_gradient
        assert x.astype("float16").numpy().dtype == np.float16
        assert x.cast("int32").numpy().dtype == np.int32
        np.testing.assert_allclose(x.numpy(), a)
        assert x.strides == [3, 1] and x.get_strides() == [3, 1]
        (x * 2).sum().backward()
        assert x.grad is not None
        x.clear_grad()
        assert x.grad is None
        (x * 3).sum().backward()
        x.clear_gradient()
        assert x.grad is None
        x.stop_gradient = True
        assert x.stop_gradient
    x = pp.to_tensor(a, stop_gradient=False)
    assert x.place == pp.CPUPlace()
    assert x.astype("float64").dtype == torch.float64  # the reference: f32
    (x * 2).sum().backward()
    assert isinstance(x.grad, pp.Tensor)  # so .numpy() works on a card too


def test_to_takes_paddles_spellings():
    x = pp.to_tensor([1.0, 2.0])
    assert x.to("float64").dtype == torch.float64
    assert x.to("cpu").device.type == "cpu"
    assert x.to(pp.CPUPlace()).device.type == "cpu"
    assert x.to(device="cpu", dtype="int64").dtype == torch.int64
    assert x.to("cpu", "float16", blocking=True).dtype == torch.float16
    assert x.to(torch.float64).dtype == torch.float64  # torch's forms too
    with pytest.raises(ValueError, match="TPU"):
        x.to("tpu")
    with pytest.raises(ValueError, match="CUDA GPUs"):
        x.tpu()


@pytest.mark.parametrize("name,args", [
    ("set_value", (np.full((2, 3), 7.0, np.float32),)),
    ("scale_", (2.5,)), ("zero_", ()), ("fill_", (3.0,)), ("add_", (1.0,)),
    ("subtract_", (1.0,)), ("multiply_", (3.0,)), ("clip_", (-0.5, 0.5)),
    ("exp_", ()), ("floor_", ()), ("ceil_", ()), ("round_", ()),
    ("tanh_", ()), ("flatten_", ()), ("reshape_", ([3, 2],)),
    ("squeeze_", ([0],)), ("unsqueeze_", ([0, 3],)),
])
def test_inplace_forms(name, args):
    """Each in-place method rebinds the value as the reference's does, on
    a leaf that requires grad too."""
    a = R("inplace_" + name).n(2, 3)
    if name == "squeeze_":
        a = a[:1]
    for grad in (False, True):
        x = pt.to_tensor(a, stop_gradient=not grad)
        y = pp.to_tensor(a, stop_gradient=not grad)
        out_r = getattr(x, name)(*args)
        out_p = getattr(y, name)(*args)
        assert out_p is y and out_r is x
        assert list(y.shape) == x.shape
        assert_close(y, x)
        assert y.requires_grad == grad


def test_sqrt_reciprocal_inplace_and_scatter_():
    a = R("sqrt_").u(2, 3)
    for name in ("sqrt_", "reciprocal_"):
        x, y = pt.to_tensor(a), pp.to_tensor(a)
        getattr(x, name)()
        getattr(y, name)()
        assert_close(y, x)
    base = np.zeros((4, 2), np.float32)
    idx = np.array([2, 0], np.int64)
    upd = R("scatter_").n(2, 2)
    x, y = pt.to_tensor(base), pp.to_tensor(base)
    x.scatter_(pt.to_tensor(idx), pt.to_tensor(upd))
    y.scatter_(pp.to_tensor(idx), pp.to_tensor(upd))
    assert_close(y, x)
    z = pp.to_tensor(base)  # torch's scatter_(dim, index, src)
    z.scatter_(0, torch.tensor([[1, 3]]), torch.ones(1, 2))
    assert z.numpy()[1, 0] == 1.0 and z.numpy()[3, 1] == 1.0


def test_inplace_on_a_graph_tensor_raises():
    for P in (pt, pp):
        x = P.to_tensor([1.0], stop_gradient=False)
        y = x * 2
        with pytest.raises(ValueError, match="non-leaf"):
            y.add_(1.0)
        with pytest.raises(ValueError, match="non-leaf"):
            y.scale_(2.0)


def test_method_table_covers_the_references():
    """Every op method the reference's Tensor has, the port's has."""
    names = [n for n in dir(pt.Tensor) if not n.startswith("_")]
    missing = [n for n in names if not hasattr(pp.Tensor, n)]
    # the reference's own attributes that have no port meaning
    assert set(missing) <= {"value", "process_mesh", "placements",
                            "persistable", "trainable", "coalesce",
                            "to_sparse_coo", "to_sparse_csr"}, missing


def test_methods_against_the_reference():
    a = R("method_calls").n(3, 4)
    calls = [
        ("matmul", (np.ones((4, 2), np.float32),), {}),
        ("sum", (), dict(axis=1)), ("mean", (), dict(axis=0, keepdim=True)),
        ("max", (), dict(axis=1)), ("transpose", ([1, 0],), {}),
        ("reshape", ([2, 6],), {}), ("flatten", (), {}),
        ("split", (2,), dict(axis=1)), ("unsqueeze", (0,), {}),
        ("tile", ([2, 1],), {}), ("expand", ([2, 3, 4],), {}),
        ("flip", ([0],), {}), ("roll", (1,), {}), ("cumsum", (), {}),
        ("sort", (), dict(axis=0)), ("argsort", (), dict(descending=True)),
        ("topk", (2,), {}), ("prod", (), dict(axis=1)),
        ("std", (), dict(axis=1)), ("var", (), {}), ("norm", (), {}),
        ("abs", (), {}), ("exp", (), {}), ("clip", (-0.1, 0.1), {}),
        ("scale", (2.0,), {}), ("pow", (2.0,), {}), ("add", (1.0,), {}),
        ("argmax", (), dict(axis=1)), ("t", (), {}),
        ("squeeze", (), {}), ("chunk", (2,), dict(axis=1)),
        ("gather", (np.array([2, 0], np.int64),), {}),
        ("median", (), dict(axis=1)), ("logsumexp", (), {}),
        ("diff", (), {}), ("kron", (np.ones((2, 1), np.float32),), {}),
        ("astype", ("int32",), {}),
    ]
    for name, args, kw in calls:
        for P in (pt, pp):
            x = P.to_tensor(a)
            pa = [P.to_tensor(v) if isinstance(v, np.ndarray) else v
                  for v in args]
            out = getattr(x, name)(*pa, **kw)
            if P is pt:
                ref = out
        outs_r = ref if isinstance(ref, (list, tuple)) else [ref]
        outs_p = out if isinstance(out, (list, tuple)) else [out]
        assert len(outs_r) == len(outs_p), name
        for p, r in zip(outs_p, outs_r):
            assert_close(p, r, what=name)
    cond = pp.to_tensor(a) > 0
    assert_close(cond.where(pp.to_tensor(a), pp.to_tensor(a) * 0),
                 (pt.to_tensor(a) > 0).where(pt.to_tensor(a),
                                             pt.to_tensor(a) * 0))


def test_torchs_own_code_gets_torchs_forms():
    """Torch's functions that call tensor methods (``torch.split``,
    ``torch.Tensor.__repr__``, ``torch.nn.functional``) keep working on a
    port tensor."""
    x = pp.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4))
    assert [p.shape[0] for p in torch.split(x, 2)] == [2, 1]
    assert "Tensor" in repr(x)
    y = torch.nn.functional.normalize(x, dim=1)
    assert isinstance(y, pp.Tensor)
    v, i = torch.max(x, dim=1)
    assert i.tolist() == [3, 3, 3]
    assert torch.std_mean(x, dim=0)[1].shape == (4,)


_THIRD_PARTY = """
import torch

def calls(x):
    return (x.split(2, 1), x.max(1), x.sort(1), x.median(), x.add_(1.0))
"""


@pytest.mark.parametrize("imports_port", [False, True])
def test_method_form_follows_the_calling_code(imports_port):
    """The same positional calls, which fit both signatures, from a library
    module outside torch and this package: torch's forms when the module
    does not import ``paddle_tpu_torch`` (a torch library), the
    reference's when it does (Paddle code)."""
    import types

    mod = types.ModuleType("some_library")
    src = _THIRD_PARTY
    if imports_port:
        src = "import paddle_tpu_torch as paddle\n" + src
    exec(compile(src, "some_library.py", "exec"), mod.__dict__)
    a = np.arange(18, dtype=np.float32).reshape(3, 6)[:, ::-1].copy()
    x = pp.to_tensor(a)
    split, mx, srt, med, added = mod.calls(x)
    if imports_port:  # Paddle's: 2 sections, values, mean of the middle
        assert [list(p.shape) for p in split] == [[3, 3], [3, 3]]
        assert_close(mx, a.max(1))
        assert_close(srt, np.sort(a, 1))
        assert float(med) == 8.5
    else:  # torch's: chunks of 2, (values, indices), the lower middle
        assert [list(p.shape) for p in split] == [[3, 2]] * 3
        assert mx.indices.tolist() == [0, 0, 0]
        assert srt.indices[0].tolist() == [5, 4, 3, 2, 1, 0]
        assert float(med) == 8.0
    # the in-place form: the same values either way (torch's writes in
    # place; the reference's rebinds)
    assert added is x and float(x[0, 0]) == a[0, 0] + 1.0


def test_layers_keep_the_input_type():
    """Given plain tensors, a port layer returns exactly ``torch.Tensor``;
    given a port ``Tensor``, the same values as a port ``Tensor``."""
    pp.seed(0)
    net = pp.nn.Sequential(pp.nn.Linear(8, 6), pp.nn.ReLU(),
                           pp.nn.LayerNorm(6), pp.nn.Linear(6, 3))
    conv = pp.nn.Conv2D(2, 3, 3, padding=1)
    a = R("layers").n(4, 8)
    img = R("layers_img").n(1, 2, 5, 5)
    plain = net(torch.from_numpy(a))
    assert type(plain) is torch.Tensor
    port = net(pp.to_tensor(a))
    assert type(port) is pp.Tensor
    assert torch.equal(plain, port.as_subclass(torch.Tensor))
    assert type(conv(torch.from_numpy(img))) is torch.Tensor
    assert torch.equal(conv(torch.from_numpy(img)),
                       conv(pp.to_tensor(img)).as_subclass(torch.Tensor))
    label = np.array([0, 2, 1, 1], np.int64)
    lp = pp.nn.functional.cross_entropy(port, pp.to_tensor(label))
    lt = pp.nn.functional.cross_entropy(plain, torch.from_numpy(label))
    assert type(lt) is torch.Tensor and type(lp) is pp.Tensor
    assert float(lp) == float(lt)


def test_places_and_devices():
    assert pp.CPUPlace() == pp.CPUPlace(0) and pp.CUDAPlace(1).get_device_id() == 1
    assert repr(pp.CUDAPlace(0)) == "Place(gpu:0)" == repr(pt.CUDAPlace(0))
    with pytest.raises(ValueError, match="TPU"):
        pp.TPUPlace(0)
    with pytest.raises(ValueError, match="TPU"):
        pp.set_device("tpu")
    prev = pp.set_device("gpu:0")
    try:
        assert pp.get_device() == "cuda:0"
        assert pp.device.expected_place() == pp.CUDAPlace(0)
    finally:
        pp.set_device(prev)
    assert pp.get_device() == "cpu"
    assert not pp.is_compiled_with_tpu()
    assert pp.is_compiled_with_cuda() == torch.cuda.is_available()


def test_dtypes_and_infos():
    assert pp.float32 is torch.float32 and pp.bool_ is torch.bool
    from paddle_tpu_torch.core.dtype import convert_dtype

    assert convert_dtype("bf16") is torch.bfloat16
    assert convert_dtype(np.float16) is torch.float16
    for dt in ("int8", "int32", "uint8", "int16"):
        assert vars(pp.iinfo(dt)) == vars(pt.iinfo(dt))
    for dt in ("float32", "float16", "bfloat16"):
        got, want = vars(pp.finfo(dt)), vars(pt.finfo(dt))
        assert got == want, dt
    with pytest.raises(ValueError):
        convert_dtype("float128")
