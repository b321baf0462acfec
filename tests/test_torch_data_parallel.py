"""The port's ``DataParallel`` and ``SyncBatchNorm`` over a group
(``paddle_tpu_torch/distributed/parallel.py``, ``nn/layer/norm.py``) on
2 gloo ranks on the CPU (``tests/torch_dist_common.py``), against the JAX
package on the same numpy weights and inputs.

- The bucket layout (how many, which parameters) at three
  ``comm_buffer_size``s equals the reference's built on ``Group([0, 1])``
  in this process, as ``tests/test_data_parallel.py`` builds it.
- Each rank's synced gradients equal the mean of the reference's two
  per-shard gradients (fp32, 1e-6 of the larger of 1 and the largest
  magnitude); ``no_sync``'s local gradients equal
  each shard's, and a synced backward after two unsynced ones reduces the
  sum; a ``paddle.grad`` pass flushes nothing; a loss made by plain torch
  from the wrapper's outputs syncs; ``find_unused_parameters`` False
  raises the reference's error, True syncs zeros for the unused layer.
- ``SyncBatchNorm`` on the two ranks' halves equals the reference's
  ``BatchNorm2D`` on the whole batch (output, input gradient, weight and
  bias gradients, running statistics; NCHW and NHWC); on one rank it is
  the port's ``BatchNorm2D``, bit for bit.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as pp
from paddle_tpu.distributed.collective import Group as JGroup
from paddle_tpu_torch.device import set_device
from torch_dist_common import SIZES, W, inputs, world


def _close(got, want):
    """fp32 to 1e-6, absolute up to magnitude 1 and relative to the
    largest |want| past it (two fp32 implementations' sum orders)."""
    np.testing.assert_allclose(
        got, want, rtol=1e-6, atol=1e-6 * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def ranks():
    return [r["dp"] for r in world()]


@pytest.fixture(autouse=True)
def _clear_reference_callbacks():
    from paddle_tpu.core import autograd

    yield
    autograd._backward_end_callbacks.clear()


def _jmodel(weights):
    layers = []
    for w, b in weights:
        lin = jpaddle.nn.Linear(*w.shape)
        lin.weight.set_value(w)
        lin.bias.set_value(b)
        layers.append(lin)
    return jpaddle.nn.Sequential(*layers)


def _jshard_grads(weights, x, first_only=False):
    """The reference's gradients of mean(model(shard) ** 2), per shard."""
    out = []
    for r in range(W):
        m = _jmodel(weights)
        k = x.shape[0] // W
        xs = jpaddle.to_tensor(x[r * k:(r + 1) * k])
        y = m[0](xs) if first_only else m(xs)
        jpaddle.mean(y ** 2).backward()
        out.append([None if p.grad is None else p.grad.numpy()
                    for p in m.parameters()])
    return out


@pytest.fixture(scope="module")
def shard_grads():
    mlp, x = inputs()["dp"][:2]
    return _jshard_grads(mlp, x)


@pytest.mark.parametrize("i", range(len(SIZES)))
def test_bucket_layout_equals_the_references(ranks, i):
    mlp = inputs()["dp"][0]
    m = _jmodel(mlp)
    idx = {id(p): n for n, p in enumerate(m.parameters())}
    dp = jpaddle.DataParallel(m, comm_buffer_size=SIZES[i],
                              group=JGroup([0, 1], axis_name="dp", id=990))
    want = [[idx[id(p)] for p in b.params] for b in dp._buckets]
    for res in ranks:
        assert res["layouts"][SIZES[i]] == want


def test_synced_gradients_are_the_mean_of_the_shards(ranks, shard_grads):
    mean = [(a + b) / 2 for a, b in zip(*shard_grads)]
    for res in ranks:
        assert res["bucket_syncs"] == res["buckets"] == 6 // 2
        for got, want in zip(res["synced"], mean):
            _close(got, want)


def test_no_sync_accumulates_then_one_sync(ranks, shard_grads):
    mean = [(a + b) / 2 for a, b in zip(*shard_grads)]
    for r, res in enumerate(ranks):
        for got, want in zip(res["unsynced"], shard_grads[r]):
            _close(got, want)
        for got, want in zip(res["no_sync_then_sync"], mean):
            _close(got, 3 * want)


def test_grad_capture_does_not_flush_and_plain_losses_do(ranks):
    for res in ranks:
        syncs, untouched = res["grad_capture"]
        assert syncs == 0 and all(untouched)
        assert res["plain_loss_synced"] == res["buckets"]


def test_find_unused_parameters_false_raises_the_references_error(ranks):
    partial, xp = inputs()["dp"][3:5]

    class Partial(jpaddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.seq = _jmodel(partial)

        def forward(self, x):
            return self.seq[0](x)

    net = Partial()
    dp = jpaddle.DataParallel(net, group=JGroup([0, 1], axis_name="dp",
                                                id=991))
    loss = jpaddle.mean(dp(jpaddle.to_tensor(xp[:2])) ** 2)
    with pytest.raises(RuntimeError) as e:
        loss.backward()
    jname = net.parameters()[-1].name
    for res in ranks:
        msg, names = res["unused_False"]
        assert msg == str(e.value).replace(jname, names[-1])


def test_find_unused_parameters_true_syncs_zeros(ranks):
    partial, xp = inputs()["dp"][3:5]
    g = _jshard_grads(partial, xp, first_only=True)
    for res in ranks:
        got = res["unused_True"]
        for i in range(2):
            _close(got[i], (g[0][i] + g[1][i]) / 2)
        for i in range(2, 4):
            np.testing.assert_array_equal(got[i], np.zeros_like(got[i]))


@pytest.fixture(scope="module")
def whole_batch_bn():
    """The reference's ``BatchNorm2D`` (NCHW) on the whole batch."""
    c = inputs()["dp"][5][0]
    bn = jpaddle.nn.BatchNorm2D(3)
    bn.weight.set_value(c["weight"])
    bn.bias.set_value(c["bias"])
    x = jpaddle.to_tensor(c["x"], stop_gradient=False)
    y = bn(x)
    (y * jpaddle.to_tensor(c["cot"])).sum().backward()
    return {"y": y.numpy(), "x_grad": x.grad.numpy(),
            "w_grad": bn.weight.grad.numpy(),
            "b_grad": bn.bias.grad.numpy(), "mean": bn._mean.numpy(),
            "variance": bn._variance.numpy()}


@pytest.mark.parametrize("case", [0, 1, 2],
                         ids=["NCHW", "NHWC", "NHWC_in_DataParallel"])
def test_sync_batch_norm_is_whole_batch_batch_norm(ranks, whole_batch_bn,
                                                   case):
    want = dict(whole_batch_bn)
    if case >= 1:  # the same batch, channels last
        for k in ("y", "x_grad"):
            want[k] = want[k].transpose(0, 2, 3, 1)
    for res in ranks:
        assert res["bn"][case]["group"] == (case == 2)
        for k, v in want.items():
            np.testing.assert_allclose(res["bn"][case][k], v, rtol=1e-5,
                                       atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_one_rank_sync_batch_norm_is_batch_norm_bit_for_bit(fmt):
    prev = set_device("cpu")
    try:
        pp.seed(3)
        bn = pp.nn.BatchNorm2D(4, data_format=fmt)
        sbn = pp.nn.SyncBatchNorm.convert_sync_batchnorm(
            pp.nn.BatchNorm2D(4, data_format=fmt))
        rng = np.random.RandomState(1)
        w, b = rng.rand(4).astype(np.float32), rng.randn(4).astype(np.float32)
        for m in (bn, sbn):
            with torch.no_grad():
                m.weight.copy_(torch.from_numpy(w))
                m.bias.copy_(torch.from_numpy(b))
        x = rng.randn(3, 4, 6, 6).astype(np.float32)
        if fmt == "NHWC":
            x = x.transpose(0, 2, 3, 1).copy()
        outs = []
        for m in (bn, sbn):
            xt = torch.from_numpy(x).requires_grad_()
            y = m(xt)
            (y * y).sum().backward()
            outs.append([y.detach(), xt.grad, m.weight.grad, m.bias.grad,
                         m._mean, m._variance])
        assert isinstance(sbn, pp.nn.SyncBatchNorm)
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    finally:
        set_device(prev)


def test_world_of_one_data_parallel_is_the_model():
    prev = set_device("cpu")
    try:
        lin = pp.nn.Linear(3, 2)
        dp = pp.DataParallel(lin)
        assert dp._buckets == [] and dp._group.nranks == 1
        x = torch.ones(2, 3)
        assert torch.equal(dp(x), lin(x))
        assert dp.state_dict().keys() == lin.state_dict().keys()
        assert dp.scale_loss(x) is x
    finally:
        set_device(prev)


def test_gradient_sync_utilities_and_a_dead_model(ranks):
    """``fused_allreduce_gradients`` averages the ranks' gradients,
    ``broadcast_dp_parameters`` gives every rank the first one's
    parameters, and a collected ``DataParallel`` unregisters its backward
    callback (the registry holds it weakly)."""
    mean = np.mean([10.0 * (r + 1) for r in range(W)])
    for res in ranks:
        u = res["util"]
        for g in u["grads"]:
            np.testing.assert_array_equal(g, np.full_like(g, mean))
        for p in u["params"]:
            np.testing.assert_array_equal(p, np.ones_like(p))
        before, made, after = u["callbacks"]
        assert made == before + 1 and after == before
