"""The port's collectives (``paddle_tpu_torch/distributed/collective.py``,
``communication``) and ``distributed.spawn``, on the CPU.

Two ranks started by the port's ``spawn`` (``tests/torch_dist_common.py``)
join their world through ``init_parallel_env()`` from the ``PADDLE_*``
variables ``spawn`` sets, and run every collective: the results are the
reference's documented ones (``tests/test_multiproc_scale.py``'s worker
assertions, at world 2: sums, gather order, MAX reduce-scatter, broadcast
from ``src=1``, ``alltoall``, point to point). A world of one is the
identity, as the reference's ``single`` path: held against the JAX
package's collectives in this process.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu_torch.distributed as pdist
from torch_dist_common import W, world


@pytest.fixture(scope="module")
def ranks():
    return [r["collective"] for r in world()]


def _f(v, n=4):
    return np.full((n,), float(v), np.float32)


def test_spawn_sets_the_environment_contract(ranks):
    for r, res in enumerate(ranks):
        assert res["env"] == (r, W, r, W)
        assert res["backend"] == "GLOO"
        assert res["staged"] == {}  # CPU tensors: nothing staged


@pytest.mark.parametrize("op,want", [("SUM", 3.0), ("AVG", 1.5),
                                     ("MAX", 2.0), ("MIN", 1.0),
                                     ("PROD", 2.0)])
def test_all_reduce_in_place(ranks, op, want):
    for res in ranks:
        value, same = res[f"all_reduce_{op}"]
        np.testing.assert_array_equal(value, _f(want))
        assert same  # written into the caller's tensor, which is returned


def test_all_reduce_keeps_bf16(ranks):
    for res in ranks:
        value, dtype = res["all_reduce_bf16"]
        assert dtype == "torch.bfloat16"
        np.testing.assert_array_equal(value, _f(3))


def test_gathers_in_rank_order(ranks):
    for r, res in enumerate(ranks):
        lst, cat = res["all_gather"]
        for i in range(W):
            np.testing.assert_array_equal(lst[i], _f(i, 2))
        np.testing.assert_array_equal(cat, np.concatenate(
            [_f(i, 2) for i in range(W)]))
        assert res["all_gather_object"] == [{"rank": i} for i in range(W)]
        # gather fills the list on dst only
        assert len(res["gather"]) == (W if r == 0 else 0)
        for i, g in enumerate(res["gather"]):
            np.testing.assert_array_equal(g, _f(i, 2))


def test_broadcast_and_scatter_from_src_1(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["broadcast"], _f(1 * 7 + 1, 3))
        np.testing.assert_array_equal(res["scatter"], _f(100 + r, 2))
        assert res["broadcast_object_list"] == [{"a": 1}, 1]
        assert res["scatter_object_list"] == [{"i": r}]


def test_reduce_scatter(ranks):
    base = np.arange(1, 2 * W + 1, dtype=np.float32)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["reduce_scatter_max"],
                                      (base + W - 1)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(
            res["reduce_scatter_sum"],
            sum(base + i for i in range(W))[2 * r:2 * r + 2])
        # the list form: piece r summed over the ranks, into the out buffer
        np.testing.assert_array_equal(
            res["reduce_scatter_list"],
            _f(sum(10 * r + i for i in range(W)), 2))
        np.testing.assert_array_equal(res["reduce"], _f(3))


def test_alltoall(ranks):
    for r, res in enumerate(ranks):
        for j, o in enumerate(res["alltoall"]):
            np.testing.assert_array_equal(o, _f(10 * j + r, 2))
        # row j of rank i is i * W + j; rank r receives row r of each rank
        want = (np.arange(W, dtype=np.float32) * W + r)[:, None].repeat(2, 1)
        np.testing.assert_array_equal(res["alltoall_single"], want)
        np.testing.assert_array_equal(res["alltoall_single_out"], want)


def test_point_to_point_addresses_global_ranks(ranks):
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["send_recv"],
                                      _f(5 if r == 1 else 0, 3))
        prev = (r - 1) % W
        np.testing.assert_array_equal(res["isend_irecv"], _f(20 + prev, 2))
        np.testing.assert_array_equal(res["batch_isend_irecv"],
                                      _f(30 + prev, 2))
        # the reference's ring forms: the previous rank's payload
        np.testing.assert_array_equal(res["send_next"], _f(40 + prev, 2))
        np.testing.assert_array_equal(res["recv_prev"], _f(50 + prev, 2))


def test_stream_forms_and_new_group(ranks):
    for r, res in enumerate(ranks):
        value, synced = res["stream_all_reduce"]
        np.testing.assert_array_equal(value, _f(3))
        assert synced is None
        ranks_, n, rank, found, value = res["new_group"]
        assert (ranks_, n, rank, found) == (list(range(W)), W, r, True)
        np.testing.assert_array_equal(value, _f(3))


def _pair(v):
    return (jpaddle.to_tensor(np.asarray(v, np.float32)),
            torch.tensor(np.asarray(v, np.float32)))


@pytest.mark.parametrize("op", ["SUM", "AVG", "MAX", "MIN", "PROD"])
def test_world_of_one_all_reduce_is_the_references_identity(op):
    j, p = _pair([1.5, -2.0, 3.0])
    jout = jdist.all_reduce(j, op=getattr(jdist.ReduceOp, op))
    pout = pdist.all_reduce(p, op=getattr(pdist.ReduceOp, op))
    assert pout is p
    np.testing.assert_array_equal(pout.numpy(), jout.numpy())


def test_world_of_one_matches_the_reference_single_path():
    """Every other collective on a group of one: the reference's result,
    touching no backend (no process group exists here)."""
    assert not torch.distributed.is_initialized()
    assert pdist.get_default_group().nranks == 1
    j, p = _pair([1.0, 2.0])
    jl, pl = [], []
    jdist.all_gather(jl, j)
    pdist.all_gather(pl, p)
    assert [t.numpy().tolist() for t in pl] == \
        [t.numpy().tolist() for t in jl]
    for name in ("broadcast", "reduce"):
        np.testing.assert_array_equal(
            getattr(pdist, name)(p).numpy(), getattr(jdist, name)(j).numpy())
    np.testing.assert_array_equal(pdist.reduce_scatter(p).numpy(),
                                  jdist.reduce_scatter(j).numpy())
    js, ps = _pair([0.0, 0.0])
    jdist.scatter(js, [_pair([7.0, 8.0])[0]])
    pdist.scatter(ps, [torch.tensor([7.0, 8.0])])
    np.testing.assert_array_equal(ps.numpy(), js.numpy())
    jo, po = [], []
    ja = jdist.alltoall([_pair([1.0, 2.0])[0]], jo)
    pa = pdist.alltoall([torch.tensor([1.0, 2.0])], po)
    np.testing.assert_array_equal(pa.numpy(), ja.numpy())
    assert [t.numpy().tolist() for t in po] == \
        [t.numpy().tolist() for t in jo]
    jg, pg = [], []
    jdist.gather(j, jg)
    pdist.gather(p, pg)
    assert [t.numpy().tolist() for t in pg] == \
        [t.numpy().tolist() for t in jg]
    assert pdist.all_gather_object([], {"a": 1}) == \
        jdist.all_gather_object([], {"a": 1})
    assert pdist.broadcast_object_list([3, "x"]) == \
        jdist.broadcast_object_list([3, "x"])
    jout, pout = [], []
    jdist.scatter_object_list(jout, [{"i": 0}])
    pdist.scatter_object_list(pout, [{"i": 0}])
    assert pout == jout
    np.testing.assert_array_equal(pdist.send_next(p).numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(pdist.recv_prev(p).numpy(), [1.0, 2.0])
    pdist.barrier()
    with pytest.raises(NotImplementedError, match="unequal split"):
        pdist.alltoall_single(p, None, in_split_sizes=[1, 3])
    with pytest.raises(NotImplementedError, match="unequal split"):
        jdist.alltoall_single(j, None, in_split_sizes=[1, 3])
