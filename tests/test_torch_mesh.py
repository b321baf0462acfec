"""The port's hybrid mesh and distributed environment
(``paddle_tpu_torch/parallel/mesh.py``, ``distributed/env.py``) against
the JAX package's, on the CPU.

The port's mesh is built in 8 spawned gloo ranks
(``experiments.mesh_train.mesh_layout``); the JAX mesh over the 8 virtual
CPU devices in this process. Rank r must sit where JAX device r sits, and
a host array sharded by a spec must give rank r exactly JAX device r's
shard; the layout error must read as the reference's.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

import paddle_tpu_torch as pp
from paddle_tpu.parallel import create_hybrid_mesh as jmesh
from paddle_tpu.parallel import mesh as jm
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu_torch.distributed import env
from paddle_tpu_torch.experiments import mesh_train
from paddle_tpu_torch.parallel import mesh as pm

LAYOUT = dict(dp=2, sharding=2, mp=2)
SPECS = [(("dp", "sharding"), None, "mp"), ("mp", None, ("dp", "sharding")),
         (None, "sharding", "dp"), (None, None, None)]
HOST = np.arange(8 * 4 * 8, dtype=np.float32).reshape(8, 4, 8)


@pytest.fixture(scope="module")
def run():
    res = mesh_train.spawn(mesh_train.mesh_layout, 8,
                           args=(LAYOUT, HOST, SPECS), timeout=120)
    mesh = jmesh(**LAYOUT)
    jset_mesh(None)
    return mesh, res


def test_axes_are_the_reference_axes():
    assert pm.HYBRID_AXES == jm.HYBRID_AXES


def test_rank_sits_where_the_reference_puts_device_r(run):
    mesh, res = run
    for r in res:
        coord = tuple(r["coord"][a] for a in pm.HYBRID_AXES)
        assert mesh.devices[coord].id == r["rank"]


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_host_to_global_gives_device_rs_shard(run, i):
    mesh, res = run
    arr = jax.device_put(HOST, NamedSharding(mesh, JP(*SPECS[i])))
    by_device = {s.device.id: np.asarray(s.data)
                 for s in arr.addressable_shards}
    for r in res:
        np.testing.assert_array_equal(r["shards"][i], by_device[r["rank"]])
        np.testing.assert_array_equal(r["back"][i], HOST)


def test_wrong_degrees_raise_the_reference_error(run):
    _, res = run
    with pytest.raises(ValueError) as e:
        jmesh(dp=3)
    jset_mesh(None)
    assert res[0]["wrong"] == str(e.value)


def test_groups_only_for_the_named_axis_sets(run):
    """The mesh makes a group for each set of ``AXIS_SETS`` cut to its
    live axes (here dp, sharding and mp of 2): five, not one for every
    subset; another set is refused by name."""
    _, res = run
    for r in res:
        assert r["groups"] == {("dp",): 2, ("sharding",): 2, ("mp",): 2,
                               ("dp", "sharding"): 4,
                               ("dp", "sharding", "mp"): 8,
                               ("dp", "sharding", "sep"): 4,
                               pm.HYBRID_AXES: 8}
        assert "('sharding', 'mp')" in r["unmade"]


def test_axis_size_and_named_sharding(run):
    _, res = run
    assert res[0]["axis_size_mp"] == 2
    assert tuple(res[0]["named"]) == ("mp",)
    assert pm.mesh_axis_size("mp", None) == 1
    assert pm.named_sharding(pm.P("mp"), None) is None


def test_partition_spec_is_the_reference_tuple():
    for s in SPECS:
        assert tuple(pm.P(*s)) == tuple(JP(*s))
    assert pm.spec_axes(pm.P("mp", ("dp", "sharding"))) == (
        "dp", "sharding", "mp")
    x = torch.ones(2)
    assert pm.with_sharding_constraint(x, pm.P("mp")) is x


def test_parallel_env_reads_the_launcher_contract(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "8")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1,b:2")
    e = env.ParallelEnv()
    assert (e.rank, e.world_size, e.nranks, e.local_rank) == (3, 8, 8, 3)
    assert e.trainer_endpoints == ["a:1", "b:2"]
    assert env.get_rank() == 3 and env.get_world_size() == 8
    assert not env.is_initialized()


def test_world_of_one_without_a_store_and_unported_names():
    """``init_parallel_env(device="cpu")`` in a world of one joins gloo
    through an in-process store; the reference's other names raise."""
    import torch.distributed as dist

    e = pp.distributed.init_parallel_env(device="cpu")
    try:
        assert dist.get_backend() == "gloo" and e.world_size == 1
        assert pp.distributed.init_parallel_env() .rank == 0
        mesh = pm.create_hybrid_mesh(device="cpu", set_as_global=False)
        assert mesh.mesh.numel() == 1 and pm.axis_group(mesh, "mp") is None
    finally:
        dist.destroy_process_group()
    for name in ("launch", "auto_parallel", "fleet.elastic",
                 "fleet.meta_parallel.PipelineLayer"):
        obj = pp.distributed
        with pytest.raises(NotImplementedError, match="Queue A item 5"):
            for part in name.split("."):
                obj = getattr(obj, part)
