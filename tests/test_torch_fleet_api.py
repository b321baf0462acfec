"""The port's Fleet facade and its pieces against the JAX package, in one
process on the CPU (no spawned ranks; the multi-rank cases are in
``test_torch_collective.py``, ``test_torch_data_parallel.py`` and
``test_torch_group_sharded.py``).

- ``CommunicateTopology``: coordinates, ``get_comm_list``,
  ``get_axis_list`` and ``get_rank_from_stage`` equal the reference's for
  degrees (2, 1, 2, 2, 1) and (1, 2, 1, 2, 2); ``get_parallel_mode`` for
  each mode's degrees; ``fleet.init`` at a world of one (gloo on the CPU)
  and the HCG's getters against the reference's.
- ``DistributedStrategy``: the reference's JSON, a round trip through a
  file, dict-style configs.
- ``distributed_optimizer``'s chain of wrappers for each meta-optimizer
  flag equals the reference's; the lamb swap keeps the rate and decay; a
  global-norm clip becomes ``HybridParallelClipGrad`` on the innermost
  optimizer.
- ``GradientMerge``, ``LocalSGD``, ``DGC``, ``FP16AllReduce`` and ``ASP``
  steps at a world of one against the reference's on the same parameters
  and gradients (fp32, 1e-6; ASP's masks equal).
- ``RNGStatesTracker``: the reference's errors; named streams that replay
  from their seed and leave the global stream as it was;
  ``model_parallel_random_seed``'s streams.
- ``recompute`` and ``recompute_sequential`` against the plain function
  (with dropout, so the replay must restore the generators): loss and
  every gradient bit for bit.
"""

import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as pp
from paddle_tpu.distributed.fleet import Fleet as JFleet
from paddle_tpu.distributed.fleet.base import topology as jtopo
from paddle_tpu.distributed.fleet.base.distributed_strategy import (
    DistributedStrategy as JStrategy,
)
from paddle_tpu.distributed.fleet.meta_optimizers import (
    strategy_optimizers as jso,
)
from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import (
    random as jrandom,
)
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.distributed import fleet as pfleet
from paddle_tpu_torch.distributed.fleet.base import topology as ptopo
from paddle_tpu_torch.distributed.fleet.meta_optimizers import (
    strategy_optimizers as pso,
)
from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers import (
    random as prandom,
)

NAMES = ("data", "pipe", "sharding", "model", "sep")


@pytest.fixture
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.mark.parametrize("dims", [(2, 1, 2, 2, 1), (1, 2, 1, 2, 2)])
def test_topology_equals_the_references(dims):
    j = jtopo.CommunicateTopology(NAMES, dims)
    p = ptopo.CommunicateTopology(NAMES, dims)
    assert p.coordinate == j.coordinate
    assert p.world_size() == j.world_size() == int(np.prod(dims))
    for name in NAMES:
        assert p.get_dim(name) == j.get_dim(name)
        assert p.get_comm_list(name) == j.get_comm_list(name)
        for i in range(p.get_dim(name)):
            assert p.get_axis_list(name, i) == j.get_axis_list(name, i)
    for r in range(p.world_size()):
        assert p.get_coord(r) == j.get_coord(r)
        assert p.get_rank_from_stage(r, pipe=dims[1] - 1) == \
            j.get_rank_from_stage(r, pipe=dims[1] - 1)


@pytest.mark.parametrize("dp,pp_,sharding,mp", [
    (2, 1, 1, 1), (1, 1, 2, 1), (2, 2, 1, 1), (1, 1, 1, 2), (2, 1, 2, 2),
    (1, 1, 1, 1)])
def test_parallel_mode_equals_the_references(dp, pp_, sharding, mp):
    ns = SimpleNamespace(_dp=dp, _pp=pp_, _sharding=sharding, _mp=mp, _sep=1)
    assert ptopo.HybridCommunicateGroup.get_parallel_mode(ns) == \
        jtopo.HybridCommunicateGroup.get_parallel_mode(ns)


@pytest.fixture
def world_of_one(cpu):
    """``fleet.init`` at a world of one (gloo on the CPU), torn down
    after."""
    import torch.distributed as dist

    from paddle_tpu_torch.parallel import set_mesh

    pfleet.init(is_collective=True, device="cpu")
    try:
        yield pfleet.fleet
    finally:
        ptopo.set_hybrid_communicate_group(None)
        set_mesh(None)
        dist.destroy_process_group()


def test_fleet_init_world_of_one(world_of_one):
    from paddle_tpu.parallel import set_mesh as jset_mesh

    hcg = world_of_one.get_hybrid_communicate_group()
    jhcg = jtopo.HybridCommunicateGroup(dp=1)
    try:
        for getter in ("get_parallel_mode", "get_data_parallel_world_size",
                       "get_data_parallel_rank", "get_model_parallel_rank",
                       "get_model_parallel_world_size", "get_stage_id",
                       "get_pipe_parallel_world_size", "is_first_stage",
                       "is_last_stage", "get_sharding_parallel_rank",
                       "get_sharding_parallel_world_size",
                       "get_sep_parallel_rank", "get_sep_parallel_world_size",
                       "get_data_parallel_group_src_rank",
                       "get_model_parallel_group_src_rank",
                       "get_sharding_parallel_group_src_rank"):
            assert getattr(hcg, getter)() == getattr(jhcg, getter)(), getter
        assert hcg.get_rank_from_stage(0) == jhcg.get_rank_from_stage(0)
        for g in ("data", "model", "pipe", "sharding", "sep"):
            group = getattr(hcg, f"get_{g}_parallel_group" if g != "pipe"
                            else "get_pipe_parallel_group")()
            assert group.ranks == [0] and group.nranks == 1
        assert pfleet.worker_index() == 0 and pfleet.worker_num() == 1
        assert pfleet.is_first_worker()
        model = pp.nn.Linear(2, 2)
        assert pfleet.distributed_model(model) is model
        pfleet.barrier_worker()
    finally:
        jtopo.set_hybrid_communicate_group(None)
        jset_mesh(None)


def test_strategy_round_trip_equals_the_references(tmp_path):
    p, j = pfleet.DistributedStrategy(), JStrategy()
    for s in (p, j):
        s.hybrid_configs = {"dp_degree": 2, "mp_degree": 4}
        s.sharding = True
        s.gradient_merge_configs = {"k_steps": 4, "avg": False}
    assert json.loads(p.to_json()) == json.loads(j.to_json())
    assert p.hybrid_configs.mp_degree == 4
    path = str(tmp_path / "strategy.prototxt")
    p.save_to_prototxt(path)
    q = pfleet.DistributedStrategy()
    q.load_from_prototxt(path)
    assert q.to_json() == p.to_json()
    assert pfleet.DistributedStrategy.from_json(p.to_json()) == p


FLAGS = [{}, {"lamb": True}, {"dgc": True}, {"localsgd": True},
         {"gradient_merge": True},
         {"lamb": True, "dgc": True, "localsgd": True,
          "gradient_merge": True}]


def _chain(opt):
    names = []
    while True:
        names.append(type(opt).__name__)
        if not hasattr(opt, "_inner_opt"):
            return names
        opt = opt.__dict__["_inner_opt"]


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "+".join(f) or "none")
def test_distributed_optimizer_chain_equals_the_references(world_of_one,
                                                           flags):
    js, ps = JStrategy(), pfleet.DistributedStrategy()
    for s in (js, ps):
        for k, v in flags.items():
            setattr(s, k, v)
    jf = JFleet()
    jf._is_initialized, jf._hcg, jf._strategy = True, None, js
    jlin = jpaddle.nn.Linear(2, 2)
    jopt = jf.distributed_optimizer(jpaddle.optimizer.AdamW(
        learning_rate=0.3, parameters=jlin.parameters(), weight_decay=0.05,
        grad_clip=jpaddle.nn.ClipGradByGlobalNorm(1.0)))
    plin = pp.nn.Linear(2, 2)
    popt = pfleet.distributed_optimizer(pp.optimizer.AdamW(
        learning_rate=0.3, parameters=plin.parameters(), weight_decay=0.05,
        grad_clip=pp.nn.ClipGradByGlobalNorm(1.0)), strategy=ps)
    assert _chain(popt) == _chain(jopt)
    jin, pin = jopt, popt
    while hasattr(pin, "_inner_opt"):
        jin, pin = jin.__dict__["_inner_opt"], pin.__dict__["_inner_opt"]
    assert type(pin._grad_clip).__name__ == type(jin._grad_clip).__name__ \
        == "HybridParallelClipGrad"
    assert pin._grad_clip.clip_norm == jin._grad_clip.clip_norm
    assert pin.get_lr() == jin.get_lr() == 0.3
    assert pin._wd == jin._wd == 0.05


def _params(package, w, b):
    lin = package.nn.Linear(*w.shape)
    if package is pp:
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
    else:
        lin.weight.set_value(w)
        lin.bias.set_value(b)
    return lin


META = [("gradient_merge", lambda m, o: m.GradientMergeOptimizer(o, 2)),
        ("gradient_merge_sum",
         lambda m, o: m.GradientMergeOptimizer(o, 2, avg=False)),
        ("localsgd", lambda m, o: m.LocalSGDOptimizer(o, 2)),
        ("dgc", lambda m, o: m.DGCOptimizer(o, rampup_begin_step=1,
                                            sparsity=0.5)),
        ("fp16_allreduce", lambda m, o: m.FP16AllReduceOptimizer(o)),
        ("asp", lambda m, o: m.ASPOptimizer(o))]


@pytest.mark.parametrize("name,make", META, ids=[m[0] for m in META])
def test_meta_optimizer_steps_equal_the_references(cpu, name, make):
    rng = np.random.RandomState(5)
    w, b = rng.randn(8, 4).astype(np.float32), rng.randn(4).astype(
        np.float32)
    grads = [(rng.randn(8, 4).astype(np.float32),
              rng.randn(4).astype(np.float32)) for _ in range(4)]
    out = []
    for package, mod in ((jpaddle, jso), (pp, pso)):
        lin = _params(package, w, b)
        opt = make(mod, package.optimizer.Momentum(
            learning_rate=0.1, momentum=0.9, parameters=lin.parameters()))
        for gw, gb in grads:
            if package is pp:
                lin.weight.grad = torch.from_numpy(gw)
                lin.bias.grad = torch.from_numpy(gb)
            else:
                lin.weight.grad = jpaddle.to_tensor(gw)
                lin.bias.grad = jpaddle.to_tensor(gb)
            opt.step()
            opt.clear_grad()
        out.append([np.asarray(lin.weight.detach().numpy() if package is pp
                               else lin.weight.numpy()),
                    np.asarray(lin.bias.detach().numpy() if package is pp
                               else lin.bias.numpy())])
    for got, want in zip(out[1], out[0]):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_asp_masks_equal_the_references():
    w = np.random.RandomState(2).randn(6, 8).astype(np.float32)
    jm = jso.ASPOptimizer._mask_2_4(jnp.asarray(w), 2, 4)
    pm = pso.ASPOptimizer._mask_2_4(torch.from_numpy(w), 2, 4)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pm.reshape(-1, 4).sum(1).eq(2).all()


def test_rng_tracker_errors_and_streams(cpu):
    for mod in (jrandom, prandom):
        t = mod.RNGStatesTracker()
        t.add("a", 1)
        errors = []
        for args in (("b", 1), ("a", 2)):
            with pytest.raises(ValueError) as e:
                t.add(*args)
            errors.append(str(e.value))
        if mod is jrandom:
            want = errors
    assert errors == want
    t = prandom.RNGStatesTracker()
    t.add("s", 11)
    pp.seed(7)
    x = torch.ones(64)
    with t.rng_state("s"):
        a1 = pp.nn.functional.dropout(x, 0.5)
    g1 = pp.nn.functional.dropout(x, 0.5)
    with t.rng_state("s"):
        a2 = pp.nn.functional.dropout(x, 0.5)
    pp.seed(7)
    g_plain = pp.nn.functional.dropout(x, 0.5)
    assert torch.equal(g1, g_plain)  # the global stream as if untouched
    assert not torch.equal(a1, a2)  # the stream advances
    replay = prandom.RNGStatesTracker()
    replay.add("s", 11)
    with replay.rng_state("s"):
        b1 = pp.nn.functional.dropout(x, 0.5)
        b2 = pp.nn.functional.dropout(x, 0.5)
    assert torch.equal(a1, b1) and torch.equal(a2, b2)
    states = t.get_states_tracker()
    t.set_states_tracker(states)
    prandom.model_parallel_random_seed(100)
    tr = prandom.get_rng_state_tracker()
    assert sorted(tr.states_) == sorted(
        [prandom.GLOBAL_SEED, prandom.LOCAL_SEED, prandom.MODEL_PARALLEL_RNG])
    assert tr.seeds_ == {100, 101, 1124}
    with tr.rng_state():
        pass


def _mlp(seed):
    pp.seed(seed)
    return pp.nn.Sequential(pp.nn.Linear(6, 8), pp.nn.ReLU(),
                            pp.nn.Dropout(0.3), pp.nn.Linear(8, 8),
                            pp.nn.Tanh(), pp.nn.Linear(8, 3))


@pytest.mark.parametrize("form", ["recompute", "sequential"])
def test_recompute_equals_the_plain_function(cpu, form):
    x0 = np.random.RandomState(3).randn(5, 6).astype(np.float32)
    results = []
    for use in (False, True):
        m = _mlp(0)
        x = torch.from_numpy(x0).requires_grad_()
        pp.seed(9)
        if not use:
            y = m(x)
        elif form == "recompute":
            y = pfleet.recompute(m, x)
        else:
            y = pfleet.recompute_sequential({"segments": 2}, m, x)
        loss = (y * y).sum()
        loss.backward()
        results.append([loss.detach(), x.grad] +
                       [p.grad for p in m.parameters()])
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_recompute_reaches_parameters_without_input_gradients(cpu):
    m = _mlp(1)
    x = torch.ones(2, 6)
    pfleet.recompute(m, x).sum().backward()
    assert all(p.grad is not None for p in m.parameters())


def test_util_file_shard_equals_the_references():
    files = [f"f{i}" for i in range(5)]
    assert pfleet.util.get_file_shard(files) == \
        jpaddle.distributed.fleet.util.get_file_shard(files)


def test_role_makers_equal_the_references(monkeypatch):
    from paddle_tpu.distributed.fleet import base as jbase
    from paddle_tpu.distributed.fleet.base import role_maker as jrm
    from paddle_tpu_torch.distributed.fleet.base import role_maker as prm

    assert jbase is not None
    monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
    monkeypatch.setenv("TRAINING_ROLE", "PSERVER")
    monkeypatch.setenv("PADDLE_PSERVERS_IP_PORT_LIST", "a:1,b:2")
    for collective in (True, False):
        j = jrm.PaddleCloudRoleMaker(is_collective=collective)
        p = prm.PaddleCloudRoleMaker(is_collective=collective)
        for m in ("worker_num", "worker_index", "is_worker", "is_server",
                  "is_first_worker", "_server_num", "_get_pserver_endpoints"):
            assert getattr(p, m)() == getattr(j, m)(), m
    j = jrm.UserDefinedRoleMaker(current_id=0, worker_num=2,
                                 worker_endpoints=["x:1", "y:2"])
    p = prm.UserDefinedRoleMaker(current_id=0, worker_num=2,
                                 worker_endpoints=["x:1", "y:2"])
    for m in ("worker_num", "worker_index", "is_first_worker",
              "_get_trainer_endpoints"):
        assert getattr(p, m)() == getattr(j, m)(), m
    assert prm.Role.SERVER == jrm.Role.SERVER


def test_pipeline_mode_waits_for_its_item(cpu):
    f = pfleet.Fleet()
    f._is_initialized = True
    f._hcg = SimpleNamespace(get_parallel_mode=lambda: "pipeline")
    with pytest.raises(NotImplementedError, match="item 5: the pipeline"):
        f.distributed_model(pp.nn.Linear(2, 2))
    with pytest.raises(RuntimeError, match="fleet.init"):
        pfleet.Fleet().distributed_optimizer(None)


def test_hybrid_optimizer_step_reaches_the_flat_update(world_of_one,
                                                       monkeypatch):
    """Row 13 on the Fleet path: ``HybridParallelOptimizer.step`` runs the
    inner optimizer's step, whose 10 parameters take one flat update (the
    kernel's plain version on the CPU)."""
    from paddle_tpu_torch.ops.kernels import multi_tensor_update as mtu

    calls = []
    inner = mtu.multi_tensor_update
    monkeypatch.setattr(mtu, "multi_tensor_update",
                        lambda kind, *a, **k: calls.append(kind)
                        or inner(kind, *a, **k))
    net = pp.nn.Sequential(*[pp.nn.Linear(4, 4) for _ in range(5)])
    opt = pfleet.distributed_optimizer(pp.optimizer.Momentum(
        learning_rate=0.1, parameters=net.parameters()))
    for _ in range(2):
        loss = (net(torch.ones(2, 4)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
    assert calls == ["momentum", "momentum"] and len(opt._plans) == 1


def test_split_caches_its_layer_by_name(cpu):
    import paddle_tpu_torch.distributed as pdist

    from paddle_tpu.enforce import InvalidArgumentError as JError
    from paddle_tpu_torch.enforce import InvalidArgumentError as PError

    x = torch.ones(2, 4)
    a = pdist.split(x, (4, 6), operation="linear", axis=1, name="fc_t")
    b = pdist.split(x, (4, 6), operation="linear", axis=1, name="fc_t")
    assert a.shape == (2, 6) and torch.equal(a, b)
    with pytest.raises(PError) as pe:
        pdist.split(x, (4, 8), operation="linear", axis=1, name="fc_t")
    jx = jpaddle.ones([2, 4])
    jpaddle.distributed.split(jx, (4, 6), operation="linear", axis=1,
                              name="fc_t")
    with pytest.raises(JError) as je:
        jpaddle.distributed.split(jx, (4, 8), operation="linear", axis=1,
                                  name="fc_t")
    # the message (each package's error then names its own call site)
    assert str(pe.value).splitlines()[0] == str(je.value).splitlines()[0]
