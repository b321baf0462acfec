"""Fleet data-parallel training (BASELINE config 3, ResNet-50), driven in
spawned ranks (``chip_smoke.py`` phase 6j, and the CPU tests' rank
programs against the JAX package).

- The CPU tests' rank programs, run one after the other by
  ``world_cases`` in ranks that ``distributed.spawn`` starts:
  ``collective_cases`` (every collective at the world's size),
  ``data_parallel_cases`` (``DataParallel``'s buckets and synced
  gradients, ``no_sync``, ``find_unused_parameters``, ``paddle.grad``,
  ``SyncBatchNorm`` over the group) and ``sharded_cases``
  (``group_sharded_parallel`` at the three levels, the sequence-parallel
  ops and layers, ``HybridParallelClipGrad`` at mp = world).
- Phase 6j (``run_6j``; ``python -m paddle_tpu_torch.experiments.fleet_dp``
  runs it alone on the card): ``world1`` (a): a world of one (NCCL) through
  ``fleet.init`` / ``distributed_model`` / ``distributed_optimizer``, the
  PaddleClas eager loop (``loss.backward(); opt.step();
  opt.clear_grad()``) against the same loop without Fleet, bit for bit;
  ``one_process`` the one-process step on the whole batch (bf16 O2 and
  fp32) that (c) is held to; ``dp_ranks`` (b, c) in each of 4 gloo ranks
  sharing the card: ``DataParallel`` through ``fleet.distributed_model``
  with plain BatchNorm (each rank's synced gradients against the mean of
  the four ranks' own gradients of their quarters, the parameters equal on
  every rank), then with ``SyncBatchNorm.convert_sync_batchnorm``;
  ``hold_to_one_process`` the bar both are read against.

The configuration is BASELINE config 3 as ``benchmarks/resnet50.py`` and
phase 6 set it: ResNet-50 NHWC, 1000 classes, the port's seed-0 weights,
``Momentum`` (lr 0.1, momentum 0.9, weight decay 1e-4) under
``amp.decorate`` O2 bf16, ``CrossEntropyLoss``; the whole batch is phase
6's, split over the ranks in rank order.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import time

import numpy as np
import torch

LR, MOMENTUM, WD, CLASSES = 0.1, 0.9, 1e-4, 1000
# (c)'s bars, as 6i's: SyncBatchNorm's step and the one-process step on
# the whole batch compute one function in bf16, rounding at different
# points, so each is held to the same step in fp32: every gradient's and
# running statistic's distance from it, relative to its norm, at most
# GRAD_RATIO times the one-process bf16 step's own distance (a fault f of
# the norm adds in quadrature: f > 0.75 e fails), plus, for a gradient of
# n elements, SPREAD / sqrt(n): the norm of n rounding errors varies by
# about 1 / sqrt(2 n) of itself. The H100's readings on three batches
# (data seeds 0, 1, 2) set both: the gradients' ratios stay under
# 1 + 2.25 / sqrt(n) at every n (largest 1.219, 1.213, 1.123, each on 64
# elements), which 1.25 + 2 / sqrt(n) holds with 0.2 to spare from 64
# elements up; the running statistics' under 1.075, so they take the flat
# GRAD_RATIO. Per-rank statistics ((b)'s step) move the gradients about
# as far as rounding does at B 32 a rank (their largest ratios 1.393,
# 1.203, 1.242, all under the bar), but fail on 94-99 of the 106 running
# statistics and on
# the loss: the step-0 loss within LOSS_ATOL of the one-process bf16
# step's, between the three batches' sound readings (2.495e-3, 1.11e-4,
# 2.973e-3) and the per-rank statistics' (1.505e-2, 1.055e-2,
# 1.656e-2): 2x the largest of the first, 1.76x under the smallest of the
# second. The two bf16 steps share the weights' rounding, so they sit far
# closer to each other than to fp32 (|bf16 - fp32| 4.8e-3 to 1.39e-2)
GRAD_RATIO = 1.25
SPREAD = 2.0
LOSS_ATOL = 6e-3


# ---------------------------------------------------------------------------
# the CPU tests' rank programs
# ---------------------------------------------------------------------------

def _full(v, n=4, dtype=torch.float32):
    return torch.full((n,), float(v), dtype=dtype)


def _on_host(tree):
    """``tree`` with every tensor as a host numpy array (fp32 for bf16)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_host(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _on_host(v) for k, v in tree.items()}
    return tree


def collectives_on(device):
    """``collective_cases`` in a rank of a world ``mesh_train.spawn``
    joined (the card's test: gloo ranks on CUDA tensors)."""
    import torch.distributed as dist
    from types import SimpleNamespace

    return collective_cases(SimpleNamespace(
        rank=dist.get_rank(), world_size=dist.get_world_size()), device)


def world_cases(out_dir, dp_args, sharded_args):
    """The CPU tests' world: in a rank started by ``distributed.spawn``,
    join it with ``init_parallel_env()`` (its ``PADDLE_*`` variables, on
    the CPU), run ``collective_cases``, ``data_parallel_cases(*dp_args)``
    and ``sharded_cases(*sharded_args)``, and pickle the three results to
    ``out_dir/rank<r>.pkl``."""
    from .. import distributed as D

    torch.set_num_threads(1)  # two ranks on a shared host, tiny tensors
    env = D.init_parallel_env(device="cpu")
    try:
        res = {"collective": collective_cases(env),
               "dp": data_parallel_cases(*dp_args),
               "sharded": sharded_cases(*sharded_args)}
        with open(os.path.join(out_dir, f"rank{env.rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    finally:
        D.destroy_process_group()


def collective_cases(env, device="cpu"):
    """Every collective at the world's size on tensors on ``device``
    (``env``: the joined ``ParallelEnv``); results on the host."""
    from .. import distributed as D
    from ..distributed import _comm

    r, w = env.rank, env.world_size
    dev = torch.device(device)

    def full(v, n=4, dtype=torch.float32):
        return _full(v, n, dtype).to(dev)

    res = {"env": (env.rank, env.world_size, D.get_rank(),
                   D.get_world_size()), "backend": D.get_backend()}
    for op in ("SUM", "AVG", "MAX", "MIN", "PROD"):
        t = full(r + 1)
        same = D.all_reduce(t, op=getattr(D.ReduceOp, op)) is t
        res[f"all_reduce_{op}"] = (t, same)
    t = full(r + 1, dtype=torch.bfloat16)
    D.all_reduce(t)
    res["all_reduce_bf16"] = (t.float(), str(t.dtype))
    lst = []
    cat = D.all_gather(lst, full(r, 2))
    res["all_gather"] = ([x for x in lst], cat)
    objs = []
    D.all_gather_object(objs, {"rank": r})
    res["all_gather_object"] = objs
    b = full(r * 7 + 1, 3)
    D.broadcast(b, src=1)
    res["broadcast"] = b
    rs = torch.arange(1, 2 * w + 1, dtype=torch.float32, device=dev) + r
    res["reduce_scatter_max"] = D.reduce_scatter(
        rs, op=D.ReduceOp.MAX)
    res["reduce_scatter_sum"] = D.reduce_scatter(rs.clone())
    out = torch.zeros(2, device=dev)
    D.reduce_scatter(out, [full(10 * j + r, 2) for j in range(w)])
    res["reduce_scatter_list"] = out
    outs = []
    D.alltoall([full(10 * r + j, 2) for j in range(w)], outs)
    res["alltoall"] = [o for o in outs]
    a2a = (torch.arange(w, dtype=torch.float32, device=dev) + w * r)[:, None].repeat(1, 2)
    res["alltoall_single"] = D.alltoall_single(a2a, None)
    o2 = torch.empty_like(a2a)
    D.alltoall_single(a2a, o2)
    res["alltoall_single_out"] = o2
    sc = torch.zeros(2, device=dev)
    D.scatter(sc, [full(100 + j, 2) for j in range(w)] if r == 1 else None,
              src=1)
    res["scatter"] = sc
    gl = []
    D.gather(full(r, 2), gl, dst=0)
    res["gather"] = [g for g in gl]
    ol = [{"a": r}, r]
    D.broadcast_object_list(ol, src=1)
    res["broadcast_object_list"] = ol
    oo = []
    D.scatter_object_list(oo, [{"i": j} for j in range(w)] if r == 0
                          else None, src=0)
    res["scatter_object_list"] = oo
    t = full(r + 1)
    D.reduce(t, dst=0)
    res["reduce"] = t
    # point to point, between global ranks
    buf = torch.zeros(3, device=dev)
    if r == 0:
        D.send(full(5, 3), dst=1)
    elif r == 1:
        D.recv(buf, src=0)
    res["send_recv"] = buf
    peer = (r + 1) % w
    got = torch.zeros(2, device=dev)
    tasks = [D.isend(full(20 + r, 2), dst=peer),
             D.irecv(got, src=(r - 1) % w)]
    for task in tasks:
        task.wait()
    res["isend_irecv"] = got
    got = torch.zeros(2, device=dev)
    tasks = D.batch_isend_irecv([D.P2POp(D.isend, full(30 + r, 2), peer),
                                 D.P2POp(D.irecv, got, (r - 1) % w)])
    for task in tasks:
        task.wait()
    res["batch_isend_irecv"] = got
    res["send_next"] = D.send_next(full(40 + r, 2))
    t = full(50 + r, 2)
    D.recv_prev(t)
    res["recv_prev"] = t
    t = full(r + 1)
    task = D.stream.all_reduce(t, sync_op=False)
    task.wait()
    res["stream_all_reduce"] = (t, D.stream.all_reduce(
        full(1), sync_op=True))
    g = D.new_group(list(range(w)))
    t = full(r + 1)
    D.all_reduce(t, group=g)
    res["new_group"] = (g.ranks, g.nranks, g.rank, D.get_group(g.id) is g,
                        t)
    D.barrier()
    res["staged"] = dict(_comm.STAGED)
    return _on_host(res)


def _linears(port, weights):
    """A port ``Sequential`` of Linear layers holding ``weights`` (a list
    of (w [in, out], b))."""
    layers = []
    for w, b in weights:
        lin = port.nn.Linear(*w.shape)
        with torch.no_grad():
            lin.weight.copy_(torch.from_numpy(w))
            lin.bias.copy_(torch.from_numpy(b))
        layers.append(lin)
    return port.nn.Sequential(*layers)


def _shard(x, r, w):
    k = x.shape[0] // w
    return x[r * k:(r + 1) * k]


def data_parallel_cases(mlp, x, sizes, partial, xp, bn_cases):
    """``DataParallel`` and ``SyncBatchNorm`` at the world's size, on the
    CPU, each rank on its rows of ``x``: the bucket layout at each of
    ``sizes`` MB (parameter indices in ``parameters()`` order), the
    synced gradients of ``mean(model(x) ** 2)``, a ``paddle.grad`` pass,
    ``no_sync`` accumulation, ``find_unused_parameters`` both ways (on
    ``partial``: used, unused), and each ``bn_cases`` entry's
    SyncBatchNorm step (output and input gradient gathered whole, weight
    and bias gradients summed, running statistics)."""
    import torch.distributed as dist

    import paddle_tpu_torch as port
    from ..device import set_device
    from ..distributed import _comm
    from ..distributed.parallel import DataParallel

    prev = set_device("cpu")
    r, w = dist.get_rank(), dist.get_world_size()
    out = {"layouts": {}}
    try:
        for mb in sizes:
            m = _linears(port, mlp)
            idx = {id(p): i for i, p in enumerate(m.parameters())}
            dp = DataParallel(m, comm_buffer_size=mb)
            out["layouts"][mb] = [[idx[id(p)] for p in b.params]
                                  for b in dp._buckets]
            del dp
        m = _linears(port, mlp)
        dp = DataParallel(m, comm_buffer_size=sizes[0])
        xs = port.to_tensor(_shard(x, r, w))
        loss = port.mean(dp(xs) ** 2)
        # paddle.grad: gradients without touching .grad, and no flush
        port.grad(loss, list(m.parameters()), retain_graph=True)
        out["grad_capture"] = (dp.bucket_syncs,
                               [p.grad is None for p in m.parameters()])
        loss.backward()
        out["buckets"] = len(dp._buckets)
        out["bucket_syncs"] = dp.bucket_syncs
        out["synced"] = [p.grad.numpy() for p in m.parameters()]
        for p in m.parameters():
            p.grad = None
        # no_sync: two local backwards, then one synced
        with dp.no_sync():
            port.mean(dp(xs) ** 2).backward()
            out["unsynced"] = [p.grad.numpy().copy() for p in m.parameters()]
            port.mean(dp(xs) ** 2).backward()
        port.mean(dp(xs) ** 2).backward()
        out["no_sync_then_sync"] = [p.grad.numpy() for p in m.parameters()]
        # a plain torch loss from the wrapper's outputs syncs too
        for p in m.parameters():
            p.grad = None
        before = dp.bucket_syncs
        torch.mean(dp(torch.from_numpy(_shard(x, r, w))) ** 2).backward()
        out["plain_loss_synced"] = dp.bucket_syncs - before
        for flag in (False, True):
            pm = _linears(port, partial)
            ppm = DataParallel(_PartialModel(pm), find_unused_parameters=flag)
            loss = port.mean(ppm(port.to_tensor(_shard(xp, r, w))) ** 2)
            try:
                loss.backward()
                out[f"unused_{flag}"] = [p.grad.numpy()
                                         for p in pm.parameters()]
            except RuntimeError as e:
                out[f"unused_{flag}"] = (str(e), [p.name for p in
                                                  pm.parameters()])
        out["bn"] = [_sync_bn_case(port, _comm, r, w, c) for c in bn_cases]
        out["util"] = _util_cases(port, r, w)
    finally:
        set_device(prev)
    return out


def _util_cases(port, r, w):
    """``fused_allreduce_gradients`` and ``broadcast_dp_parameters`` over
    the world, and a dead ``DataParallel``'s callback leaving the
    registry."""
    import gc

    from ..core import autograd
    from ..distributed.fleet.utils import hybrid_parallel_util as U
    from ..distributed.parallel import DataParallel

    lin = port.nn.Linear(3, 2)
    with torch.no_grad():
        for p in lin.parameters():
            p.copy_(torch.full_like(p, float(r + 1)))
            p.grad = torch.full_like(p, float(10 * (r + 1)))
    U.fused_allreduce_gradients(list(lin.parameters()))
    grads = [p.grad.numpy().copy() for p in lin.parameters()]
    U.broadcast_dp_parameters(lin)
    params = [p.detach().numpy().copy() for p in lin.parameters()]
    before = len(autograd._backward_end_callbacks)
    dp = DataParallel(port.nn.Linear(2, 2))
    made = len(autograd._backward_end_callbacks)
    del dp
    gc.collect()
    return {"grads": grads, "params": params,
            "callbacks": (before, made,
                          len(autograd._backward_end_callbacks))}


class _PartialModel(torch.nn.Module):
    """Uses the first layer of a two-layer ``Sequential`` only."""

    def __init__(self, seq):
        super().__init__()
        self.seq = seq

    def forward(self, x):
        return self.seq[0](x)


def _sync_bn_case(port, _comm, r, w, c):
    """A SyncBatchNorm step on this rank's rows of ``c``'s batch, alone
    (over the world) or, with ``c["wrapped"]``, inside a ``DataParallel``
    that hands it its group."""
    from ..distributed.parallel import DataParallel

    fmt = c["data_format"]
    bn = port.nn.SyncBatchNorm(c["weight"].shape[0], data_format=fmt)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(c["weight"]))
        bn.bias.copy_(torch.from_numpy(c["bias"]))
    run = DataParallel(bn) if c.get("wrapped") else bn
    x = torch.from_numpy(_shard(c["x"], r, w)).requires_grad_()
    y = run(x)
    (y * torch.from_numpy(_shard(c["cot"], r, w))).sum().backward()
    world = torch.distributed.group.WORLD
    # summed over the ranks: the whole batch's (w times the synced mean)
    return {"y": _comm.all_gather(y.detach(), world).numpy(),
            "x_grad": _comm.all_gather(x.grad, world).numpy(),
            "w_grad": _comm.all_reduce(bn.weight.grad, world).numpy(),
            "b_grad": _comm.all_reduce(bn.bias.grad, world).numpy(),
            "mean": bn._mean.numpy(), "variance": bn._variance.numpy(),
            "group": bn._group is not None}


def sharded_cases(lin, steps_data, out_dir, sp, clip):
    """At the world's size, on the CPU: ``group_sharded_parallel`` over a
    Linear holding ``lin`` (w, b) at each level (and ``os_g`` offloaded),
    3 AdamW steps on each rank's half of ``steps_data``'s batches (the
    losses averaged over the ranks, the whole parameters, each slice's
    state sizes, the parameters' sizes between steps, the state's device,
    a ``save_group_sharded_model`` file); then at mp = world the
    sequence-parallel ops, the column-row pair and a marked LayerNorm
    (``sp``), and ``HybridParallelClipGrad`` (``clip``)."""
    import torch.distributed as dist

    import paddle_tpu_torch as port
    from ..device import set_device
    from ..distributed import _comm, fleet
    from ..distributed.sharding import (group_sharded_parallel,
                                        save_group_sharded_model)

    prev = set_device("cpu")
    r, w = dist.get_rank(), dist.get_world_size()
    world = dist.group.WORLD
    out = {"zero": {}}
    try:
        strategy = fleet.DistributedStrategy()
        strategy.hybrid_configs = {"dp_degree": 1, "sharding_degree": w}
        fleet.init(is_collective=True, strategy=strategy, device="cpu")
        out["mode"] = fleet.fleet.get_hybrid_communicate_group() \
            .get_parallel_mode()
        for level, offload in (("os", False), ("os_g", False),
                               ("p_g_os", False), ("os_g", True)):
            model = _linears(port, [lin])[0]
            opt = port.optimizer.AdamW(learning_rate=1e-2,
                                       parameters=model.parameters())
            model, opt = group_sharded_parallel(model, opt, level=level,
                                                offload=offload)
            losses, between = [], []
            for xb, yb in steps_data:
                xs = port.to_tensor(_shard(xb, r, w))
                ys = port.to_tensor(_shard(yb, r, w))
                loss = port.mean((model(xs) - ys) ** 2)
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(_comm.all_reduce(loss.detach(), world))
                              / w)
                between.append([p.numel() for p in model.parameters()])
            owner = opt._owner
            state = {s.name: {k: v.numel() for k, v in owner.opt
                              ._shaped_state(s, owner.opt._accumulators[
                                  id(s)]).items()}
                     for s in owner.slices}
            path = os.path.join(out_dir, f"{level}_{int(offload)}")
            save_group_sharded_model(model, path, opt)
            owner.ensure_gathered()
            out["zero"][(level, offload)] = {
                "losses": losses, "between": between, "state": state,
                "on_host": owner.state_on_host(),
                "host_moves": owner.host_moves, "path": path,
                "weight": model.weight.detach().numpy().copy(),
                "bias": model.bias.detach().numpy().copy(),
                "slices": [s.numel() for s in owner.slices]}
        out["sp"] = _sp_cases(port, r, w, sp)
        out["clip"] = _clip_case(port, r, w, clip)
        out["tensor_parallel"] = _tensor_parallel_case(port, r)
    finally:
        set_device(prev)
        from ..distributed.fleet.base.topology import \
            set_hybrid_communicate_group
        from ..parallel import set_mesh

        set_hybrid_communicate_group(None)
        set_mesh(None)
    return out


def _seq_slice(a, r, w):
    k = a.shape[1] // w
    return a[:, r * k:(r + 1) * k]


def _sp_cases(port, r, w, c):
    """The four sequence ops (forward and input gradient), the
    column-then-row sequence-parallel pair and a marked LayerNorm, at mp
    = world."""
    from ..distributed import _comm
    from ..distributed.fleet import HybridCommunicateGroup
    from ..distributed.fleet import utils as U

    HybridCommunicateGroup(mp=w, device="cpu")
    world = torch.distributed.group.WORLD
    x, cot = c["x"], c["cot"]
    own = c["cot_by_rank"][r]
    out = {}
    xt = torch.from_numpy(x).requires_grad_()
    y = U.ScatterOp.apply(xt)
    (y * torch.from_numpy(_seq_slice(cot, r, w))).sum().backward()
    out["scatter"] = (y.detach().numpy(), xt.grad.numpy())
    xl = torch.from_numpy(_seq_slice(x, r, w)).requires_grad_()
    y = U.GatherOp(xl)
    (y * torch.from_numpy(cot)).sum().backward()
    out["gather"] = (y.detach().numpy(), xl.grad.numpy())
    xl = torch.from_numpy(_seq_slice(x, r, w)).requires_grad_()
    y = U.AllGatherOp.apply(xl)
    (y * torch.from_numpy(own)).sum().backward()
    out["all_gather"] = (y.detach().numpy(), xl.grad.numpy())
    xr = torch.from_numpy(c["x_by_rank"][r]).requires_grad_()
    y = U.ReduceScatterOp(xr)
    (y * torch.from_numpy(_seq_slice(cot, r, w))).sum().backward()
    out["reduce_scatter"] = (y.detach().numpy(), xr.grad.numpy())
    # the pair: column (sequence gathered) -> relu -> row (reduce-scattered)
    h, f = c["wc"].shape
    col = U.ColumnSequenceParallelLinear(h, f, gather_output=False)
    row = U.RowSequenceParallelLinear(f, h, input_is_parallel=True)
    k = f // w
    with torch.no_grad():
        col.weight.copy_(torch.from_numpy(c["wc"][:, r * k:(r + 1) * k]))
        col.bias.copy_(torch.from_numpy(c["bc"][r * k:(r + 1) * k]))
        row.weight.copy_(torch.from_numpy(c["wr"][r * k:(r + 1) * k]))
        row.bias.copy_(torch.from_numpy(c["br"]))
    pair = port.nn.LayerList([col, row])
    handles = U.register_sequence_parallel_allreduce_hooks(pair)
    xl = torch.from_numpy(_seq_slice(x, r, w)).requires_grad_()
    y = row(torch.relu(col(xl)))
    (y * torch.from_numpy(_seq_slice(cot, r, w))).sum().backward()
    out["pair"] = {
        "y": _comm.all_gather(y.detach(), world, 1).numpy(),
        "x_grad": _comm.all_gather(xl.grad, world, 1).numpy(),
        "wc_grad": _comm.all_gather(col.weight.grad, world, 1).numpy(),
        "bc_grad": _comm.all_gather(col.bias.grad, world, 0).numpy(),
        "wr_grad": _comm.all_gather(row.weight.grad, world, 0).numpy(),
        "br_grad": row.bias.grad.numpy(), "hooks": len(handles),
        "marked": [bool(getattr(p, "sequence_parallel", False))
                   for p in pair.parameters()]}
    grads = {}
    for hooked in (True, False):
        ln = port.nn.LayerNorm(h)
        with torch.no_grad():
            ln.weight.copy_(torch.from_numpy(c["ln_w"]))
            ln.bias.copy_(torch.from_numpy(c["ln_b"]))
        U.mark_as_sequence_parallel_parameter(ln.weight)
        U.mark_as_sequence_parallel_parameter(ln.bias)
        if hooked:
            U.register_sequence_parallel_allreduce_hooks(ln)
        xl = torch.from_numpy(_seq_slice(x, r, w)).requires_grad_()
        (ln(xl) * torch.from_numpy(_seq_slice(cot, r, w))).sum().backward()
        grads[hooked] = (ln.weight.grad.numpy(), ln.bias.grad.numpy())
    out["layer_norm"] = grads
    return out


def _tensor_parallel_case(port, r):
    """``TensorParallel`` at mp = world: the replicated parameters (a
    LayerNorm's, the row layer's bias) take the first rank's values, the
    mp shards keep their own."""
    from ..distributed.fleet import meta_parallel as mpl

    net = port.nn.Sequential(mpl.ColumnParallelLinear(4, 8,
                                                      gather_output=False),
                             mpl.RowParallelLinear(8, 4,
                                                   input_is_parallel=True),
                             port.nn.LayerNorm(4))
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(float(r + 1))
    mpl.TensorParallel(net)
    return [(mpl.parallel_layers.mp_layers.is_mp_shard(p),
             float(p.detach().mean())) for p in net.parameters()]


def _clip_case(port, r, w, c):
    """``HybridParallelClipGrad`` at mp = world on a column, a row and a
    LayerNorm's local gradients; the clipped gradients gathered whole."""
    from ..distributed import _comm
    from ..distributed.fleet import meta_parallel as mpl
    from ..distributed.fleet.meta_optimizers import HybridParallelClipGrad
    from ..distributed.fleet.base.topology import \
        get_hybrid_communicate_group

    hcg = get_hybrid_communicate_group()
    world = torch.distributed.group.WORLD
    h, f = c["grads"]["col_w"].shape
    col = mpl.ColumnParallelLinear(h, f, gather_output=False)
    row = mpl.RowParallelLinear(f, h, input_is_parallel=True)
    ln = port.nn.LayerNorm(h)
    params = {"col_w": (col.weight, 1), "col_b": (col.bias, 0),
              "row_w": (row.weight, 0), "row_b": (row.bias, None),
              "ln_w": (ln.weight, None), "ln_b": (ln.bias, None)}
    pairs = []
    for k, (p, dim) in params.items():
        g = torch.from_numpy(c["grads"][k])
        if dim is not None:
            n = g.shape[dim] // w
            g = g.narrow(dim, r * n, n).contiguous()
        pairs.append((p, g))
    clip = HybridParallelClipGrad(port.nn.ClipGradByGlobalNorm(
        c["clip_norm"]), hcg)
    clipped = clip(pairs)
    out = {}
    for (k, (p, dim)), (_, g) in zip(params.items(), clipped):
        out[k] = (g if dim is None else _comm.all_gather(g, world, dim)
                  ).numpy()
    out["distributed"] = {k: mpl.parallel_layers.mp_layers.is_mp_shard(p)
                          for k, (p, _) in params.items()}
    return out


# ---------------------------------------------------------------------------
# phase 6j
# ---------------------------------------------------------------------------

def resnet18_nhwc():
    """A smaller model of the same family (the card tests' size)."""
    import paddle_tpu_torch as port

    return port.vision.models.resnet18(num_classes=CLASSES,
                                       data_format="NHWC")


def build(port, sync_bn=False, fp32=False, size_model=None):
    """The seed-0 ResNet-50 (NHWC, 1000 classes; ``size_model`` builds
    another) and its Momentum, under ``amp.decorate`` O2 bf16 unless
    ``fp32``; SyncBatchNorm swapped in with ``sync_bn``."""
    port.seed(0)
    model = (size_model() if size_model is not None else
             port.vision.models.resnet50(num_classes=CLASSES,
                                         data_format="NHWC"))
    if sync_bn:
        model = port.nn.SyncBatchNorm.convert_sync_batchnorm(model)
    model.train()
    opt = port.optimizer.Momentum(learning_rate=LR, momentum=MOMENTUM,
                                  parameters=model.parameters(),
                                  weight_decay=WD)
    if not fp32:
        model, opt = port.amp.decorate(models=model, optimizers=opt,
                                       level="O2", dtype="bfloat16")
    return model, opt


def loss_of(port, model, x, y, fp32=False):
    ce = port.nn.CrossEntropyLoss()
    if fp32:
        return ce(model(x), y)
    with port.amp.auto_cast(level="O2", dtype="bfloat16"):
        return ce(model(x), y)


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize()


def eager_loop(port, model, opt, x, y, steps, counts=None):
    """The PaddleClas dygraph loop; (losses, ms a step: the wall of all
    the steps, issued without a read between them, over their number,
    launches a step)."""
    losses, launches = [], []
    _sync(x)
    t0 = time.perf_counter()
    for _ in range(steps):
        if counts:
            counts[0]()
        loss = loss_of(port, model, x, y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
        if counts:
            launches.append(counts[1]())
    _sync(x)
    ms = 1e3 * (time.perf_counter() - t0) / steps
    return [v.item() for v in losses], ms, launches


def world1(port, x, y, steps, counts=None, profile=None, size_model=None):
    """6j (a): the eager loop without Fleet, then through ``fleet.init``
    (a world of one: NCCL on the card, gloo for tensors on the CPU),
    ``distributed_model`` (the model itself) and ``distributed_optimizer``,
    each from the seed-0 weights under deterministic cuDNN; one more Fleet
    step profiled."""
    import torch.distributed as dist

    from ..distributed import fleet
    from ..distributed.fleet.base.topology import \
        set_hybrid_communicate_group
    from ..parallel import set_mesh

    torch.backends.cudnn.deterministic = True
    try:
        model, opt = build(port, size_model=size_model)
        plain, plain_ms, _ = eager_loop(port, model, opt, x, y, steps)
        del model, opt
        fleet.init(is_collective=True, device=x.device)
        try:
            model, opt = build(port, size_model=size_model)
            model = fleet.distributed_model(model)
            opt = fleet.distributed_optimizer(opt)
            wrapped = (type(model).__name__, type(opt).__name__,
                       type(opt._inner_opt).__name__)
            losses, ms, launches = eager_loop(port, model, opt, x, y, steps,
                                              counts)
            prof = None
            if profile is not None:
                prof = profile(lambda: eager_loop(port, model, opt, x, y, 1))
            return {"losses": losses, "plain_losses": plain,
                    "ms_per_step": ms, "plain_ms_per_step": plain_ms,
                    "launches": launches, "plans": len(opt._plans),
                    "wrapped": wrapped, "backend": dist.get_backend(),
                    "world_size": dist.get_world_size(), "profile": prof}
        finally:
            set_hybrid_communicate_group(None)
            set_mesh(None)
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = False


def _grads(model):
    return {n: p.grad.detach().float().clone()
            for n, p in model.named_parameters() if p.grad is not None}


def _bn_stats(model):
    return {n: b.detach().float().clone() for n, b in model.named_buffers()
            if n.endswith(("_mean", "_variance"))}


def one_process(port, x, y, size_model=None):
    """The one-process step on the whole batch, plain BatchNorm, from the
    seed-0 weights: bf16 O2 and fp32, each (loss, {name: gradient},
    {name: running statistic after the step}) on the card, fp32."""
    out = {}
    torch.backends.cudnn.deterministic = True
    try:
        for fp32 in (False, True):
            model, _ = build(port, fp32=fp32, size_model=size_model)
            loss = loss_of(port, model, x, y, fp32=fp32)
            loss.backward()
            out["fp32" if fp32 else "bf16"] = (loss.item(), _grads(model),
                                               _bn_stats(model))
            del model
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def _rel(a, b):
    b = b.float()
    n = float(b.norm())
    return float((a.float() - b).norm()) / n if n else float(
        (a.float() - b).norm())


def ratio_bar(n: int, kind: str = "grad") -> float:
    """(c)'s bar on the distance ratio of a gradient (``kind`` "grad") or
    running statistic ("stat") of ``n`` elements."""
    return GRAD_RATIO + (SPREAD / n ** 0.5 if kind == "grad" else 0.0)


def hold_to_one_process(ref, loss, grads, stats):
    """(c)'s bar: each gradient's and running statistic's distance from
    the fp32 step, over the one-process bf16 step's, within
    ``ratio_bar``; the loss within ``LOSS_ATOL`` of the bf16 step's.
    Returns the
    readings (``worst``: the reading nearest its bar, as (key, ratio,
    bar); ``ratios``: each key's (ratio, bar, distance, one process's
    distance)) and the keys that fail."""
    (l16, g16, s16), (l32, g32, s32) = ref["bf16"], ref["fp32"]
    ratios, failing = {}, []
    for kind, got, one, f32 in (("grad", grads, g16, g32),
                                ("stat", stats, s16, s32)):
        for k, want in f32.items():
            e_one = _rel(one[k], want)
            e_got = _rel(got[k].to(want.device), want)
            ratio = e_got / e_one if e_one else (0.0 if e_got == 0
                                                 else float("inf"))
            bar = ratio_bar(want.numel(), kind)
            ratios[f"{kind}:{k}"] = (ratio, bar, e_got, e_one)
            if ratio > bar:
                failing.append(f"{kind}:{k}")
    loss_bar = LOSS_ATOL
    loss_err = abs(loss - l16)
    if loss_err > loss_bar:
        failing.append("loss")
    worst = max(ratios, key=lambda k: ratios[k][0] / ratios[k][1])
    return {"loss": loss, "loss_bf16": l16, "loss_fp32": l32,
            "loss_abs_err": loss_err, "loss_bar": loss_bar,
            "worst": (worst, ratios[worst][0], ratios[worst][1]),
            "worst_grad": max((v[0] for k, v in ratios.items()
                               if k.startswith("grad:")), default=0.0),
            "worst_stat": max((v[0] for k, v in ratios.items()
                               if k.startswith("stat:")), default=0.0),
            "failing": failing, "checked": len(ratios), "ratios": ratios}


def _digest(model) -> str:
    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def _count_calls():
    from ..distributed import _comm

    return {"calls": dict(_comm.CALLS), "staged": dict(_comm.STAGED)}


def _delta(after, before):
    return {kind: {k: v - before[kind].get(k, 0)
                   for k, v in after[kind].items()
                   if v - before[kind].get(k, 0)}
            for kind in after}


def _rank_run(port, xs, ys, steps, sync_bn, size_model, check_mean):
    """One configuration's steps in this rank; ``check_mean`` holds each
    synced gradient to the mean of the ranks' own ones. Every kernel's
    launch count is set to 0 before each synced step and read after it."""
    import torch.distributed as dist

    from ..distributed import _comm, fleet
    from ..ops.kernels import launch_counters

    r, w = dist.get_rank(), dist.get_world_size()
    model, opt = build(port, sync_bn=sync_bn, size_model=size_model)
    dp = fleet.distributed_model(model)
    opt = fleet.distributed_optimizer(opt)
    fns = launch_counters()
    world = dist.group.WORLD
    out = {"wrapped": (type(dp).__name__, type(opt).__name__),
           "buckets": len(dp._buckets), "losses": [], "mean_checks": [],
           "launches": [], "calls": [], "bucket_syncs": [], "ms": [],
           "digests": []}
    for step in range(steps):
        if check_mean:
            bufs = _bn_stats(model)
            with dp.no_sync():
                loss_of(port, dp, xs, ys).backward()
            local = [p.grad.detach().reshape(-1).float()
                     for p in model.parameters()]
            opt.clear_grad()
            with torch.no_grad():
                for n, b in model.named_buffers():
                    if n in bufs:
                        b.copy_(bufs[n])
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
        syncs, calls = dp.bucket_syncs, _count_calls()
        _sync(xs)
        t0 = time.perf_counter()
        loss = loss_of(port, dp, xs, ys)
        loss.backward()
        if step == 0 and r == 0:
            out["grads0"] = {n: p.grad.detach().float().cpu()
                             for n, p in model.named_parameters()}
        synced = [p.grad.detach() for p in model.parameters()]
        opt.step()
        _sync(xs)
        out["ms"].append(1e3 * (time.perf_counter() - t0))
        out["calls"].append(_delta(_count_calls(), calls))
        out["bucket_syncs"].append(dp.bucket_syncs - syncs)
        out["launches"].append({n: getattr(fn, attr)
                                for n, (fn, attr) in fns.items()})
        if step == 0 and r == 0:
            out["stats0"] = {n: v.cpu() for n, v in _bn_stats(model).items()}
        if check_mean:
            out["mean_checks"].append(_mean_check(local, synced, world, w))
        opt.clear_grad()
        out["losses"].append(float(_comm.all_reduce(loss.detach().float(),
                                                    world)) / w)
        got = [None] * w
        dist.all_gather_object(got, _digest(model))
        out["digests"].append(got)
    return out


def _mean_check(local, synced, world, w):
    """Each synced gradient against the ranks' own gradients gathered and
    summed in fp32 in rank order, times 1 / world, cast to its type.
    Another order of the backend's sum may round otherwise: two orders of
    a fp32 sum of w terms differ by at most 2 (w - 1) units of 2^-24 of
    the sum of their magnitudes (the bound on an fp32 gradient), and a
    bf16 gradient may then round to the neighbouring value (one ulp).
    Returns the largest difference, the elements that differ and those
    past the bound."""
    from ..distributed import _comm

    flat = torch.cat(local)
    every = _comm.all_gather(flat, world).view(w, -1)
    total = every[0].clone()
    for i in range(1, w):
        total += every[i]
    bound = every.abs().sum(0) * (2 * (w - 1) * 2.0 ** -24 / w)
    mean = total * (1.0 / w)
    off, worst, differ, over = 0, 0.0, 0, 0
    for g in synced:
        n = g.numel()
        want = mean[off:off + n].to(g.dtype)
        got = g.reshape(-1)
        diff = (got.float() - want.float()).abs()
        differ += int((got != want).sum())
        worst = max(worst, float(diff.max()))
        b = bound[off:off + n]
        if g.dtype != torch.float32:
            b = b + torch.finfo(g.dtype).eps * want.float().abs()
        over += int((diff > b).sum())
        off += n
    return {"bit_identical": differ == 0, "elements_differing": differ,
            "max_abs_diff": worst, "over_bound": over}


def dp_ranks(x, y, steps, size_model=None, device="cuda"):
    """6j (b) then (c) in this rank of a gloo world sharing the card: its
    quarter of the batch (rank order) through ``fleet.init``,
    ``distributed_model`` (``DataParallel``) and ``distributed_optimizer``,
    ``steps`` steps with plain BatchNorm (each synced gradient against the
    mean of the ranks' own, the parameters' digests on every rank), then
    one step with ``SyncBatchNorm``. Returns rank 0's readings (step-0
    gradients and running statistics on the host) and every rank's
    launches, each step's as {kernel: count}."""
    import torch.distributed as dist

    import paddle_tpu_torch as port
    from ..device import set_device
    from ..distributed import fleet
    from ..distributed.fleet.base.topology import \
        set_hybrid_communicate_group
    from ..parallel import set_mesh

    r, w = dist.get_rank(), dist.get_world_size()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device == "cuda" else torch.device(device))
    set_device(str(dev))
    k = x.shape[0] // w
    xs = torch.from_numpy(x[r * k:(r + 1) * k]).to(dev)
    ys = torch.from_numpy(y[r * k:(r + 1) * k]).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    fleet.init(is_collective=True, device=dev, backend="gloo")
    try:
        mode = fleet.fleet.get_hybrid_communicate_group().get_parallel_mode()
        plain = _rank_run(port, xs, ys, steps, False, size_model, True)
        t_plain = time.perf_counter() - t0
        sync = _rank_run(port, xs, ys, 1, True, size_model, False)
    finally:
        set_hybrid_communicate_group(None)
        set_mesh(None)
    seconds = (t_plain, time.perf_counter() - t0)
    launches = {"plain": plain["launches"], "sync": sync["launches"]}
    if r != 0:
        return {"launches": launches}
    return {"launches": launches, "mode": mode, "plain": plain,
            "sync": sync, "seconds": seconds}


def run_6j(port, x, y, counts=None, profile=None, world1_steps=3, ranks=4,
           steps=2, size_model=None, timeout=300.0):
    """Phase 6j on ``x``, ``y`` (the whole batch, on the card): (a)
    ``world1``, then the one-process reference step, then (b, c)
    ``dp_ranks`` in ``ranks`` gloo ranks sharing the card; the readings,
    and under ``"faults"`` every check that failed."""
    from . import mesh_train

    t0, secs, faults = time.perf_counter(), {}, []
    w1 = world1(port, x, y, world1_steps, counts, profile, size_model)
    if w1["losses"] != w1["plain_losses"]:
        faults.append(f"(a): Fleet losses {w1['losses']} against the eager "
                      f"loop's {w1['plain_losses']}")
    secs["a"] = time.perf_counter() - t0
    if x.is_cuda:
        torch.cuda.empty_cache()
    ref = one_process(port, x, y, size_model)
    got = mesh_train.spawn(dp_ranks, ranks, args=(
        x.cpu().numpy(), y.cpu().numpy(), steps, size_model, x.device.type),
        device=x.device.type, backend="gloo", timeout=timeout)
    r0 = got[0]
    plain, sync = r0["plain"], r0["sync"]
    if r0["mode"] != "data" or plain["wrapped"] != (
            "DataParallel", "HybridParallelOptimizer"):
        faults.append(f"(b): mode {r0['mode']}, wrapped {plain['wrapped']}")
    for i in range(steps):
        want = {"calls": {"all_reduce": plain["buckets"]}, "staged": {}}
        if plain["bucket_syncs"][i] != plain["buckets"] or \
                plain["calls"][i] != want:
            faults.append(f"(b) step {i}: {plain['bucket_syncs'][i]} bucket "
                          f"syncs for {plain['buckets']} buckets, calls "
                          f"{plain['calls'][i]}")
        if plain["mean_checks"][i]["over_bound"]:
            faults.append(f"(b) step {i}: synced gradients against the mean "
                          f"of the ranks' own: {plain['mean_checks'][i]}")
        if len(set(plain["digests"][i])) != 1:
            faults.append(f"(b) step {i}: the parameters differ between "
                          f"ranks")
    launches = [r["launches"] for r in got]
    held = hold_to_one_process(ref, sync["losses"][0], sync["grads0"],
                               sync["stats0"])
    mutant = hold_to_one_process(ref, plain["losses"][0], plain["grads0"],
                                 plain["stats0"])
    if held["failing"]:
        faults.append(f"(c): SyncBatchNorm's step against the one-process "
                      f"step fails the bar on {held['failing'][:8]} (worst "
                      f"{held['worst']})")
    if "loss" not in mutant["failing"] or not any(
            k.startswith("stat:") for k in mutant["failing"]):
        faults.append(f"(c): per-rank statistics ((b)'s step) pass the loss "
                      f"bar or every running statistic's (failing "
                      f"{mutant['failing'][:8]}, loss error "
                      f"{mutant['loss_abs_err']}): the bars miss the fault")
    secs["bc"] = time.perf_counter() - t0
    strip = ("grads0", "stats0")
    return {"world1": w1, "mode": r0["mode"],
            "plain": {k: v for k, v in plain.items() if k not in strip},
            "sync": {k: v for k, v in sync.items() if k not in strip},
            "held": held, "mutant": mutant, "launches": launches,
            "rank_seconds": r0["seconds"], "seconds_to_end_of": secs,
            "faults": faults}


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.experiments.fleet_dp [batch] [size]
    [seed]``: phase 6j alone on the card (default phase 6's 128 images of
    224 x 224, drawn as ``benchmarks/resnet50.py`` draws them, from numpy
    seed 0; another seed draws another batch for the same seed-0
    weights); prints the report as one JSON line, and exits 1 on a failed
    check."""
    import json
    import sys

    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device: phase 6j runs on the card", file=sys.stderr)
        return 1
    batch, size, seed = (int(a) for a in (
        list(argv) + ["128", "224", "0"][len(argv):]))
    import paddle_tpu_torch as port

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(seed)
    xs = [rng.rand(batch, size, size, 3).astype(np.float32)
          for _ in range(3)]
    ys = [rng.randint(0, CLASSES, (batch,)) for _ in range(3)]
    x, y = torch.from_numpy(xs[0]).cuda(), torch.from_numpy(ys[0]).cuda()
    rep = run_6j(port, x, y)
    rep["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(rep, default=str))
    return 1 if rep["faults"] else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
