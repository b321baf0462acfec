"""Hybrid-parallel training on a mesh, driven in spawned ranks
(``chip_smoke.py`` phase 6i, and the CPU tests against the JAX package).

- ``spawn(target, nprocs, args)``: one ``torch.distributed`` world of
  ``nprocs`` spawned processes (a ``file://`` store in a fresh temporary
  directory, so two worlds never race for a port), each running
  ``target(*args)`` after ``init_parallel_env``; returns every rank's
  result. A rank that raises fails the world: the others are stopped, and
  every join has a deadline, so a hang cannot outlive ``timeout``.
- The rank programs the CPU tests run (``mesh_layout``, ``tp_layers``,
  ``attention_cases``, ``llama_cases``, ``bert_cases``): the port's side
  of a comparison, on whole numpy inputs the test made, returning whole
  numpy outputs from rank 0.
- ``world1_steps``: phase 6i (a), ``make_sharded_train_step`` on a mesh of
  one rank (NCCL), whose losses equal ``make_train_step``'s.
- ``layouts_vs_single``: phase 6i (b), three layouts in one gloo world of
  ranks sharing one card, each held against one rank's step on the same
  batch and weights.
- ``probe_gloo_cuda``: which gloo collectives take CUDA tensors as they
  are (``python -m paddle_tpu_torch.experiments.mesh_train --probe``).
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

# the rows of a collective's probe, and phase 6i (b)'s layouts (remat on,
# as llama7b's default: the flash kernels then launch once a layer and
# step only if attention stays outside the checkpointed halves)
PROBE_OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
             "ring_shift")
LAYOUTS = (("dp2_mp2_zero3", dict(dp=2, mp=2), dict(sharding_stage=3)),
           ("mp2_sep2_ring", dict(mp=2, sep=2),
            dict(sequence_parallel=True, sp_impl="ring")),
           ("mp2_sep2_ulysses", dict(mp=2, sep=2),
            dict(sequence_parallel=True, sp_impl="ulysses")))
FLASH_LAYOUTS = ("dp2_mp2_zero3", "mp2_sep2_ulysses")
# 6i (b)'s bars. A layout and one rank compute one function in bf16 with
# the same loss arithmetic (fp32 cross entropy, no custom tail), rounding
# at different points: each row-parallel sum rounds once more per rank,
# and the ring merges fp32 chunks. Two such computations differ by about
# as much as each differs from the exact function (on the H100 at
# bert_base_equiv width, one bf16 rank's wq gradient sits 3.4 % of its
# norm from the fp32 step, and a layout's 2.8 % from one bf16 rank's), so
# each is held against the same step in fp32 (one rank,
# ``dtype=float32``): every gradient's distance from it, relative to its
# norm, at most GRAD_RATIO times the one-rank bf16 step's own distance.
# Read: 1.00-1.046 on the H100, up to 1.063 on the CPU at the card test's
# width; a layout fault f of the norm adds in quadrature, so
# f > 0.75 e fails (2.5 % for wq, 0.64 % for ln_f). Step 0's loss within
# LOSS_ATOL of one rank's: 5x the H100's largest reading (1.993e-4), 2.2x
# the CPU's at the card test's width (4.5e-4)
LOSS_ATOL = 1e-3
GRAD_RATIO = 1.25


# ---------------------------------------------------------------------------
# a world of spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(target, rank, nprocs, store, device, backend, args_file,
               out):
    from ..distributed import init_parallel_env

    if device == "cpu":
        torch.set_num_threads(1)
    try:
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        init_parallel_env(device=device, backend=backend, rank=rank,
                          world_size=nprocs, init_method=f"file://{store}")
        result = target(*args)
        with open(out, "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, nprocs, args=(), device="cpu", backend=None,
          timeout=120.0):
    """``target(*args)`` in each of ``nprocs`` spawned ranks of one world
    (gloo on the CPU unless ``backend`` names another); returns the list
    of their results, rank by rank."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="mesh_world_")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
    # the arguments go through a file: a process's own pickle travels by
    # pipe, and a large one would hold each start until the child before
    # had imported its modules
    args_file = os.path.join(tmp, "args.pkl")
    with open(args_file, "wb") as f:
        pickle.dump(tuple(args), f)
    procs = [ctx.Process(target=_rank_main, args=(
        target, r, nprocs, os.path.join(tmp, "store"), device, backend,
        args_file, outs[r])) for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.exitcode for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.05)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        late = time.monotonic() >= deadline
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(10)
        errs = [open(o + ".err").read() for o in outs
                if os.path.exists(o + ".err")]
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if errs or failed:
            hang = (f"; ranks {hung} still running "
                    + (f"after {timeout} s" if late else "when one ended")
                    if hung else "")
            raise RuntimeError(
                f"ranks {failed} of {nprocs} failed (exit codes "
                f"{[p.exitcode for p in procs]}){hang}:\n"
                + "\n".join(errs))
        results = []
        for o in outs:
            with open(o, "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _rank0(value):
    import torch.distributed as dist

    return value if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# the CPU tests' rank programs (whole numpy in, whole numpy out of rank 0)
# ---------------------------------------------------------------------------

def mesh_layout(layout, host, specs):
    """The rank's mesh coordinate under ``layout``, and its shard of
    ``host`` under each spec; the ValueError of a wrong layout."""
    import torch.distributed as dist

    from ..parallel import mesh as M

    mesh = M.create_hybrid_mesh(**layout, device="cpu")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    shards = [M.host_to_global(host, M.P(*s), mesh, device="cpu").numpy()
              for s in specs]
    back = [M.local_to_global(torch.from_numpy(sh), M.P(*s), mesh).numpy()
            for sh, s in zip(shards, specs)]
    try:
        M.create_hybrid_mesh(dp=3, device="cpu", set_as_global=False)
        wrong = None
    except ValueError as e:
        wrong = str(e)
    groups = {axes: dist.get_world_size(M.axis_group(mesh, axes))
              for axes in M.AXIS_SETS if M.axis_group(mesh, axes)}
    try:
        M.axis_group(mesh, ("sharding", "mp"))
        unmade = None
    except ValueError as e:
        unmade = str(e)
    return {"rank": dist.get_rank(), "coord": coord, "shards": shards,
            "back": back, "wrong": wrong, "groups": groups,
            "unmade": unmade,
            "axis_size_mp": M.mesh_axis_size("mp"),
            "named": M.named_sharding(M.P("mp")).spec}


def tp_layers(weights, x, x2, ids, labels, cot):
    """The four tensor-parallel layers at mp = world size, each fed the
    reference's whole weights (this rank's slice); outputs and gradients
    gathered whole."""
    from ..device import set_device
    from ..distributed.fleet.meta_parallel import parallel_layers as pl
    from ..parallel import mesh as M
    from ..parallel.sharded import gather_tree

    n = torch.distributed.get_world_size()
    mesh = M.create_hybrid_mesh(mp=n, device="cpu")
    prev = set_device("cpu")
    try:
        emb = pl.VocabParallelEmbedding(*weights["emb"].shape)
        col = pl.ColumnParallelLinear(*weights["col_w"].shape,
                                      gather_output=True)
        col_p = pl.ColumnParallelLinear(*weights["col_w"].shape,
                                        gather_output=False)
        row = pl.RowParallelLinear(*weights["row_w"].shape,
                                   input_is_parallel=False)
        row_p = pl.RowParallelLinear(*weights["row_w"].shape,
                                     input_is_parallel=True)
        ce = pl.ParallelCrossEntropy()
    finally:
        set_device(prev)
    specs = {"emb": M.P("mp", None), "col_w": M.P(None, "mp"),
             "col_b": M.P("mp"), "row_w": M.P("mp", None),
             "row_b": M.P(None)}
    with torch.no_grad():
        for layer, keys in ((emb, ("emb",)), (col, ("col_w", "col_b")),
                            (col_p, ("col_w", "col_b")),
                            (row, ("row_w", "row_b")),
                            (row_p, ("row_w", "row_b"))):
            for attr, k in zip(("weight", "bias"), keys):
                getattr(layer, attr).copy_(M.local_shard(
                    torch.from_numpy(weights[k]), specs[k], mesh))
    out = {}
    xt = torch.from_numpy(x).requires_grad_()
    e = emb(torch.from_numpy(ids))
    (e * torch.from_numpy(cot["emb"])).sum().backward()
    out["emb"] = e.detach().numpy()
    g = gather_tree({"emb": emb.weight.grad}, specs, mesh)
    out["emb_grad"] = g["emb"]
    y = col(xt)
    (y * torch.from_numpy(cot["col"])).sum().backward()
    out["col"] = y.detach().numpy()
    out["col_x_grad"] = xt.grad.numpy().copy()
    out.update({f"col_{k}": v for k, v in gather_tree(
        {"w_grad": col.weight.grad, "b_grad": col.bias.grad},
        {"w_grad": specs["col_w"], "b_grad": specs["col_b"]}, mesh).items()})
    xt.grad = None
    # column (no gather) into row (input parallel): the Megatron MLP
    h = row_p(torch.relu(col_p(xt)))
    (h * torch.from_numpy(cot["mlp"])).sum().backward()
    out["mlp"] = h.detach().numpy()
    out["mlp_x_grad"] = xt.grad.numpy().copy()
    x2t = torch.from_numpy(x2).requires_grad_()
    z = row(x2t)
    (z * torch.from_numpy(cot["row"])).sum().backward()
    out["row"] = z.detach().numpy()
    out["row_x_grad"] = x2t.grad.numpy().copy()
    out.update({f"row_{k}": v for k, v in gather_tree(
        {"w_grad": row.weight.grad, "b_grad": row.bias.grad},
        {"w_grad": specs["row_w"], "b_grad": specs["row_b"]}, mesh).items()})
    out.update({f"mlp_{k}": v for k, v in gather_tree(
        {"col_w_grad": col_p.weight.grad, "row_w_grad": row_p.weight.grad},
        {"col_w_grad": specs["col_w"], "row_w_grad": specs["row_w"]},
        mesh).items()})
    vocab = M.P(None, None, "mp")
    lg = M.local_shard(torch.from_numpy(cot["logits"]), vocab, mesh)
    lg = lg.clone().requires_grad_()
    loss = ce(lg, torch.from_numpy(labels))
    loss.sum().backward()
    out["ce"] = loss.detach().numpy()
    out["ce_grad"] = M.local_to_global(lg.grad, vocab, mesh).numpy()
    return _rank0(out)


def attention_cases(cases):
    """Each case: ``impl`` ("ring" or "ulysses"), the mesh ``layout``,
    ``causal``, whole q/k/v and a cotangent; the local function on this
    rank's rows (split over sep), then the output and the q/k/v gradients
    gathered whole. A case with ``entry`` runs the whole-array entry
    (``context_parallel_attention`` / ``ulysses_parallel_attention``)
    instead, with a ``fallback`` that records whether it ran."""
    from ..ops import ring_attention as RA
    from ..parallel import mesh as M

    results = []
    for c in cases:
        mesh = M.create_hybrid_mesh(**c["layout"], device="cpu")
        q, k, v, cot = (torch.from_numpy(c[n]).requires_grad_(n != "cot")
                        for n in ("q", "k", "v", "cot"))
        if c.get("entry"):
            ran = []

            def fallback():
                ran.append(True)
                return RA._fa.xla_attention(q, k, v, is_causal=c["causal"])

            fn = {"ring": RA.context_parallel_attention,
                  "ulysses": RA.ulysses_parallel_attention}[c["impl"]]
            out = fn(q, k, v, mesh=mesh, is_causal=c["causal"],
                     batch_axes=c.get("batch_axes"), fallback=fallback)
            (out * cot).sum().backward()
            # sharded, each rank's input gradient holds its own rows'
            # share; on the dense branch every rank holds the whole
            grads = [g if ran else _sum_over(g, mesh)
                     for g in (q.grad, k.grad, v.grad)]
            results.append({"out": out.detach().numpy(), "fallback": bool(ran),
                            "grads": [g.numpy() for g in grads]})
            continue
        spec = M.P(None, "sep", None, None)
        local = [M.local_shard(t, spec, mesh).detach().clone()
                 .requires_grad_() for t in (q, k, v)]
        fn = {"ring": RA.ring_attention,
              "ulysses": RA.ulysses_attention}[c["impl"]]
        out = fn(*local, axis_name="sep", is_causal=c["causal"], mesh=mesh)
        (out * M.local_shard(cot, spec, mesh)).sum().backward()
        results.append({
            "out": M.local_to_global(out.detach(), spec, mesh).numpy(),
            "grads": [M.local_to_global(t.grad, spec, mesh).numpy()
                      for t in local]})
    return _rank0(results)


def _sum_over(g, mesh):
    """The sum of a gradient over every rank (each holds its share)."""
    from ..distributed import _comm
    from ..parallel import mesh as M

    return _comm.all_reduce(g, M.axis_group(mesh, M.HYBRID_AXES))


def _opt_zeros(params):
    return {"step": 0, "m": {k: np.zeros_like(v) for k, v in params.items()},
            "v": {k: np.zeros_like(v) for k, v in params.items()}}


def _model_cases(model, make_cfg, cases):
    from ..parallel import mesh as M
    from ..parallel.sharded import gather_tree

    results = []
    for c in cases:
        mesh = M.create_hybrid_mesh(**c["layout"], device="cpu")
        cfg = make_cfg(**c["cfg"])
        params, opt = model.shard_state(cfg, mesh, c["params"],
                                        _opt_zeros(c["params"]))
        step = model.make_sharded_train_step(cfg, mesh, lr=c["lr"],
                                             device="cpu")
        blocks = model._column_blocks(cfg)
        ospecs = model.opt_state_specs(cfg)
        r = {"local_numel": {k: (params[k].numel(), opt["m"][k].numel())
                             for k in params}}
        if c.get("grads"):
            loss, grads = step.loss_and_grads(params, c["tokens"],
                                              c["labels"])
            r["loss"] = float(loss)
            r["grads"] = gather_tree(grads, ospecs, mesh, blocks)
        losses = []
        for i in range(c.get("steps", 0)):
            losses.append(float(step(params, opt, c["tokens"],
                                     c["labels"])[2]))
            if i == 0:
                _, o1 = model.gather_state(cfg, mesh, params, opt)
                r["m1"], r["v1"] = o1["m"], o1["v"]
        r["losses"] = losses
        r["params"], r["opt"] = model.gather_state(cfg, mesh, params, opt)
        results.append(r)
    return _rank0(results)


def llama_cases(cases):
    """LLaMA ``make_sharded_train_step`` cases at ``LlamaConfig.tiny``:
    each ``layout``, ``cfg`` overrides, whole ``params``, ``tokens``
    (labels = tokens), ``lr``; ``grads``: the step-0 loss and gradients
    (summed over the data axes, gathered whole); ``steps``: that many
    steps' losses, the moments after step 1 and the state after the
    last."""
    from ..models import llama

    for c in cases:
        c.setdefault("labels", c["tokens"])
    return _model_cases(llama, llama.LlamaConfig.tiny, cases)


def bert_cases(cases):
    """BERT's cases at ``BertConfig.tiny``, as ``llama_cases``."""
    from ..models import bert

    return _model_cases(bert, bert.BertConfig.tiny, cases)


def model_cases(llama_list, bert_list):
    """``llama_cases`` then ``bert_cases`` in one world."""
    return _rank0({"llama": llama_cases(llama_list),
                   "bert": bert_cases(bert_list)})


# ---------------------------------------------------------------------------
# phase 6i on the card
# ---------------------------------------------------------------------------

def world1_steps(llama, cfg, params, tokens, steps, counts=None, lr=1e-4):
    """6i (a): ``create_hybrid_mesh()`` with every degree 1 (NCCL, a world
    of one), then ``steps`` of ``make_sharded_train_step`` from
    ``params`` (whole fp32, copied) on ``tokens``; returns the losses,
    ms a step and the launches a step (``counts``: (zero, read))."""
    import torch.distributed as dist

    from ..distributed import init_parallel_env
    from ..parallel import create_hybrid_mesh, set_mesh

    init_parallel_env(device="cuda")
    try:
        mesh = create_hybrid_mesh(device="cuda")
        p, opt = llama.shard_state(cfg, mesh, params,
                                   llama.init_opt_state(params))
        step = llama.make_sharded_train_step(cfg, mesh, lr=lr)
        losses, ms, launches = [], [], []
        for _ in range(steps):
            if counts:
                counts[0]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(p, opt, tokens, tokens)[2]
            losses.append(loss.item())
            ms.append(1e3 * (time.perf_counter() - t0))
            if counts:
                launches.append(counts[1]())
        set_mesh(None)
        return {"losses": losses, "ms_per_step": ms, "launches": launches,
                "world_size": dist.get_world_size(),
                "backend": dist.get_backend()}
    finally:
        dist.destroy_process_group()


def _flash_heads(record):
    """Wrap the flash wrappers' launch count to record each forward
    launch's (heads, rows); returns the function that undoes it."""
    from ..ops.kernels import flash_attention as fa

    inner = fa._count

    def spy(wrapper, q):
        if wrapper is fa.flash_attention_fwd:
            record.append((int(q.shape[2]), int(q.shape[1])))
        return inner(wrapper, q)

    fa._count = spy
    return lambda: setattr(fa, "_count", inner)


def _one_rank(llama, cfg, full, tok):
    """(loss, {key: gradient}) of the single-device ``loss_fn``."""
    leaves = {k: p.detach().requires_grad_() for k, p in full.items()}
    loss = llama.loss_fn(leaves, tok, tok, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.item(), dict(zip(leaves, grads))


def _rel(a, b):
    """|a - b| / |b| in fp32 (Frobenius)."""
    b = b.float()
    return float((a.float() - b).norm() / b.norm())


def layouts_vs_single(cfg_kw, tokens, steps=2, lr=1e-4, seed=0,
                      preset="bert_base_equiv", device="cuda"):
    """6i (b), in each rank of a gloo world sharing the card. Rank 0 first
    takes one rank's loss and gradients from phase 5's seeded fp32
    weights: ``llama.loss_fn`` in bf16 on the mesh's loss arithmetic
    (``ce_tail_custom=False``), the same in fp32, and, for the record,
    with the custom CE tail. Then each layout of ``LAYOUTS`` trains
    ``steps`` steps from the same weights with remat on, every rank
    counting its launches from 0 and asserting the flash kernels ran once
    a layer and step (never for the ring); rank 0 holds step 0's loss and
    gathered gradients to the one-rank step (``LOSS_ATOL``,
    ``GRAD_RATIO``). Returns each rank's launches by layout, and rank 0's
    report."""
    import dataclasses

    import torch.distributed as dist

    from ..distributed import _comm
    from ..models import llama
    from ..ops.kernels import launch_counters
    from ..parallel import create_hybrid_mesh, set_mesh
    from ..parallel.sharded import gather_tree

    rank = dist.get_rank()
    fns = launch_counters()
    make = getattr(llama.LlamaConfig, preset)
    base = make(**cfg_kw, ce_tail_custom=False)
    full = llama.init_params(base, torch.Generator(device=device)
                             .manual_seed(seed), device=device,
                             dtype=torch.float32)
    tok = torch.as_tensor(tokens, device=device)
    ref = None
    if rank == 0:
        ref = {"bf16": _one_rank(llama, base, full, tok),
               "fp32": _one_rank(llama, dataclasses.replace(
                   base, dtype=torch.float32), full, tok),
               "ce_tail": _one_rank(llama, make(**cfg_kw), full, tok)}
    report, launches = {}, {}
    for name, degrees, opts in LAYOUTS:
        t0 = time.perf_counter()
        cfg = make(**cfg_kw, remat=True, **opts)
        mesh = create_hybrid_mesh(**degrees, device=device)
        params, opt = llama.shard_state(cfg, mesh, full,
                                        llama.init_opt_state(full))
        step = llama.make_sharded_train_step(cfg, mesh, lr=lr, device=device)
        heads = []
        _comm.STAGED.clear()
        for fn, attr in fns.values():
            setattr(fn, attr, 0)
        undo = _flash_heads(heads)
        try:
            loss0, grads = step.loss_and_grads(params, tok, tok)
            gathered = gather_tree(grads, llama.opt_state_specs(cfg), mesh,
                                   llama._column_blocks(cfg))
            staged0 = dict(_comm.STAGED)
            step.update(params, opt, grads)
            losses = [loss0.item()]
            for _ in range(steps - 1):
                losses.append(step(params, opt, tok, tok)[2].item())
        finally:
            undo()
        counted = {n: getattr(fn, attr) for n, (fn, attr) in fns.items()}
        # the flash kernels launch on the card only (a CPU tensor takes
        # their plain versions)
        n = (cfg.num_layers * steps
             if name in FLASH_LAYOUTS and tok.is_cuda else 0)
        want = {"flash_attention_fwd": n, "flash_attention_bwd": n}
        wrong = {k: v for k, v in counted.items() if v != want.get(k, 0)}
        if wrong:
            raise AssertionError(f"{name}, rank {rank}: launches {wrong}, "
                                 f"wanted {want} ({steps} steps)")
        launches[name] = counted
        row = {"losses": losses, "seconds": time.perf_counter() - t0,
               "flash_heads_rows": sorted(set(heads)),
               "staged_step0": staged0}
        if rank == 0:
            l1, g1 = ref["bf16"]
            l32, g32 = ref["fp32"]
            d = {k: _rel(torch.from_numpy(gathered[k]).to(g.device), g)
                 for k, g in g1.items()}
            e_layout = {k: _rel(torch.from_numpy(gathered[k]).to(g.device),
                                g) for k, g in g32.items()}
            e_one = {k: _rel(g1[k], g) for k, g in g32.items()}
            ratio = {k: e_layout[k] / e_one[k] for k in g32}
            worst = max(ratio, key=ratio.get)
            row.update({
                "loss_single": l1, "loss_fp32": l32,
                "loss_abs_err": abs(losses[0] - l1),
                "grad_ratio_worst": [worst, ratio[worst]],
                "grad_vs_one_rank": d, "grad_vs_fp32": e_layout,
                "one_rank_vs_fp32": e_one})
            if not all(np.isfinite(losses)):
                raise AssertionError(f"{name}: non-finite losses {losses}")
            if not abs(losses[0] - l1) <= LOSS_ATOL:
                raise AssertionError(f"{name}: loss {losses[0]} against one "
                                     f"rank's {l1}")
            if not ratio[worst] <= GRAD_RATIO:
                raise AssertionError(
                    f"{name}: the gradient of {worst} is {e_layout[worst]} "
                    f"of its norm from the fp32 step, {ratio[worst]} times "
                    f"one bf16 rank's {e_one[worst]}")
        report[name] = row
        del params, opt, step, grads, gathered
        set_mesh(None)
        if device == "cuda":
            torch.cuda.empty_cache()
    if rank == 0:
        lt, gt = ref["ce_tail"]
        l1, g1 = ref["bf16"]
        l32, g32 = ref["fp32"]
        report["one_rank"] = {
            "loss_bf16": l1, "loss_fp32": l32, "loss_ce_tail": lt,
            "ce_tail_vs_plain": {k: _rel(gt[k], g) for k, g in g1.items()},
            "ce_tail_vs_fp32": {k: _rel(gt[k], g) for k, g in g32.items()}}
    return {"launches": launches, "report": report if rank == 0 else None}


def probe_gloo_cuda(op):
    """In each rank of a gloo world on the card: ``op`` (one of
    ``PROBE_OPS``) on CUDA tensors as they are, not staged; True where
    the result lands on the card with the right numbers."""
    import torch.distributed as dist

    from ..distributed import _comm

    n, r = dist.get_world_size(), dist.get_rank()
    group = dist.new_group(list(range(n)))
    base = torch.arange(4 * n, dtype=torch.float32)
    x = (base + 100 * r).cuda()
    parts = [base + 100 * j for j in range(n)]
    want = {"all_reduce": sum(parts), "all_gather": torch.cat(parts),
            "reduce_scatter": sum(parts).chunk(n)[r],
            "all_to_all": torch.cat([p.chunk(n)[r] for p in parts]),
            "ring_shift": parts[(r - 1) % n]}[op]
    _comm.GLOO_TAKES_CUDA = frozenset((op,))
    fn = {"all_reduce": _comm.all_reduce, "all_gather": _comm.all_gather,
          "reduce_scatter": _comm.reduce_scatter,
          "all_to_all": _comm.all_to_all, "ring_shift": _comm.ring_shift}[op]
    y = fn(x, group)
    torch.cuda.synchronize()
    return _rank0(bool(y.is_cuda and torch.equal(y.cpu(), want))
                  and not _comm.STAGED)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv != ["--probe"]:
        print("usage: python -m paddle_tpu_torch.experiments.mesh_train "
              "--probe", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the probe runs on the card", file=sys.stderr)
        return 1
    import json

    found = {}
    for op in PROBE_OPS:
        # a world of its own for each: a refused operation may leave the
        # other rank waiting, which the deadline ends
        try:
            found[op] = spawn(probe_gloo_cuda, 2, args=(op,), device="cuda",
                              backend="gloo", timeout=60)[0]
        except RuntimeError as e:
            lines = [ln for ln in str(e).splitlines() if "Error" in ln]
            found[op] = (lines[-1] if lines else str(e).splitlines()[0])[:300]
    print(json.dumps({"gloo_takes_cuda": found,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
