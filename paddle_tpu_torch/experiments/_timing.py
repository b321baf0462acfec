"""Device timing for the experiments: CUDA-graph replay timed with CUDA
events.

The counterpart of ``benchmarks/microbench.py`` ``slope_timeit`` and
``benchmarks/flash_micro.py`` ``timeit``, which chain calls inside one
jitted loop so that the host's dispatch stays out of the number: here
``iters`` calls are captured into one CUDA graph and its replay is timed
with CUDA events, so the number is device time per call.

Launch counts: a wrapper counts a launch where it is called, but a call
captured into a graph launches nothing until the graph replays. So the
capture's counts are taken back, and each replay adds them again: a
kernel's ``launches`` are the launches the device ran.
"""

from __future__ import annotations

import torch

from ..ops.kernels import launch_counters

__all__ = ["require_cuda", "events_ms", "time_ms", "backward_ms"]


def require_cuda() -> torch.device:
    """The card; raises where there is none (the experiments time device
    work and never fall back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the experiments need a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def events_ms(run) -> float:
    """Device ms from before ``run()``'s work to after it, by CUDA
    events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def _capture(graph, body, pool=None):
    """Capture ``body()`` into ``graph``; returns the launches it
    recorded, as (wrapper, attribute, count), with the counters put back
    to where they were."""
    counters = launch_counters().values()
    before = [getattr(fn, attr) for fn, attr in counters]
    with torch.cuda.graph(graph, pool=pool):
        body()
    captured = []
    for (fn, attr), n in zip(counters, before):
        if getattr(fn, attr) != n:
            captured.append((fn, attr, getattr(fn, attr) - n))
            setattr(fn, attr, n)
    return captured


def _replay(graph, captured):
    graph.replay()
    for fn, attr, n in captured:
        setattr(fn, attr, getattr(fn, attr) + n)


def _replay_ms(graph, captured, iters):
    _replay(graph, captured)  # warm
    return events_ms(lambda: _replay(graph, captured)) / iters


def time_ms(fn, n_inputs=1, iters=100, warmup=5) -> float:
    """Mean device ms per call of ``fn(i)``, cycling i over ``n_inputs``
    input sets (a tick-sized kernel is launched faster than Python can
    enqueue it, so the host's launch cost is kept out)."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()

    def body():
        for i in range(iters):
            fn(i % n_inputs)
    ms = _replay_ms(graph, _capture(graph, body), iters)
    del graph
    return ms


def backward_ms(forward, inputs, grad_out, iters=20, warmup=3) -> float:
    """Mean device ms per call of the backward of ``forward(*inputs)`` (the
    gradient of every input): the forward is captured into one graph and
    ``iters`` ``torch.autograd.grad`` calls into a second, on the
    forward's stream, as ``torch.cuda.make_graphed_callables`` does."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            torch.autograd.grad(forward(*leaves), leaves, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    outs = []
    fwd_launches = _capture(fwd, lambda: outs.append(forward(*leaves)))

    def body():
        for _ in range(iters):
            torch.autograd.grad(outs[0], leaves, grad_out, retain_graph=True)
    bwd_launches = _capture(bwd, body, pool=fwd.pool())
    _replay(fwd, fwd_launches)
    ms = _replay_ms(bwd, bwd_launches, iters)
    del fwd, bwd, outs
    return ms
