"""The packed flash-attention variants on the card: the port's counterpart
of ``benchmarks/flash_variants.py`` (``main``, ``diag_main`` and
``run_diag``).

``main`` first holds every ``nsplit`` x ``exp_bf16`` variant at B 4
against the production kernels (``ops/kernels/flash_attention.py``: the
forward and the one-launch backward), printing the largest difference of
out and of the gradients (the production lse is natural-log ``[B, H, S]``
and is not compared), then times at ``[b, S, h, d]`` (default 44, 512, 12,
64, the bench shape, causal): the production forward, its backward in one
launch and each of the backward's roles alone, SDPA's forward
and backward as the yardstick, every ``nsplit`` x ``exp_bf16`` forward and
backward, the ``run_fwd2`` knobs, and the ablations of ``run_diag``
(``diag_main``). The kernels are those of
``ops/kernels/flash_variants.py``; ``qblocks`` does not change their
schedule (blocks always split q rows), so it is timed once.

Usage: python -m paddle_tpu_torch.experiments.flash_variants [b S h d]
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops.kernels import flash_attention as fa
from ..ops.kernels import flash_variants as fv
from ._timing import backward_ms, require_cuda, time_ms

__all__ = ["main", "diag_main", "run_diag", "parity"]

ITERS = 30


def _shape(argv):
    shape = [44, 512, 12, 64]
    vals = [int(a) for a in (sys.argv[1:] if argv is None else argv)]
    return tuple(vals + shape[len(vals):])


def _inputs(dev, shape, seed=0, n=4):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*shape, generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(n)]


def _max_diff(a, b):
    return (a.float() - b.float()).abs().max().item()


def _production(q, k, v, do):
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.attention_delta(out, do)
    return out, lse, fa.flash_attention_bwd(q, k, v, do, lse, delta, True)


def _timed(tag, fn, rows, **extra):
    ms = time_ms(lambda i: fn(), iters=ITERS)
    print(f"{tag:<44} {ms:8.4f} ms", flush=True)
    rows.append(dict(tag=tag, ms=ms, **extra))


def parity(dev, S, h, d, bs=4):
    """Every nsplit x exp_bf16 variant against the production kernels at
    batch ``bs``: rows with max |out| and max |grad| differences."""
    qs, ks, vs, dos = _inputs(dev, (bs, S, h, d))
    out0, _, g0 = _production(qs, ks, vs, dos)
    out_max = out0.float().abs().max().item()
    grad_max = max(g.float().abs().max().item() for g in g0)
    rows = []
    for nsplit in (1, 2, 4):
        for ebf in (False, True):
            o1, l1 = fv.run_fwd(qs, ks, vs, True, nsplit, ebf)
            g1 = fv.run_bwd(qs, ks, vs, dos, o1, l1, True, nsplit, ebf)
            eo = _max_diff(o1, out0)
            eg = max(_max_diff(a, b) for a, b in zip(g1, g0))
            print(f"parity nsplit={nsplit} exp_bf16={ebf}: max|do|={eo:.2e} "
                  f"max|dgrad|={eg:.2e}", flush=True)
            rows.append(dict(nsplit=nsplit, exp_bf16=ebf, out_max_diff=eo,
                             grad_max_diff=eg, out_abs_max=out_max,
                             grad_abs_max=grad_max))
    return rows


def run_diag(q, k, v, do, out, lse):
    """Time every ablation of the reference's ``run_diag``; ``lse`` is
    base 2 ``[B, G, hp, S]``."""
    rows = []
    for drop in fv.FWD_DROPS:
        _timed(f"fwd diag drop={list(drop)}",
               lambda drop=drop: fv.fwd_diag(q, k, v, drop), rows,
               kind="fwd_diag", drop=list(drop))
    for drop in fv.BWD_DROPS:
        _timed(f"bwd diag drop={list(drop)}",
               lambda drop=drop: fv.bwd_diag(q, k, v, do, out, lse, drop),
               rows, kind="bwd_diag", drop=list(drop))
    return rows


def _diag_inputs(dev, shape):
    """The ablations' inputs: the production forward's out and its lse in
    the variants' base-2 packed layout, as ``diag_main`` feeds them."""
    q, k, v, do = _inputs(dev, shape, seed=1)
    b, S, h, d = shape
    out, lse = fa.flash_attention_fwd(q, k, v, True)
    lse2 = (lse * fv.LOG2_E).view(b, h // (128 // d), 128 // d, S)
    return q, k, v, do, out, lse2


def diag_main(argv=None):
    """The ablation sweeps alone at ``[b S h d]``."""
    shape = _shape(argv)
    dev = require_cuda()
    return run_diag(*_diag_inputs(dev, shape))


def main(argv=None):
    """Parity at B 4, then the timings at ``[b S h d]``; returns
    {"parity": rows, "timing": rows}."""
    b, S, h, d = shape = _shape(argv)
    dev = require_cuda()
    par = parity(dev, S, h, d)

    q, k, v, do = _inputs(dev, shape)
    print(f"\nshape b{b} S{S} h{h} d{d} ({torch.cuda.get_device_name(dev)})",
          flush=True)
    rows = []
    out0, lse0, _ = _production(q, k, v, do)
    delta0 = fa.attention_delta(out0, do)
    _timed("fwd production", lambda: fa.flash_attention_fwd(q, k, v, True),
           rows, kind="production")
    _timed("bwd production (dq, dk and dv, one launch)",
           lambda: fa.flash_attention_bwd(q, k, v, do, lse0, delta0, True),
           rows, kind="production")
    _timed("bwd production, the dq role alone",
           lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse0, delta0, True),
           rows, kind="production")
    _timed("bwd production, the dk/dv role alone",
           lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse0, delta0,
                                              True), rows, kind="production")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    _timed("fwd sdpa", lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), rows, kind="library")
    ms = backward_ms(lambda *t: F.scaled_dot_product_attention(
        *t, is_causal=True), (qt, kt, vt), do.transpose(1, 2).contiguous())
    print(f"{'bwd sdpa (dq, dk and dv)':<44} {ms:8.4f} ms", flush=True)
    rows.append(dict(tag="bwd sdpa", ms=ms, kind="library"))

    out, lse = fv.run_fwd(q, k, v, True)
    for nsplit in (1, 2, 4):
        for ebf in (False, True):
            knobs = dict(nsplit=nsplit, exp_bf16=ebf)
            _timed(f"fwd nsplit={nsplit} bf16exp={ebf}",
                   lambda: fv.run_fwd(q, k, v, True, nsplit, ebf), rows,
                   kind="fwd", **knobs)
            _timed(f"bwd nsplit={nsplit} bf16exp={ebf}",
                   lambda: fv.run_bwd(q, k, v, do, out, lse, True, nsplit,
                                      ebf), rows, kind="bwd", **knobs)
    for qblocks, p_bf16, scale_in in ((1, False, True), (1, True, True),
                                      (1, False, False), (1, True, False),
                                      (4, True, True)):
        knobs = dict(qblocks=qblocks, p_bf16=p_bf16,
                     in_kernel_scale=scale_in)
        _timed(f"fwd2 qblocks={qblocks} p_bf16={p_bf16} "
               f"in_kernel_scale={scale_in}",
               lambda: fv.run_fwd2(q, k, v, True, qblocks, p_bf16, scale_in),
               rows, kind="fwd2", **knobs)
    rows += run_diag(*_diag_inputs(dev, shape))
    return {"parity": par, "timing": rows}


if __name__ == "__main__":
    main()
