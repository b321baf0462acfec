"""Alternate formulations of the lm_head dx product ``do[Mv, V] @ W[V, H]``
on the card: the port's counterpart of ``benchmarks/dot_variants.py``.

Variants, each but the last a plain PyTorch call (the reference's are
XLA's):

  base        do[Mv, V] @ W[V, H], Mv = 44 * 511 = 22484
  fp32-acc    the product emitted in fp32 (``out_dtype``), then cast
  padM        Mv padded to 22528 = 44 * 512 (8-aligned rows)
  transT      (W^T @ do^T)^T
  ksplit2/4   K = 32000 contracted in 2 / 4 chunks, summed
  blocked     the hand-written blocked matmul (``ops/kernels/
              blocked_matmul.py``) at the padded M, each of its four tile
              instances, with its max |err| against ``torch.mm``

and the head dW shape ``[H, Mv] @ [Mv, V]`` emitted in fp32 against bf16
and a separate convert. Shares are of the H100 SXM's dense bf16 rate.
Inputs come from a seeded generator on the card (the reference draws
``RandomState(0)`` on the host; the values feed only the timings and the
blocked kernel's error).

Usage: python -m paddle_tpu_torch.experiments.dot_variants [iters]
"""

from __future__ import annotations

import sys

import torch

from ..ops.kernels import blocked_matmul as bm
from ._timing import require_cuda, time_ms

__all__ = ["PEAK_FLOPS", "main"]

PEAK_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores


def _row(tag, ms, flops):
    tfs = flops / (ms * 1e-3)
    print(f"{tag:<28} {ms:8.3f} ms  {tfs / 1e12:6.1f} TF/s  "
          f"{tfs / PEAK_FLOPS:6.1%} of peak", flush=True)
    return {"tag": tag, "ms": ms, "tflops": tfs / 1e12,
            "peak_share": tfs / PEAK_FLOPS}


def _ksplit(x, y, n):
    parts, wparts = x.chunk(n, dim=1), y.chunk(n, dim=0)
    acc = parts[0] @ wparts[0]
    for p, w in zip(parts[1:], wparts[1:]):
        acc = acc + p @ w
    return acc


def main(argv=None, shape=(44 * 511, 32000, 768)):
    """Time every variant (``argv``: [iters], default 20); returns the
    rows as dicts (the blocked kernel's with ``tile``, ``max_abs_err``
    against ``torch.mm`` and ``out_abs_max``)."""
    argv = sys.argv[1:] if argv is None else argv
    iters = int(argv[0]) if argv else 20
    dev = require_cuda()
    Mv, V, H = shape
    Mp = -(-Mv // 512) * 512
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*s):
        return torch.randn(*s, generator=gen, device=dev).to(torch.bfloat16)

    do, w = randn(Mv, V), randn(V, H)
    flops = 2.0 * Mv * V * H
    print(f"device {torch.cuda.get_device_name(dev)}  head dx shape "
          f"[{Mv},{V}]x[{V},{H}]", flush=True)

    def timed(fn):
        return time_ms(lambda i: fn(), iters=iters)

    rows = [
        _row("base", timed(lambda: do @ w), flops),
        _row("base fp32-acc", timed(lambda: torch.mm(
            do, w, out_dtype=torch.float32).to(torch.bfloat16)), flops),
    ]
    dop = randn(Mp, V)
    rows.append(_row(f"padM ({Mp} rows)", timed(lambda: dop @ w),
                     2.0 * Mp * V * H))
    rows.append(_row("transT (W^T do^T)",
                     timed(lambda: (w.t() @ do.t()).t()), flops))
    for n in (2, 4):
        rows.append(_row(f"ksplit{n}",
                         timed(lambda n=n: _ksplit(do, w, n)), flops))

    # the hand-written kernel over its tile instances, at the padded M
    exp = (dop @ w).float()
    for tile in bm.TILES:
        got = bm.blocked_matmul(dop, w, *tile)
        err = (got.float() - exp).abs().max().item()
        tag = "blocked bm{} bn{} bk{}".format(*tile)
        row = _row(tag, timed(lambda t=tile: bm.blocked_matmul(dop, w, *t)),
                   2.0 * Mp * V * H)
        print(f"    max|err| vs torch.mm = {err:.3f}", flush=True)
        rows.append(dict(row, tile=tile, max_abs_err=err,
                         out_abs_max=exp.abs().max().item()))
    del exp, dop

    # the head dW emission: fp32 out of the product, or bf16 and a convert
    a, b = randn(H, Mv), randn(Mv, V)
    fl = 2.0 * H * Mv * V
    rows.append(_row("head dW fp32-out", timed(lambda: torch.mm(
        a, b, out_dtype=torch.float32)), fl))
    rows.append(_row("head dW bf16-out + convert",
                     timed(lambda: (a @ b).float()), fl))
    return rows


if __name__ == "__main__":
    main()
