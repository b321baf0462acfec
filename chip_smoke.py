#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths (LLaMA and
ResNet-50) and its kernel experiments on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the script exits non-zero):

1. build the CUDA kernels from ``paddle_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print the card's name and power
   limit;
2. hold every kernel against its plain PyTorch version on the card, in
   bf16 and fp32, and time the kernel, the plain version and, where one
   PyTorch call computes the same function, that call: the tick kernels
   and ``ragged_decode_attention`` at the serving shape, a llama7b-width
   shape and a GQA shape; ``ragged_paged_attention`` on the serving
   decode tick, the serving admit prefill (256 rows at context 0 and
   192), llama7b-width and GQA decode ticks and one mixed-q_len launch,
   each on a shuffled page table, beside gather + SDPA (two calls); the
   flash-attention forward, dq and dk/dv kernels (bf16) at bench.py's
   training shape (B 44, S 512, 12 heads of D 64, causal), at llama7b
   width (B 1, S 2048, 32 heads of D 128, causal) and one non-causal
   shape with a ragged edge, beside SDPA's forward and backward;
   ``head_dx_softmax`` at the CE tail's shape (M 22528, V 32000, H 768)
   beside its GEMM alone; ``quant_matmul`` (int8 and fp8 weights, bf16
   x) at the decode tick's four projection shapes with B 8, lm_head with
   B 1 and B 8, and two ragged edges, beside dequantize + ``torch.mm``;
   ``ragged_decode_attention``'s quant mode (int8 and fp8 caches with
   per-row scales) at the serving shape and at llama7b width, beside
   dequantize + SDPA; and ``multi_tensor_update`` at ResNet-50's 161
   parameters (one flat buffer, padding held at zero) in bf16 momentum
   (the main path), fp32 momentum, bf16 Nesterov, bf16 sgd, O2 AdamW
   (bf16 params, fp32 moments and master) and fp32 Lamb, beside
   ``torch._fused_sgd_`` / ``torch._fused_adamw_`` on the shaped list, and
   a step with skip = 1 that must leave every buffer bit-identical; the
   kernel experiments' kernels: ``blocked_matmul``'s four tile instances
   at the lm_head dx shape (22528 x 32000 x 768) beside ``torch.mm``, every
   flash-variant instance (``run_fwd`` / ``run_bwd`` causal and not over
   nsplit 1, 2, 4 and exp_bf16, ``run_fwd2``'s p_bf16 and in-kernel
   scale, the twelve ablations) at B 4 against its plain version, and the
   main variants (forward and backward at nsplit 1 and 4, ``run_fwd2``)
   timed at B 44, S 512, 12 heads of D 64 beside SDPA;
3. serve 32 requests of the mixed workload through ``ServingEngine`` at
   ``LlamaConfig.bert_base_equiv`` width in bf16 (random weights from a
   seeded generator), check every request's tokens, and check from the
   launch counters that every decode tick went through the four kernels;
3b. the same 32 requests through ``ServingEngine(paged=True)``: every
   attention through ``ragged_paged_attention`` (L per segment step),
   the tick kernels L or L + 1 times per decode step, no page leaked,
   one device read per segment and none while a segment is issued; then
   both engines' drains timed in turns;
3c. the serving benchmark's shared-prefix burst (16 requests, a 192-token
   prefix, 32-token tails) through ``OnlineScheduler`` with a
   ``PagedPrefixCache``: prefix hits by page reference, no COW break, no
   leak;
3d. quantized serving: the 32 requests through
   ``ServingEngine(paged=True, quant="int8", quality_digest=True)``, every
   tick projection and lm_head through ``quant_matmul`` (7 L + 1 per
   decode step, 1 per admit) and no paged or decode attention kernel
   (the quantized pool attends through the dequantizing gather); one
   fetch per segment and none while one is issued; then the same
   requests through a bf16 paged engine with digests as the shadow, each
   request scored with ``compare_pair`` (printed: on random weights at
   this width two bf16 engines already disagree, see 3b's matched-prefix
   rate against the contiguous engine); then 8 requests through an fp8
   engine;
4. teacher-forced decode ticks through the kernel path and the plain path
   side by side, on the contiguous cache (4), on a shuffled page table
   (4b) and, with int8 weights and pool, on a quantized one (4c): logits
   within a stated bf16 tolerance;
5. training at ``bert_base_equiv`` width, bf16 compute with fp32 master
   weights (random, from a seeded generator) on tokens from
   ``np.random.RandomState(0)`` with labels = tokens, as bench.py trains:
   (a) at B 8, S 512 one ``loss_fn`` value and gradient through the
   kernels and through their plain versions, within stated budgets;
   (b) at B 44, S 512, two warm-up steps of ``make_train_step`` (AdamW,
   lr 1e-4), then ten timed ones: tokens/s, ms/step, peak memory, the
   device's busy share from a profiled step; (c) the loss after them is
   below the first step's; (d) each timed step launches the forward, dq
   and dk/dv kernels once per layer and ``head_dx_softmax`` once;
3e. (after 5) quantized serving's quality bar on a confident model:
   phase 5's weights trained on over its batch until the loss is below
   0.3, cast to bf16, serve 32 continuations of its training sequences
   (the mixed workload's lengths) through the int8 and the bf16 paged
   engines with digests; the int8 serve's matched-prefix rate against the
   bf16 one must be at least 0.5, the JAX package's bar;
6. ResNet-50 training, BASELINE config 1 (benchmarks/resnet50.py):
   ``resnet50(num_classes=1000, data_format="NHWC")`` from the port's
   initializers (seed 0), B 128 at 224x224 (``RandomState(0)`` images and
   labels), Momentum(0.1, 0.9, weight decay 1e-4), AMP O2 bf16,
   ``CrossEntropyLoss`` and ``fused_train_step``: (6.1) two steps through
   ``multi_tensor_update`` and two through its plain version from the
   same weights under deterministic cuDNN, losses, params and BN running
   statistics compared; (6.2) 2 warm-up and 10 timed steps: images/s,
   ms/step, peak memory, one profiled step's busy share and device time
   by kind; (6.3) exactly one ``multi_tensor_update`` launch per step
   (the 161 params are one bf16 group); (6.4) three O2
   ``AdamW(multi_precision=True)`` steps, one adam-with-master launch
   each;
7. the kernel experiments' entry points, as a user runs them
   (``paddle_tpu_torch.experiments.dot_variants`` and ``.flash_variants``
   at the reference's shapes): every blocked tile within two bf16 ulps
   of ``torch.mm``, every flash variant within four bf16 ulps of the
   largest value of the production kernels' outputs and gradients, and
   each experiment's kernels launched;
8. print the kernels' JSON line, then the result line. Each path of
   3-3e, 5b, 6 and 7 is driven with every launch count set to 0 just
   before it and read just after; a kernel's ``launches`` is its sum over
   those paths (the decode kernel's quant mode has no engine caller, as in
   the JAX package, so its count is 0 there; the experiments' kernels run
   on phase 7's paths alone, as in the JAX package).

Exits non-zero, printing no result, without a CUDA device or outside a
checkout of the repository. Imports nothing of JAX or of ``paddle_tpu``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
PEAK_OPS = {"torch.bfloat16": 989e12,  # dense bf16 tensor-core rate
            "torch.float32": 67e12}    # fp32 outside the tensor cores
VECTOR_OPS = 67e12            # fp32 CUDA-core rate: norms and rope

# tolerances, kernel against its plain version on the same inputs. bf16:
# rtol 1.6e-2 is two bf16 ulps (torch's own bf16 default); atol 2e-2 is one
# ulp at the inputs' magnitude (~4), for outputs that cancel (rope's
# a - b) or sit near 0. fp32: sums run in another order than the plain
# version's, so 1e-5.
TOL = {"torch.bfloat16": (1.6e-2, 2e-2), "torch.float32": (1e-5, 1e-5)}
# teacher-forced logits, bf16 engine path against the plain path: the
# twelve layers' residual streams round at different points (online vs
# full softmax, sum orders), each worth about one bf16 ulp of the stream;
# the budget is 0.15 absolute on logits of magnitude ~4 (~4 % of the
# range), far below the gap that separates distinct greedy tokens on
# average but not on near-ties, which is why token agreement is printed,
# not asserted.
LOGIT_ATOL = 0.15
# lse is fp32, from the same bf16 products summed in another order, with
# exp2/log2 on the card's approximate units: 1e-4
LSE_TOL = 1e-4
# head_dx_softmax's outputs are far below the shared bf16 atol (a row's
# probabilities sum to at most 1 and W is drawn at 1/sqrt(H), so |out| is
# ~1e-2), so its limit is tied to the output's size: atol 2^-7 of the
# largest |output| (two bf16 ulps there) with rtol 1.6e-2, and the
# relative Frobenius error within 1e-2. The output's own bf16 rounding is
# ~2^-9 of it (rms); an output off by 2 % in scale moves it 2 %, and one
# dropped 64-column V tile of 32000 about 1.5 % (the probabilities of
# logits at scale 3 are heavy-tailed, so a tile carries more than 1/500).
HEAD_DX_ATOL_OF_MAX = 2.0 ** -7
HEAD_DX_FRO_RTOL = 1e-2
# the flash variants' base-2 lse, kernel against plain: exp2/log2 on the
# card's units and l summed in another order, on lse of magnitude ~10
VARIANT_LSE_TOL = 1e-3
# the experiments' parity, each flash variant against the production
# kernels (an online softmax on unscaled q with a natural-log lse): the
# variants round q * scale * log2(e) to bf16 and, with exp_bf16, exp2's
# argument, so outputs and gradients may differ by a few bf16 ulps of the
# largest value: 2^-6 of it (four ulps)
PARITY_OF_MAX = 2.0 ** -6
# quant_matmul against its plain version: both fp32, sums over K in
# another order and the scale applied once per column after the sum (the
# plain version scales each weight), a few fp32 ulps of outputs of
# magnitude ~1
QMM_TOL = 1e-4
# quantized serving's bar against its bf16 shadow: the JAX package's
# matched-prefix rate on random-init weights (tests/test_quantized_serving)
MATCHED_PREFIX_FLOOR = 0.5
# phase 3e trains on until its batch's loss is below this: a memorized
# batch, whose continuations the model predicts with margins far above
# quantization's logit error (random weights at vocab 32000 are near-ties
# everywhere, where two bf16 engines already diverge)
MEMO_LOSS = 0.3
# training, bf16 kernel path against the plain path on the same fp32
# master weights and tokens: the loss (~10.4 = ln 32000 at random weights)
# within 2e-2, about one bf16 ulp of a logit at magnitude 4, where the two
# paths' attention outputs round differently; each parameter's gradient
# within 5e-2 of its norm (relative Frobenius error: bf16 keeps 2^-8 per
# element, and the paths' rounding differences pass through twelve
# layers' backward)
TRAIN_LOSS_ATOL = 2e-2
TRAIN_GRAD_RTOL = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def mixed_workload(rng, n, vocab):
    """The offline mixed workload of the serving benchmark: prompt lengths
    32..256 and generation lengths 16..128."""
    lens = rng.choice([32, 48, 64, 96, 128, 192, 256], size=n)
    gens = rng.choice([16, 32, 48, 64, 96, 128], size=n)
    return [(rng.randint(0, vocab, (int(l),)).astype(np.int32), int(g))
            for l, g in zip(lens, gens)]


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def eager_ms(torch, fn, n_inputs=1, iters=100):
    """Mean ms per call of ``fn(i)`` issued eagerly, back to back: what a
    call costs the eager decode tick, the host's launch included."""
    from paddle_tpu_torch.experiments._timing import events_ms

    fn(0)
    torch.cuda.synchronize()

    def run():
        for i in range(iters):
            fn(i % n_inputs)
    return events_ms(run) / iters


# library yardsticks at one shape, timed once per run: (what, shape) -> ms
_YARDSTICKS = {}


def yardstick_ms(key, measure):
    """``measure()``, the ms of a library call, taken once per run for each
    ``key`` (phase 2's flash rows and the flash variants' rows share
    SDPA's times at the bench shape)."""
    if key not in _YARDSTICKS:
        _YARDSTICKS[key] = measure()
    return _YARDSTICKS[key]


def bound_ms(nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check(torch, name, out, ref, dtype, atol_floor=0.0):
    rtol, atol = TOL[str(dtype)]
    atol = max(atol, atol_floor)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = 0.0
    for o, r in zip(outs, refs):
        torch.testing.assert_close(o.float(), r.float(), rtol=rtol,
                                   atol=atol, msg=lambda m: f"{name}: {m}")
        err = max(err, (o.float() - r.float()).abs().max().item())
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

SHAPES = [
    # name, B, nH, Hkv, D, max_len, L (cache layers cycled when timing)
    ("serving", 8, 12, 12, 64, 384, 12),
    ("llama7b", 8, 32, 32, 128, 2048, 4),
    ("gqa", 8, 32, 8, 128, 2048, 4),
]


def timed(torch, name, err, kernel, plain, library, bound, n_inputs=1,
          plain_iters=100):
    """One kernel's row: its error against the plain version, the device
    times of the kernel, the plain version and the library call (None
    where there is none), the kernel's eager per-call time, its bound."""
    from paddle_tpu_torch.experiments._timing import time_ms

    b_ms, b_by = bound
    return dict(
        name=name, max_abs_err=err, ms=time_ms(kernel, n_inputs),
        eager_ms=eager_ms(torch, kernel, n_inputs),
        plain_ms=time_ms(plain, n_inputs, iters=plain_iters),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=(None if library is None
                    else time_ms(library, n_inputs)))


def kernel_checks(torch, F, da, tf, shape, dtype, gen):
    name, B, nH, Hkv, D, max_len, L = shape
    dev = DEVICE
    H = nH * D
    elt = torch.tensor([], dtype=dtype).element_size()
    peak = PEAK_OPS[str(dtype)]

    def randn(*s, scale=1.0):
        return (torch.randn(*s, generator=gen, device=dev) * scale).to(dtype)

    rows = []
    x, y = randn(B, H, scale=2.0), randn(B, H, scale=2.0)
    w = (1.0 + 0.1 * torch.randn(H, generator=gen, device=dev)).to(dtype)
    eps = 1e-6

    # fused_rms_norm
    err = check(torch, "fused_rms_norm", tf.fused_rms_norm(x, w, eps),
                tf.rms_norm_plain(x, w, eps), dtype)
    rows.append(timed(
        torch, "fused_rms_norm", err,
        lambda i: tf.fused_rms_norm(x, w, eps),
        lambda i: tf.rms_norm_plain(x, w, eps),
        lambda i: F.rms_norm(x, (H,), w, eps),
        bound_ms((2 * B * H + H) * elt, 4 * B * H, VECTOR_OPS)))

    # fused_add_rms_norm
    err = check(torch, "fused_add_rms_norm",
                tf.fused_add_rms_norm(x, y, w, eps),
                tf.add_rms_norm_plain(x, y, w, eps), dtype)
    rows.append(timed(
        torch, "fused_add_rms_norm", err,
        lambda i: tf.fused_add_rms_norm(x, y, w, eps),
        lambda i: tf.add_rms_norm_plain(x, y, w, eps), None,
        bound_ms((4 * B * H + H) * elt, 5 * B * H, VECTOR_OPS)))

    # fused_rope_qk: positions mixed, including 0 and max_len - 1
    zq, zk = randn(B, H, scale=2.0), randn(B, Hkv * D, scale=2.0)
    pos = torch.randint(0, max_len, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1
    # an angle pos * freq near max_len carries an fp32 rounding of one ulp
    # of max_len; a one-ulp difference in freq (the kernel's libdevice pow
    # against torch's) moves it by that much, so the rotated values may
    # differ by two such ulps times the largest input
    ang_ulp = 2.0 ** (math.floor(math.log2(max_len - 1)) - 23)
    zmax = max(zq.abs().max().item(), zk.abs().max().item())
    err = check(torch, "fused_rope_qk",
                tf.fused_rope_qk(zq, zk, pos, D, 10000.0),
                tf.rope_qk_plain(zq, zk, pos, D, 10000.0), dtype,
                atol_floor=2 * ang_ulp * zmax)
    nz = B * (H + Hkv * D)
    rows.append(timed(
        torch, "fused_rope_qk", err,
        lambda i: tf.fused_rope_qk(zq, zk, pos, D, 10000.0),
        lambda i: tf.rope_qk_plain(zq, zk, pos, D, 10000.0), None,
        bound_ms(2 * nz * elt + 4 * B, 8 * nz, VECTOR_OPS)))

    # ragged_decode_attention over an [L, B, max_len, Hkv, D] cache, one
    # layer per call and the layers cycled, so the cache (113 MB at the
    # serving shape in bf16) exceeds the 50 MB L2 as on the decode tick
    kc = randn(L, B, max_len, Hkv, D)
    vc = randn(L, B, max_len, Hkv, D)
    q = randn(B, nH, D)
    err = check(torch, "ragged_decode_attention",
                da.ragged_decode_attention(q, kc[0], vc[0], pos),
                da.ragged_decode_attention_plain(q, kc[0], vc[0], pos),
                dtype)
    keys = int((pos.long() + 1).sum())
    nbytes = 2 * keys * Hkv * D * elt + 2 * B * nH * D * elt + 4 * B
    mask = (torch.arange(max_len, device=dev)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def sdpa(i):
        return F.scaled_dot_product_attention(
            qs, kc[i].transpose(1, 2), vc[i].transpose(1, 2),
            attn_mask=mask, **gqa)

    ref = da.ragged_decode_attention_plain(q, kc[0], vc[0], pos)
    row = timed(
        torch, "ragged_decode_attention", err,
        lambda i: da.ragged_decode_attention(q, kc[i], vc[i], pos),
        lambda i: da.ragged_decode_attention_plain(q, kc[i], vc[i], pos),
        sdpa, bound_ms(nbytes, 4 * keys * nH * D, peak), n_inputs=L,
        plain_iters=20)
    row["library_max_abs_err"] = (sdpa(0)[:, :, 0].float()
                                  - ref.float()).abs().max().item()
    rows.append(row)
    for r in rows:
        r["shape"], r["dtype"] = name, str(dtype).replace("torch.", "")
    return rows


FLASH_SHAPES = [
    # name, B, S, H, D, causal
    ("bench", 44, 512, 12, 64, True),        # bench.py's training shape
    ("llama7b", 1, 2048, 32, 128, True),     # the TPU's blocked regime
    ("noncausal", 8, 1000, 12, 64, False),   # a ragged edge at 64 rows
]


def sdpa_ms(torch, F, q, k, v, do, causal):
    """SDPA's forward and backward ms (the flash rows' yardsticks) on
    [B, S, H, D] inputs, once per run for each shape."""
    from paddle_tpu_torch.experiments._timing import backward_ms, time_ms

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    key = (*q.shape, causal)
    fwd = yardstick_ms(("sdpa forward", key), lambda: time_ms(
        lambda i: F.scaled_dot_product_attention(qt, kt, vt,
                                                 is_causal=causal)))
    bwd = yardstick_ms(("sdpa backward", key), lambda: backward_ms(
        lambda *t: F.scaled_dot_product_attention(*t, is_causal=causal),
        (qt, kt, vt), do.transpose(1, 2).contiguous()))
    return fwd, bwd


def flash_checks(torch, F, fa, shape, gen):
    """The forward, dq and dk/dv kernels at one shape against their plain
    versions (the backward kernels get the plain forward's out, lse and
    delta), timed beside SDPA: its forward, and its backward (dq, dk and
    dv in one call), both as CUDA-graph replays like the kernels."""
    name, B, S, H, D, causal = shape
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    ref, ref_lse = fa.flash_attention_fwd_plain(q, k, v, causal)
    torch.cuda.synchronize()
    err_f = check(torch, "flash_attention_fwd", out, ref, dt)
    torch.testing.assert_close(lse, ref_lse, rtol=LSE_TOL, atol=LSE_TOL)
    lse_err = (lse - ref_lse).abs().max().item()
    delta = fa.attention_delta(ref, do)
    bwd = (q, k, v, do, ref_lse, delta, causal)
    err_q = check(torch, "flash_attention_bwd_dq",
                  fa.flash_attention_bwd_dq(*bwd),
                  fa.flash_attention_bwd_dq_plain(*bwd), dt)
    err_kv = check(torch, "flash_attention_bwd_dkv",
                   fa.flash_attention_bwd_dkv(*bwd),
                   fa.flash_attention_bwd_dkv_plain(*bwd), dt)

    # bound: q, k, v, do read once, outputs written once, lse and delta
    # fp32; operations 2 * D per visible (query, key) pair and product
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    n = B * S * H * D * 2
    stats = 2 * B * H * S * 4
    peak = PEAK_OPS[str(dt)]

    rows = [
        timed(torch, "flash_attention_fwd", err_f,
              lambda i: fa.flash_attention_fwd(q, k, v, causal),
              lambda i: fa.flash_attention_fwd_plain(q, k, v, causal), None,
              bound_ms(4 * n + stats // 2, 4 * D * pairs, peak),
              plain_iters=3),
        timed(torch, "flash_attention_bwd_dq", err_q,
              lambda i: fa.flash_attention_bwd_dq(*bwd),
              lambda i: fa.flash_attention_bwd_dq_plain(*bwd), None,
              bound_ms(5 * n + stats, 6 * D * pairs, peak), plain_iters=3),
        timed(torch, "flash_attention_bwd_dkv", err_kv,
              lambda i: fa.flash_attention_bwd_dkv(*bwd),
              lambda i: fa.flash_attention_bwd_dkv_plain(*bwd), None,
              bound_ms(6 * n + stats, 8 * D * pairs, peak), plain_iters=3)]
    rows[0]["lse_max_abs_err"] = lse_err
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, do, causal)
    for r in rows[1:]:
        r["library_ms"] = lib_bwd
        r["library"] = "sdpa backward (dq, dk and dv in one call)"
    rows[0]["library_ms"] = lib_fwd
    rows[0]["library"] = "sdpa forward"
    for r in rows:
        r["shape"], r["dtype"] = name, "bfloat16"
    return rows


def head_dx_checks(torch, hd, gen, M=22528, V=32000, H=768):
    """``head_dx_softmax`` at the CE tail's shape (bench.py's B 44 x S 512
    rows, the vocabulary, the hidden width) against its plain version,
    beside the GEMM alone on precomputed bf16 probabilities."""
    from paddle_tpu_torch.experiments._timing import time_ms

    dt = torch.bfloat16
    logits = (torch.randn(M, V, generator=gen, device=DEVICE) * 3).to(dt)
    m = logits.float().max(-1).values
    se = torch.exp(logits.float() - m[:, None]).sum(-1)
    scale = torch.rand(M, generator=gen, device=DEVICE) / se
    w = (torch.randn(H, V, generator=gen, device=DEVICE)
         / math.sqrt(H)).to(dt)
    out = hd.head_dx_softmax(logits, m, scale, w)
    ref = hd.head_dx_softmax_plain(logits, m, scale, w)
    torch.cuda.synchronize()
    ref_max = ref.float().abs().max().item()
    atol = HEAD_DX_ATOL_OF_MAX * ref_max
    torch.testing.assert_close(
        out.float(), ref.float(), rtol=TOL[str(dt)][0], atol=atol,
        msg=lambda m: f"head_dx_softmax: {m}")
    err = (out.float() - ref.float()).abs().max().item()
    fro = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    if not fro <= HEAD_DX_FRO_RTOL:
        raise AssertionError(f"head_dx_softmax: relative Frobenius error "
                             f"{fro} > {HEAD_DX_FRO_RTOL}")
    del ref
    p = (torch.exp(torch.clamp(logits.float() - m[:, None], max=0.0))
         * scale[:, None]).to(dt)
    row = timed(torch, "head_dx_softmax", err,
                lambda i: hd.head_dx_softmax(logits, m, scale, w),
                lambda i: hd.head_dx_softmax_plain(logits, m, scale, w),
                None, bound_ms(M * V * 2 + 2 * M * 4 + H * V * 2 + M * H * 2,
                               2 * M * V * H, PEAK_OPS[str(dt)]),
                plain_iters=3)
    row["gemm_only_ms"] = time_ms(lambda i: p @ w.t(), iters=20)
    row.update(shape="ce_tail", dtype="bfloat16", out_abs_max=ref_max,
               atol=atol, rtol=TOL[str(dt)][0], fro_rel_err=fro,
               fro_rtol=HEAD_DX_FRO_RTOL)
    return row


PAGED_SHAPES = [
    # name, B, Tq, nH, Hkv, D, max_pages, ctx (None: mixed, 0 and the
    # window's last row included), q_len (None: every row)
    ("serving_decode", 8, 1, 12, 12, 64, 24, None, None),
    ("serving_prefill_ctx0", 1, 256, 12, 12, 64, 24, [0], None),
    ("serving_prefill_ctx192", 1, 256, 12, 12, 64, 24, [192], None),
    ("llama7b_decode", 8, 1, 32, 32, 128, 128, None, None),
    ("gqa_decode", 8, 1, 32, 8, 128, 128, None, None),
    ("mixed_q_len", 4, 16, 12, 12, 64, 24, [0, 5, 200, 370],
     [1, 16, 9, 1]),
]
PAGE = 16
L2_BYTES = 50e6


def paged_checks(torch, F, pa, shape, dtype, gen):
    """``ragged_paged_attention`` at one shape: the pool is stacked over
    enough layers to exceed twice the L2 cache, and the timed calls cycle
    the layers, as the engine's layers do."""
    from paddle_tpu_torch.experiments._timing import time_ms

    name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len = shape
    dev = DEVICE
    W = max_pages * PAGE
    P = B * max_pages + 1
    elt = torch.tensor([], dtype=dtype).element_size()
    layer_bytes = 2 * P * PAGE * Hkv * D * elt
    L = max(2, min(128, math.ceil(2 * L2_BYTES / layer_bytes)))
    kp = (torch.randn(L, P, PAGE, Hkv, D, generator=gen, device=dev)
          .to(dtype))
    vp = (torch.randn(L, P, PAGE, Hkv, D, generator=gen, device=dev)
          .to(dtype))
    q = torch.randn(B, Tq, nH, D, generator=gen, device=dev).to(dtype)
    pt = (torch.randperm(P - 1, generator=gen, device=dev)[:B * max_pages]
          + 1).to(torch.int32).reshape(B, max_pages)
    if ctx is None:
        c = torch.randint(0, W, (B,), generator=gen, device=dev)
        c[0], c[-1] = 0, W - 1
    else:
        c = torch.tensor(ctx, device=dev)
    c = c.to(torch.int32)
    ql = None if q_len is None else torch.tensor(q_len, dtype=torch.int32,
                                                 device=dev)
    rows = [Tq] * B if q_len is None else q_len
    ctx_h = c.tolist()

    def kernel(i):
        return pa.ragged_paged_attention(q, kp[i], vp[i], pt, c, ql)

    def plain(i):
        return pa.ragged_paged_attention_plain(q, kp[i], vp[i], pt, c, ql)

    out, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    err = 0.0
    for b in range(B):  # rows at or past q_len are padding
        err = max(err, check(torch, f"ragged_paged_attention {name}",
                             out[b, :rows[b]], ref[b, :rows[b]], dtype))
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"ragged_paged_attention {name}: non-finite")

    # the same function as two library calls: gather the slot's pages,
    # then SDPA with the causal mask in virtual positions
    idx = pt.long()
    qpos = c.long()[:, None] + torch.arange(Tq, device=dev)       # [B, Tq]
    mask = (torch.arange(W, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]                       # [B,1,Tq,W]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def gather_sdpa(i):
        gk = kp[i][idx].reshape(B, W, Hkv, D).transpose(1, 2)
        gv = vp[i][idx].reshape(B, W, Hkv, D).transpose(1, 2)
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), gk, gv, attn_mask=mask, **gqa).transpose(1, 2)

    lib = gather_sdpa(0)
    lib_err = max((lib[b, :rows[b]].float() - ref[b, :rows[b]].float())
                  .abs().max().item() for b in range(B))
    # bound: each visible K/V row read once, q read and out written once;
    # 4 operations per (query row, visible key, head, dim): two products
    keys = sum(min(ctx_h[b] + rows[b], W) for b in range(B))
    pairs = sum(min(ctx_h[b] + t + 1, W) for b in range(B)
                for t in range(rows[b]))
    nbytes = (2 * keys * Hkv * D * elt + 2 * B * Tq * nH * D * elt
              + 4 * B * (max_pages + 2))
    row = timed(torch, "ragged_paged_attention", err, kernel, plain, None,
                bound_ms(nbytes, 4 * pairs * nH * D, PEAK_OPS[str(dtype)]),
                n_inputs=L, plain_iters=20)
    row["gather_sdpa_ms"] = time_ms(gather_sdpa, L, iters=20)
    row["gather_sdpa_max_abs_err"] = lib_err
    row["shape"], row["dtype"] = name, str(dtype).replace("torch.", "")
    row["pages_read"] = sum(min(pa.pages_read(ctx_h[b], rows[b], PAGE),
                                max_pages) for b in range(B))
    return row


QMM_SHAPES = [
    # name, B, K, N: the decode tick's projections (B = 8 slots), the
    # admit's and the tick's lm_head, and two ragged edges (N no multiple
    # of the 64-column block; then no multiple of 8 either, K of the
    # 256-row chunk)
    ("wq_wk_wv_wo", 8, 768, 768),
    ("w_gate_w_up", 8, 768, 3072),
    ("w_down", 8, 3072, 768),
    ("lm_head_admit", 1, 768, 32000),
    ("lm_head_tick", 8, 768, 32000),
    ("ragged_n", 8, 768, 1000),
    ("ragged_nk", 8, 770, 999),
]


def quant_matmul_checks(torch, qm, qs, mode, shape, gen):
    """``quant_matmul`` at one shape against its plain version, timed
    beside dequantize + ``torch.mm`` in bf16 (the two-call library path,
    which rounds the dequantized weights to bf16); the weight is one of
    enough copies to exceed twice the L2 cache, cycled, as the engine's
    layers are."""
    name, B, K, N = shape
    dt = torch.bfloat16
    copies = max(2, min(64, math.ceil(2 * L2_BYTES / (K * N))))
    ws, scs = [], []
    for _ in range(copies):
        w, sc = qs.quantize_weight(
            torch.randn(K, N, generator=gen, device=DEVICE) / math.sqrt(K),
            mode)
        ws.append(w)
        scs.append(sc)
    x = torch.randn(B, K, generator=gen, device=DEVICE).to(dt)
    out = qm.quant_matmul(x, ws[0], scs[0])
    ref = qm.quant_matmul_plain(x, ws[0], scs[0])
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, rtol=QMM_TOL, atol=QMM_TOL,
                               msg=lambda m: f"quant_matmul {name}: {m}")
    err = (out - ref).abs().max().item()

    def library(i):
        return torch.mm(x, ws[i].to(dt) * scs[i].to(dt))

    lib_err = (library(0).float() - ref).abs().max().item()
    # bound: each weight byte, scale, x and output element once; 2 B K N
    # operations at the bf16 tensor-core rate (bytes bound it here)
    row = timed(torch, "quant_matmul", err,
                lambda i: qm.quant_matmul(x, ws[i], scs[i]),
                lambda i: qm.quant_matmul_plain(x, ws[i], scs[i]), library,
                bound_ms(K * N + 4 * N + 2 * B * K + 4 * B * N,
                         2 * B * K * N, PEAK_OPS[str(dt)]),
                n_inputs=copies, plain_iters=20)
    row.update(shape=name, dtype=mode, B=B, K=K, N=N,
               library="dequantize (bf16) + torch.mm, two calls",
               library_max_abs_err=lib_err)
    return row


DECODE_QUANT_SHAPES = [s for s in SHAPES if s[0] in ("serving", "llama7b")]


def decode_quant_checks(torch, F, da, qs, mode, shape, gen):
    """``ragged_decode_attention``'s quant mode at one shape, bf16 q, an
    [L, B, max_len, Hkv, D] narrow cache with its row scales (layers
    cycled, as in ``kernel_checks``), against its plain version and beside
    dequantize + SDPA."""
    name, B, nH, Hkv, D, max_len, L = shape
    dt = torch.bfloat16
    qdt = qs.quant_dtype(mode)
    kc, ks = qs.quantize_kv_rows(torch.randn(
        L, B, max_len, Hkv, D, generator=gen, device=DEVICE), qdt)
    vc, vs = qs.quantize_kv_rows(torch.randn(
        L, B, max_len, Hkv, D, generator=gen, device=DEVICE), qdt)
    q = torch.randn(B, nH, D, generator=gen, device=DEVICE).to(dt)
    pos = torch.randint(0, max_len, (B,), generator=gen, device=DEVICE,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1

    def kernel(i):
        return da.ragged_decode_attention(q, kc[i], vc[i], pos, ks[i], vs[i])

    def plain(i):
        return da.ragged_decode_attention_plain(q, kc[i], vc[i], pos, ks[i],
                                                vs[i])

    out, ref = kernel(0), plain(0)
    torch.cuda.synchronize()
    err = check(torch, f"ragged_decode_attention quant {mode} {name}", out,
                ref, dt)
    mask = (torch.arange(max_len, device=DEVICE)[None, :]
            <= pos.long()[:, None])[:, None, None, :]
    gqa = {"enable_gqa": True} if nH != Hkv else {}

    def library(i):
        kd = kc[i].to(dt) * ks[i][..., None, None].to(dt)
        vd = vc[i].to(dt) * vs[i][..., None, None].to(dt)
        return F.scaled_dot_product_attention(
            q[:, :, None, :], kd.transpose(1, 2), vd.transpose(1, 2),
            attn_mask=mask, **gqa)

    lib_err = (library(0)[:, :, 0].float() - ref.float()).abs().max().item()
    keys = int((pos.long() + 1).sum())
    nbytes = (2 * keys * (Hkv * D + 4) + 2 * B * nH * D * 2 + 4 * B)
    row = timed(torch, "ragged_decode_attention_quant", err, kernel, plain,
                library, bound_ms(nbytes, 4 * keys * nH * D,
                                  PEAK_OPS[str(dt)]),
                n_inputs=L, plain_iters=20)
    row.update(shape=name, dtype=mode, q_dtype="bfloat16",
               library="dequantize (bf16) + SDPA",
               library_max_abs_err=lib_err)
    return row


# ---------------------------------------------------------------------------
# phase 2: multi_tensor_update
# ---------------------------------------------------------------------------

# multi_tensor_update at ResNet-50's parameter population (161 tensors in
# parameters() order). Kernel against plain on the same buffers: both round
# once per operation in the buffer's type; the bias corrections (powf on
# the card, torch.pow on the host) may differ in the last bit, so fp32 to
# rtol 1e-6 and bf16 to one ulp (rtol 2^-7), atol 1e-7 for entries near 0
MTU_TOL = {"torch.float32": (1e-6, 1e-7), "torch.bfloat16": (2.0 ** -7, 1e-7)}
_ADAM = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8}
MTU_VARIANTS = [
    # name, kind, hyper, param dtype, state dtype, master, library yardstick
    ("momentum_bf16", "momentum", {"momentum": 0.9}, "bfloat16",
     "bfloat16", False, "sgd"),
    ("momentum_fp32", "momentum", {"momentum": 0.9}, "float32", "float32",
     False, "sgd"),
    ("nesterov_bf16", "momentum", {"momentum": 0.9, "nesterov": True},
     "bfloat16", "bfloat16", False, "sgd"),
    ("sgd_bf16", "sgd", {}, "bfloat16", None, False, "sgd"),
    ("adamw_bf16_master", "adam", dict(_ADAM, decay=0.01, decoupled=True),
     "bfloat16", "float32", True, "adamw"),
    ("lamb_fp32", "lamb", dict(_ADAM, epsilon=1e-6, decay=0.01), "float32",
     "float32", False, None),
]
_MTU_STATE = {"sgd": (), "momentum": ("velocity",),
              "adam": ("moment1", "moment2"), "lamb": ("moment1", "moment2")}


def resnet50_shapes(resnet, device_mod):
    """ResNet-50's parameter shapes in ``parameters()`` order (built on the
    CPU: only the shapes are kept)."""
    prev = device_mod.set_device("cpu")
    try:
        model = resnet.resnet50(num_classes=1000, data_format="NHWC")
    finally:
        device_mod.set_device(prev)
    return [tuple(p.shape) for p in model.parameters()]


def _mtu_buffers(torch, plan, shapes, kind, pdt, sdt, master, gen):
    """Params, grads and state of one group, packed by ``plan`` (tail lanes
    and rows zero), from a seeded generator."""
    def packed(scale, dtype, positive=False):
        ts = [torch.randn(s, generator=gen, device=DEVICE) * scale
              for s in shapes]
        return plan.pack([t.abs() if positive else t for t in ts],
                         dtype=dtype)

    pbuf, gbuf = packed(0.1, pdt), packed(0.01, pdt)
    sbufs = {k: packed(0.01, sdt, positive=True) for k in _MTU_STATE[kind]}
    if master:
        sbufs["master"] = pbuf.float()
    return pbuf, gbuf, sbufs


def _clone(bufs):
    p, g, s = bufs
    return p.clone(), g.clone(), {k: v.clone() for k, v in s.items()}


def multi_tensor_checks(torch, mtu, shapes, variant, gen):
    """One ``multi_tensor_update`` variant at ResNet-50's population: the
    kernel against its plain version on the same buffers (padding stays
    zero), then the kernel (in place, over and over), its plain version
    and, where one PyTorch call makes the same update on the shaped list,
    that call, timed. Bound: each buffer the kernel reads read once, each
    one it writes written once."""
    name, kind, hyper, pdt, sdt, master, lib = variant
    pdt = getattr(torch, pdt)
    sdt = getattr(torch, sdt) if sdt else None
    plan = mtu.FlatPlan(shapes)
    bufs = _mtu_buffers(torch, plan, shapes, kind, pdt, sdt, master, gen)
    kb, pb = _clone(bufs), _clone(bufs)
    r_k = mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3)
    r_p = mtu.flat_update_plain(kind, *pb, hyper, 0.1, 3)
    torch.cuda.synchronize()
    outs = [("p", kb[0], pb[0])] + [(k, kb[2][k], pb[2][k]) for k in kb[2]]
    if r_k is not None:
        outs.append(("r", r_k, r_p))
    err = 0.0
    used = torch.zeros(plan.total_rows * plan.LANES, dtype=torch.bool,
                       device=DEVICE)
    for i, n in enumerate(plan.sizes):
        r0 = int(plan.row_offsets[i]) * plan.LANES
        used[r0:r0 + n] = True
    for key, got, want in outs:
        rtol, atol = MTU_TOL[str(want.dtype)]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} {key}: {m}")
        err = max(err, (got.float() - want.float()).abs().max().item())
        if got.reshape(-1)[~used].any():
            raise AssertionError(f"{name} {key}: padding is not zero")
    elems = plan.total_rows * plan.LANES
    st = bufs[2]
    if kind == "lamb":  # reads the master or p, writes the moments and r
        reads = [st.get("master", bufs[0]), bufs[1], st["moment1"],
                 st["moment2"]]
        writes = [st["moment1"], st["moment2"], r_k]
    else:
        reads = [bufs[0], bufs[1], *st.values()]
        writes = [bufs[0], *st.values()]
    nbytes = sum(b.element_size() for b in reads + writes) * elems
    library = None
    if lib is not None:
        P = [torch.randn(s, generator=gen, device=DEVICE) * 0.1
             for s in shapes]
        G = [torch.randn(s, generator=gen, device=DEVICE) * 0.01
             for s in shapes]
        if lib == "sgd":
            P, G = [t.to(pdt) for t in P], [t.to(pdt) for t in G]
            V = [torch.zeros_like(t) for t in P] if kind == "momentum" else []

            def library(i):
                torch._fused_sgd_(
                    P, G, V, weight_decay=0.0,
                    momentum=hyper.get("momentum", 0.0), lr=0.1,
                    dampening=0.0, nesterov=bool(hyper.get("nesterov")),
                    maximize=False, is_first_step=False)
        else:  # AdamW on the fp32 master list: 28 B per element to our 30
            M = [torch.zeros_like(t) for t in P]
            V2 = [torch.zeros_like(t) for t in P]
            steps = [torch.tensor(3.0, device=DEVICE) for _ in P]

            def library(i):
                torch._fused_adamw_(
                    P, G, M, V2, [], steps, lr=0.1, beta1=0.9, beta2=0.999,
                    weight_decay=0.01, eps=1e-8, amsgrad=False,
                    maximize=False)
    row = timed(torch, "multi_tensor_update", err,
                lambda i: mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3),
                lambda i: mtu.flat_update_plain(kind, *pb, hyper, 0.1, 3),
                library, bound_ms(nbytes, 12 * elems, VECTOR_OPS),
                plain_iters=20)
    row.update(shape="resnet50", dtype=name, elements=elems,
               bytes_per_element=nbytes / elems,
               library=("torch._fused_sgd_ on the shaped list"
                        if lib == "sgd" else
                        "torch._fused_adamw_ on the fp32 master list"
                        if lib == "adamw" else "none"))
    return row


def multi_tensor_skip_check(torch, mtu, shapes, gen):
    """skip = 1 (a device float the kernel reads): every buffer of every
    kind stays bit-identical."""
    out = {}
    for name, kind, hyper, pdt, sdt, master, _ in MTU_VARIANTS:
        plan = mtu.FlatPlan(shapes)
        bufs = _mtu_buffers(torch, plan, shapes, kind,
                            getattr(torch, pdt),
                            getattr(torch, sdt) if sdt else None, master, gen)
        kb = _clone(bufs)
        mtu.multi_tensor_update(kind, *kb, hyper, 0.1, 3,
                                skip=torch.ones((), device=DEVICE))
        torch.cuda.synchronize()
        same = torch.equal(kb[0], bufs[0]) and all(
            torch.equal(kb[2][k], v) for k, v in bufs[2].items())
        if not same:
            raise AssertionError(f"{name}: skip = 1 changed a buffer")
        out[name] = same
    return out


# ---------------------------------------------------------------------------
# phase 2: the kernel experiments' kernels
# ---------------------------------------------------------------------------

def blocked_matmul_checks(torch, bm, gen, M=22528, K=32000, N=768):
    """Every tile instance of ``blocked_matmul`` at the experiment's shape
    (the lm_head dx at the padded M) against its plain version, beside
    ``torch.mm`` (cuBLAS)."""
    from paddle_tpu_torch.experiments._timing import time_ms

    dt = torch.bfloat16
    a = torch.randn(M, K, generator=gen, device=DEVICE).to(dt)
    b = torch.randn(K, N, generator=gen, device=DEVICE).to(dt)
    mm = a @ b
    mm_ms = time_ms(lambda i: a @ b)
    rows = []
    for tile in bm.TILES:
        out = bm.blocked_matmul(a, b, *tile)
        ref = bm.blocked_matmul_plain(a, b, tile[2])
        torch.cuda.synchronize()
        err = check(torch, "blocked_matmul", out, ref, dt)
        del ref
        row = timed(torch, "blocked_matmul", err,
                    lambda i, t=tile: bm.blocked_matmul(a, b, *t),
                    lambda i, t=tile: bm.blocked_matmul_plain(a, b, t[2]),
                    None, bound_ms(2 * (M * K + K * N + M * N),
                                   2 * M * N * K, PEAK_OPS[str(dt)]),
                    plain_iters=2)
        row.update(shape="lm_head_dx", dtype="bm{}_bn{}_bk{}".format(*tile),
                   mm_max_abs_err=(out.float() - mm.float()).abs().max()
                   .item(), library_ms=mm_ms, library="torch.mm")
        rows.append(row)
    return rows


def _of_max(torch, name, out, ref):
    """bf16 to two ulps with the atol of two ulps of the largest |ref|
    (the ablations' outputs reach ~1e9: exp2 of unscaled scores)."""
    rtol = TOL["torch.bfloat16"][0]
    return check(torch, name, out, ref, torch.bfloat16,
                 atol_floor=rtol * ref.float().abs().max().item())


def variant_matrix(torch, fv, gen, B=4, S=512, H=12, D=64):
    """Every flash-variant instance at B 4 against its plain version:
    run_fwd and run_bwd (causal and not, nsplit 1, 2, 4, exp_bf16),
    run_fwd2 (p_bf16, in-kernel scale), the twelve ablations. Returns the
    largest errors by entry."""
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    err = {"run_fwd": 0.0, "run_fwd_lse": 0.0, "run_bwd": 0.0,
           "run_fwd2": 0.0, "fwd_diag": 0.0, "bwd_diag": 0.0}

    def note(key, e):
        err[key] = max(err[key], e)

    for causal in (True, False):
        for nsplit in (1, 2, 4):
            for ebf in (False, True):
                out, lse = fv.run_fwd(q, k, v, causal, nsplit, ebf)
                ref, ref_lse = fv.run_fwd_plain(q, k, v, causal, nsplit, ebf)
                torch.cuda.synchronize()
                note("run_fwd", check(torch, "flash_variants_fwd", out, ref,
                                      dt))
                torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                           atol=VARIANT_LSE_TOL)
                note("run_fwd_lse", (lse - ref_lse).abs().max().item())
                args = (q, k, v, do, ref, ref_lse, causal, nsplit, ebf)
                note("run_bwd", check(torch, "flash_variants_bwd",
                                      fv.run_bwd(*args),
                                      fv.run_bwd_plain(*args), dt))
        for p_bf16, scale_in in ((True, False), (False, True), (True, True)):
            args = (q, k, v, causal, 1, p_bf16, scale_in)
            out, lse = fv.run_fwd2(*args)
            ref, ref_lse = fv.run_fwd2_plain(*args)
            note("run_fwd2", check(torch, "flash_variants_fwd", out, ref, dt))
            torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                       atol=VARIANT_LSE_TOL)
    for drop in fv.FWD_DROPS:
        out, lse = fv.fwd_diag(q, k, v, drop)
        ref, ref_lse = fv.fwd_diag_plain(q, k, v, drop)
        note("fwd_diag", _of_max(torch, "flash_variants_fwd", out, ref))
        torch.testing.assert_close(lse, ref_lse, rtol=VARIANT_LSE_TOL,
                                   atol=VARIANT_LSE_TOL)
    o, lse = fv.run_fwd_plain(q, k, v)
    for drop in fv.BWD_DROPS:
        args = (q, k, v, do, o, lse, drop)
        for g, w in zip(fv.bwd_diag(*args), fv.bwd_diag_plain(*args)):
            note("bwd_diag", _of_max(torch, "flash_variants_bwd", g, w))
    return err


def variant_rows(torch, F, fv, gen, B=44, S=512, H=12, D=64):
    """The main variants at the experiments' shape (causal), timed beside
    their plain versions and SDPA: the forward at nsplit 1 (the whole
    square, the experiment's baseline) and 4, ``run_fwd2`` with the scale
    in the kernel, the backward at nsplit 1 and 4."""
    dt = torch.bfloat16

    def randn():
        return torch.randn(B, S, H, D, generator=gen, device=DEVICE).to(dt)

    q, k, v, do = randn(), randn(), randn(), randn()
    out, lse = fv.run_fwd(q, k, v)
    ref, ref_lse = fv.run_fwd_plain(q, k, v)
    torch.cuda.synchronize()
    err_f = check(torch, "flash_variants_fwd", out, ref, dt)
    lib_fwd, lib_bwd = sdpa_ms(torch, F, q, k, v, do, True)
    # bound: the function's work, whatever share of the square a variant
    # computes: inputs read once, outputs written once, the lse fp32;
    # operations 2 * D per visible (query, key) pair and product (two
    # products forward, five backward)
    peak = PEAK_OPS[str(dt)]
    pairs = B * H * S * (S + 1) // 2
    n = B * S * H * D * 2
    stats = B * H * S * 4
    fwd_bound = bound_ms(4 * n + stats, 4 * D * pairs, peak)
    bwd_bound = bound_ms(8 * n + stats, 10 * D * pairs, peak)
    rows = []
    for nsplit in (1, 4):
        if nsplit == 1:
            err = err_f
        else:
            err = check(torch, "flash_variants_fwd",
                        fv.run_fwd(q, k, v, True, nsplit)[0],
                        fv.run_fwd_plain(q, k, v, True, nsplit)[0], dt)
        r = timed(torch, "flash_variants_fwd", err,
                  lambda i, n_=nsplit: fv.run_fwd(q, k, v, True, n_),
                  lambda i, n_=nsplit: fv.run_fwd_plain(q, k, v, True, n_),
                  None, fwd_bound, plain_iters=2)
        r.update(dtype=f"run_fwd_nsplit{nsplit}", library_ms=lib_fwd,
                 library="sdpa forward")
        rows.append(r)
        args = (q, k, v, do, ref, ref_lse, True, nsplit)
        err = check(torch, "flash_variants_bwd", fv.run_bwd(*args),
                    fv.run_bwd_plain(*args), dt)
        r = timed(torch, "flash_variants_bwd", err,
                  lambda i, a=args: fv.run_bwd(*a),
                  lambda i, a=args: fv.run_bwd_plain(*a), None, bwd_bound,
                  plain_iters=2)
        r.update(dtype=f"run_bwd_nsplit{nsplit}", library_ms=lib_bwd,
                 library="sdpa backward (dq, dk and dv in one call)")
        rows.append(r)
    err = check(torch, "flash_variants_fwd", fv.run_fwd2(q, k, v)[0],
                fv.run_fwd2_plain(q, k, v)[0], dt)
    r = timed(torch, "flash_variants_fwd", err,
              lambda i: fv.run_fwd2(q, k, v),
              lambda i: fv.run_fwd2_plain(q, k, v), None, fwd_bound,
              plain_iters=2)
    r.update(dtype="run_fwd2_in_kernel_scale", library_ms=lib_fwd,
             library="sdpa forward")
    rows.append(r)
    for r in rows:
        r["shape"] = "bench"
    return rows


def check_launched(launches, names, what):
    """Each kernel of ``names`` launched at least once on the path."""
    for n in names:
        if not launches[n] > 0:
            raise AssertionError(f"{n}: no launch on {what}")


def experiments(torch, fns, xdot, xfv):
    """Phase 7: the two experiments' entry points, each with every launch
    count set to 0 just before it and read just after; the blocked
    kernel's error against torch.mm and each flash variant's against the
    production kernels held to their bounds."""
    zero_counts(fns)
    dot = xdot.main(["20"])
    dlaunches = read_counts(fns)
    check_launched(dlaunches, ["blocked_matmul"], "the dot experiment")
    blocked = [r for r in dot if "tile" in r]
    if len(blocked) != 4:
        raise AssertionError(f"{len(blocked)} blocked rows, wanted 4")
    for r in blocked:
        limit = TOL["torch.bfloat16"][0] * r["out_abs_max"]
        if not r["max_abs_err"] <= limit:
            raise AssertionError(f"{r['tag']}: max |err| against torch.mm "
                                 f"{r['max_abs_err']} > {limit}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0 for r in dot):
        raise AssertionError(f"a dot variant's time is not finite: {dot}")
    zero_counts(fns)
    flash = xfv.main([])
    flaunches = read_counts(fns)
    check_launched(flaunches, ["flash_variants_fwd", "flash_variants_bwd",
                               "flash_attention_fwd", "flash_attention_bwd_dq",
                               "flash_attention_bwd_dkv"],
                   "the flash experiment")
    for r in flash["parity"]:
        for key, big in (("out_max_diff", "out_abs_max"),
                         ("grad_max_diff", "grad_abs_max")):
            if not r[key] <= PARITY_OF_MAX * r[big]:
                raise AssertionError(f"flash variant parity {r}: {key} > "
                                     f"{PARITY_OF_MAX} of {big}")
    if not all(math.isfinite(r["ms"]) and r["ms"] > 0
               for r in flash["timing"]):
        raise AssertionError("a flash variant's time is not finite")
    return {"dot_variants": dot, "flash_variants": flash}, dlaunches, \
        flaunches


# ---------------------------------------------------------------------------
# phase 3: the engine
# ---------------------------------------------------------------------------

def zero_counts(fns):
    for fn, attr in fns.values():
        setattr(fn, attr, 0)


def read_counts(fns):
    return {n: getattr(fn, attr) for n, (fn, attr) in fns.items()}


def serve(torch, ServingEngine, fns, params, cfg, reqs, max_len):
    """Serve ``reqs`` once to warm up, then again with every launch count
    at 0; returns the timed run's stats, the launch counts and the tokens
    of each request."""
    def engine():
        return ServingEngine(cfg, params, slots=8, max_len=max_len,
                             chunk=16, prompt_buckets=(64, 128, 256),
                             device=DEVICE)

    warm = engine()
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    rids = [eng.add_request(p, g) for p, g in reqs]
    zero_counts(fns)
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)

    check_tokens(out, rids, reqs, cfg)
    ticks = eng.last_run_ticks
    L = cfg.num_layers
    check_counts(launches, {
        "ragged_decode_attention": L * ticks,
        "fused_rms_norm": (L + 1) * ticks,
        "fused_add_rms_norm": L * ticks, "fused_rope_qk": L * ticks,
        "ragged_paged_attention": 0}, f"{ticks} ticks")
    new_tokens = sum(g for _, g in reqs)
    return {"requests": len(reqs), "new_tokens": new_tokens,
            "wall_s": wall, "tokens_per_s": new_tokens / wall,
            "ticks": ticks, "chunks": eng.last_run_chunks,
            "ms_per_tick": 1e3 * wall / max(1, ticks)}, launches, \
        [out[r] for r in rids]


def check_tokens(out, rids, reqs, cfg):
    for rid, (p, g) in zip(rids, reqs):
        toks = out[rid]
        if len(toks) != g:
            raise AssertionError(f"request {rid}: {len(toks)} tokens, "
                                 f"wanted {g}")
        if not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"request {rid}: token out of vocab")


def check_counts(launches, want, what):
    """Each kernel launched exactly as often as the path needs it (a kernel
    ``want`` does not name, never), and a kernel of the path at least
    once."""
    for n, c in launches.items():
        if c != want.get(n, 0):
            raise AssertionError(f"{n}: {c} launches on the main path, "
                                 f"wanted {want.get(n, 0)} ({what})")
    if not any(launches.values()):
        raise AssertionError(f"no kernel launched on the main path ({what})")


def serve_paged(torch, ServingEngine, fns, params, cfg, reqs, max_len):
    """Phase 3b: the same requests through the paged engine's segments
    (``run()`` drains in segments of 4 * chunk steps), after a warm-up
    run. Returns stats, launch counts and tokens."""
    def engine():
        return ServingEngine(cfg, params, slots=8, max_len=max_len,
                             chunk=16, prompt_buckets=(64, 128, 256),
                             paged=True, page_size=PAGE, device=DEVICE)

    warm = engine()
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run()
    torch.cuda.synchronize()

    eng = engine()
    rids = [eng.add_request(p, g) for p, g in reqs]
    zero_counts(fns)
    f0 = eng.fetches
    t0 = time.perf_counter()
    out = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)

    check_tokens(out, rids, reqs, cfg)
    leaks = eng.pager.leak_report()
    if leaks:
        raise AssertionError(f"paged drain leaked pages: {leaks}")
    steps = eng.last_run_ticks
    decode = steps - len(reqs)      # every request is admitted once
    L = cfg.num_layers
    check_counts(launches, {
        "ragged_paged_attention": L * steps, "ragged_decode_attention": 0,
        "fused_rms_norm": (L + 1) * decode,
        "fused_add_rms_norm": L * decode, "fused_rope_qk": L * decode},
        f"{steps} steps, {decode} decode steps")
    fetches = eng.fetches - f0
    if fetches != eng.last_run_chunks:
        raise AssertionError(f"{fetches} fetches for "
                             f"{eng.last_run_chunks} segments")
    # no host read inside a segment: issuing a segment's steps must not
    # synchronise with the card at all (PyTorch raises on any sync while
    # the debug mode is "error"); only finish_segment reads the device
    audit = engine()
    for p, g in reqs[:12]:
        audit.add_request(p, g)
    audited = 0
    while audit._queue or audit.free_slot_count() < audit.slots:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = audit.dispatch_segment(64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        audit.finish_segment(pending)
        audited += 1
    new_tokens = sum(g for _, g in reqs)
    return {"requests": len(reqs), "new_tokens": new_tokens,
            "wall_s": wall, "tokens_per_s": new_tokens / wall,
            "steps": steps, "decode_steps": decode, "admits": len(reqs),
            "segments": eng.last_run_chunks, "fetches": fetches,
            "sync_free_dispatches": audited,
            "ms_per_step": 1e3 * wall / max(1, steps),
            "pages": eng.pager.stats()}, launches, [out[r] for r in rids]


def prefix_burst(torch, sched, PagedPrefixCache, ServingEngine, fns,
                 params, cfg):
    """Phase 3c: the serving benchmark's shared-prefix burst (16 requests
    of a 192-token prefix and a 32-token tail, 32 generated tokens each,
    all at t = 0) through ``OnlineScheduler`` with a paged prefix cache.
    The warm pass of ``serve(warm=True)`` runs first as its own call, so
    the launch counts cover the measured pass alone."""
    prefix = np.random.RandomState(0).randint(
        0, cfg.vocab_size, (192,)).astype(np.int32)
    arrivals = sched.staggered_arrivals(0, 16, 0.0, cfg.vocab_size,
                                        prompt_lens=(32,), gen_lens=(32,),
                                        prefix=prefix)
    eng = ServingEngine(cfg, params, slots=8, max_len=384,
                        prompt_buckets=(32, 64, 128, 256), paged=True,
                        page_size=PAGE, device=DEVICE)
    pc = PagedPrefixCache(eng.pager, capacity_pages=512)
    sch = sched.OnlineScheduler(eng, seg_steps=16, prefix_cache=pc)
    sch.serve(arrivals)             # serve(warm=True) is this, reset, serve
    torch.cuda.synchronize()
    sch.reset()
    zero_counts(fns)
    rep = sch.serve(arrivals)
    torch.cuda.synchronize()
    launches = read_counts(fns)
    res = sch.results()
    if sorted(len(t) for t in res.values()) != [32] * 16:
        raise AssertionError("prefix burst: a request got the wrong count")
    if rep.prefix["hits"] < 1 or eng.pager.cow_breaks != 0:
        raise AssertionError(f"prefix burst: {rep.prefix['hits']} hits, "
                             f"{eng.pager.cow_breaks} COW breaks")
    steps = rep.ticks
    decode = steps - len(arrivals)  # every request is admitted once
    L = cfg.num_layers
    check_counts(launches, {
        "ragged_paged_attention": L * steps, "ragged_decode_attention": 0,
        "fused_rms_norm": (L + 1) * decode,
        "fused_add_rms_norm": L * decode, "fused_rope_qk": L * decode},
        f"prefix burst: {steps} steps, {decode} decode steps")
    pc.clear()
    leaks = eng.pager.leak_report()
    if leaks:
        raise AssertionError(f"prefix burst leaked pages: {leaks}")
    out = {k: getattr(rep, k) for k in (
        "n_requests", "total_tokens", "makespan_s", "throughput_tok_s",
        "ttft_p50_s", "ttft_p99_s", "e2e_p50_s", "e2e_p99_s",
        "queue_wait_p50_s", "slot_occupancy", "segments", "ticks")}
    out["prefix"] = rep.prefix
    # ``prefix["hits"]`` counts matches when a request is picked, so a
    # request picked, requeued for want of a slot and picked again counts
    # twice; this counts the requests that were admitted on a hit
    out["requests_admitted_on_a_hit"] = sum(
        r["prefix_hit_len"] > 0 for r in rep.per_request)
    out["decode_steps"] = decode
    out["pages"] = rep.pages
    return out, launches


def paged_counts(L, steps, decode, quant=False):
    """The launches a paged drain of ``steps`` steps (``decode`` of them
    decode ticks, the rest admits) needs: the tick kernels on every decode
    tick; the paged kernel on every step of an unquantized pool, none on a
    quantized one (the dequantizing gather); on a quantized tree,
    ``quant_matmul`` for the tick's 7 projections per layer and lm_head,
    and the admit's lm_head."""
    want = {"fused_rms_norm": (L + 1) * decode,
            "fused_add_rms_norm": L * decode, "fused_rope_qk": L * decode,
            "ragged_paged_attention": 0 if quant else L * steps}
    if quant:
        want["quant_matmul"] = (7 * L + 1) * decode + (steps - decode)
    return want


def paged_engine(ServingEngine, params, cfg, max_len, **kw):
    """The paged engine of phases 3b-3e: 8 slots, pages of 16."""
    return ServingEngine(cfg, params, slots=8, max_len=max_len, chunk=16,
                         prompt_buckets=(64, 128, 256), paged=True,
                         page_size=PAGE, device=DEVICE, **kw)


def digest_drain(torch, fns, eng, cfg, rs):
    """``run()``'s drain of requests ``rs`` on a paged engine with quality
    digests, every launch count at 0 before it and read after, the
    finished requests (their digests) kept before ``collect_finished``
    hands back their tokens, as the JAX fleet's shadow harvest does.
    Checks the tokens, the pages, the launches and one fetch per segment.
    Returns (stats, launches, [(tokens, digests)] in request order)."""
    rids = [eng.add_request(p, g) for p, g in rs]
    zero_counts(fns)
    f0 = eng.fetches
    eng.last_run_ticks = eng.last_run_chunks = 0
    t0 = time.perf_counter()
    while eng._queue or eng.free_slot_count() < eng.slots:
        eng.run_segment(4 * eng.chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    finished = list(eng._finished)
    out = eng.collect_finished()
    digests = {r.rid: r.digests for r in finished}
    check_tokens(out, rids, rs, cfg)
    if eng.pager.leak_report():
        raise AssertionError(f"leaked pages: {eng.pager.leak_report()}")
    steps = eng.last_run_ticks
    decode = steps - len(rs)    # every request is admitted once
    check_counts(launches,
                 paged_counts(cfg.num_layers, steps, decode, eng.quant),
                 f"quant={eng.quant}: {steps} steps, {decode} decode")
    if eng.fetches - f0 != eng.last_run_chunks:
        raise AssertionError(f"{eng.fetches - f0} fetches for "
                             f"{eng.last_run_chunks} segments")
    new = sum(g for _, g in rs)
    stats = {"requests": len(rs), "new_tokens": new, "wall_s": wall,
             "tokens_per_s": new / wall, "steps": steps,
             "decode_steps": decode, "segments": eng.last_run_chunks,
             "fetches": eng.fetches - f0,
             "ms_per_step": 1e3 * wall / max(1, steps)}
    return stats, launches, [(out[r], digests[r]) for r in rids]


def score_pairs(compare_pair, prim, shad):
    """``compare_pair`` over requests: [(tokens, digests or None)] of the
    primary and of the shadow serve, aggregated. The matched-prefix rate
    is the matched tokens (up to each first divergence) over the tokens
    compared; KL mean is over all scored positions."""
    pairs = [compare_pair(pt, st, pd, sd)
             for (pt, pd), (st, sd) in zip(prim, shad)]
    compared = sum(r["compared"] for r in pairs)
    kl_pos = sum(r["kl_positions"] for r in pairs)
    return {"matched_prefix_rate": sum(r["tokens_matched"]
                                       for r in pairs) / compared,
            "requests_identical": sum(r["match"] for r in pairs),
            "requests": len(pairs),
            "logit_positions": sum(r["logit_positions"] for r in pairs),
            "logit_max_abs_err": max(
                (r["logit_max_abs_err"] for r in pairs
                 if r["logit_max_abs_err"] is not None), default=None),
            "kl_positions": kl_pos,
            "kl_mean": (sum(r["kl_mean"] * r["kl_positions"]
                            for r in pairs if r["kl_positions"])
                        / kl_pos if kl_pos else None),
            "kl_max": max((r["kl_max"] for r in pairs
                           if r["kl_max"] is not None), default=None)}


def quant_serve(torch, ServingEngine, compare_pair, fns, params, cfg, reqs,
                max_len):
    """Phase 3d: the requests through the int8 paged engine with quality
    digests (after a warm-up run), its launches and fetches checked and
    its segment dispatch audited for host syncs; the same requests through
    a bf16 paged engine with digests, the shadow, each request scored with
    ``compare_pair`` (reported: on these random weights the bar is not
    asserted, see ``quant_trained``); then an fp8 engine on the first 8
    requests."""
    warm = paged_engine(ServingEngine, params, cfg, max_len, quant="int8",
                        quality_digest=True)
    for p, g in reqs[:8]:
        warm.add_request(p, g)
    warm.run()
    torch.cuda.synchronize()
    eng = paged_engine(ServingEngine, params, cfg, max_len, quant="int8",
                       quality_digest=True)
    if not (eng.quant_kernel_active() and not eng.paged_kernel_active()):
        raise AssertionError("the int8 engine does not route its "
                             "projections to quant_matmul")
    stats, launches, primary = digest_drain(torch, fns, eng, cfg, reqs)
    # no host read while a segment is issued, digests included
    audited = 0
    for p, g in reqs[:12]:
        eng.add_request(p, g)
    while eng._queue or eng.free_slot_count() < eng.slots:
        torch.cuda.set_sync_debug_mode("error")
        try:
            pending = eng.dispatch_segment(64)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        eng.finish_segment(pending)
        audited += 1
    eng.collect_finished()
    stats["sync_free_dispatches"] = audited
    shadow, _, shadow_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quality_digest=True), cfg, reqs)
    fp8, fp8_launches, fp8_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quant="fp8", quality_digest=True), cfg,
        reqs[:8])
    fp8["quality_against_bf16"] = score_pairs(compare_pair, fp8_out,
                                              shadow_out[:8])
    return ({"int8": stats, "bf16_shadow": shadow, "fp8": fp8,
             "int8_against_bf16": score_pairs(compare_pair, primary,
                                              shadow_out)},
            launches, fp8_launches)


def memorize(torch, llama, params, cfg, tokens, lr=1e-4, max_steps=60):
    """Phase 3e's model: more AdamW steps on phase 5's batch (a fresh
    optimizer state) until its loss is below ``MEMO_LOSS`` or ``max_steps``
    ran; returns the losses. A model that has memorized its batch is
    confident on continuations of those sequences."""
    opt = llama.init_opt_state(params)
    step = llama.make_train_step(cfg, lr=lr)
    losses = []
    while len(losses) < max_steps and (not losses
                                       or losses[-1] >= MEMO_LOSS):
        losses.append(step(params, opt, tokens, tokens)[2].item())
    del opt
    return losses


def quant_trained(torch, ServingEngine, compare_pair, fns, params, cfg,
                  reqs, max_len):
    """Phase 3e: the quality bar on the memorized model (cast to bf16),
    served continuations of its training sequences: the requests through
    the int8 engine and through the bf16 engine, both with digests, each
    request scored with ``compare_pair``; the matched-prefix rate must be
    at least ``MATCHED_PREFIX_FLOOR``."""
    int8, launches, primary = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quant="int8", quality_digest=True), cfg,
        reqs)
    shadow, _, shadow_out = digest_drain(
        torch, fns, paged_engine(ServingEngine, params, cfg, max_len,
                                 quality_digest=True), cfg, reqs)
    quality = score_pairs(compare_pair, primary, shadow_out)
    if not quality["matched_prefix_rate"] >= MATCHED_PREFIX_FLOOR:
        raise AssertionError(f"int8 against bf16 on the trained weights: "
                             f"matched-prefix rate "
                             f"{quality['matched_prefix_rate']} < "
                             f"{MATCHED_PREFIX_FLOOR}")
    return {"int8": int8, "bf16_shadow": shadow,
            "int8_against_bf16": quality,
            "outputs": (primary, shadow_out)}, launches


def eager_and_device_ms(torch, step, iters):
    """ms per call of ``step()`` issued eagerly (host clock around
    ``iters`` calls and a synchronize), and the device ms of the same
    call captured in a CUDA graph and replayed."""
    from paddle_tpu_torch.experiments._timing import events_ms

    with torch.no_grad():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        eager = 1e3 * (time.perf_counter() - t0) / iters
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        graph.replay()

        def replay():
            for _ in range(iters):
                graph.replay()
        device = events_ms(replay) / iters
        del graph
    return eager, device


def paged_step_breakdown(torch, llama, params, cfg, max_len, iters=50,
                         quant=None):
    """The paged engine's two kinds of step at the engine's shape: a
    decode tick over 8 slots (positions spread over the window, a
    shuffled page table) and an admit prefill ([1, 256] at context 0),
    each eager and as a CUDA-graph replay: the device's busy share of
    the eager step. ``quant``: a quantized tree's steps on a pool of that
    mode."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    pool = llama.init_paged_pool(cfg, P, PAGE, DEVICE, quant=quant)
    pt = torch.from_numpy(np.random.RandomState(2).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    nxt = torch.arange(B, device=DEVICE)[:, None]
    pos = torch.linspace(0, max_len - 1, B, device=DEVICE).to(torch.int32)
    live = torch.ones(B, dtype=torch.bool, device=DEVICE)
    prompt = torch.arange(256, device=DEVICE)[None] % cfg.vocab_size
    zero = torch.zeros(1, dtype=torch.int32, device=DEVICE)
    out = {}
    for name, step in (
            ("decode", lambda: llama.forward_with_pages(
                params, nxt, cfg, pool, pt, pos, live=live)),
            ("admit_prefill", lambda: llama.forward_with_pages(
                params, prompt, cfg, pool, pt[:1], zero, logit_pos=200))):
        eager, device = eager_and_device_ms(torch, step, iters)
        out[name] = {"eager_ms": eager, "device_ms": device,
                     "device_busy_share": device / eager}
    return out


def tick_breakdown(torch, llama, params, cfg, max_len, rows, iters=50):
    """One ragged decode tick at the engine's shape (8 slots, positions
    spread over the window): its eager time per tick, the device time of
    the same tick captured in a CUDA graph and replayed, and the four
    kernels' share of that device time, estimated from their per-call
    device times at the serving shape (bf16) times their launches per
    tick."""
    B, L = 8, cfg.num_layers
    cache = llama.init_kv_cache(cfg, B, max_len, DEVICE)
    nxt = torch.arange(B, device=DEVICE)[:, None]
    pos = torch.linspace(0, max_len - 1, B, device=DEVICE).to(torch.int32)
    eager, device = eager_and_device_ms(
        torch, lambda: llama.forward_with_cache(params, nxt, cfg, cache, pos),
        iters)
    per_tick = {"ragged_decode_attention": L, "fused_rms_norm": L + 1,
                "fused_add_rms_norm": L, "fused_rope_qk": L}
    kern = sum(n * next(r["ms"] for r in rows if r["name"] == name
                        and r["shape"] == "serving"
                        and r["dtype"] == "bfloat16")
               for name, n in per_tick.items())
    return {"eager_ms_per_tick": eager, "device_ms_per_tick": device,
            "device_busy_share": device / eager,
            "kernel_device_ms_per_tick": kern,
            "kernel_share_of_device": kern / device}


# ---------------------------------------------------------------------------
# phase 4: teacher-forced ticks, kernel path against plain path
# ---------------------------------------------------------------------------

def teacher_forced(torch, llama, da, tf, params, cfg, reqs, max_len, ticks):
    B = 8
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    if prompt.shape[0] != B:
        raise AssertionError("workload has too few prompts of >= 64 tokens")
    cache_k = llama.init_kv_cache(cfg, B, max_len, DEVICE)
    with torch.no_grad():
        llama.forward_with_cache(params, prompt, cfg, cache_k, 0)
    cache_p = {k: v.clone() for k, v in cache_k.items()}
    # ragged positions: row b continues after its first lens[b] tokens
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(da, "ragged_decode_attention",
                               da.ragged_decode_attention_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_cache(params, nxt[:, None], cfg,
                                             cache_k, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_cache(params, nxt[:, None], cfg,
                                                 cache_p, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"teacher-forced logits differ by {max_err} > "
                             f"{LOGIT_ATOL}")
    return {"ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL,
            "greedy_agreement": agree / (ticks * B)}


def teacher_forced_paged(torch, llama, pa, tf, params, cfg, reqs, max_len,
                         ticks):
    """Phase 4b: phase 4 on a paged pool behind a shuffled page table:
    the 8 prompts prefill at context 0 in one [8, 64] chunk, then ragged
    ticks run through the kernels and through the plain versions side
    by side."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    pt = torch.from_numpy(np.random.RandomState(1).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    pool_k = llama.init_paged_pool(cfg, P, PAGE, DEVICE)
    with torch.no_grad():
        llama.forward_with_pages(params, prompt, cfg, pool_k, pt,
                                 torch.zeros(B, dtype=torch.int32,
                                             device=DEVICE))
    pool_p = {k: v.clone() for k, v in pool_k.items()}
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(pa, "ragged_paged_attention",
                               pa.ragged_paged_attention_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_pages(params, nxt[:, None], cfg,
                                             pool_k, pt, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_pages(params, nxt[:, None], cfg,
                                                 pool_p, pt, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"paged teacher-forced logits differ by "
                             f"{max_err} > {LOGIT_ATOL}")
    return {"ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL,
            "greedy_agreement": agree / (ticks * B)}


def teacher_forced_quant(torch, llama, qm, qs, tf, params, cfg, reqs,
                         max_len, ticks, mode="int8"):
    """Phase 4c: phase 4b with the parameters quantized and a quantized
    pool: every tick projection and lm_head through ``quant_matmul`` and
    the tick kernels, against the same ticks with those swapped for their
    plain versions; attention is the dequantizing gather on both."""
    B = 8
    max_pages = max_len // PAGE
    P = B * max_pages + 1
    qparams = qs.quantize_llama_params(params, cfg, mode)
    prompt = torch.tensor(np.stack([p[:64] for p, _ in reqs
                                    if len(p) >= 64][:B]),
                          dtype=torch.int64, device=DEVICE)
    pt = torch.from_numpy(np.random.RandomState(1).permutation(
        np.arange(1, P)).reshape(B, max_pages).astype(np.int32)).to(DEVICE)
    pool_k = llama.init_paged_pool(cfg, P, PAGE, DEVICE, quant=mode)
    with torch.no_grad():
        llama.forward_with_pages(qparams, prompt, cfg, pool_k, pt,
                                 torch.zeros(B, dtype=torch.int32,
                                             device=DEVICE))
    pool_p = {k: v.clone() for k, v in pool_k.items()}
    lens = torch.tensor([64, 1, 17, 33, 48, 63, 5, 40], dtype=torch.int32,
                        device=DEVICE)
    nxt = prompt[torch.arange(B, device=DEVICE), lens.long() - 1]
    plain = [mock.patch.object(tf, "fused_rms_norm", tf.rms_norm_plain),
             mock.patch.object(tf, "fused_add_rms_norm",
                               tf.add_rms_norm_plain),
             mock.patch.object(tf, "fused_rope_qk", tf.rope_qk_plain),
             mock.patch.object(qm, "quant_matmul", qm.quant_matmul_plain)]
    max_err, agree = 0.0, 0
    pos = lens.clone()
    with torch.no_grad():
        for _ in range(ticks):
            lk, _ = llama.forward_with_pages(qparams, nxt[:, None], cfg,
                                             pool_k, pt, pos)
            for p in plain:
                p.start()
            try:
                lp, _ = llama.forward_with_pages(qparams, nxt[:, None], cfg,
                                                 pool_p, pt, pos)
            finally:
                for p in plain:
                    p.stop()
            if not torch.isfinite(lk).all():
                raise AssertionError("non-finite logits on the kernel path")
            max_err = max(max_err, (lk - lp).abs().max().item())
            agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
            nxt = lk.argmax(-1)          # the kernel path is the teacher
            pos = pos + 1
    if max_err > LOGIT_ATOL:
        raise AssertionError(f"quantized teacher-forced logits differ by "
                             f"{max_err} > {LOGIT_ATOL}")
    return {"mode": mode, "ticks": ticks, "max_abs_logit_err": max_err,
            "logit_atol": LOGIT_ATOL, "greedy_agreement": agree / (ticks * B)}


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

def plain_kernels(fa, hd):
    """Every training kernel swapped for its plain version."""
    return [mock.patch.object(fa, "flash_attention_fwd",
                              fa.flash_attention_fwd_plain),
            mock.patch.object(fa, "flash_attention_bwd_dq",
                              fa.flash_attention_bwd_dq_plain),
            mock.patch.object(fa, "flash_attention_bwd_dkv",
                              fa.flash_attention_bwd_dkv_plain),
            mock.patch.object(hd, "head_dx_softmax",
                              hd.head_dx_softmax_plain)]


PROFILER_RECORDS = ("Activity Buffer Request", "Runtime Triggered Module",
                    "Lazy Function Loading")
# device kernel names: the port's training kernels, cuBLAS's matmuls
HAND_WRITTEN = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                "head_dx_kernel")
MATMUL = ("nvjet", "gemm", "xmma")


def train_vs_plain(torch, llama, fa, hd, params, cfg, tokens):
    """Phase 5a: one ``loss_fn`` value and gradient through the kernels and
    through their plain versions, on the same master weights and tokens."""
    def loss_and_grads():
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = llama.loss_fn(leaves, tokens, tokens, cfg)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss.item(), dict(zip(leaves, grads))

    lk, gk = loss_and_grads()
    patches = plain_kernels(fa, hd)
    for p in patches:
        p.start()
    try:
        lp, gp = loss_and_grads()
    finally:
        for p in patches:
            p.stop()
    errs = {k: ((gk[k] - g).norm() / g.norm()).item() for k, g in gp.items()}
    finite = all(torch.isfinite(g).all().item() for g in gk.values())
    out = {"batch": list(tokens.shape), "loss_kernels": lk, "loss_plain": lp,
           "loss_abs_err": abs(lk - lp), "loss_atol": TRAIN_LOSS_ATOL,
           "grad_rel_err": errs, "grad_rtol": TRAIN_GRAD_RTOL}
    if not (math.isfinite(lk) and finite):
        raise AssertionError("non-finite loss or gradient on the kernel path")
    if abs(lk - lp) > TRAIN_LOSS_ATOL:
        raise AssertionError(f"loss {lk} against the plain path's {lp}")
    worst = max(errs, key=errs.get)
    if errs[worst] > TRAIN_GRAD_RTOL:
        raise AssertionError(f"gradient of {worst} differs by "
                             f"{errs[worst]} of its norm")
    return out


def device_profile(torch, run, kinds=None):
    """Device time of ``run()`` by kernel from ``torch.profiler``: total
    ms, its split by ``kinds`` (category -> substrings of kernel names, in
    order; by default the port's hand-written kernels and cuBLAS matmuls)
    and the rest (PyTorch's elementwise and reduction kernels), and the
    twelve largest entries (None where the profiler saw no device time). Only
    device entries count: the host operators that launch them report the
    same time again, and the profiler's own buffer and module-loading
    records are no kernels. ``wall_ms`` is the host clock around the same
    ``run()`` and its synchronize, so the busy share it gives reads device
    and wall time from one run (the profiler's host cost included)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows, host = [], []
    for e in prof.key_averages():
        us = e.self_device_time_total
        if (e.device_type == torch.autograd.DeviceType.CUDA and us > 0
                and not e.key.startswith(PROFILER_RECORDS)):
            rows.append((e.key, us / 1e3, e.count))
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append((e.key, e.self_cpu_time_total / 1e3, e.count))
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    kinds = kinds or {"hand_written": HAND_WRITTEN, "matmul": MATMUL}
    split = {part: 0.0 for part in [*kinds, "other"]}
    largest = {part: [] for part in split}
    for k, ms, c in rows:
        part = next((part for part, names in kinds.items()
                     if any(n in k for n in names)), "other")
        split[part] += ms
        if len(largest[part]) < 3:
            largest[part].append({"name": k[:90], "ms": ms, "calls": c})
    return {"device_ms": sum(r[1] for r in rows), "wall_ms": wall_ms,
            "split_ms": split, "largest_by_kind": largest,
            "top": [{"name": k[:90], "ms": ms, "calls": c}
                    for k, ms, c in rows[:12]],
            "host_top": [{"name": k[:60], "self_ms": ms, "calls": c}
                         for k, ms, c in host[:10]]}


def train_run(torch, llama, fns, params, cfg, tokens, lr=1e-4, warmup=2,
              steps=10):
    """Phases 5b-5d: ``make_train_step`` at bench.py's batch; two warm-up
    steps, then ``steps`` timed ones with every launch count at 0 before
    them; then one profiled step for the device's busy share: its device
    time over its own wall time."""
    opt = llama.init_opt_state(params)
    step = llama.make_train_step(cfg, lr=lr)
    losses = []
    for _ in range(warmup):
        losses.append(step(params, opt, tokens, tokens)[2].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    timed_losses = []
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        timed_losses.append(step(params, opt, tokens, tokens)[2])
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    L = cfg.num_layers
    check_counts(launches, {
        "flash_attention_fwd": L * steps, "flash_attention_bwd_dq": L * steps,
        "flash_attention_bwd_dkv": L * steps, "head_dx_softmax": steps},
        f"{steps} train steps")
    peak = torch.cuda.max_memory_allocated()
    losses += [t.item() for t in timed_losses]
    with torch.no_grad():
        final = llama.loss_fn(params, tokens, tokens, cfg).item()
    if not all(math.isfinite(x) for x in losses + [final]):
        raise AssertionError(f"non-finite training loss: {losses}, {final}")
    if not final < losses[0]:
        raise AssertionError(f"the loss did not fall: {losses[0]} at step 0, "
                             f"{final} after {warmup + steps} steps")
    prof = device_profile(torch, lambda: step(params, opt, tokens, tokens))
    B, S = tokens.shape
    ms_step = 1e3 * wall / steps
    out = {"batch": [B, S], "lr": lr, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall, "ms_per_step": ms_step,
           "tokens_per_s": B * S * steps / wall,
           "event_ms_per_step": start.elapsed_time(end) / steps,
           "peak_memory_bytes": peak, "losses": losses,
           "loss_after": final}
    if prof is None:
        out["device_ms_per_step"] = "not measured"
    else:
        out["device_ms_per_step"] = prof["device_ms"]
        out["profiled_step_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        out["device_split_ms"] = prof["split_ms"]
        out["device_top"] = prof["top"]
    return out, launches


# ---------------------------------------------------------------------------
# phase 6: ResNet-50 training
# ---------------------------------------------------------------------------

# BASELINE config 1, as benchmarks/resnet50.py pins it: ResNet-50
# NHWC, B 128 at 224x224, Momentum(0.1, 0.9, weight decay 1e-4), AMP O2
# bf16, CrossEntropyLoss, fused_train_step; inputs from RandomState(0)
RESNET_BATCH, RESNET_SIZE, RESNET_CLASSES = 128, 224, 1000
RESNET_LR, RESNET_MOMENTUM, RESNET_WD = 0.1, 0.9, 1e-4
# kernel path against plain path, two steps from the same weights under
# deterministic cuDNN (TF32 off, as set for the whole script): the update
# is the same arithmetic on both paths, so a first step that differs in
# any bit would show; bf16 params and fp32 statistics to the phase-2
# tolerances of the update
RESNET_LOSS_ATOL = 1e-3
# device kernel names by kind, for the step's time split
RESNET_KINDS = {
    "update": ("momentum_kernel", "adam_kernel", "sgd_kernel",
               "lamb_kernel"),
    "pack": ("CatArrayBatchedCopy",),
    "conv": ("xmma", "conv", "implicit_gemm", "wgrad", "dgrad", "fprop",
             "cutlass", "nhwcTo", "nchwTo", "Nhwc", "Nchw"),
    "batch_norm": ("batch_norm", "bn_fw", "bn_bw", "batchnorm", "welford"),
    "matmul": MATMUL,
}


def resnet_batch(torch):
    """Batch 0 of benchmarks/resnet50.py's three prepared host batches
    (its draws in its order: three image arrays, then three label
    arrays), on the card."""
    rng = np.random.RandomState(0)
    shape = (RESNET_BATCH, RESNET_SIZE, RESNET_SIZE, 3)
    xs = [rng.rand(*shape).astype(np.float32) for _ in range(3)]
    ys = [rng.randint(0, RESNET_CLASSES, (RESNET_BATCH,)) for _ in range(3)]
    return (torch.from_numpy(xs[0]).to(DEVICE),
            torch.from_numpy(ys[0]).to(DEVICE))


def resnet_train(port, opt_name="momentum"):
    """The model (the port's initializers, seed 0), its optimizer under
    ``amp.decorate`` O2 and the ``fused_train_step`` over them."""
    port.seed(0)
    model = port.vision.models.resnet50(num_classes=RESNET_CLASSES,
                                        data_format="NHWC")
    model.train()
    opt = port.optimizer.Momentum(
        learning_rate=RESNET_LR, momentum=RESNET_MOMENTUM,
        parameters=model.parameters(), weight_decay=RESNET_WD)
    model, opt = port.amp.decorate(models=model, optimizers=opt, level="O2",
                                   dtype="bfloat16")
    return model, opt, resnet_step(port, model, opt)


def resnet_step(port, model, opt):
    ce = port.nn.CrossEntropyLoss()

    def loss_fn(x, y):
        with port.amp.auto_cast(level="O2", dtype="bfloat16"):
            return ce(model(x), y)
    return port.jit.fused_train_step(loss_fn, opt, model=model)


def resnet_vs_plain(torch, port, mtu, fns, x, y, steps=2):
    """Phase 6.1: two steps through the kernel and two through its plain
    version, each from the seed's weights, under deterministic cuDNN: the
    losses, every updated parameter and every BN running statistic.
    Returns the comparison and the kernel path's (model, opt, step)."""
    torch.backends.cudnn.deterministic = True
    runs = []
    try:
        for plain in (False, True):
            model, opt, step = resnet_train(port)
            zero_counts(fns)
            with (mock.patch.object(mtu, "multi_tensor_update",
                                    mtu.flat_update_plain) if plain
                  else contextlib.nullcontext()):
                losses = [step(x, y).item() for _ in range(steps)]
            n = read_counts(fns)["multi_tensor_update"]
            if n != (0 if plain else steps):
                raise AssertionError(f"{n} multi_tensor_update launches in "
                                     f"{steps} steps of the "
                                     f"{'plain' if plain else 'kernel'} path")
            runs.append((losses, {k: v.detach().clone() for k, v in
                                  model.state_dict().items()},
                         (model, opt, step)))
    finally:
        torch.backends.cudnn.deterministic = False
    (lk, sk, kernel_path), (lp, sp, _) = runs
    out = {"losses_kernel": lk, "losses_plain": lp,
           "loss_abs_err": max(abs(a - b) for a, b in zip(lk, lp)),
           "loss_atol": RESNET_LOSS_ATOL, "param_max_abs_err": 0.0,
           "bn_stat_max_abs_err": 0.0, "bit_identical": True}
    if not all(math.isfinite(v) for v in lk + lp):
        raise AssertionError(f"non-finite ResNet-50 loss: {lk}, {lp}")
    if out["loss_abs_err"] > RESNET_LOSS_ATOL:
        raise AssertionError(f"ResNet-50 losses {lk} against the plain "
                             f"path's {lp}")
    for k, got in sk.items():
        want = sp[k]
        out["bit_identical"] &= torch.equal(got, want)
        rtol, atol = MTU_TOL[str(want.dtype)]
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                                   msg=lambda m: f"ResNet-50 {k}: {m}")
        key = ("bn_stat_max_abs_err" if k.endswith(("._mean", "._variance"))
               else "param_max_abs_err")
        out[key] = max(out[key], (got.float() - want.float()).abs().max()
                       .item())
    return out, kernel_path


def resnet_run(torch, fns, step, x, y, warmup=2, steps=10):
    """Phase 6.2-6.3: ``warmup`` then ``steps`` timed steps on the host
    clock with every launch count at 0 before them (exactly one
    ``multi_tensor_update`` per step: the 161 params are one bf16 group),
    then one profiled step for the busy share and the time split."""
    for _ in range(warmup):
        step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(fns)
    t0 = time.perf_counter()
    losses = [step(x, y) for _ in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts(fns)
    check_counts(launches, {"multi_tensor_update": steps},
                 f"{steps} ResNet-50 steps")
    peak = torch.cuda.max_memory_allocated()
    losses = [t.item() for t in losses]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet-50 loss: {losses}")
    prof = device_profile(torch, lambda: step(x, y), kinds=RESNET_KINDS)
    out = {"batch": RESNET_BATCH, "size": RESNET_SIZE, "warmup_steps": warmup,
           "timed_steps": steps, "wall_s": wall,
           "ms_per_step": 1e3 * wall / steps,
           "images_per_s": RESNET_BATCH * steps / wall,
           "peak_memory_bytes": peak, "losses": losses}
    if prof is None:
        out["device_ms_per_step"] = "not measured"
    else:
        out["device_ms_per_step"] = prof["device_ms"]
        out["profiled_step_wall_ms"] = prof["wall_ms"]
        out["device_busy_share"] = prof["device_ms"] / prof["wall_ms"]
        out["device_split_ms"] = prof["split_ms"]
        out["update_kernel_share"] = (prof["split_ms"]["update"]
                                      / prof["device_ms"])
        out["device_top"] = prof["top"]
        out["device_largest_by_kind"] = prof["largest_by_kind"]
        out["host_top"] = prof["host_top"]
    return out, launches


def resnet_adamw(torch, port, fns, model, x, y, steps=3):
    """Phase 6.4: ``AdamW(multi_precision=True)`` on the O2 model, one
    adam-with-master launch per step; its state fp32 and flat."""
    opt = port.optimizer.AdamW(learning_rate=1e-3, weight_decay=0.01,
                               parameters=model.parameters(),
                               multi_precision=True)
    step = resnet_step(port, model, opt)
    zero_counts(fns)
    losses = [step(x, y).item() for _ in range(steps)]
    launches = read_counts(fns)
    check_counts(launches, {"multi_tensor_update": steps},
                 f"{steps} ResNet-50 AdamW steps")
    st = opt._accumulators[id(model.parameters()[0])]
    if not (st["master"].dtype == st["moment1"].dtype == torch.float32
            and st["master"].dim() == 2):
        raise AssertionError("O2 AdamW state is not fp32 and flat")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite ResNet-50 AdamW loss: {losses}")
    return {"steps": steps, "losses": losses}, launches


def kernels_line(rows, by_path):
    """The kernels' JSON line: for each kernel its route, source, the
    TPU kernel it replaces, its launches summed over the driven paths
    and its phase-2 row at the shape of the path that runs it."""
    meta = {
        "ragged_decode_attention": (
            "cuda", "paddle_tpu_torch/csrc/decode_attention.cu",
            "paddle_tpu/ops/pallas/decode_attention.py:220", "serving"),
        "fused_rms_norm": (
            "triton", "paddle_tpu_torch/ops/kernels/tick_fusion_triton.py",
            "paddle_tpu/ops/pallas/tick_fusion.py:88", "serving"),
        "fused_add_rms_norm": (
            "triton", "paddle_tpu_torch/ops/kernels/tick_fusion_triton.py",
            "paddle_tpu/ops/pallas/tick_fusion.py:111", "serving"),
        "fused_rope_qk": (
            "triton", "paddle_tpu_torch/ops/kernels/tick_fusion_triton.py",
            "paddle_tpu/ops/pallas/tick_fusion.py:159", "serving"),
        "ragged_paged_attention": (
            "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
            "paddle_tpu/ops/pallas/paged_attention.py:194",
            "serving_decode"),
        "flash_attention_fwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:647", "bench"),
        "flash_attention_bwd_dq": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:682", "bench"),
        "flash_attention_bwd_dkv": (
            "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
            "paddle_tpu/ops/pallas/flash_attention.py:682", "bench"),
        "head_dx_softmax": (
            "cuda", "paddle_tpu_torch/csrc/head_dx.cu",
            "paddle_tpu/ops/pallas/head_dx.py:86", "ce_tail"),
        "quant_matmul": (
            "cuda", "paddle_tpu_torch/csrc/quant_matmul.cu",
            "paddle_tpu/ops/pallas/tick_fusion.py:213", "w_gate_w_up"),
        "multi_tensor_update": (
            "cuda", "paddle_tpu_torch/csrc/multi_tensor_update.cu",
            "paddle_tpu/ops/pallas/multi_tensor_update.py:288", "resnet50"),
        "blocked_matmul": (
            "cuda", "paddle_tpu_torch/csrc/blocked_matmul.cu",
            "benchmarks/dot_variants.py:67", "lm_head_dx"),
        "flash_variants_fwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_variants_fwd.cu",
            "benchmarks/flash_variants.py:152", "bench"),
        "flash_variants_bwd": (
            "cuda", "paddle_tpu_torch/csrc/flash_variants_bwd.cu",
            "benchmarks/flash_variants.py:182", "bench"),
    }
    # the rows the line quotes: bf16 for the fp kernels, int8 weights for
    # quant_matmul, the main path's bf16 momentum for multi_tensor_update,
    # the fastest tile of blocked_matmul, the flash variants' baseline
    # (nsplit 1, the whole square)
    line_dtype = {"quant_matmul": "int8",
                  "multi_tensor_update": "momentum_bf16",
                  "blocked_matmul": "bm128_bn256_bk32",
                  "flash_variants_fwd": "run_fwd_nsplit1",
                  "flash_variants_bwd": "run_bwd_nsplit1"}
    # other TPU kernels the same kernels serve: the blocked flash kernels
    # (S > 512), the flash experiments' fwd2 and ablations
    also = {"flash_attention_fwd": ["paddle_tpu/ops/pallas/flash_attention.py:246"],
            "flash_attention_bwd_dq": ["paddle_tpu/ops/pallas/flash_attention.py:442"],
            "flash_attention_bwd_dkv": ["paddle_tpu/ops/pallas/flash_attention.py:458"],
            "flash_variants_fwd": ["benchmarks/flash_variants.py:352",
                                   "benchmarks/flash_variants.py:465"],
            "flash_variants_bwd": ["benchmarks/flash_variants.py:365"]}
    kernels = []
    for name, (route, source, replaces, at) in meta.items():
        r = next(r for r in rows if r["name"] == name and r["shape"] == at
                 and r["dtype"] == line_dtype.get(name, "bfloat16"))
        k = {"name": name, "route": route, "source": source,
             "replaces": replaces,
             "launches": sum(c[name] for c in by_path.values()),
             "launches_by_path": {p: c[name] for p, c in by_path.items()},
             "max_abs_err": r["max_abs_err"], "ms": r["ms"],
             "eager_ms": r["eager_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r["library_ms"]}
        if "gather_sdpa_ms" in r:
            k["gather_sdpa_ms_two_calls"] = r["gather_sdpa_ms"]
        if "gemm_only_ms" in r:
            k["gemm_only_ms"] = r["gemm_only_ms"]
        if name in also:
            k["also_replaces"] = also[name]
        if name in line_dtype:
            k["shape"], k["mode"] = at, line_dtype[name]
        if name in ("multi_tensor_update", "blocked_matmul",
                    "flash_variants_fwd", "flash_variants_bwd"):
            # every variant held against its plain version in phase 2
            k["variants"] = {
                v["dtype"]: {key: v[key] for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "library")}
                for v in rows if v["name"] == name}
        if name == "ragged_decode_attention":
            # the same kernel's quant mode (int8 pages with row scales, the
            # TPU kernel's k_scale / v_scale): no engine path calls it, in
            # the JAX package as here, so it is held by phase 2 alone
            q = next(r for r in rows if r["name"] == name + "_quant"
                     and r["shape"] == "serving" and r["dtype"] == "int8")
            k["quant_mode"] = {
                "launches": sum(c[name + "_quant"] for c in by_path.values()),
                "shape": "serving", "mode": "int8",
                **{key: q[key] for key in (
                    "max_abs_err", "ms", "eager_ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms")}}
        kernels.append(k)
    return kernels


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the card")
    if not (ROOT / "paddle_tpu_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository")
    sys.path.insert(0, str(ROOT))
    build_dir = ROOT / "paddle_tpu_torch" / "_build"
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir / "triton"))
    import torch.nn.functional as F

    import paddle_tpu_torch as port
    import paddle_tpu_torch.amp
    import paddle_tpu_torch.jit
    import paddle_tpu_torch.nn
    import paddle_tpu_torch.optimizer
    import paddle_tpu_torch.vision.models  # noqa: F401 (port.<module>)
    from paddle_tpu_torch import device as device_mod
    from paddle_tpu_torch.inference import scheduler as sched
    from paddle_tpu_torch.inference.prefix_cache import PagedPrefixCache
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.observability.quality import compare_pair
    from paddle_tpu_torch.experiments import dot_variants as xdot
    from paddle_tpu_torch.experiments import flash_variants as xfv
    from paddle_tpu_torch.ops.kernels import _build, launch_counters
    from paddle_tpu_torch.ops.kernels import blocked_matmul as bm
    from paddle_tpu_torch.ops.kernels import decode_attention as da
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import flash_variants as fv
    from paddle_tpu_torch.ops.kernels import head_dx as hd
    from paddle_tpu_torch.ops.kernels import multi_tensor_update as mtu
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.ops.kernels import tick_fusion as tf
    from paddle_tpu_torch.quantization import serving as qs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    card = smi_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    for b in _build.build_all():
        print(f"built {b['name']} in {b['seconds']:.2f} s")
        for line in str(b["log"]).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build: {time.perf_counter() - t0:.2f} s")

    # 2. kernels against their plain versions
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape in SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            for r in kernel_checks(torch, F, da, tf, shape, dtype, gen):
                rows.append(r)
                lib = ("null" if r["library_ms"] is None
                       else f"{r['library_ms']:.6g}")
                print(f"kernel {r['name']:24s} {r['shape']:8s} "
                      f"{r['dtype']:9s} max_abs_err {r['max_abs_err']:.3e} "
                      f"ms {r['ms']:.6g} eager_ms {r['eager_ms']:.6g} "
                      f"plain_ms {r['plain_ms']:.6g} library_ms {lib} "
                      f"bound_ms {r['bound_ms']:.6g} ({r['bound_by']})")
    for shape in PAGED_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            r = paged_checks(torch, F, pa, shape, dtype, gen)
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:22s} "
                  f"{r['dtype']:9s} max_abs_err {r['max_abs_err']:.3e} "
                  f"ms {r['ms']:.6g} eager_ms {r['eager_ms']:.6g} "
                  f"plain_ms {r['plain_ms']:.6g} gather+sdpa_ms (two calls) "
                  f"{r['gather_sdpa_ms']:.6g} (err "
                  f"{r['gather_sdpa_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']}) pages_read "
                  f"{r['pages_read']}")
    for shape in FLASH_SHAPES:
        for r in flash_checks(torch, F, fa, shape, gen):
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:10s} bfloat16  "
                  f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
                  f"eager_ms {r['eager_ms']:.6g} plain_ms "
                  f"{r['plain_ms']:.6g} library_ms {r['library_ms']:.6g} "
                  f"({r['library']}) bound_ms {r['bound_ms']:.6g} "
                  f"({r['bound_by']})")
    r = head_dx_checks(torch, hd, gen)
    rows.append(r)
    print(f"kernel {r['name']:24s} {r['shape']:10s} bfloat16  max_abs_err "
          f"{r['max_abs_err']:.3e} (atol {r['atol']:.3e} = 2^-7 of max "
          f"|out| {r['out_abs_max']:.3e}, rtol {r['rtol']}; relative "
          f"Frobenius error {r['fro_rel_err']:.3e} <= {r['fro_rtol']}) ms "
          f"{r['ms']:.6g} eager_ms "
          f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} library_ms "
          f"null (none; its GEMM alone: {r['gemm_only_ms']:.6g}) bound_ms "
          f"{r['bound_ms']:.6g} ({r['bound_by']})")
    for mode in ("int8", "fp8"):
        for shape in QMM_SHAPES:
            r = quant_matmul_checks(torch, qm, qs, mode, shape, gen)
            rows.append(r)
            print(f"kernel {r['name']:24s} {r['shape']:14s} {mode:4s} B "
                  f"{r['B']} K {r['K']} N {r['N']} max_abs_err "
                  f"{r['max_abs_err']:.3e} ms {r['ms']:.6g} eager_ms "
                  f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
                  f"library_ms (dequantize + mm) {r['library_ms']:.6g} "
                  f"(err {r['library_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']})")
        for shape in DECODE_QUANT_SHAPES:
            r = decode_quant_checks(torch, F, da, qs, mode, shape, gen)
            rows.append(r)
            print(f"kernel {r['name']:30s} {r['shape']:8s} {mode:4s} "
                  f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
                  f"eager_ms {r['eager_ms']:.6g} plain_ms "
                  f"{r['plain_ms']:.6g} library_ms (dequantize + sdpa) "
                  f"{r['library_ms']:.6g} (err "
                  f"{r['library_max_abs_err']:.3e}) bound_ms "
                  f"{r['bound_ms']:.6g} ({r['bound_by']})")
    mtu_shapes = resnet50_shapes(port.vision.models, device_mod)
    for variant in MTU_VARIANTS:
        r = multi_tensor_checks(torch, mtu, mtu_shapes, variant, gen)
        rows.append(r)
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.6g}")
        print(f"kernel {r['name']:24s} {r['shape']:8s} {r['dtype']:18s} "
              f"{r['elements']} elements {r['bytes_per_element']:.0f} B "
              f"each max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
              f"eager_ms {r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
              f"library_ms {lib} ({r['library']}) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    mtu_skip = multi_tensor_skip_check(torch, mtu, mtu_shapes, gen)
    print(f"multi_tensor_update skip = 1 left every buffer bit-identical: "
          f"{json.dumps(mtu_skip)}")
    for r in blocked_matmul_checks(torch, bm, gen):
        rows.append(r)
        print(f"kernel {r['name']:24s} {r['shape']:10s} {r['dtype']:18s} "
              f"max_abs_err {r['max_abs_err']:.3e} (torch.mm "
              f"{r['mm_max_abs_err']:.3e}) ms {r['ms']:.6g} eager_ms "
              f"{r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} library_ms "
              f"{r['library_ms']:.6g} (torch.mm) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    variant_errs = variant_matrix(torch, fv, gen)
    print(f"flash variants, every instance at B 4 against its plain "
          f"version, largest errors: {json.dumps(variant_errs)}")
    for r in variant_rows(torch, F, fv, gen):
        rows.append(r)
        print(f"kernel {r['name']:24s} {r['shape']:6s} {r['dtype']:26s} "
              f"max_abs_err {r['max_abs_err']:.3e} ms {r['ms']:.6g} "
              f"eager_ms {r['eager_ms']:.6g} plain_ms {r['plain_ms']:.6g} "
              f"library_ms {r['library_ms']:.6g} ({r['library']}) bound_ms "
              f"{r['bound_ms']:.6g} ({r['bound_by']})")
    print(f"kernel checks passed ({card})")

    # 3. the engine at bert_base_equiv width
    cfg = llama.LlamaConfig.bert_base_equiv()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs = mixed_workload(np.random.RandomState(0), 32, cfg.vocab_size)
    need = max(len(p) + g - 1 for p, g in reqs)
    max_len = min(cfg.max_seq_len, -(-need // 128) * 128)
    fns = launch_counters()
    stats, launches, toks_c = serve(torch, ServingEngine, fns, params, cfg,
                                    reqs, max_len)
    print(f"engine ({card}): bert_base_equiv bf16 slots 8 chunk 16 "
          f"max_len {max_len}: {stats['requests']} requests, "
          f"{stats['new_tokens']} tokens in {stats['wall_s']:.3f} s = "
          f"{stats['tokens_per_s']:.1f} tokens/s, {stats['ticks']} ticks, "
          f"{stats['chunks']} chunks, {stats['ms_per_tick']:.3f} ms/tick")
    print(f"launches on the contiguous drain: {json.dumps(launches)}")
    tick = tick_breakdown(torch, llama, params, cfg, max_len, rows)
    print(f"decode tick ({card}): {json.dumps(tick)}")

    # 3b. the paged engine, same requests
    pstats, plaunches, toks_p = serve_paged(torch, ServingEngine, fns,
                                            params, cfg, reqs, max_len)
    same = sum(a == b for a, b in zip(toks_c, toks_p))
    pos_same = sum(x == y for a, b in zip(toks_c, toks_p)
                   for x, y in zip(a, b))
    pstats["requests_identical_to_contiguous"] = same
    pstats["tokens_identical_to_contiguous"] = pos_same / sum(
        len(a) for a in toks_c)
    # two bf16 engines whose kernels round differently: how near-tied the
    # random weights' greedy choices are (the baseline for phase 3d's rate)
    pstats["against_contiguous"] = score_pairs(
        compare_pair, [(t, None) for t in toks_p],
        [(t, None) for t in toks_c])
    print(f"paged engine ({card}): bert_base_equiv bf16 slots 8 page 16 "
          f"max_len {max_len}: {pstats['new_tokens']} tokens in "
          f"{pstats['wall_s']:.3f} s = {pstats['tokens_per_s']:.1f} "
          f"tokens/s, {pstats['steps']} steps ({pstats['admits']} admits), "
          f"{pstats['segments']} segments, {pstats['fetches']} fetches "
          f"({pstats['sync_free_dispatches']} more segments issued with no "
          f"sync), "
          f"{pstats['ms_per_step']:.3f} ms/step; greedy agreement with the "
          f"contiguous engine: {same}/{len(reqs)} requests, "
          f"{pstats['tokens_identical_to_contiguous']:.4f} of tokens, "
          f"matched-prefix rate "
          f"{pstats['against_contiguous']['matched_prefix_rate']:.4f}")
    print(f"launches on the paged drain: {json.dumps(plaunches)}")
    psteps = paged_step_breakdown(torch, llama, params, cfg, max_len)
    print(f"paged steps ({card}): {json.dumps(psteps)}")

    # 3c. the shared-prefix burst through the online scheduler
    burst, blaunches = prefix_burst(torch, sched, PagedPrefixCache,
                                    ServingEngine, fns, params, cfg)
    print(f"prefix burst ({card}): {burst['total_tokens']} tokens, "
          f"{burst['throughput_tok_s']:.1f} tokens/s, ttft p50/p99 "
          f"{burst['ttft_p50_s']:.4f}/{burst['ttft_p99_s']:.4f} s, e2e "
          f"p50/p99 {burst['e2e_p50_s']:.4f}/{burst['e2e_p99_s']:.4f} s, "
          f"{burst['requests_admitted_on_a_hit']}/{burst['n_requests']} "
          f"requests admitted on a prefix hit ({burst['prefix']['hits']} "
          f"matches at picking, {burst['prefix']['hit_tokens']} hit tokens), "
          f"{burst['segments']} segments, {burst['ticks']} steps "
          f"({burst['decode_steps']} decode)")
    print(f"launches on the prefix burst: {json.dumps(blaunches)}")

    # 3d. quantized serving, scored against a bf16 shadow
    quant, qlaunches, f8launches = quant_serve(
        torch, ServingEngine, compare_pair, fns, params, cfg, reqs, max_len)
    quant["int8_steps"] = paged_step_breakdown(
        torch, llama, qs.quantize_llama_params(params, cfg, "int8"), cfg,
        max_len, quant="int8")
    q8, sh, f8 = quant["int8"], quant["bf16_shadow"], quant["fp8"]
    qual = quant["int8_against_bf16"]
    print(f"quantized engine ({card}): bert_base_equiv int8 weights and "
          f"pages, digests, slots 8 page 16 max_len {max_len}: "
          f"{q8['new_tokens']} tokens in {q8['wall_s']:.3f} s = "
          f"{q8['tokens_per_s']:.1f} tokens/s, {q8['steps']} steps, "
          f"{q8['ms_per_step']:.3f} ms/step, {q8['segments']} segments, "
          f"{q8['fetches']} fetches ({q8['sync_free_dispatches']} more "
          f"segments issued with no sync); bf16 shadow with digests "
          f"{sh['tokens_per_s']:.1f} tokens/s, {sh['ms_per_step']:.3f} "
          f"ms/step; fp8 (8 requests) {f8['tokens_per_s']:.1f} tokens/s")
    print(f"int8 against its bf16 shadow, random weights ({card}): "
          f"matched-prefix rate {qual['matched_prefix_rate']:.4f} (the bar "
          f"is held on a memorized model, phase 3e), "
          f"{qual['requests_identical']}/{len(reqs)} requests identical, "
          f"logit max abs err {qual['logit_max_abs_err']} over "
          f"{qual['logit_positions']} positions, KL mean {qual['kl_mean']} "
          f"max {qual['kl_max']} over {qual['kl_positions']}; fp8 (8 "
          f"requests): {json.dumps(f8['quality_against_bf16'])}")
    print(f"int8 paged steps ({card}): {json.dumps(quant['int8_steps'])}")
    print(f"launches on the int8 drain: {json.dumps(qlaunches)}")
    print(f"launches on the fp8 drain: {json.dumps(f8launches)}")

    # 4. teacher-forced ticks, contiguous cache and paged pool
    tfc = teacher_forced(torch, llama, da, tf, params, cfg, reqs, max_len,
                         ticks=16)
    print(f"teacher-forced ({card}): {json.dumps(tfc)}")
    tfp = teacher_forced_paged(torch, llama, pa, tf, params, cfg, reqs,
                               max_len, ticks=16)
    print(f"teacher-forced paged ({card}): {json.dumps(tfp)}")
    tfq = teacher_forced_quant(torch, llama, qm, qs, tf, params, cfg, reqs,
                               max_len, ticks=16)
    print(f"teacher-forced quantized paged ({card}): {json.dumps(tfq)}")

    # 5. training at bert_base_equiv width, fp32 master weights
    del params
    tcfg = llama.LlamaConfig.bert_base_equiv()
    tparams = llama.init_params(
        tcfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=torch.float32)
    rng = np.random.RandomState(0)
    tok8 = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (8, 512))
                            .astype(np.int32)).to(DEVICE)
    tvp = train_vs_plain(torch, llama, fa, hd, tparams, tcfg, tok8)
    print(f"train, kernels against plain ({card}): B 8 S 512 loss "
          f"{tvp['loss_kernels']:.6f} / {tvp['loss_plain']:.6f} (|err| "
          f"{tvp['loss_abs_err']:.3e} <= {TRAIN_LOSS_ATOL}), largest "
          f"gradient error {max(tvp['grad_rel_err'].values()):.3e} of its "
          f"norm (<= {TRAIN_GRAD_RTOL}): {json.dumps(tvp['grad_rel_err'])}")
    tok44 = torch.from_numpy(rng.randint(0, tcfg.vocab_size, (44, 512))
                             .astype(np.int32)).to(DEVICE)
    train, tlaunches = train_run(torch, llama, fns, tparams, tcfg, tok44)
    busy = train.get("device_busy_share")
    print(f"train ({card}): bert_base_equiv bf16/fp32 master, B 44 S 512, "
          f"{train['timed_steps']} timed AdamW steps: "
          f"{train['tokens_per_s']:.1f} tokens/s, "
          f"{train['ms_per_step']:.3f} ms/step (CUDA events "
          f"{train['event_ms_per_step']:.3f}), device "
          f"{train['device_ms_per_step']} ms in one profiled step of "
          f"{train.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'}), peak "
          f"memory {train['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
          f"{', '.join(f'{x:.4f}' for x in train['losses'])}, after "
          f"{train['loss_after']:.4f}")
    print(f"launches on the train steps: {json.dumps(tlaunches)}")
    print(f"train device time (ms/step) by kind: "
          f"{json.dumps(train.get('device_split_ms'))}; largest kernels: "
          f"{json.dumps(train.get('device_top'))}")

    # 3e. the quality bar of quantized serving, on a memorized model served
    # continuations of its training sequences (the mixed workload's
    # prompt and generation lengths)
    memo = memorize(torch, llama, tparams, tcfg, tok44)
    sparams = {k: v.detach().to(torch.bfloat16) for k, v in tparams.items()}
    seqs = tok44.cpu().numpy()
    mreqs = [(seqs[i, :len(p)].copy(), g) for i, (p, g) in enumerate(reqs)]
    del tparams, tok8, tok44
    qtrained, qtlaunches = quant_trained(
        torch, ServingEngine, compare_pair, fns, sparams, cfg, mreqs,
        max_len)
    # how far each serve follows the memorized sequence
    for key, outs in zip(("int8", "bf16_shadow"), qtrained.pop("outputs")):
        hit = sum(t == int(seqs[i, len(p) + j])
                  for i, ((p, _), (toks, _)) in enumerate(zip(mreqs, outs))
                  for j, t in enumerate(toks))
        qtrained[key]["memorized_token_rate"] = hit / sum(
            g for _, g in mreqs)
    qtrained["memorize_losses"] = memo
    qual = qtrained["int8_against_bf16"]
    print(f"memorized ({card}): {len(memo)} more AdamW steps on phase 5's "
          f"batch, loss {memo[0]:.4f} -> {memo[-1]:.4f}; tokens following "
          f"the training sequences: int8 "
          f"{qtrained['int8']['memorized_token_rate']:.4f}, bf16 "
          f"{qtrained['bf16_shadow']['memorized_token_rate']:.4f}")
    print(f"int8 against its bf16 shadow, memorized model ({card}): "
          f"matched-prefix rate {qual['matched_prefix_rate']:.4f} (>= "
          f"{MATCHED_PREFIX_FLOOR}), {qual['requests_identical']}/"
          f"{len(reqs)} requests identical, logit max abs err "
          f"{qual['logit_max_abs_err']} over {qual['logit_positions']} "
          f"positions, KL mean {qual['kl_mean']} max {qual['kl_max']} over "
          f"{qual['kl_positions']}; int8 "
          f"{qtrained['int8']['tokens_per_s']:.1f} tokens/s, bf16 "
          f"{qtrained['bf16_shadow']['tokens_per_s']:.1f} tokens/s")
    print(f"launches on the trained int8 drain: {json.dumps(qtlaunches)}")

    # 6. ResNet-50 training, BASELINE config 1 at full shape
    del sparams
    x, y = resnet_batch(torch)
    rvp, (rmodel, ropt, rstep) = resnet_vs_plain(torch, port, mtu, fns, x,
                                                 y)
    print(f"ResNet-50, kernel against plain ({card}): B {RESNET_BATCH} "
          f"{RESNET_SIZE}x{RESNET_SIZE} NHWC O2 bf16 Momentum, losses "
          f"{rvp['losses_kernel']} / {rvp['losses_plain']} (|err| "
          f"{rvp['loss_abs_err']:.3e} <= {RESNET_LOSS_ATOL}), largest param "
          f"error {rvp['param_max_abs_err']:.3e}, BN statistics "
          f"{rvp['bn_stat_max_abs_err']:.3e}, bit-identical "
          f"{rvp['bit_identical']}")
    rtrain, rlaunches = resnet_run(torch, fns, rstep, x, y)
    rbusy = rtrain.get("device_busy_share")
    print(f"ResNet-50 train ({card}): B {RESNET_BATCH} {RESNET_SIZE}x"
          f"{RESNET_SIZE} NHWC O2 bf16, {rtrain['timed_steps']} timed "
          f"Momentum steps: {rtrain['images_per_s']:.1f} images/s, "
          f"{rtrain['ms_per_step']:.3f} ms/step, device "
          f"{rtrain['device_ms_per_step']} ms in one profiled step of "
          f"{rtrain.get('profiled_step_wall_ms', 'not measured')} ms wall "
          f"(busy share "
          f"{'not measured' if rbusy is None else f'{rbusy:.4f}'}), "
          f"multi_tensor_update share of the device time "
          f"{rtrain.get('update_kernel_share', 'not measured')}, peak "
          f"memory {rtrain['peak_memory_bytes'] / 2**30:.2f} GiB, losses "
          f"{', '.join(f'{v:.4f}' for v in rtrain['losses'])}")
    print(f"launches on the ResNet-50 steps: {json.dumps(rlaunches)}")
    print(f"ResNet-50 device time (ms/step) by kind: "
          f"{json.dumps(rtrain.get('device_split_ms'))}; largest kernels "
          f"of each kind: {json.dumps(rtrain.get('device_largest_by_kind'))}"
          f"; host operators by self time (ms): "
          f"{json.dumps(rtrain.get('host_top'))}")
    del ropt, rstep
    radamw, alaunches = resnet_adamw(torch, port, fns, rmodel, x, y)
    print(f"ResNet-50 O2 AdamW(multi_precision) ({card}): "
          f"{radamw['steps']} steps, losses "
          f"{', '.join(f'{v:.4f}' for v in radamw['losses'])}")
    print(f"launches on the ResNet-50 AdamW steps: {json.dumps(alaunches)}")

    # 7. the kernel experiments' entry points, at the reference's shapes
    del rmodel, x, y
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    exps, dlaunches, flaunches = experiments(torch, fns, xdot, xfv)
    print(f"experiments ({card}): dot_variants and flash_variants in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"launches on the dot experiment: {json.dumps(dlaunches)}")
    print(f"launches on the flash experiment: {json.dumps(flaunches)}")

    # 8. results
    by_path = {"contiguous_drain": launches, "paged_drain": plaunches,
               "prefix_burst": blaunches, "quant_int8_drain": qlaunches,
               "quant_fp8_drain": f8launches, "train": tlaunches,
               "quant_int8_trained_drain": qtlaunches,
               "resnet50_train": rlaunches, "resnet50_adamw": alaunches,
               "dot_experiment": dlaunches, "flash_experiment": flaunches}
    kernels = kernels_line(rows, by_path)
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "kernel_rows": rows, "engine": stats,
                   "tick": tick, "paged_engine": pstats,
                   "paged_steps": psteps, "prefix_burst": burst,
                   "quant": quant, "quant_trained": qtrained,
                   "launches": by_path,
                   "teacher_forced": tfc, "teacher_forced_paged": tfp,
                   "teacher_forced_quant": tfq, "train_vs_plain": tvp,
                   "train": train, "multi_tensor_skip": mtu_skip,
                   "resnet50_vs_plain": rvp, "resnet50_train": rtrain,
                   "resnet50_adamw": radamw,
                   "flash_variant_matrix_errors": variant_errs,
                   "experiments": exps}, f, indent=1)
    print(f"total: {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
