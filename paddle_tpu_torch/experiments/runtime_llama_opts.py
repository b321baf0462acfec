"""The runtime modules and LLaMA's single-device options on a device
(``chip_smoke.py`` phase 6h).

- ``runtime_checks(device)``: ``device``'s counts, memory statistics (held
  to ``torch.cuda``'s after a 1 GiB allocation and after its release), a
  copy on a side stream under ``stream_guard`` joined by ``wait_stream``,
  ``Event.query`` while a queue of matmuls runs and after ``synchronize``;
  ``utils.cpp_extension`` building ``RELU_SRC`` (the JAX package's test
  source) with g++ and running it, forward and C backward, on ``device``'s
  tensors; a ``utils.dlpack`` round trip sharing memory;
  ``amp.debugging``'s tensor checker naming the op that made an Inf;
  ``utils.run_check`` and ``version``.
- ``fused_train(llama, cfg, params, tokens, ...)``: bench.py's training
  step with ``fused_weights`` and ``bf16_grads`` from the unfused fp32
  master weights ``params`` (``llama.fuse_params``: wq/wk/wv and
  w_gate/w_up concatenated), its
  launches counted on the timed steps and each loss returned beside its
  step time.
- ``fused_serve(llama, ServingEngine, cfg, params, reqs, ...)``: a paged
  drain of ``reqs`` on the unfused tree and on the fused one (int8
  weights, or bf16 through the paged kernel), launches counted on the
  fused drain, tokens compared request by request, and the first decode
  tick's logits of both trees teacher-forced on the same prompts.

Each takes the caller's launch counters (``counts``: a pair of functions
that zero and read them) or None (a CPU rehearsal, as the tests run
them), and raises ``AssertionError`` on a failed check.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import time

import numpy as np
import torch

# tests/test_cpp_extension.py's source, compiled against this package's
# ``paddle_ext.h``
RELU_SRC = r"""
#include "paddle_ext.h"
#include <algorithm>

extern "C" void custom_relu(const PTTensor* ins, int32_t n_in,
                            PTMutableTensor* outs, int32_t n_out) {
  const float* x = static_cast<const float*>(ins[0].data);
  float* y = static_cast<float*>(outs[0].data);
  int64_t n = pt_numel(&ins[0]);
  for (int64_t i = 0; i < n; ++i) y[i] = x[i] > 0.f ? x[i] : 0.f;
}

/* backward: inputs = (x, grad_out) -> grad_x */
extern "C" void custom_relu_grad(const PTTensor* ins, int32_t n_in,
                                 PTMutableTensor* outs, int32_t n_out) {
  const float* x = static_cast<const float*>(ins[0].data);
  const float* gy = static_cast<const float*>(ins[1].data);
  float* gx = static_cast<float*>(outs[0].data);
  int64_t n = pt_numel(&ins[0]);
  for (int64_t i = 0; i < n; ++i) gx[i] = x[i] > 0.f ? gy[i] : 0.f;
}

extern "C" void pairwise_sum(const PTTensor* ins, int32_t n_in,
                             PTMutableTensor* outs, int32_t n_out) {
  const float* a = static_cast<const float*>(ins[0].data);
  const float* b = static_cast<const float*>(ins[1].data);
  float* y = static_cast<float*>(outs[0].data);
  int64_t n = pt_numel(&ins[0]);
  for (int64_t i = 0; i < n; ++i) y[i] = a[i] + b[i];
}
"""

GIB = 1 << 30
# the queue Event.query must find running: 4096^2 fp32 products, ~3 ms
# each on an H100 (TF32 off), ~0.15 s in all
QUERY_MATMULS, QUERY_N = 50, 4096


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def runtime_checks(device="cuda", alloc_bytes=GIB, query_n=QUERY_N,
                   query_matmuls=QUERY_MATMULS) -> dict:
    """Part (a); returns its readings."""
    import paddle_tpu_torch as port
    from paddle_tpu_torch import device as dmod
    from paddle_tpu_torch.amp import debugging
    from paddle_tpu_torch.ops.registry import OPS
    from paddle_tpu_torch.utils import cpp_extension, dlpack

    dev = dmod.resolve_device(device)
    prev = dmod.set_device(str(dev))
    out = {}
    try:
        t0 = time.perf_counter()
        devices = dmod.get_all_devices()
        want = ([f"gpu:{i}" for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else ["cpu:0"])
        assert devices == want, f"get_all_devices() {devices} != {want}"
        out["devices"] = devices

        def stats():
            mine = [dmod.memory_allocated(), dmod.max_memory_allocated(),
                    dmod.memory_reserved(), dmod.max_memory_reserved()]
            if dev.type != "cuda":
                return mine, [0, 0, 0, 0]
            return mine, [torch.cuda.memory_allocated(dev),
                          torch.cuda.max_memory_allocated(dev),
                          torch.cuda.memory_reserved(dev),
                          torch.cuda.max_memory_reserved(dev)]

        # no collection may free a tensor between the two readings
        gc.collect()
        gc.disable()
        try:
            before, _ = stats()
            big = torch.empty(alloc_bytes, dtype=torch.uint8, device=dev)
            held, ref_held = stats()
            del big
            dmod.empty_cache()
            freed, ref_freed = stats()
        finally:
            gc.enable()
        assert held == ref_held and freed == ref_freed, (
            f"memory statistics {held} / {freed} against torch.cuda's "
            f"{ref_held} / {ref_freed}")
        if dev.type == "cuda":
            assert held[0] - before[0] >= alloc_bytes, (before, held)
            assert freed[0] <= held[0] - alloc_bytes, (held, freed)
        out["memory"] = {"before": before, "holding": held, "freed": freed}

        main = dmod.current_stream()
        side = dmod.Stream()
        src = torch.arange(1 << 22, dtype=torch.float32, device=dev)
        side.wait_stream(main)
        with dmod.stream_guard(side):
            dst = src * 2.0
        main.wait_stream(side)
        if dev.type == "cuda":
            dst.record_stream(main._s)
        assert torch.equal(dst, src * 2.0), "side-stream copy"

        a = torch.randn(query_n, query_n, device=dev)
        _sync(dev)
        ev = dmod.Event()
        for _ in range(query_matmuls):
            a = a @ a * (1.0 / query_n)
        ev.record()
        running = ev.query()
        dmod.synchronize()
        done = ev.query()
        assert done and (dev.type != "cuda" or not running), (
            f"Event.query: {running} while the matmuls ran, {done} after "
            f"synchronize")
        out["event_query"] = {"while_running": running, "after": done}

        ext = cpp_extension.load(name="runtime_relu", sources=[RELU_SRC])
        try:
            relu = ext.define_op("custom_relu", backward="custom_relu_grad")
            x = torch.randn(1 << 16, device=dev, requires_grad=True)
            w = torch.randn(1 << 16, device=dev)
            y = relu(x)
            assert y.device == dev and torch.equal(y, torch.relu(x)), \
                "custom_relu's output"
            (gx,) = torch.autograd.grad((y * w).sum(), x)
            (gp,) = torch.autograd.grad((torch.relu(x) * w).sum(), x)
            assert gx.device == dev and torch.equal(gx, gp), \
                "custom_relu's gradient through its C backward"
        finally:
            OPS.pop("custom_custom_relu", None)
        out["custom_relu"] = {"elements": x.numel(), "device": str(y.device)}

        t = torch.randn(1024, device=dev)
        r = dlpack.from_dlpack(dlpack.to_dlpack(t))
        assert isinstance(r, port.Tensor) and r.data_ptr() == t.data_ptr()
        out["dlpack_shares_memory"] = True

        debugging.enable_tensor_checker(debugging.TensorCheckerConfig())
        try:
            port.log(port.to_tensor(np.zeros(4, np.float32)))
        except FloatingPointError as e:
            named = "'log'" in str(e)
        else:
            named = False
        finally:
            debugging.disable_tensor_checker()
        assert named, "the tensor checker did not name log's Inf"
        try:
            debugging.check_numerics(torch.tensor([1.0, float("inf")],
                                                  device=dev))
            counted = False
        except FloatingPointError as e:
            counted = "0 NaN and 1 Inf" in str(e)
        assert counted, "check_numerics' counts"

        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            port.utils.run_check()
        line = printed.getvalue().strip()
        place = "gpu:0" if dev.type == "cuda" else "cpu:0"
        assert place in line and "paddle_tpu_torch" in line, line
        assert port.version.cuda() == (torch.version.cuda or "False")
        out["run_check"] = line
        out["version_cuda"] = port.version.cuda()
        out["seconds"] = round(time.perf_counter() - t0, 2)
    finally:
        dmod.set_device(prev)
    return out


def fused_train(llama, cfg, params, tokens, counts=None, lr=1e-4, warmup=2,
                steps=10, profile=None) -> tuple:
    """Part (b): ``warmup`` + ``steps`` steps of ``make_train_step`` under
    ``cfg`` with ``fused_weights`` and ``bf16_grads``, from ``fuse_params``
    of the fp32 ``params`` (left as they are), on ``tokens``; launches
    counted over the timed steps. ``profile(run)`` (optional) returns the
    device time of one more step. Returns (readings, launches)."""
    fcfg = dataclasses.replace(cfg, fused_weights=True, bf16_grads=True)
    fp = {k: v.detach().clone()
          for k, v in llama.fuse_params(params).items()}
    opt = llama.init_opt_state(fp)
    step = llama.make_train_step(fcfg, lr=lr, device=tokens.device)
    dev = tokens.device
    losses = [step(fp, opt, tokens, tokens)[2].item() for _ in range(warmup)]
    _sync(dev)
    if counts:
        counts[0]()
    timed = []
    t0 = time.perf_counter()
    for _ in range(steps):
        timed.append(step(fp, opt, tokens, tokens)[2])
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = counts[1]() if counts else {}
    losses += [t.item() for t in timed]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite fused training loss: {losses}")
    out = {"warmup_steps": warmup, "timed_steps": steps, "losses": losses,
           "ms_per_step": 1e3 * wall / steps,
           "tokens_per_s": tokens.numel() * steps / wall}
    if profile is not None:
        prof = profile(lambda: step(fp, opt, tokens, tokens))
        if prof is not None:
            out["device_ms_per_step"] = prof["device_ms"]
            out["device_split_ms"] = prof["split_ms"]
            out["device_top"] = prof["top"]
    return out, launches


def _drain(eng, reqs, counts):
    """Serve ``reqs`` to the end on ``eng``; (tokens by request, launches,
    steps, decode steps, seconds)."""
    rids = [eng.add_request(p, g) for p, g in reqs]
    if counts:
        counts[0]()
    eng.last_run_ticks = eng.last_run_chunks = 0
    t0 = time.perf_counter()
    while eng._queue or eng.free_slot_count() < eng.slots:
        eng.run_segment(4 * eng.chunk)
    _sync(eng.device)
    wall = time.perf_counter() - t0
    launches = counts[1]() if counts else {}
    out = eng.collect_finished()
    toks = [list(out[r]) for r in rids]
    for t, (_, g) in zip(toks, reqs):
        if len(t) != g:
            raise AssertionError(f"a request got {len(t)} tokens of {g}")
    steps = eng.last_run_ticks
    return toks, launches, steps, steps - len(reqs), wall


def _first_tick(llama, cfg, params, prompts, page_size):
    """Logits of one decode tick after a prefill of ``prompts`` ([B, S]
    tokens) on a fresh paged pool (the int8 pool of a quantized tree),
    each slot on pages of its own; the tick feeds each prompt's greedy
    next token. Returns (prefill logits, tick logits), fp32."""
    B, S = prompts.shape
    per = -(-(S + 1) // page_size)
    dev = prompts.device
    table = (1 + torch.arange(B * per, dtype=torch.int32, device=dev)
             ).reshape(B, per)
    quant = "int8" if "wo_scale" in params else None
    pool = llama.init_paged_pool(cfg, 1 + B * per, page_size, dev,
                                 quant=quant)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    with torch.no_grad():
        pre, pool = llama.forward_with_pages(params, prompts, cfg, pool,
                                             table, pos)
        nxt = pre.argmax(-1)[:, None]
        tick, _ = llama.forward_with_pages(params, nxt, cfg, pool, table,
                                           pos + S)
    return pre, tick


def fused_serve(llama, ServingEngine, cfg, params, reqs, quant=None,
                counts=None, slots=8, max_len=384, page_size=16,
                prompt_buckets=(64, 128, 256), tick_rows=8, tick_prompt=64):
    """Part (c): ``reqs`` through a paged engine on ``params`` (unfused,
    ``cfg``'s dtype) and on their fused layout, ``quant`` (None or 'int8')
    applied by each engine; the fused drain's launches counted. Then the
    first ``tick_rows`` requests' first ``tick_prompt`` prompt tokens (at
    most the shortest of those prompts) prefilled and one tick run on
    both trees (``_first_tick``). Returns
    (readings, the fused drain's launches)."""
    from paddle_tpu_torch.quantization.serving import quantize_llama_params

    fcfg = dataclasses.replace(cfg, fused_weights=True)
    fparams = llama.fuse_params(params)
    dev = next(iter(params.values())).device

    def engine(c, p):
        return ServingEngine(c, p, slots=slots, max_len=max_len, chunk=16,
                             prompt_buckets=prompt_buckets, paged=True,
                             page_size=page_size, device=dev, quant=quant)

    toks, _, steps, _, wall = _drain(engine(cfg, params), reqs, None)
    ftoks, launches, fsteps, fdecode, fwall = _drain(
        engine(fcfg, fparams), reqs, counts)
    same = [a == b for a, b in zip(toks, ftoks)]
    matched = sum(next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                       len(a)) for a, b in zip(toks, ftoks))
    rows = reqs[:tick_rows]
    S = min([tick_prompt] + [len(p) for p, _ in rows])
    prompts = torch.as_tensor(np.stack([p[:S] for p, _ in rows]),
                              device=dev)
    if quant:
        qp = quantize_llama_params(params, cfg, quant)
        qf = quantize_llama_params(fparams, fcfg, quant)
    else:
        qp, qf = params, fparams
    pre, tick = _first_tick(llama, cfg, qp, prompts, page_size)
    fpre, ftick = _first_tick(llama, fcfg, qf, prompts, page_size)
    new = sum(g for _, g in reqs)
    out = {"quant": quant, "requests": len(reqs), "new_tokens": new,
           "identical_requests": sum(same),
           "matched_prefix_rate": matched / new,
           "unfused": {"steps": steps, "wall_s": wall,
                       "tokens_per_s": new / wall},
           "fused": {"steps": fsteps, "decode_steps": fdecode,
                     "wall_s": fwall, "tokens_per_s": new / fwall},
           "prefill_logit_max_abs_err": (fpre - pre).abs().max().item(),
           "tick_logit_max_abs_err": (ftick - tick).abs().max().item(),
           "tick_logit_max_abs": tick.abs().max().item(),
           "tick_argmax_agree": (ftick.argmax(-1) == tick.argmax(-1)
                                 ).float().mean().item()}
    return out, launches


def strided_rope_check(tf, device, cfg, rows=8, seed=0, timer=None
                       ) -> dict:
    """The tick's rope on q and k read by their row stride out of one
    fused [rows, H + 2 Hkv] bf16 product (``cfg``'s widths), against the
    same launch on contiguous copies (bit for bit) and the plain version
    (``chip_smoke.py``'s phase-2 rope tolerance in bf16: rtol 1.6e-2, atol
    the larger of 2e-2 and two fp32 ulps of the largest angle times the
    largest input, at positions up to ``cfg.max_seq_len - 1``). With
    ``timer`` (``fn(i) -> ms``), the launch on the strided rows, on
    contiguous rows and the two copies plus that launch, timed."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    D, H = cfg.head_dim, cfg.hidden_size
    Hkv = cfg.num_kv_heads * D
    z = (2.0 * torch.randn(rows, H + 2 * Hkv, generator=g, device=dev)
         ).to(torch.bfloat16)
    pos = torch.randint(0, cfg.max_seq_len, (rows,), generator=g,
                        device=dev, dtype=torch.int32)
    zq, zk = z[:, :H], z[:, H:H + Hkv]
    got = tf.fused_rope_qk(zq, zk, pos, D, cfg.rope_theta)
    cont = tf.fused_rope_qk(zq.contiguous(), zk.contiguous(), pos, D,
                            cfg.rope_theta)
    plain = tf.rope_qk_plain(zq.contiguous(), zk.contiguous(), pos, D,
                             cfg.rope_theta)
    ang_ulp = 2.0 ** (np.floor(np.log2(cfg.max_seq_len - 1)) - 23)
    atol = max(2e-2, 2 * ang_ulp * z.float().abs().max().item())
    ms = {}
    if timer is not None:
        zqc, zkc = zq.contiguous(), zk.contiguous()
        th = cfg.rope_theta
        ms = {"ms_strided": timer(lambda i: tf.fused_rope_qk(
                  zq, zk, pos, D, th)),
              "ms_contiguous": timer(lambda i: tf.fused_rope_qk(
                  zqc, zkc, pos, D, th)),
              "ms_copies_and_launch": timer(lambda i: tf.fused_rope_qk(
                  zq.contiguous(), zk.contiguous(), pos, D, th))}
    return {"rows": rows, "width": z.shape[1], **ms,
            "against_contiguous": max((a.float() - b.float()).abs().max()
                                      .item() for a, b in zip(got, cont)),
            "against_plain": max((a.float() - b.float()).abs().max().item()
                                 for a, b in zip(got, plain)),
            "plain_ok": all(torch.allclose(a.float(), b.float(), rtol=1.6e-2,
                                           atol=atol)
                            for a, b in zip(got, plain)),
            "plain_atol": atol}


def quant_column_check(llama, qm, cfg, params, rows=8, seed=0) -> dict:
    """Whether ``quant_matmul``'s arithmetic for a column depends on the
    weight's width N: layer 0's int8 wq [H, H] against the first H columns
    of the fused wqkv [H, H + 2 Hkv] (the same quantized bytes), on one
    x [rows, H] in ``cfg.dtype``. The kernel splits K over more blocks at
    N = H than at N = H + 2 Hkv (``quant_matmul.tiling``), so its fp32
    sums run in another order. Returns the fp32 outputs' largest
    difference, the share of entries that differ after rounding to
    ``cfg.dtype`` and each width's tiling."""
    from paddle_tpu_torch.quantization.serving import quantize_weight

    dev = next(iter(params.values())).device
    H = cfg.hidden_size
    wqkv = llama.fuse_params(params)["wqkv"][0]
    q8, s8 = quantize_weight(wqkv, "int8")
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, H, generator=g, device=dev).to(cfg.dtype)
    narrow = qm.quant_matmul(x, q8[:, :H].contiguous(), s8[:H].contiguous())
    wide = qm.quant_matmul(x, q8, s8)[:, :H]
    return {"N": [H, wqkv.shape[1]],
            "tiling": [list(qm.tiling(H, H)),
                       list(qm.tiling(H, wqkv.shape[1]))],
            "fp32_max_abs_diff": (narrow - wide).abs().max().item(),
            "rounded_differ_share": (narrow.to(cfg.dtype) != wide.to(
                cfg.dtype)).float().mean().item()}
