"""The training step, the production flash kernels, the blocked matmul,
the CE tail's head_dx, the tick's rope and norms, the decode, paged and
quantized-matmul kernels, the bf16 decode tick and the paged engine's steps
of this checkout and of another one, timed in turns on one card.

    python3 -m paddle_tpu_torch.experiments.turns OTHER_ROOT [rounds]
    python3 -m paddle_tpu_torch.experiments.turns --drains [rounds]

Run from the root of a checkout; ``OTHER_ROOT`` is the root of another
checkout of the repository (an older commit, say). Each turn is a process
of its own in one checkout's root, in the order other, this, this, other
for each round (default 1), so that both sides share the card's state and
a drift shows as a difference between the two turns of one side. A turn
builds its checkout's ``flash_attention``, ``head_dx``, ``blocked_matmul``,
``decode_attention``, ``paged_attention``, ``quant_matmul`` and (where
the checkout has them) ``rope`` and ``rms_norm`` kernels, times
``head_dx_softmax`` at the CE tail's shape (M 22528, V 32000, H 768),
``fused_rope_qk`` at the serving tick (B 8, 12 + 12 heads of D 64, bf16)
and both norms at the serving tick (B 8, H 768, bf16) and at llama7b
width (B 8, H 4096), replayed and eager, with a cProfile of the norms'
eager calls and each after the matmul that feeds it on the tick, and,
where the checkout has them, the launch floor
(``tick_fusion.empty_launch``), each step of a norm's host path timed
alone, and the norms, the floor and the decode tick with programmatic
dependent launch off (``tick_fusion.set_pdl``) beside on, its flash
forward and backward (the backward as its
``_FlashAttention`` launches it: ``flash_attention_bwd`` where the
checkout has it, else the dq and the dk/dv kernels) at bench.py's
training shape (B 44, S 512, 12 heads of D 64, causal) and at llama7b
width (B 1, S 2048, 32 heads of D 128, causal), ``blocked_matmul``'s four
tiles at the lm_head dx shape (22528 x 32000 x 768),
``ragged_decode_attention`` in bf16 at ``chip_smoke.SHAPES`` (as phase 2
times it: layers cycled, positions from seed 0 with the first slot at 0
and the last at max_len - 1; replayed and eager), ``quant_matmul`` with
int8 weights and bf16 x at ``chip_smoke.QMM_SHAPES`` and
``ragged_paged_attention`` in bf16 at ``chip_smoke.PAGED_SHAPES`` (inputs
as phase 2 makes them, from seed 0; replayed and eager), the paged
engine's decode step and admit prefill in bf16 and with int8 weights and
pool (``chip_smoke.paged_step_breakdown``: eager and replayed device ms),
the contiguous engine's bf16 decode tick (8 slots, max_len 384: eager and
replayed device ms), then runs its ``chip_smoke.train_run`` (phase 5b:
two warm-up and ten timed AdamW steps of ``bert_base_equiv`` at B 44 x S
512 from seed 0, launch counts asserted, one profiled step). Prints the
card's name and
power limit, then one JSON line per turn, then all turns as one JSON
line.

``--drains`` times the contiguous engine's two offline drains of this
checkout against each other instead (``drains``), in one process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from ._timing import require_cuda

__all__ = ["main"]

ROOT = Path(__file__).resolve().parents[2]

# one turn, run with its checkout's root as the working directory
_TURN = r'''
import cProfile, json, math, pstats, sys, time
sys.path.insert(0, ".")
import numpy as np
import torch
import chip_smoke as cs
from paddle_tpu_torch.experiments._timing import time_ms
from paddle_tpu_torch.models import llama
from paddle_tpu_torch.ops.kernels import _build, launch_counters
from paddle_tpu_torch.ops.kernels import blocked_matmul as bm
from paddle_tpu_torch.ops.kernels import decode_attention as da
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from paddle_tpu_torch.ops.kernels import head_dx as hd
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import quant_matmul as qm
from paddle_tpu_torch.ops.kernels import tick_fusion as tf
from paddle_tpu_torch.quantization import serving as qs

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for name in ("flash_attention", "head_dx", "blocked_matmul",
             "decode_attention", "paged_attention", "quant_matmul", "rope",
             "rms_norm"):
    if (_build.CSRC_DIR / f"{name}.cu").exists():  # older trees lack some
        _build.build(name)
out = {}
gen = torch.Generator(device="cuda").manual_seed(0)
M, V, H = 22528, 32000, 768  # the CE tail's head_dx_softmax
logits = (torch.randn(M, V, generator=gen, device="cuda") * 3).bfloat16()
m = logits.float().max(-1).values
scale = (torch.rand(M, generator=gen, device="cuda")
         / torch.exp(logits.float() - m[:, None]).sum(-1))
w = (torch.randn(H, V, generator=gen, device="cuda") / math.sqrt(H)).bfloat16()
dx = lambda i: hd.head_dx_softmax(logits, m, scale, w)
out["head_dx"] = {"ms": time_ms(dx, iters=20), "eager_ms": cs.eager_ms(
    torch, dx, iters=20)}
del logits, m, scale, w
gen = torch.Generator(device="cuda").manual_seed(0)
zq = (torch.randn(8, 768, generator=gen, device="cuda") * 2).bfloat16()
zk = (torch.randn(8, 768, generator=gen, device="cuda") * 2).bfloat16()
pos = torch.randint(0, 384, (8,), generator=gen, device="cuda",
                    dtype=torch.int32)
rope = lambda i: tf.fused_rope_qk(zq, zk, pos, 64, 10000.0)
out["rope"] = {"ms": time_ms(rope), "eager_ms": cs.eager_ms(torch, rope)}
out["norms"], norm_inputs = {}, {}
for H in (768, 4096):  # the serving tick's width and llama7b's
    gen = torch.Generator(device="cuda").manual_seed(0)
    x, y = ((torch.randn(8, H, generator=gen, device="cuda") * 2).bfloat16()
            for _ in range(2))
    w = (1 + 0.1 * torch.randn(H, generator=gen, device="cuda")).bfloat16()
    rms = lambda i: tf.fused_rms_norm(x, w, 1e-6)
    add = lambda i: tf.fused_add_rms_norm(x, y, w, 1e-6)
    norm_inputs[H] = x, y, w
    out["norms"][H] = {
        "rms_ms": time_ms(rms), "rms_eager_ms": cs.eager_ms(torch, rms),
        "add_ms": time_ms(add), "add_eager_ms": cs.eager_ms(torch, add)}
    if hasattr(tf, "set_pdl"):  # back to back without the early launch
        tf.set_pdl(False)
        out["norms"][H].update(rms_ms_without_pdl=time_ms(rms),
                               add_ms_without_pdl=time_ms(add))
        tf.set_pdl(True)
# each norm after the matmul that feeds it on the tick (8 x 768 @ 768 x
# 768), so a launch that overlaps the kernel ahead shows as it would there
gen = torch.Generator(device="cuda").manual_seed(0)
a = torch.randn(8, 768, generator=gen, device="cuda").bfloat16()
W = (torch.randn(768, 768, generator=gen, device="cuda") / 28).bfloat16()
x, y, w = norm_inputs[768]
out["norms_after_mm"] = {
    "mm_ms": time_ms(lambda i: torch.mm(a, W)),
    "mm_rms_ms": time_ms(lambda i: tf.fused_rms_norm(torch.mm(a, W), w,
                                                     1e-6)),
    "mm_add_ms": time_ms(lambda i: tf.fused_add_rms_norm(torch.mm(a, W), y,
                                                         w, 1e-6))}
# the norms' host path at the serving tick: the largest entries of a
# cProfile of 2000 eager calls each (own time per call, us), and, where the
# checkout launches through ctypes, each step of the call timed alone
out["norm_host_profile"] = {}
for tag, fn in (("rms", lambda: tf.fused_rms_norm(x, w, 1e-6)),
                ("add", lambda: tf.fused_add_rms_norm(x, y, w, 1e-6))):
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(2000):
        fn()
    prof.disable()
    torch.cuda.synchronize()
    own = sorted(((v[2] / 2000 * 1e6, f"{k[0].split('/')[-1]}:{k[1]}({k[2]})")
                  for k, v in pstats.Stats(prof).stats.items()),
                 reverse=True)[:12]
    out["norm_host_profile"][tag] = [[name, us] for us, name in own]
if hasattr(tf, "empty_launch"):
    dev = torch.cuda.current_device()
    floor = lambda i: tf.empty_launch(dev)
    out["launch_floor"] = {"ms": time_ms(floor),
                           "eager_ms": cs.eager_ms(torch, floor)}
    tf.set_pdl(False)
    out["launch_floor"]["ms_without_pdl"] = time_ms(floor)
    tf.set_pdl(True)

    def host_us(fn, n=5000):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        us = 1e6 * (time.perf_counter() - t0) / n
        torch.cuda.synchronize()
        return us
    s_, o_ = torch.empty_like(x), torch.empty_like(x)
    entry = tf._entry("rms_norm", "fused_add_rms_norm")
    empty = tf._entry("rms_norm", "empty_launch")
    stream = tf._stream(dev)
    ptrs = (x.data_ptr(), y.data_ptr(), w.data_ptr(), s_.data_ptr(),
            o_.data_ptr())

    def device_ctx():
        with torch.cuda.device(x.device):
            pass
    out["norm_host_steps_us"] = {
        "whole fused_add_rms_norm": host_us(
            lambda: tf.fused_add_rms_norm(x, y, w, 1e-6)),
        "whole fused_rms_norm": host_us(lambda: tf.fused_rms_norm(x, w,
                                                                  1e-6)),
        "checks": host_us(lambda: tf._check_norm("fused_add_rms_norm", x, w,
                                                 y)),
        "two empty_like": host_us(lambda: (torch.empty_like(x),
                                           torch.empty_like(x))),
        "five data_ptr": host_us(lambda: (x.data_ptr(), y.data_ptr(),
                                          w.data_ptr(), s_.data_ptr(),
                                          o_.data_ptr())),
        "entry lookup": host_us(lambda: tf._entry("rms_norm",
                                                  "fused_add_rms_norm")),
        "raw stream": host_us(lambda: tf._stream(dev)),
        "ctypes call with launch": host_us(
            lambda: entry(*ptrs, 8, 768, 1, 1e-6, dev, stream)),
        "ctypes empty launch": host_us(lambda: empty(dev, stream)),
        "torch.cuda.device context": host_us(device_ctx),
        "current_stream().cuda_stream": host_us(
            lambda: torch.cuda.current_stream().cuda_stream)}
gen = torch.Generator(device="cuda").manual_seed(0)
a = torch.randn(22528, 32000, generator=gen, device="cuda").bfloat16()
b = torch.randn(32000, 768, generator=gen, device="cuda").bfloat16()
out["blocked_matmul"] = {"x".join(map(str, t)): time_ms(
    lambda i, t=t: bm.blocked_matmul(a, b, *t), iters=20) for t in bm.TILES}
del a, b
out["decode"], out["decode_eager"] = {}, {}
for name, B, nH, Hkv, D, max_len, L in cs.SHAPES:
    gen = torch.Generator(device="cuda").manual_seed(0)
    kc, vc = (torch.randn(L, B, max_len, Hkv, D, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(B, nH, D, generator=gen, device="cuda").bfloat16()
    pos = torch.randint(0, max_len, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, max_len - 1
    decode = lambda i: da.ragged_decode_attention(q, kc[i], vc[i], pos)
    out["decode"][name] = time_ms(decode, L)
    out["decode_eager"][name] = cs.eager_ms(torch, decode, L)
    del kc, vc
out["quant_matmul"], out["quant_matmul_eager"] = {}, {}
for name, B, K, N in cs.QMM_SHAPES:
    gen = torch.Generator(device="cuda").manual_seed(0)
    copies = max(2, min(64, math.ceil(2 * cs.L2_BYTES / (K * N))))
    ws = [qs.quantize_weight(torch.randn(K, N, generator=gen, device="cuda")
                             / math.sqrt(K), "int8") for _ in range(copies)]
    x = torch.randn(B, K, generator=gen, device="cuda").bfloat16()
    qmm = lambda i: qm.quant_matmul(x, *ws[i])
    out["quant_matmul"][name] = time_ms(qmm, copies)
    out["quant_matmul_eager"][name] = cs.eager_ms(torch, qmm, copies)
    del ws
out["paged"], out["paged_eager"] = {}, {}
for name, B, Tq, nH, Hkv, D, max_pages, ctx, q_len in cs.PAGED_SHAPES:
    gen = torch.Generator(device="cuda").manual_seed(0)
    W, P = max_pages * cs.PAGE, B * max_pages + 1
    L = max(2, min(128, math.ceil(2 * cs.L2_BYTES
                                  / (2 * P * cs.PAGE * Hkv * D * 2))))
    kp, vp = (torch.randn(L, P, cs.PAGE, Hkv, D, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    q = torch.randn(B, Tq, nH, D, generator=gen, device="cuda").bfloat16()
    pt = (torch.randperm(P - 1, generator=gen, device="cuda")[:B * max_pages]
          + 1).to(torch.int32).reshape(B, max_pages)
    if ctx is None:
        c = torch.randint(0, W, (B,), generator=gen, device="cuda")
        c[0], c[-1] = 0, W - 1
    else:
        c = torch.tensor(ctx, device="cuda")
    c = c.to(torch.int32)
    ql = (None if q_len is None
          else torch.tensor(q_len, dtype=torch.int32, device="cuda"))
    paged = lambda i: pa.ragged_paged_attention(q, kp[i], vp[i], pt, c, ql)
    out["paged"][name] = time_ms(paged, L)
    out["paged_eager"][name] = cs.eager_ms(torch, paged, L)
    del kp, vp
cfg = llama.LlamaConfig.bert_base_equiv()
params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda")
cache = llama.init_kv_cache(cfg, 8, 384, "cuda")
nxt = torch.arange(8, device="cuda")[:, None]
tpos = torch.linspace(0, 383, 8, device="cuda").to(torch.int32)
eager, device = cs.eager_and_device_ms(
    torch, lambda: llama.forward_with_cache(params, nxt, cfg, cache, tpos), 50)
out["decode_tick"] = {"eager_ms": eager, "device_ms": device}
if hasattr(tf, "set_pdl"):  # in turns: on (above), off, off, on
    tick = lambda: llama.forward_with_cache(params, nxt, cfg, cache, tpos)
    ticks = []
    for on in (False, False, True):
        tf.set_pdl(on)
        ticks.append(cs.eager_and_device_ms(torch, tick, 50)[1])
    out["decode_tick_device_ms_pdl_on_off_off_on"] = [device] + ticks
del cache
out["paged_steps"] = cs.paged_step_breakdown(torch, llama, params, cfg, 384)
out["paged_steps_int8"] = cs.paged_step_breakdown(
    torch, llama, qs.quantize_llama_params(params, cfg, "int8"), cfg, 384,
    quant="int8")
del params
for tag, (B, S, H, D) in (("bench", (44, 512, 12, 64)),
                          ("llama7b", (1, 2048, 32, 128))):
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v, True)
    delta = fa.attention_delta(o, do)
    args = (q, k, v, do, lse, delta, True)
    if hasattr(fa, "flash_attention_bwd"):
        bwd = lambda i: fa.flash_attention_bwd(*args)
    else:
        bwd = lambda i: (fa.flash_attention_bwd_dq(*args),
                         fa.flash_attention_bwd_dkv(*args))
    out[tag] = {"fwd_ms": time_ms(lambda i: fa.flash_attention_fwd(q, k, v,
                                                                   True)),
                "bwd_ms": time_ms(bwd)}
    del q, k, v, do, o, lse, delta, args
cfg = llama.LlamaConfig.bert_base_equiv()
params = llama.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           device="cuda", dtype=torch.float32)
rng = np.random.RandomState(0)
rng.randint(0, cfg.vocab_size, (8, 512))  # chip_smoke's phase 5a batch
tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (44, 512))
                       .astype(np.int32)).to("cuda")
train, _ = cs.train_run(torch, llama, launch_counters(), params, cfg, tok)
out["train"] = {key: train.get(key) for key in (
    "ms_per_step", "tokens_per_s", "event_ms_per_step", "device_ms_per_step",
    "device_busy_share", "device_split_ms")}
print("TURN " + json.dumps(out), flush=True)
'''


def _turn(root: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", _TURN], cwd=root,
                          capture_output=True, text=True,
                          env={**os.environ, "PYTHONDONTWRITEBYTECODE": "1"})
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("TURN ")]
    if proc.returncode != 0 or len(lines) != 1:
        raise RuntimeError(f"the turn in {root} failed ({proc.returncode}):"
                           f"\n{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    return json.loads(lines[0][len("TURN "):])


def drains(rounds: int = 2) -> list:
    """The contiguous engine's fused drain (``run()``) against its windowed
    drain (``run(fused=False)``), in turns in one process: chip_smoke's 32
    mixed requests at ``bert_base_equiv`` width in bf16 on phase 3's engine
    (8 slots, chunk 16, buckets 64/128/256), after one warm-up drain of
    each kind, in the order windowed, fused, fused, windowed for each
    round. Each turn is a fresh engine: tokens/s, wall ms per tick and per
    step (a step is a decode tick or an admit's prefill: one a request
    fused, one a wave windowed) and the engine's fetches. The first turn
    of each kind is followed by a drain of that kind under
    ``torch.profiler``, whose device time gives every turn's busy share
    (over the turn's wall time). Returns the turns."""
    import numpy as np

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from ..inference.serving import ServingEngine
    from ..models import llama

    require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    cfg = llama.LlamaConfig.bert_base_equiv()
    params = llama.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    reqs = cs.mixed_workload(np.random.RandomState(0), 32, cfg.vocab_size)
    max_len = min(cfg.max_seq_len,
                  -(-max(len(p) + g - 1 for p, g in reqs) // 128) * 128)

    def drain(fused, n=len(reqs)):
        eng = ServingEngine(cfg, params, slots=8, max_len=max_len, chunk=16,
                            prompt_buckets=(64, 128, 256), device="cuda")
        waves = [0]
        admit = eng._admit

        def counted(*args):
            waves[0] += 1
            return admit(*args)

        eng._admit = counted
        for p, g in reqs[:n]:
            eng.add_request(p, g)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.run(fused=fused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tokens = sum(len(t) for t in out.values())
        steps = eng.last_run_ticks + (n if fused else waves[0])
        return {"tokens_per_s": tokens / wall, "wall_s": wall,
                "ticks": eng.last_run_ticks, "steps": steps,
                "ms_per_tick": 1e3 * wall / eng.last_run_ticks,
                "ms_per_step": 1e3 * wall / steps,
                "fetches": eng.fetches}

    for fused in (True, False):
        drain(fused, 8)
    device_ms, turns = {}, []
    for _ in range(rounds):
        for fused in (False, True, True, False):
            t = {"drain": "fused" if fused else "windowed", **drain(fused)}
            if fused not in device_ms:
                # a drain's device work is fixed (its device time varied
                # by < 2 % over 13 profiled drains of each kind), and a
                # profiled drain costs ~50 s of trace processing, so one
                # of each kind serves every turn
                prof = cs.device_profile(torch, lambda: drain(fused))
                device_ms[fused] = prof and prof["device_ms"]
            t["device_ms"] = device_ms[fused]
            t["device_busy_share"] = device_ms[fused] and (
                device_ms[fused] / (1e3 * t["wall_s"]))
            print(json.dumps(t), flush=True)
            turns.append(t)
    print(json.dumps({"card": smi, "drain_turns": turns}), flush=True)
    return turns


def main(argv=None):
    """Time both checkouts in turns; returns the turns as
    [{"checkout": "other" or "this", ...}, ...]. With ``--drains``, the
    fused and windowed drains of this checkout (``drains``)."""
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit(__doc__)
    if argv[0] == "--drains":
        return drains(int(argv[1]) if len(argv) > 1 else 2)
    other = Path(argv[0]).resolve()
    rounds = int(argv[1]) if len(argv) > 1 else 1
    require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    turns = []
    for _ in range(rounds):
        for side, root in (("other", other), ("this", ROOT), ("this", ROOT),
                           ("other", other)):
            t = {"checkout": side, **_turn(root)}
            print(json.dumps(t), flush=True)
            turns.append(t)
    print(json.dumps({"card": smi, "turns": turns}), flush=True)
    return turns


if __name__ == "__main__":
    main()
