"""Continuous-batching generation engine, slot-contiguous or paged.

Port of ``paddle_tpu/inference/serving.py``. A fixed pool of decode slots
shares one KV store; finished requests hand their slot to queued ones so
the batch stays full. Two layouts, as in the JAX engine: slot-contiguous
(``paged=False``, one ``[L, slots, max_len, Hkv, D]`` cache) and paged
(``paged=True``, one flat page pool and per-slot page tables,
``inference/paged_kv.py``; admission is gated on pages free).

**Segments** (``run_segment`` = ``dispatch_segment`` + ``finish_segment``,
both layouts; the online scheduler's loop). A segment picks queued
requests FCFS (up to ``n_pad``), then runs up to ``max_steps`` steps.
Each step either admits the next picked request into the first slot with
nothing owed (a ``[1, s_max]`` prefill of its prompt past any prefix-cache
hit) or runs one ragged decode tick over every slot; a slot freezes on
the device the tick its remaining count reaches 0 or it emits EOS. The
JAX engine makes that choice inside one compiled ``while_loop``; here the
host makes it from its mirror of the slots' remaining counts, which
without EOS are known from the generation lengths alone, so the steps are
issued back to back and the segment's event log comes back in ONE counted
fetch (``_fetch``). With ``eos_token_id`` set the schedule depends on the
tokens, so each step's tokens are fetched once before the next step is
chosen. The host then replays the event log (the same admitted /
first-token / finished lists, in the same order, as the JAX engine),
requeues what the step budget did not admit and harvests each slot's
latest admitted prompt into the prefix cache. The layouts differ in the
admit alone:

* contiguous: the prefill runs over a temporary cache of ``pre_max +
  s_max`` rows that holds the hit's rows (a ``PrefixCache`` of row
  copies), then its rows are copied into the slot. The engine picks up to
  ``n_pad`` requests whatever the free slots, since slots free within the
  segment; harvesting copies the slot's rows.
* paged: the prefill writes straight into the request's pages, which were
  reserved at picking with any ``PagedPrefixCache`` hit shared by
  reference; picking stops at the first request the pool cannot hold.
  Harvesting retains the prompt's pages.

**Offline drains** (``run()``). A paged engine drains through segments.
The contiguous engine's ``run(fused=True)`` (the default, the JAX engine's
``_drain_prog``) runs the whole queue as one run of segment steps from
empty slots, longest generation first, every prefill at the bucket of the
longest prompt: one fetch for the whole drain without EOS. Its
``run(fused=False)`` is the windowed loop: admission groups queued
requests by prompt bucket and prefills each group as one ``[nb, bucket]``
batch (sub-waves of ``_WAVE_WIDTHS``), decode runs chunks of ``chunk``
ticks up to the next point where the host knows the refill hysteresis
would admit, and each window's tokens come back in ONE fetch.

**Preemption and abort**: ``preempt_slot`` frees a slot between segments
and returns its request to be requeued (its prompt and generated tokens
parked in the prefix cache, so the resume prefills only the tail);
``abort`` returns every request the engine still owes.

Two options of the paged engine, as in the JAX engine:

* ``quant="int8"`` or ``"fp8"``: the parameters are quantized once at
  build (``quantization/serving.py``), every projection of the decode
  tick and every lm_head runs ``quant_matmul``, and the page pool holds
  narrow K/V rows with per-row scales, read through the dequantizing
  gather.
* ``quality_digest=True``: every generated token also records its logit
  and the top ``digest_top_k`` (ids, values) of its step's fp32 logits;
  the columns ride the segment's one fetch and reach
  ``Request.digests``, index-aligned with ``Request.tokens``, for
  ``observability.quality.compare_pair`` to score a serve against its
  shadow.

Three segment families of the paged engine, as in the JAX engine, each
driven by the same host loop (``_run_steps``):

* ``chunked_prefill=True`` (``cseg``): an admit prefills its suffix in
  chunks of C tokens (``prefill_chunks``, ``program_space.chunk_for``) at
  a context offset, interleaved with decode ticks while any slot is live,
  so co-resident decodes wait one chunk, not a whole prompt. At most one
  slot is mid-prefill; a prefill starts only while 2 x its chunks fit the
  step budget, and its last chunk takes the first token. The schedule
  follows from the lengths alone: one fetch a segment without EOS.
* ``speculative=K`` and ``sampling={"temperature", "top_k", "top_p"}``
  (``sseg``): admits run as chunks (one full-width chunk when the engine
  is not chunked) and every decode step is a verify tick over K + 1
  positions a slot (``inference/speculative.py``: an n-gram draft from
  each slot's token history, greedy or rejection-sampling acceptance,
  per-slot sampling streams re-seeded at every admit from the request's
  ``seed``). How many tokens a K > 0 tick emits depends on the data, so
  the host reads the slots' remaining counts whenever its next choice
  depends on them (counted in ``fetches``): which slot an admit takes,
  and, once nothing waits to start, whether any slot is still live, so
  no tick is issued past the segment's end. Greedy or sampled K = 0
  keeps one fetch a segment.
* ``seq_parallel=sp`` with ``long_buckets`` (``spseg``): a segment whose
  picked requests include a suffix past the largest regular bucket (or a
  prefill carried over) prefills in slabs of sp chunks of C tokens, one
  batched call whose rows share the request's page-table row (on one
  card the JAX engine's no-mesh form). A long prefill may span segments:
  its reservation is held in ``_sp_inflight`` and it resumes at the head
  of the queue. Regular traffic stays on the plain or chunked segment.

**Host tier** (a ``PagedPrefixCache`` with a ``HostTier``): a hit on a
spilled prefix restores it at admission (the whole span must fit, after
the pressure valve; a failed restore is a miss), billed to the request
(``tier_pages`` / ``tier_bytes``); the stages that inserts issued land in
``finish_segment`` after the segment's counted fetch, so the tier adds no
read of its own.

**Telemetry**: every segment reports through the metrics registry, the
flight recorder and ``SEGMENT_HOOKS`` (host ints from the replayed log);
each request carries its capacity meter (pages reserved, page-seconds,
weight streams). The admit stamp reads the decision clock
(``observability.journal.now``), so a fed clock reproduces it; the meter
stamps read ``perf_counter``.

Out of this port so far: the quantized engine's program space and
journal replay, and meshes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import metrics as _metrics
from ..ops.kernels.decode_attention import check_heads
from ..quantization.serving import QUANT_MODES, quantize_llama_params
from . import speculative as spec_ops
from .paged_kv import PagedKVCache
from .program_space import chunk_for

__all__ = ["Request", "ServingEngine", "SEGMENT_HOOKS"]

_WAVE_WIDTHS = (8, 4, 2, 1)  # prefill sub-batch sizes

# Process-wide segment observers: ``fn(steps, new_tokens, finished)`` after
# every segment's replay (host ints only). ``observability.slo.install``,
# ``perf.install``, ``capacity.install`` and ``kv_tiers.install`` attach
# here.
SEGMENT_HOOKS: List = []


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    max_new_tokens: int
    tokens: List[int] = field(default_factory=list)
    submit_time: float = 0.0      # perf_counter at add_request
    finish_time: float = 0.0      # perf_counter at retirement
    # online lifecycle (perf_counter, 0.0 = not yet), stamped by the
    # segment engine and the online scheduler at the host fetch that
    # surfaced each event
    arrival_time: float = 0.0     # entered the system
    admit_time: float = 0.0       # picked into a segment
    first_token_time: float = 0.0  # first generated token host-visible
    prefix_hit_len: int = 0       # KV rows reused from the prefix cache
    # SLO class (smaller outranks larger) and absolute e2e deadline on the
    # decision clock (0.0: never shed); set by the SLO scheduler
    priority: int = 0
    deadline: float = 0.0
    preemptions: int = 0          # lost its slot (resumes from its tokens)
    requeues: int = 0             # lost its replica
    # quality digests (engine built with quality_digest=True): one
    # (emitted_logit, top_k_ids, top_k_values) per generated token
    digests: Optional[List[tuple]] = None
    # sampling seed (read by an engine with a sampling config: the slot's
    # stream is keyed at every admit by it and the tokens already
    # generated), and the drafts proposed for and accepted by this request
    seed: int = 0
    spec_proposed: int = 0
    spec_accepted: int = 0
    # capacity meter (perf_counter stamps, telemetry only): the latest
    # reservation's span and its fresh (non-shared) part; page-seconds
    # held, summed over every release (retire, requeue, preempt, abort);
    # weight streams the request was live for (its admit and every tick)
    # and its fair share of them (1 / live slots a tick: over a serve the
    # shares sum to the segment steps)
    pages_reserved: int = 0
    pages_fresh: int = 0
    page_seconds: float = 0.0
    meter_ticks: int = 0
    meter_streams: float = 0.0
    # host-tier traffic billed to this request's admissions
    tier_pages: int = 0
    tier_bytes: int = 0
    _pages_live: int = 0          # pages held now (meter internal)
    _pages_t0: float = 0.0        # when they were reserved

    def _meter_reserve(self, pages: int, fresh: int) -> None:
        self.pages_reserved = pages
        self.pages_fresh = fresh
        self._pages_live = pages
        self._pages_t0 = time.perf_counter()

    def _meter_release(self) -> None:
        """Close the open page-holding interval (idempotent)."""
        if self._pages_live:
            self.page_seconds += self._pages_live * (
                time.perf_counter() - self._pages_t0)
            self._pages_live = 0

    @property
    def done(self) -> bool:
        return len(self.tokens) >= self.max_new_tokens

    def resume_view(self):
        """(tokens to prefill, generations still owed) for admission: a
        fresh request prefills its prompt; a resumed one prompt + what it
        already generated, and owes only the tail."""
        if not self.tokens:
            return self.prompt, self.max_new_tokens
        full = np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])
        return full, self.max_new_tokens - len(self.tokens)


@dataclass
class _StepLog:
    """What ``_run_steps`` issued: the device token log ([max_steps,
    slots], or [max_steps, slots, K + 1] on a speculative engine), the
    same log read step by step under EOS (else None), the host-known admit
    records (aq: the picked row an admit served, n_pad a decode step,
    n_pad + 1 a non-final chunk step; aslot: its slot), the steps run and
    the requests admitted."""
    out: torch.Tensor
    toks: Optional[np.ndarray]
    aq: np.ndarray
    aslot: np.ndarray
    steps: int
    qadm: int
    # quality digests on the device: the emitted token's logit [max_steps,
    # slots] fp32, the top-k ids [max_steps, slots, k] int32 and values
    # fp32 (None without quality_digest)
    dig: Optional[tuple] = None
    # speculative: the tokens each slot emitted a step [max_steps, slots]
    acc: Optional[torch.Tensor] = None
    # a prefill the step budget cut: (slot, picked row, suffix rows done);
    # slot -1: none
    pf: tuple = (-1, 0, 0)


@dataclass
class _PendingSegment:
    """A segment whose steps are issued and whose event log is not yet
    read: the picked requests, their reservations and admission views, and
    the host-known half of the log."""
    paged: bool
    picked: List[Request]
    prefix_cache: object
    pre_lens: List[int]            # reused-prefix rows per request
    req_pages: List[List[int]]     # page reservations per request (paged)
    full_prompts: List[np.ndarray]  # the spans the admits prefill
    log: _StepLog
    chunk_marker: Optional[int] = None  # aq of a non-final chunk step
    sp: bool = False               # a sequence-parallel (slab) segment

    @property
    def steps(self) -> int:
        return self.log.steps

    @property
    def qadm(self) -> int:
        return self.log.qadm


def _live_any(lo, hi):
    """Whether some slot owes tokens, from bounds on each slot's remaining
    count: True, False, or None (not known without a read)."""
    if any(v > 0 for v in lo):
        return True
    return None if any(v > 0 for v in hi) else False


def _free_slot(lo, hi):
    """The first slot owing nothing (the device's ``argmin(rem)``), -1 if
    none, None if not known without a read."""
    for i, (l, h) in enumerate(zip(lo, hi)):
        if h == 0:
            return i
        if l == 0:
            return None
    return -1


def _choose(lo, hi, waiting: bool, chunked: bool, pf: int, phase: int):
    """The JAX segment's choice of the next step, from bounds on the
    remaining counts: ("admit", slot) (an admit, or a prefill chunk),
    ("tick", -1), ("stop", -1), or (None, -1) when the choice needs a
    read. ``waiting``: a picked request could start, or a prefill is
    under way; ``chunked``: admits run as chunks that alternate with
    ticks (``phase`` 1 after a chunk step)."""
    la = _live_any(lo, hi)
    if not waiting:
        return (None if la is None else "tick" if la else "stop"), -1
    if chunked and pf >= 0:
        s = pf
    else:
        s = _free_slot(lo, hi)
        if s is None:
            return None, -1
        if s < 0:
            return "tick", -1
    if chunked and phase == 1:
        if la is None:
            return None, -1
        if la:
            return "tick", -1
    return "admit", s


class ServingEngine:
    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 max_len: Optional[int] = None, chunk: int = 32,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256),
                 eos_token_id: Optional[int] = None, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 chunked_prefill: bool = False,
                 prefill_chunks: Sequence[int] = (8, 16, 32, 64),
                 speculative: int = 0, sampling: Optional[dict] = None,
                 sample_seed: int = 0,
                 quality_digest: bool = False, digest_top_k: int = 4,
                 quant: Optional[str] = None, seq_parallel: int = 0,
                 long_buckets: Sequence[int] = (), device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not quant:
            # the decode and paged kernels' shapes, refused here rather
            # than at the first tick (a quantized pool attends through the
            # dequantizing gather instead)
            check_heads(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
        for name, t in params.items():
            if t.device != self.device or t.dtype != cfg.dtype:
                raise ValueError(
                    f"parameter {name} is {t.dtype} on {t.device}; the "
                    f"engine needs {cfg.dtype} on {self.device}")
        self.cfg = cfg
        self.params = params
        self.slots = int(slots)
        self.max_len = int(max_len or cfg.max_seq_len)
        self.chunk = int(chunk)
        self.buckets = tuple(sorted(int(b) for b in prompt_buckets
                                    if b <= self.max_len))
        if not self.buckets:
            raise ValueError("no prompt bucket fits max_len")
        self.eos = eos_token_id
        self._queue: List[Request] = []
        self._active: List[Optional[Request]] = [None] * self.slots
        self._rem_host = [0] * self.slots  # host mirror of remaining counts
        self._finished: List[Request] = []
        self.last_run_chunks = 0  # decode chunks (paged: segments) last run
        self.last_run_ticks = 0   # decode ticks (paged: segment steps)
        self.last_latencies = {}  # rid -> submit->finish seconds (last run)
        self.fetches = 0          # device-to-host reads (``_fetch``)
        self.prefill_chunk_steps = 0  # non-final prefill chunk steps run
        self._next_rid = 0
        self.paged = bool(paged)
        self.page_backpressure_events = 0  # admissions deferred for pages
        self._pending_seg: Optional[_PendingSegment] = None
        # the options and their refusals, in the JAX engine's order and
        # with its messages
        self.chunked = bool(chunked_prefill)
        if self.chunked and not self.paged:
            raise ValueError(
                "chunked_prefill requires paged=True (chunks prefill at "
                "a context offset through the page tables; the "
                "contiguous admit branch stages whole windows)")
        self.prefill_chunks = tuple(sorted(int(c) for c in prefill_chunks))
        if self.chunked and not self.prefill_chunks:
            raise ValueError("chunked_prefill needs a non-empty "
                             "prefill_chunks ladder")
        self.speculative = int(speculative)
        if self.speculative < 0:
            raise ValueError(f"speculative draft length must be >= 0, "
                             f"got {speculative}")
        samp = None
        if sampling:
            t = float(sampling.get("temperature", 1.0))
            if t < 0.0:
                raise ValueError(f"temperature must be >= 0, got {t}")
            if t > 0.0:     # temperature 0 is greedy
                samp = (t, int(sampling.get("top_k", 0)),
                        float(sampling.get("top_p", 1.0)))
        self.sampling = samp
        self.sample_seed = int(sample_seed)
        if (self.speculative or self.sampling) and not self.paged:
            raise ValueError(
                "speculative/sampled decoding requires paged=True (the "
                "verify tick reuses the page-indirect q_len>1 path and "
                "the RNG/history state rides the paged segment family)")
        self.quality_digest = bool(quality_digest)
        self.digest_top_k = int(digest_top_k)
        if self.quality_digest:
            if not self.paged:
                raise ValueError(
                    "quality_digest requires paged=True (digests extend "
                    "the paged segment event log; the contiguous "
                    "engine's windowed path has no single event fetch "
                    "to ride)")
            if self.chunked or self.speculative or self.sampling:
                raise ValueError(
                    "quality_digest composes with the plain paged "
                    "segment only — chunked/speculative/sampled "
                    "variants are shadow-diffed at token level")
            if self.digest_top_k < 1:
                raise ValueError(f"digest_top_k must be >= 1, got "
                                 f"{digest_top_k}")
        self.quant = str(quant) if quant else None
        if self.quant:
            if self.quant not in QUANT_MODES:
                raise ValueError(f"quant must be one of {QUANT_MODES}, "
                                 f"got {quant!r}")
            if not self.paged:
                raise ValueError(
                    "quant requires paged=True (per-page KV scales ride "
                    "the paged pool's fixed tiles; the contiguous cache "
                    "has no page axis to key them on)")
            if self.chunked or self.speculative or self.sampling:
                raise ValueError(
                    "quant composes with the plain paged segment (and "
                    "quality_digest) only — chunked/speculative/sampled "
                    "variants need their own shadow certification")
            self.params = quantize_llama_params(params, cfg, self.quant)
        self.seq_parallel = int(seq_parallel or 0)
        self.long_buckets = tuple(sorted(int(b) for b in long_buckets))
        if self.seq_parallel < 0:
            raise ValueError(f"seq_parallel must be >= 0, got "
                             f"{seq_parallel}")
        if self.seq_parallel:
            if not self.paged:
                raise ValueError(
                    "seq_parallel requires paged=True (prefill shards "
                    "scatter into the shared paged pool; the contiguous "
                    "cache has no page indirection to land them in)")
            if self.speculative or self.sampling or self.quality_digest \
                    or self.quant:
                raise ValueError(
                    "seq_parallel composes with the plain/chunked paged "
                    "segment only — speculative/sampled/digest/quant "
                    "variants need their own certification")
            if not self.long_buckets:
                raise ValueError("seq_parallel needs a non-empty "
                                 "long_buckets rung ladder")
            if self.long_buckets[0] < max(self.buckets):
                raise ValueError(
                    f"every long bucket must be >= the largest regular "
                    f"bucket {max(self.buckets)} (got "
                    f"{self.long_buckets[0]} — regular traffic rides "
                    f"the ordinary pseg/cseg families)")
            if self.long_buckets[-1] > self.max_len:
                raise ValueError(
                    f"long bucket {self.long_buckets[-1]} exceeds "
                    f"max_len {self.max_len}")
        # rid -> {"pages", "resident"}: a long prefill carried over to the
        # next segment, its reservation held and ``resident`` rows (prefix
        # hit and slabs landed) already in the pool
        self._sp_inflight: Dict[int, dict] = {}
        # tokens a slot emits a verify tick, averaged over segments (>= 1)
        self.spec_accept_ewma = 1.0
        if self.paged:
            # max_len stays the per-slot virtual cap (max_pages pages);
            # num_pages sizes the physical pool
            self.page_size = int(page_size)
            if self.max_len % self.page_size:
                raise ValueError(f"max_len {self.max_len} is not a "
                                 f"multiple of page_size {self.page_size}")
            max_pages = self.max_len // self.page_size
            self.pager = PagedKVCache(
                cfg, self.slots, self.page_size,
                num_pages=int(num_pages or self.slots * max_pages + 1),
                max_pages=max_pages, device=self.device, quant=self.quant)
            self._cache = None
        else:
            self.pager = None
            self._cache = llama.init_kv_cache(cfg, self.slots, self.max_len,
                                              self.device)
        # slot state on the device: position of the next write, the token
        # to feed, generations still owed
        self._pos, self._nxt, self._rem = self._slot_state()
        self._init_spec_state()
        # cold start: build to the first host-visible token
        self.built_at = time.perf_counter()
        self.cold_start_s: Optional[float] = None
        self._seg_fetch0 = 0      # ``fetches`` when the segment dispatched

    @property
    def _spec(self) -> bool:
        """Decode steps are verify ticks (``sseg``)."""
        return bool(self.speculative or self.sampling)

    def _init_spec_state(self) -> None:
        """(Re)build the speculative and sampled slot state on the device:
        ``_hist`` [slots, max_len + 1] int64, each slot's token history
        (the suffix it prefilled and every token it fed a verify tick),
        the n-gram draft's table, with one overflow column past max_len
        for clamped writes; ``_hstart`` [slots] int32, the first history
        column of the slot's own tokens (its prefix-cache hit length);
        ``_rng`` [slots, 2] int64, each slot's sampling stream (key, draws
        so far), re-seeded at every admit. None where unused."""
        dev = self.device
        self._hist = self._hstart = self._rng = None
        if self.paged and self._spec:
            self._hist = torch.zeros((self.slots, self.max_len + 1),
                                     dtype=torch.int64, device=dev)
            self._hstart = torch.zeros(self.slots, dtype=torch.int32,
                                       device=dev)
        if self.paged and self.sampling:
            self._rng = torch.zeros((self.slots, 2), dtype=torch.int64,
                                    device=dev)

    def paged_kernel_active(self) -> bool:
        """True when this engine's paged segments launch the
        ``ragged_paged_attention`` kernel: a paged engine on the card. A
        quantized pool attends through the dequantizing gather instead
        (the paged kernel has no quant mode, in the JAX package too)."""
        return self.paged and not self.quant and self.device.type == "cuda"

    def quant_kernel_active(self) -> bool:
        """True when this engine's quantized projections launch the
        ``quant_matmul`` kernel: a quantized engine on the card (on the
        CPU they take its plain version)."""
        return bool(self.quant) and self.device.type == "cuda"

    def _slot_state(self):
        z = torch.zeros(self.slots, dtype=torch.int32, device=self.device)
        return z, z.to(torch.int64), z.clone()

    # --- request intake ---------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int,
                    seed: Optional[int] = None) -> int:
        """Queue a request; returns its id. ``seed`` keys its sampling
        stream (default ``sample_seed + rid``). With ``seq_parallel`` a
        prompt may be as long as the largest long bucket."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        intake_cap = (max(self.long_buckets) if self.seq_parallel
                      else max(self.buckets))
        if len(prompt) > intake_cap:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds the largest "
                f"{'long ' if self.seq_parallel else ''}bucket "
                f"{intake_cap}")
        if len(prompt) + max_new_tokens - 1 > self.max_len:
            raise ValueError(
                f"prompt {len(prompt)} + max_new_tokens {max_new_tokens} "
                f"exceeds cache max_len {self.max_len}")
        if self.paged:
            need = self.pager.pages_needed(len(prompt) + max_new_tokens - 1)
            if need > self.pager.num_pages - 1:
                raise ValueError(
                    f"request spans {need} pages but the pool holds only "
                    f"{self.pager.num_pages - 1} — it could never admit")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, prompt, int(max_new_tokens),
                                   submit_time=time.perf_counter(),
                                   seed=(self.sample_seed + rid
                                         if seed is None else int(seed))))
        return rid

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the engine's device without synchronising: from pinned
        memory, non-blocking, on a card."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """The engine's one way to read the device from the host: a copy
        of ``t`` as numpy, counted in ``fetches``."""
        self.fetches += 1
        return t.cpu().numpy()

    def _retire(self, r: Request) -> None:
        r.finish_time = time.perf_counter()
        self._finished.append(r)

    # --- device steps -----------------------------------------------------
    @torch.no_grad()
    def _admit(self, prompts, true_lens, slot_ids, rems_new):
        """Prefill a [nb, bucket] wave and insert it into its slots.
        Returns the first generated token per row (left on the device)."""
        nb, bucket = prompts.shape
        c = llama.init_kv_cache(self.cfg, nb, bucket, self.device)
        logits, c = llama.forward_with_cache(self.params, prompts, self.cfg,
                                             c, 0, logit_pos=true_lens - 1)
        tok0 = torch.argmax(logits, dim=-1)
        # rows past bucket keep an earlier occupant's values: decode writes
        # row pos before it reads it, so they are never read
        self._cache["k"][:, slot_ids, :bucket] = c["k"]
        self._cache["v"][:, slot_ids, :bucket] = c["v"]
        self._pos[slot_ids] = true_lens
        self._nxt[slot_ids] = tok0
        if self.eos is not None:
            # EOS at prefill freezes the slot on the device: the host only
            # learns of it at the next sync
            rems_new = torch.where(tok0 == self.eos, 0, rems_new)
        self._rem[slot_ids] = rems_new
        return tok0

    @torch.no_grad()
    def _decode_chunk(self):
        """``chunk`` ragged decode ticks over every slot. Returns the
        [chunk, slots] tokens, left on the device."""
        return torch.stack([self._decode_dense()[0]
                            for _ in range(self.chunk)])

    def _decode_dense(self):
        """One ragged decode tick over every slot of the contiguous cache;
        frozen slots (nothing owed) repeat their token. Returns the [slots]
        tokens and the fp32 logits [slots, V], on the device."""
        live = self._rem > 0
        # a frozen slot may sit at pos == max_len (its last token was never
        # written back); it still runs the tick, so its write lands on its
        # own last row, and its output is discarded
        at = torch.clamp(self._pos, max=self.max_len - 1)
        logits, _ = llama.forward_with_cache(
            self.params, self._nxt[:, None], self.cfg, self._cache, at)
        tok = torch.where(live, torch.argmax(logits, dim=-1), self._nxt)
        self._advance(live, tok)
        return tok, logits

    def _advance(self, live, tok) -> None:
        """Slot state after a decode tick that emitted ``tok``: live slots
        step their position and owe one token less (none after EOS)."""
        step = live.to(torch.int32)
        self._rem = self._rem - step
        if self.eos is not None:
            self._rem = torch.where(live & (tok == self.eos), 0, self._rem)
        self._pos = self._pos + step
        self._nxt = tok

    # --- scheduling -------------------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket for prompt length {n}")

    def _fill_slots(self, admits: List[tuple]) -> None:
        """Admission wave: take as many queued requests as there are free
        slots (longest-remaining-first), group them by prompt bucket, and
        prefill each group in sub-waves. Hysteresis: between windows,
        refill only once a few slots are free (the threshold shrinks with
        the queue so the tail always drains).

        tok0 is not read here: the device tensor and its (request, slot)
        pairs append to ``admits`` and are read at the next sync.
        Requests with ``max_new_tokens == 1`` free their slot at once."""
        free = [s for s in range(self.slots) if self._active[s] is None]
        if not free or not self._queue:
            return
        threshold = min(4, self.slots, len(self._queue))
        if len(free) < threshold and len(free) < self.slots:
            return
        self._queue.sort(key=lambda r: -r.max_new_tokens)
        picked = self._queue[:len(free)]
        del self._queue[:len(free)]
        by_bucket: Dict[int, List[Request]] = {}
        for r in picked:
            by_bucket.setdefault(self._bucket_for(len(r.prompt)), []).append(r)
        it = iter(free)
        for bucket, group in sorted(by_bucket.items()):
            i = 0
            while i < len(group):
                nb = next(w for w in _WAVE_WIDTHS if w <= len(group) - i)
                sub = group[i:i + nb]
                i += nb
                slots = [next(it) for _ in sub]
                prompts = np.zeros((nb, bucket), np.int64)
                lens = np.zeros((nb,), np.int32)
                for j, r in enumerate(sub):
                    prompts[j, :len(r.prompt)] = r.prompt
                    lens[j] = len(r.prompt)
                rems = np.array([r.max_new_tokens - 1 for r in sub],
                                np.int32)
                dev = self.device
                tok0 = self._admit(
                    torch.from_numpy(prompts).to(dev),
                    torch.from_numpy(lens).to(dev),
                    torch.tensor(slots, dtype=torch.int64, device=dev),
                    torch.from_numpy(rems).to(dev))
                admits.append((tok0, list(zip(sub, slots))))
                for r, s in zip(sub, slots):
                    if r.max_new_tokens <= 1:
                        # done at prefill (host-known): the device-side rem
                        # is already 0
                        self._rem_host[s] = 0
                        self._active[s] = None
                    else:
                        self._active[s] = r
                        self._rem_host[s] = r.max_new_tokens - 1
        # host-known prefill retirements free slots for the rest
        if self._queue and any(a is None for a in self._active):
            self._fill_slots(admits)

    def _chunks_until_sync(self) -> int:
        """How many decode chunks to issue before the next host sync.

        Retirement times are host-known absent EOS (remaining counts are
        fixed at admission), so the host runs the device ahead to exactly
        the point where the refill hysteresis would admit new work. With
        EOS, a slot may freeze where the host cannot see it, so the
        run-ahead is capped to bound the idle slot-ticks."""
        rems = sorted(self._rem_host[s] for s in range(self.slots)
                      if self._active[s] is not None)
        if not rems:
            return 0
        if self._queue:
            threshold = min(4, self.slots, len(self._queue))
            free_now = self.slots - len(rems)
            need = min(max(threshold - free_now, 1), len(rems))
            target = rems[need - 1]
        else:
            target = rems[-1]  # no queue: drain every active slot
        n = -(-target // self.chunk)
        if self.eos is not None:
            n = min(n, 4)
        return n

    def _sync(self, admits: List[tuple], chunk_toks: List[torch.Tensor]
              ) -> None:
        """ONE device-to-host copy for a whole window (admit tok0s + every
        decode chunk's [K, slots] tokens), then distribute in order: a slot
        admitted this window takes its tok0 first, then the chunk ticks.
        Tokens after a slot's remaining count or its first EOS are frozen
        repeats and are dropped."""
        if not admits and not chunk_toks:
            return
        parts = [a[0] for a in admits] + [t.reshape(-1) for t in chunk_toks]
        flat = self._fetch(torch.cat(parts))
        off = 0
        for tok0, pairs in admits:
            for (r, s), t in zip(pairs, flat[off:off + len(pairs)].tolist()):
                r.tokens.append(int(t))
                hit_eos = self.eos is not None and int(t) == self.eos
                if r.done or hit_eos:
                    if self._active[s] is r:  # not already freed host-side
                        self._active[s] = None
                    self._rem_host[s] = 0
                    self._retire(r)
            off += len(pairs)
        if not chunk_toks:
            return
        stream = flat[off:].reshape(-1, self.slots)
        ticks = stream.shape[0]
        for slot, req in enumerate(self._active):
            if req is None:
                continue
            take = min(ticks, self._rem_host[slot])
            for k in range(take):
                t = int(stream[k, slot])
                req.tokens.append(t)
                self._rem_host[slot] -= 1
                if self.eos is not None and t == self.eos:
                    self._rem_host[slot] = 0
                    break
            if self._rem_host[slot] == 0:
                self._retire(req)
                self._active[slot] = None

    def collect_finished(self) -> Dict[int, List[int]]:
        """Drain the finished list: rid -> tokens, truncated at
        max_new_tokens and after the first EOS; records each request's
        submit-to-finish latency in ``last_latencies``."""
        done = {}
        for r in self._finished:
            toks = r.tokens[:r.max_new_tokens]
            if self.eos is not None and self.eos in toks:
                toks = toks[:toks.index(self.eos) + 1]
            r.tokens = toks
            if r.digests is not None:
                r.digests = r.digests[:len(toks)]  # stay index-aligned
            done[r.rid] = toks
            self.last_latencies[r.rid] = r.finish_time - r.submit_time
        self._finished = []
        return done

    def free_slot_count(self) -> int:
        return sum(1 for r in self._active if r is None)

    def reset_slots(self) -> None:
        """Clear all slot state between a warm-up and a timed run (cache
        rows and pages stay allocated: positions and page tables make
        stale rows unreachable)."""
        assert all(r is None for r in self._active), \
            "reset_slots with live requests"
        assert self._pending_seg is None, \
            "reset_slots with a dispatched segment in flight"
        self._pos, self._nxt, self._rem = self._slot_state()
        self._init_spec_state()
        self.spec_accept_ewma = 1.0
        self._rem_host = [0] * self.slots
        for r in self._queue:      # prefills carried over hold pages
            info = self._sp_inflight.pop(r.rid, None)
            if info is not None:
                r._meter_release()
                self.pager.release_pages(info["pages"])
        self._sp_inflight = {}
        self._queue = []
        self._finished = []
        self.last_run_ticks = 0
        self.last_run_chunks = 0
        self.last_latencies = {}
        self.page_backpressure_events = 0
        if self.paged:
            self.pager.reset()

    # --- preemption and abort ---------------------------------------------
    def can_preempt(self, slot: int) -> bool:
        """Whether ``slot``'s request could be preempted and resumed here:
        its resume view (prompt + generated tokens) must still fit the
        largest prompt bucket, or it could not be prefilled again."""
        r = self._active[slot]
        return (r is not None
                and len(r.prompt) + len(r.tokens) <= max(self.buckets))

    def preempt_slot(self, slot: int, prefix_cache=None) -> Request:
        """Take ``slot``'s request off the engine between segments and
        return it for the caller to requeue (it resumes from its prompt and
        generated tokens). The device sees one write (the slot owes
        nothing, so it freezes and, paged, writes to the trash page) and
        no read. With ``prefix_cache``, the block-aligned rows the slot has
        written (its prompt and tokens but the last) are parked in it
        first, so the resume prefills only the tail: by page reference on
        a paged engine, as row copies on the contiguous one.
        A paged slot's pages are then released. As in the JAX engine, the
        slot's speculative state (history, sampling stream) stays, since
        the next admit rewrites it, and so do prefills carried over: they
        wait in the queue, not in a slot."""
        if self._pending_seg is not None:
            raise RuntimeError("preempt_slot with a dispatched segment in "
                               "flight: finish_segment must run first")
        r = self._active[slot]
        if r is None:
            raise ValueError(f"preempt_slot of empty slot {slot}")
        self._rem[slot].fill_(0)
        self._rem_host[slot] = 0
        self._active[slot] = None
        r.preemptions += 1
        r._meter_release()
        fp, _ = r.resume_view()
        if prefix_cache is not None:
            # the last generated token was never fed, so its row is not
            # written: park the aligned rows before it (the JAX engine
            # parks round_down(len(fp)), a stale row when that is all of
            # fp, which a second preemption within the block then reads)
            plen_b = prefix_cache.round_down(len(fp) - 1)
            if plen_b:
                self._harvest(prefix_cache, fp[:plen_b], slot,
                              self.pager.slot_pages[slot] if self.paged
                              else None)
        if self.paged:
            self.pager.free_slot(slot)
        _metrics.counter("serving.preemptions").inc()
        _flight.record("preempt", rid=r.rid, slot=slot,
                       tokens_done=len(r.tokens),
                       remaining=r.max_new_tokens - len(r.tokens),
                       parked=prefix_cache is not None)
        return r

    def abort(self) -> List[Request]:
        """Tear the engine down (a replica lost) and return every request
        it still owes, in order: the picked requests of a dispatched
        segment whose log was never read (their host state never advanced,
        so each resumes from its last read token), the live slots, then
        the queue. The reservations of prefills carried over are released
        (their landed rows are lost: each resumes with a full prefill).
        Slot state, the speculative state and the page pool reset, so the
        engine serves again from empty."""
        orphans: List[Request] = []
        p, self._pending_seg = self._pending_seg, None
        released = set()
        if p is not None:
            for pages in p.req_pages:
                self.pager.release_pages(pages)
            for r in p.picked:
                r.admit_time = 0.0
                r._meter_release()
                released.add(r.rid)
            orphans += p.picked
        for rid, info in self._sp_inflight.items():
            if rid not in released:
                self.pager.release_pages(info["pages"])
        self._sp_inflight = {}
        for r in self._active:
            if r is not None:
                r._meter_release()
        for r in self._queue:
            r._meter_release()   # held carried-over reservations
        orphans += [r for r in self._active if r is not None]
        orphans += self._queue
        self._queue = []
        self._active = [None] * self.slots
        self._rem_host = [0] * self.slots
        self._pos, self._nxt, self._rem = self._slot_state()
        self._init_spec_state()
        if self.paged:
            self.pager.reset()
        return orphans

    # --- the engine loop --------------------------------------------------
    def run(self, fused: bool = True) -> Dict[int, List[int]]:
        """Drain the queue: continuous batching until every request is
        served. Returns rid -> generated tokens (greedy, including the
        token chosen at prefill). A paged engine drains through segments
        of ``4 * chunk`` steps, one counted fetch each without EOS
        (``fused`` does not apply). On the contiguous engine, ``fused``
        (when every slot is free) runs the whole queue as one run of steps
        with one fetch without EOS (``_run_fused``); otherwise the
        windowed loop reads the device once per admission window."""
        if self.paged:
            self.last_run_ticks = 0
            self.last_run_chunks = 0
            self.last_latencies = {}
            while self._queue or any(r is not None for r in self._active):
                self.run_segment(4 * self.chunk)
            return self.collect_finished()
        if fused and self._queue and all(r is None for r in self._active):
            return self._run_fused()
        self.last_run_chunks = 0
        self.last_latencies = {}
        admits: List[tuple] = []
        self._fill_slots(admits)
        while any(r is not None for r in self._active):
            chunk_toks = []
            for _ in range(self._chunks_until_sync()):
                chunk_toks.append(self._decode_chunk())
                self.last_run_chunks += 1
            self._sync(admits, chunk_toks)
            admits = []
            self._fill_slots(admits)
        self._sync(admits, [])  # tail: admits whose requests all retired
        self.last_run_ticks = self.last_run_chunks * self.chunk
        return self.collect_finished()

    def _run_fused(self) -> Dict[int, List[int]]:
        """The whole queue, longest generation first (a stable sort), as
        one run of segment steps from empty slots: each step admits the
        next request into the first free slot, its prompt padded to the
        bucket of the longest prompt, or runs a decode tick. Every request
        is served from its prompt. ``last_run_ticks`` counts the decode
        ticks and ``last_run_chunks`` them in chunks. The drain has no
        host clock per request: each finishes at its step's share of the
        drain's measured wall time, the JAX engine's uniform-step
        estimate (an admit and a tick each stream the weights once)."""
        self._queue.sort(key=lambda r: -r.max_new_tokens)
        picked, self._queue = self._queue, []
        n = len(picked)
        p_max = self._bucket_for(max(len(r.prompt) for r in picked))
        gens = [r.max_new_tokens for r in picked]
        prompts = np.zeros((n, p_max), np.int32)
        for j, r in enumerate(picked):
            prompts[j, :len(r.prompt)] = r.prompt
            r.tokens = []
        t0 = time.perf_counter()
        prompts_d = self._upload(prompts.reshape(-1)).view(n, p_max)

        def admit(q, s):
            return self._admit_dense(s, prompts_d[q:q + 1], None, 0, 0,
                                     len(picked[q].prompt), gens[q])

        # every decode tick retires at least one owed token, so the step
        # budget cannot run out; n marks a decode step in the admit log
        log = self._run_steps(n + sum(g - 1 for g in gens), n, gens, admit)
        steps = log.steps
        toks = (log.toks if log.toks is not None
                else self._fetch(log.out[:steps]))
        wall = time.perf_counter() - t0
        fin = {}

        def on_retire(r, s, st):
            fin[r.rid] = st

        self._replay_segment(picked, toks, log.aq, log.aslot, steps,
                             on_retire=on_retire)
        ticks = steps - n
        self.last_run_ticks = ticks
        self.last_run_chunks = -(-ticks // self.chunk)
        self.last_latencies = {}
        per_step = wall / max(steps, 1)
        for r in picked:
            r.finish_time = r.submit_time + (fin[r.rid] + 1) * per_step
        return self.collect_finished()

    # --- segments ---------------------------------------------------------
    @staticmethod
    def _pow2(n: int, lo: int = 1) -> int:
        p = lo
        while p < n:
            p *= 2
        return p

    def run_segment(self, max_steps: int, prefix_cache=None,
                    n_pad: Optional[int] = None,
                    now: Optional[float] = None) -> dict:
        """One continuous-batching segment: admit from the queue into free
        slots (at most ``n_pad`` requests), run up to ``max_steps`` steps,
        read the event log back, and replay it on the host to distribute
        tokens and retire requests.

        Returns {"steps", "admitted", "first_tokens", "finished",
        "tokens"}: rid lists the caller (the online scheduler) stamps with
        the time of the read; ``now`` (default: the decision clock,
        ``observability.journal.now()``) is each picked request's
        admit_time. ``dispatch_segment`` followed by ``finish_segment``."""
        return self.finish_segment(
            self.dispatch_segment(max_steps, prefix_cache, n_pad, now))

    def dispatch_segment(self, max_steps: int, prefix_cache=None,
                         n_pad: Optional[int] = None,
                         now: Optional[float] = None) -> _PendingSegment:
        """Pick requests (and, paged, reserve their pages) and issue the
        segment's steps, without reading its event log (unless EOS makes
        the schedule depend on the tokens). At most one segment is in
        flight per engine: the next one starts from this one's slot
        state. ``prefix_cache`` is a ``PagedPrefixCache`` on a paged
        engine, a ``PrefixCache`` on the contiguous one."""
        if self._pending_seg is not None:
            raise RuntimeError(
                "dispatch_segment with a segment already in flight — "
                "finish_segment must run first (one outstanding segment "
                "per engine)")
        if prefix_cache is not None and \
                hasattr(prefix_cache, "pager") != self.paged:
            want = "PagedPrefixCache" if self.paged else "PrefixCache"
            raise TypeError(
                f"a {'paged' if self.paged else 'contiguous'} engine takes "
                f"a {want} (inference/prefix_cache.py), got "
                f"{type(prefix_cache).__name__}")
        if now is None:
            # the admit stamp feeds the SLO scheduler's estimates, so it
            # reads the decision clock (journaled, or fed back)
            now = _journal.now()
        self._seg_fetch0 = self.fetches
        n_pad = n_pad or self._pow2(self.slots)
        dispatch = (self._dispatch_segment_paged if self.paged
                    else self._dispatch_segment_dense)
        self._pending_seg = dispatch(max_steps, prefix_cache, n_pad, now)
        return self._pending_seg

    def _dispatch_segment_dense(self, max_steps: int, prefix_cache,
                                n_pad: int, now: float) -> _PendingSegment:
        """Pick up to ``n_pad`` requests whatever the free slots (slots
        free within the segment, and what the step budget does not admit
        goes back to the queue head), look each up in the row-copy cache,
        then issue the steps."""
        picked = self._queue[:n_pad]
        del self._queue[:len(picked)]
        n = len(picked)
        fulls = [r.resume_view() for r in picked]   # (span, owed)
        pre_lens = [0] * n
        hits = [None] * n
        if prefix_cache is not None:
            for j, r in enumerate(picked):
                m = prefix_cache.match(fulls[j][0])
                if m is not None and m.length < len(fulls[j][0]):
                    hits[j], pre_lens[j] = m, m.length
                    r.prefix_hit_len = m.length
        # admit window: the largest bucket when nothing is reused (one
        # shape for every admit), the bucket of the longest suffix after
        # the hits, whose rows sit in the first pre_max rows
        pre_max = prefix_cache.round_up(max(pre_lens)) if any(pre_lens) else 0
        if pre_max:
            s_max = self._bucket_for(max(len(f) - pl for (f, _), pl
                                         in zip(fulls, pre_lens)))
            if pre_max + s_max > self.max_len:
                # prefix and suffix window must fit the cache: no reuse
                pre_max, pre_lens, hits = 0, [0] * n, [None] * n
                for r in picked:
                    r.prefix_hit_len = 0
        if not pre_max:
            s_max = self.buckets[-1]
        prompts = np.zeros((n, s_max), np.int32)
        lens, gens = [], []
        for j, r in enumerate(picked):
            suf = fulls[j][0][pre_lens[j]:]
            prompts[j, :len(suf)] = suf
            lens.append(len(suf))
            gens.append(fulls[j][1])
            r.admit_time = now
        prompts_d = self._upload(prompts.reshape(-1)).view(n, s_max)

        def admit(q, s):
            return self._admit_dense(s, prompts_d[q:q + 1], hits[q],
                                     pre_lens[q], pre_max, lens[q], gens[q])

        return _PendingSegment(paged=False, picked=picked,
                               prefix_cache=prefix_cache, pre_lens=pre_lens,
                               req_pages=[], full_prompts=[f for f, _ in fulls],
                               log=self._run_steps(max_steps, n_pad, gens,
                                                   admit))

    def _long_rung(self, n: int) -> int:
        """The smallest long bucket that holds an ``n``-token suffix: a
        sequence-parallel segment's admit window."""
        for b in self.long_buckets:
            if n <= b:
                return b
        raise ValueError(f"no long bucket for suffix length {n}")

    def _prefill_chunk_for(self, s_max: int) -> int:
        """Chunk width of a chunked segment whose admit window is
        ``s_max`` wide (``program_space.chunk_for``)."""
        return chunk_for(self.prefill_chunks, s_max)

    def _dispatch_segment_paged(self, max_steps: int, prefix_cache,
                                n_pad: int, now: float) -> _PendingSegment:
        """Pick FCFS gated on pages free (a request's page span is known
        at admission: its generation length is fixed), reserve page lists
        with any prefix hit shared by reference, then issue the steps of
        the segment's family: plain, chunked, speculative/sampled, or
        sequence-parallel when a picked request is a long prefill (a
        continuation reuses its held reservation and resumes at its
        resident rows)."""
        pgr = self.pager
        psz = self.page_size
        picked: List[Request] = []
        fulls: List[np.ndarray] = []      # admission (resume) views
        req_pages: List[List[int]] = []
        pre_lens_l: List[int] = []
        tables: List[np.ndarray] = []
        deferred = 0
        while self._queue and len(picked) < n_pad:
            r = self._queue[0]
            sp_info = (self._sp_inflight.get(r.rid) if self.seq_parallel
                       else None)
            if sp_info is not None:
                # a long prefill carried over: its pages and the rows that
                # landed are reused, nothing is reserved or looked up
                row = np.zeros((pgr.max_pages,), np.int32)
                row[:len(sp_info["pages"])] = sp_info["pages"]
                self._queue.pop(0)
                if not r.admit_time:
                    r.admit_time = now
                picked.append(r)
                fulls.append(r.resume_view()[0])
                req_pages.append(sp_info["pages"])
                pre_lens_l.append(sp_info["resident"])
                tables.append(row)
                continue
            fp, remaining = r.resume_view()
            rows = len(fp) + remaining - 1
            total = pgr.pages_needed(rows)
            hit_pages: List[int] = []
            hit_len = 0
            restored = 0
            if prefix_cache is not None:
                m = prefix_cache.match(fp)
                if m is not None and getattr(m, "tier", "hbm") != "host":
                    hit_pages, hit_len = list(m.pages), m.length
                elif m is not None:
                    # a hit on a spilled prefix: restore it into fresh
                    # pages (an H2D copy the stream orders before the
                    # prefill), then share them like any hit. The restore
                    # takes free pages itself, so the whole span must fit,
                    # after the pressure valve; a failed restore is a miss
                    if total > pgr.pages_free:
                        prefix_cache.evict_until(total)
                    if total <= pgr.pages_free:
                        rp = prefix_cache.restore(m.key, m.length)
                        if rp:
                            hit_pages, hit_len = rp, len(rp) * psz
                            restored = len(rp)
            need_new = total - len(hit_pages)
            if need_new > pgr.pages_free:
                if prefix_cache is not None:
                    # pressure valve: cached history yields pages before
                    # live traffic defers; eviction may have freed pages
                    # the hit named, so trim it at the first freed page
                    prefix_cache.evict_until(need_new)
                    k = 0
                    while (k < len(hit_pages)
                           and pgr.allocator.ref(hit_pages[k]) > 0):
                        k += 1
                    hit_pages, hit_len = hit_pages[:k], k * psz
                    need_new = total - k
                if need_new > pgr.pages_free:
                    # FCFS: the queue head blocks until pages retire
                    deferred = len(self._queue)
                    if not picked and all(not p for p in pgr.slot_pages):
                        raise RuntimeError(
                            f"page pool starved: request needs "
                            f"{need_new} pages, {pgr.pages_free} free, "
                            f"no live slots to retire (pages held by an "
                            f"external prefix cache or fork?)")
                    break
            pages, row = pgr.reserve(rows, hit_pages)
            self._queue.pop(0)
            r.prefix_hit_len = hit_len
            r.admit_time = now
            r._meter_reserve(len(pages), len(pages) - len(hit_pages))
            if restored:
                r.tier_pages += restored
                r.tier_bytes += (restored
                                 * prefix_cache.host_tier.page_bytes())
            picked.append(r)
            fulls.append(fp)
            req_pages.append(pages)
            pre_lens_l.append(hit_len)
            tables.append(row)
        if deferred:
            self.page_backpressure_events += 1
            _metrics.counter("serving.backpressure_pages").inc()
            _flight.record("backpressure", reason="pages",
                           deferred=deferred, pages_free=pgr.pages_free)
        n = len(picked)
        lens = [len(f) - pl for f, pl in zip(fulls, pre_lens_l)]
        gens = [r.max_new_tokens - len(r.tokens) for r in picked]

        # the family. A segment is sequence-parallel when a picked request
        # is a long prefill (a suffix past the largest regular bucket, or
        # a carried-over one); its window is the largest such rung,
        # rounded to the slab. Otherwise the admit window is the largest
        # bucket when nothing was reused (one shape for every admit; a
        # speculative segment always), the bucket of the longest suffix
        # when prefix hits shorten the prefills, rounded to the chunk on a
        # chunked engine.
        sp_engaged = [j for j in range(n) if self.seq_parallel and (
            picked[j].rid in self._sp_inflight
            or lens[j] > self.buckets[-1])]
        sp_mode = bool(sp_engaged)
        spec = self._spec
        C = None
        if sp_mode:
            C = self.prefill_chunks[-1]
            slab = self.seq_parallel * C
            lb = max(self._long_rung(max(1, lens[j])) for j in sp_engaged)
            s_max = -(-lb // slab) * slab
        elif spec or prefix_cache is None or not any(pre_lens_l):
            s_max = self.buckets[-1]
        else:
            s_max = self._bucket_for(max(lens, default=1))
        if self.chunked and not sp_mode:
            C = self._prefill_chunk_for(s_max)
            s_max = -(-s_max // C) * C        # chunk-aligned admit window
            worst = 2 * (s_max // C)
            if max_steps < worst:
                raise ValueError(
                    f"seg_steps {max_steps} cannot fit one chunked "
                    f"prefill ({s_max // C} chunks x {C} interleaved = "
                    f"{worst} steps) — raise seg_steps or shrink the "
                    f"prompt buckets / chunk ladder")
        if spec:
            # admits run through the chunk step: one full-width chunk
            # when the engine is not chunked
            if max_steps < 2:
                raise ValueError("speculative segments need seg_steps "
                                 ">= 2 (a prefill start reserves one "
                                 "chunk + one verify step)")
            C = C or s_max

        prompts = np.zeros((n, s_max), np.int32)
        seeds = np.zeros((n,), np.int32)
        for j, r in enumerate(picked):
            suf = fulls[j][pre_lens_l[j]:]
            prompts[j, :len(suf)] = suf
            # the slot's stream is keyed by the request's seed and the
            # tokens it already has: a resume continues from a fold of
            # both instead of replaying the draws it consumed
            seeds[j] = (r.seed + 0x9E3779B1 * len(r.tokens)) & 0x7FFFFFFF
        M = pgr.max_pages
        # the segment's inputs reach the device in one copy that the host
        # does not wait for
        buf = self._upload(np.concatenate([
            prompts.reshape(-1), np.asarray(tables, np.int32).reshape(-1),
            np.asarray(pre_lens_l, np.int32), seeds]))
        prompts_d = buf[:n * s_max].view(n, s_max)
        tables_d = buf[n * s_max:n * (s_max + M)].view(n, M)
        pre_d = buf[n * (s_max + M):n * (s_max + M + 1)]
        seeds_d = buf[n * (s_max + M + 1):]

        if C is None:
            def admit(q, s):
                # one full-width chunk: the same admit body as every family
                return self._chunk_paged(s, prompts_d[q:q + 1],
                                         tables_d[q:q + 1], pre_d[q:q + 1],
                                         0, lens[q], gens[q], True, None)
            chunks = None
        else:
            rows = self.seq_parallel if sp_mode else 1
            width = rows * C

            def admit(q, s, off, done):
                return self._chunk_paged(
                    s, prompts_d[q, off:off + width].view(rows, C),
                    tables_d[q:q + 1], pre_d[q:q + 1], off, lens[q],
                    gens[q], done, seeds_d[q:q + 1])
            # a sequence-parallel prefill is expected to span segments: no
            # step budget gates its start
            chunks = (lens, width, not sp_mode)

        log = self._run_steps(max_steps, n_pad, gens, admit,
                              tick=self._verify_paged if spec else None,
                              chunks=chunks)
        return _PendingSegment(paged=True, picked=picked,
                               prefix_cache=prefix_cache,
                               pre_lens=pre_lens_l, req_pages=req_pages,
                               full_prompts=fulls, log=log,
                               chunk_marker=None if C is None else n_pad + 1,
                               sp=sp_mode)

    @torch.no_grad()
    def _run_steps(self, max_steps: int, n_pad: int, gens: List[int],
                   admit, tick=None, chunks=None) -> _StepLog:
        """Issue a segment's steps, any family: the JAX segment's
        ``while_loop``, driven from the host. ``gens[q]`` is what picked
        request q owes; each step admits the next picked request into the
        first slot owing nothing, or runs a decode tick over every slot
        (``tick()`` -> (tokens, fp32 logits[, emitted counts]); default the
        layout's decode tick).

        ``chunks`` None: an admit is one step (``admit(q, slot)`` -> (first
        token [1], fp32 logits [1, V])) and admits run back to back while
        a slot is free. Else ``(lens, width, gated)``: request q's
        ``lens[q]``-token suffix prefills ``width`` tokens a step
        (``admit(q, slot, offset, done)``, the first token when ``done``);
        at most one prefill is under way, chunk steps alternate with ticks
        while a slot is live, and with ``gated`` a prefill starts only
        while 2 x its chunks fit the steps left.

        The host keeps bounds on every slot's remaining count. Without EOS
        and speculation they are exact, so the steps issue back to back;
        with EOS each step's tokens are read once; on a speculative engine
        a verify tick emits 1 to K + 1 tokens a slot, so when a choice
        depends on counts the bounds do not settle (which slot is free,
        whether any is live), the counts are read (``_fetch``). No step
        is issued past the JAX loop's end."""
        n = len(gens)
        spec = self._spec
        K = self.speculative
        tick = tick or (self._decode_paged if self.paged
                        else self._decode_dense)
        dev = self.device
        out = torch.zeros((max_steps, self.slots) + ((K + 1,) if spec else ()),
                          dtype=torch.int64, device=dev)
        acc = (torch.zeros((max_steps, self.slots), dtype=torch.int64,
                           device=dev) if spec else None)
        toks = (np.zeros((max_steps, self.slots), np.int64)
                if self.eos is not None and not spec else None)
        aq = np.full((max_steps,), n_pad, np.int32)
        aslot = np.zeros((max_steps,), np.int32)
        dig = None
        if self.quality_digest:
            k = self.digest_top_k
            dig = (torch.zeros((max_steps, self.slots), dtype=torch.float32,
                               device=dev),
                   torch.zeros((max_steps, self.slots, k), dtype=torch.int32,
                               device=dev),
                   torch.zeros((max_steps, self.slots, k),
                               dtype=torch.float32, device=dev))
        lens, width, gated = chunks if chunks is not None else (None, 0, 0)
        lo, hi = list(self._rem_host), list(self._rem_host)
        step = qidx = 0
        pf, pfq, pfo, phase = -1, 0, 0, 0
        while step < max_steps:
            if chunks is None:
                waiting = qidx < n
            else:
                waiting = pf >= 0 or (qidx < n and (
                    not gated
                    or step + 2 * -(-lens[qidx] // width) <= max_steps))
            kind, s = _choose(lo, hi, waiting, chunks is not None, pf,
                              phase)
            if kind is None:
                lo = [int(v) for v in self._fetch(self._rem)]
                hi = list(lo)
                kind, s = _choose(lo, hi, waiting, chunks is not None, pf,
                                  phase)
            if kind == "stop":
                break
            if kind == "admit":
                starting = pf < 0
                q = qidx if starting else pfq
                off = 0 if starting else pfo
                done = chunks is None or off + width >= lens[q]
                t0, logits = (admit(q, s) if chunks is None
                              else admit(q, s, off, done))
                if done:
                    if spec:
                        out[step, s, 0] = t0[0]
                        acc[step, s].fill_(1)
                    else:
                        out[step, s] = t0[0]
                    if dig is not None:
                        self._record_digest(dig, step, s, logits, t0)
                    lo[s] = hi[s] = gens[q] - 1
                    if toks is not None:
                        toks[step, s] = self._fetch(t0)[0]
                        if toks[step, s] == self.eos:
                            lo[s] = hi[s] = 0
                    elif self.eos is not None:
                        lo[s] = 0         # an EOS first token is not read
                    aq[step] = q
                else:
                    aq[step] = n_pad + 1
                aslot[step] = s
                if chunks is not None:
                    pf, pfq, pfo, phase = (-1 if done else s), q, off + width, 1
                qidx += starting
            else:
                res = tick()
                out[step] = res[0]
                if acc is not None:
                    acc[step] = res[2]
                if dig is not None:
                    self._record_digest(dig, step, slice(None), res[1],
                                        out[step])
                if toks is not None:
                    toks[step] = self._fetch(out[step])
                for i in range(self.slots):
                    if hi[i] > 0:      # a live slot emits 1 to K + 1
                        hi[i] -= 1
                        lo[i] = max(lo[i] - (K + 1 if spec else 1), 0)
                        if spec and self.eos is not None:
                            lo[i] = 0
                        if toks is not None and toks[step, i] == self.eos:
                            lo[i] = hi[i] = 0
                phase = 0
            step += 1
        return _StepLog(out=out, toks=toks, aq=aq, aslot=aslot, steps=step,
                        qadm=qidx, dig=dig, acc=acc, pf=(pf, pfq, pfo))

    def _record_digest(self, dig, step: int, s, logits, tok) -> None:
        """Write one step's digests on the device: for the rows ``s`` of
        the log (a slot, or every slot), the logit of the emitted token
        ``tok`` and the top-k (ids, values) of the fp32 ``logits``."""
        dlg, dti, dtv = dig
        tv, ti = torch.topk(logits, self.digest_top_k, dim=-1)
        el = torch.gather(logits, 1, tok.reshape(-1, 1))[:, 0]
        if isinstance(s, int):
            el, ti, tv = el[0], ti[0], tv[0]
        dlg[step, s] = el
        dti[step, s] = ti.to(torch.int32)
        dtv[step, s] = tv

    def _bind(self, s: int, t0, gen: int) -> None:
        """Slot ``s`` feeds the admitted request's first token ``t0`` [1]
        next and owes ``gen - 1`` more (none if ``t0`` is EOS)."""
        self._nxt[s] = t0[0]
        if self.eos is None:
            # fill_, not item assignment: assigning a Python number copies
            # it from the host and synchronises
            self._rem[s].fill_(gen - 1)
        else:
            self._rem[s] = torch.where(t0[0] == self.eos, 0, gen - 1)

    def _admit_dense(self, s: int, prompt, hit, pre_len: int, pre_max: int,
                     ln: int, gen: int):
        """Prefill one picked request's suffix (``prompt`` [1, W], its
        true length ``ln``) at position ``pre_len`` over a temporary cache
        of ``pre_max + W`` rows whose first ``pre_len`` rows are the hit's
        (``hit``: a ``PrefixMatch``, or None), then copy those rows into
        slot ``s`` and bind it. Rows past the request's own stay masked:
        decode writes row ``pos`` before it reads it. Returns the first
        token [1] and the fp32 logits [1, V], on the device."""
        rows = pre_max + prompt.shape[1]
        c = llama.init_kv_cache(self.cfg, 1, rows, self.device)
        if hit is not None:
            c["k"][:, 0, :pre_len] = hit.k[:, :pre_len]
            c["v"][:, 0, :pre_len] = hit.v[:, :pre_len]
        logits, _ = llama.forward_with_cache(self.params, prompt, self.cfg,
                                             c, pre_len, logit_pos=ln - 1)
        t0 = torch.argmax(logits, dim=-1)
        self._cache["k"][:, s, :rows] = c["k"][:, 0]
        self._cache["v"][:, s, :rows] = c["v"][:, 0]
        self._pos[s].fill_(pre_len + ln)
        self._bind(s, t0, gen)
        return t0, logits

    def _decode_paged(self):
        """One ragged decode tick over every slot; dead slots (nothing
        owed) write to the trash page and repeat their token. Returns the
        [slots] tokens and the fp32 logits [slots, V], on the device."""
        live = self._rem > 0
        logits, _ = llama.forward_with_pages(
            self.params, self._nxt[:, None], self.cfg, self.pager.pool,
            self.pager.page_table, self._pos, live=live)
        tok = torch.where(live, torch.argmax(logits, dim=-1), self._nxt)
        self._advance(live, tok)
        return tok, logits

    def _chunk_paged(self, s: int, tokens, table, pre_len, off: int, ln: int,
                     gen: int, done: bool, seed):
        """One chunk step of an admit into slot ``s``: ``tokens`` [1, C]
        (a sequence-parallel slab: [sp, C], row i at ``i * C`` tokens
        further) of the picked request's suffix from suffix row ``off``,
        at context offset ``pre_len + off`` through its table row
        ``table`` [1, max_pages] (installed now: idempotent across
        chunks), ``ln`` the suffix length. A speculative engine writes the
        tokens into the slot's history. On the last chunk (``done``) the
        row holding the suffix's last token gives the first token (greedy,
        or drawn from the stream keyed by ``seed`` [1], which the slot
        takes) and the slot is bound. Returns (first token [1] or None,
        fp32 logits [1, V])."""
        rows, C = tokens.shape
        self.pager.page_table[s] = table[0]
        if rows == 1:
            pos, lp, tab = pre_len + off, min(ln - 1 - off, C - 1), table
        else:
            # every slab row scatters its rows before any row attends
            # (the model's per-layer order), so the slab computes what sp
            # chunks in turn would
            ar = C * torch.arange(rows, dtype=torch.int32,
                                  device=self.device)
            pos = pre_len + off + ar
            lp = torch.clamp((ln - 1 - off) - ar, 0, C - 1)
            tab = table.expand(rows, -1).contiguous()
        logits, _ = llama.forward_with_pages(
            self.params, tokens, self.cfg, self.pager.pool, tab, pos,
            logit_pos=lp)
        if self._hist is not None:
            # history columns clamp into the overflow column at max_len
            hidx = torch.clamp(pre_len.long() + off + torch.arange(
                C, device=self.device), max=self.max_len)
            self._hist[s, hidx] = tokens[0].long()
            self._hstart[s] = pre_len[0]
        if not done:
            return None, logits
        r_star = min(max((ln - 1 - off) // C, 0), rows - 1)
        logits = logits[r_star:r_star + 1]
        if self.sampling is None:
            t0 = torch.argmax(logits, dim=-1)
        else:
            t0 = spec_ops.sample_first(logits, seed.long(), self.sampling)
            self._rng[s, 0] = seed[0]
            self._rng[s, 1].fill_(1)
        self._pos[s] = pre_len[0] + ln
        self._bind(s, t0, gen)
        return t0, logits

    def _verify_paged(self):
        """One verify tick over every slot: draft K tokens a slot
        (``speculative.ngram_draft``), score ``[nxt, drafts]`` in one pass
        (``logits_all``; dead slots write to the trash page), accept
        (``speculative.verify``), then each live slot emits ``m = min(a +
        1, owed)`` tokens, cut after an EOS, and advances by ``m``. The K +
        1 fed tokens enter the history at ``pos``; columns past the new
        position are stale and rewritten before a draft can read them.
        Returns (the [slots, K + 1] tokens, fp32 logits [slots, K + 1, V],
        emitted counts [slots]), on the device."""
        K = self.speculative
        dev = self.device
        live = self._rem > 0
        pos, nxt, rem = self._pos, self._nxt, self._rem
        drafts = (spec_ops.ngram_draft(self._hist, self._hstart, pos, nxt, K)
                  if K else nxt.new_zeros((self.slots, 0)))
        x = torch.cat([nxt[:, None], drafts], dim=1)
        logits, _ = llama.forward_with_pages(
            self.params, x, self.cfg, self.pager.pool,
            self.pager.page_table, pos, live=live, logits_all=True)
        e, a = spec_ops.verify(logits, drafts, nxt, self.sampling, self._rng)
        m = torch.where(live, torch.minimum(a.to(rem.dtype) + 1, rem), 0)
        if self.eos is not None:
            ii = torch.arange(K + 1, device=dev)
            eosm = (e == self.eos) & (ii[None] < m[:, None])
            has_eos = eosm.any(dim=1)
            m = torch.where(has_eos, torch.argmax(eosm.int(), dim=1).to(
                m.dtype) + 1, m)
        last = torch.gather(e, 1, torch.clamp(m - 1, min=0).long()[:, None])
        self._nxt = torch.where(m > 0, last[:, 0], nxt)
        rem = rem - m
        if self.eos is not None:
            rem = torch.where(live & has_eos, 0, rem)
        hw = torch.clamp(pos.long()[:, None] + torch.arange(K + 1, device=dev),
                         max=self.max_len)
        self._hist.scatter_(1, hw, x)
        self._pos = pos + m
        self._rem = rem
        return e, logits, m

    def _read_log(self, p: _PendingSegment):
        """The segment's event log on the host: (tokens [steps, slots] (a
        speculative segment's [steps, slots, K + 1]), digests or None,
        emitted counts [steps, slots] or None). Everything comes back in
        ONE fetch (without EOS; with EOS the plain segment's tokens were
        read step by step and the digests take one fetch here), packed as
        integer words: the fp32 digest columns bit-cast, so nothing is
        rounded."""
        log = p.log
        steps = log.steps
        if log.acc is not None:
            flat = self._fetch(torch.cat([log.out[:steps].reshape(-1),
                                          log.acc[:steps].reshape(-1)]))
            n = steps * self.slots * (self.speculative + 1)
            return (flat[:n].reshape(steps, self.slots,
                                     self.speculative + 1), None,
                    flat[n:].reshape(steps, self.slots))
        if log.dig is None:
            return (log.toks if log.toks is not None
                    else self._fetch(log.out[:steps])), None, None
        n, k = steps * self.slots, self.digest_top_k
        dlg, dti, dtv = (t[:steps].reshape(-1) for t in log.dig)
        parts = [dlg.view(torch.int32), dti, dtv.view(torch.int32)]
        if log.toks is None:
            parts.insert(0, log.out[:steps].reshape(-1).to(torch.int32))
        flat = self._fetch(torch.cat(parts))
        toks = log.toks
        if toks is None:
            toks, flat = flat[:n].reshape(steps, self.slots), flat[n:]
        dig = (flat[:n].view(np.float32).reshape(steps, self.slots),
               flat[n:n + n * k].reshape(steps, self.slots, k),
               flat[n + n * k:].view(np.float32).reshape(steps,
                                                         self.slots, k))
        return toks, dig, None

    def finish_segment(self, pending: Optional[_PendingSegment] = None
                       ) -> dict:
        """Read a dispatched segment's event log (its one counted fetch)
        and replay it: tokens to their requests, then the requests the
        step budget did not admit back to the queue head (a long prefill
        the budget cut keeps its reservation and goes first), then each
        slot's latest admitted prompt harvested into the prefix cache.
        Returns the ``run_segment`` result dict; a speculative segment's
        adds ``"spec"``: drafts proposed and accepted, tokens emitted,
        verify steps and slot ticks."""
        p = pending if pending is not None else self._pending_seg
        if p is None or p is not self._pending_seg:
            raise RuntimeError("finish_segment without a matching "
                               "dispatched segment")
        self._pending_seg = None
        picked, n, prefix_cache = p.picked, len(p.picked), p.prefix_cache
        log = p.log
        pgr = self.pager
        toks, dig, acc = self._read_log(p)
        tier = getattr(prefix_cache, "host_tier", None)
        if tier is not None and self.fetches > self._seg_fetch0:
            # the segment's counted fetch waited for the stream, which had
            # passed every stage copy queued before the dispatch and every
            # upload of its admissions: file the stages, free the uploads'
            # sources
            tier.complete(tier.take_pending())
        spec_stats = None if acc is None else {
            "proposed": 0, "accepted": 0, "emitted": 0, "verify_steps": 0,
            "slot_ticks": 0}

        # page bookkeeping rides the replay through hooks; retired slots'
        # releases wait until after the prefix-cache inserts, so harvest
        # by reference can still retain a finished request's prompt pages
        pending_frees: List[List[int]] = []
        on_admit = on_retire = None
        if p.paged:
            def on_admit(q, s):
                pgr.install(s, p.req_pages[q])

            def on_retire(r, s, st):
                r._meter_release()
                pending_frees.append(pgr.slot_pages[s])
                pgr.slot_pages[s] = []

        admitted, first_tokens, finished, new_tokens, eos_stops = \
            self._replay_segment(picked, toks, log.aq, log.aslot, log.steps,
                                 on_admit, on_retire, dig,
                                 chunk_marker=p.chunk_marker, acc=acc,
                                 spec_stats=spec_stats)
        self.last_run_ticks += log.steps
        self.last_run_chunks += 1
        if p.chunk_marker is not None:
            chunk_steps = int((log.aq[:log.steps] >= p.chunk_marker).sum())
            self.prefill_chunk_steps += chunk_steps
            if chunk_steps:
                _metrics.counter("serving.prefill_chunks").inc(chunk_steps)
        qadm = log.qadm
        if p.sp:
            # completed admissions end their carry-over
            for r in picked:
                self._sp_inflight.pop(r.rid, None)
        pf, pfq, pfo = log.pf
        if p.sp and pf >= 0:
            # a long prefill the budget cut: its reservation stays held
            # (its pages hold the landed rows) and it goes back first, to
            # resume at the rows now resident; the rest release and
            # requeue behind it
            assert qadm == pfq + 1, (f"prefill progress desynced: row "
                                     f"{pfq}, {qadm} admitted")
            self._sp_inflight[picked[pfq].rid] = {
                "pages": p.req_pages[pfq],
                "resident": p.pre_lens[pfq] + pfo}
            for j in range(qadm, n):
                picked[j].admit_time = 0.0
                picked[j]._meter_release()
                pgr.release_pages(p.req_pages[j])
            _flight.record("sp_carryover", rid=picked[pfq].rid,
                           resident=p.pre_lens[pfq] + pfo,
                           total=len(p.full_prompts[pfq]))
            self._queue[:0] = picked[pfq:]
        elif qadm < n:
            # the step budget ran out before every picked request found a
            # slot: release their reservations and requeue them FCFS
            for j in range(qadm, n):
                picked[j].admit_time = 0.0
                picked[j]._meter_release()
                if p.paged:
                    pgr.release_pages(p.req_pages[j])
            self._queue[:0] = picked[qadm:]

        if prefix_cache is not None:
            last_admit = {}                # slot -> its latest admit event
            for st in range(log.steps):
                if log.aq[st] < n:
                    last_admit[int(log.aslot[st])] = int(log.aq[st])
            for s, q in last_admit.items():
                fp = p.full_prompts[q]     # the span actually prefilled
                plen_b = prefix_cache.round_down(len(fp))
                if plen_b > p.pre_lens[q]:
                    self._harvest(prefix_cache, fp[:plen_b], s,
                                  p.req_pages[q] if p.paged else None)
        for pages in pending_frees:
            pgr.release_pages(pages)
        if p.paged:
            pgr._gauges()
        result = {"steps": log.steps, "admitted": admitted,
                  "first_tokens": first_tokens, "finished": finished,
                  "tokens": new_tokens}
        if spec_stats is not None:
            self._spec_telemetry(spec_stats)
            result["spec"] = spec_stats
        self._segment_telemetry(log.steps, admitted, finished, eos_stops,
                                new_tokens, max(0, n - qadm))
        return result

    def _segment_telemetry(self, steps, admitted, finished, eos_stops,
                           new_tokens, requeued) -> None:
        """One segment's counters, flight event and ``SEGMENT_HOOKS``:
        host arithmetic on the replayed event log."""
        _metrics.counter("serving.segments").inc()
        _metrics.counter("serving.ticks").inc(steps)
        _metrics.counter("serving.admissions").inc(len(admitted))
        _metrics.counter("serving.tokens_generated").inc(new_tokens)
        if eos_stops:
            _metrics.counter("serving.eos_stops").inc(eos_stops)
        _metrics.gauge("serving.slots_live").set(
            self.slots - self.free_slot_count())
        _flight.record("segment", steps=steps, admitted=len(admitted),
                       finished=len(finished), eos=eos_stops,
                       tokens=new_tokens, requeued=requeued)
        if SEGMENT_HOOKS:
            for hook in SEGMENT_HOOKS:
                hook(steps, new_tokens, len(finished))

    def _spec_telemetry(self, stats: dict) -> None:
        """A speculative segment's draft counters and gauges, its
        ``spec_accept`` flight event, and the acceptance EWMA (tokens one
        slot retires a verify tick, averaged over segments) that the SLO
        scheduler's estimates divide by."""
        prop, accepted = stats["proposed"], stats["accepted"]
        if prop:
            _metrics.counter("spec.proposed").inc(prop)
            _metrics.counter("spec.accepted").inc(accepted)
            _metrics.counter("spec.rejected").inc(prop - accepted)
            _metrics.gauge("spec.accept_rate").set(accepted / prop)
        if stats["slot_ticks"]:
            eff = stats["emitted"] / stats["slot_ticks"]
            _metrics.gauge("spec.effective_tok_per_tick").set(eff)
            self.spec_accept_ewma = 0.5 * self.spec_accept_ewma + 0.5 * eff
            _flight.record("spec_accept", proposed=prop,
                           accepted=accepted,
                           rate=round(accepted / prop, 4) if prop else 0.0,
                           tok_per_tick=round(eff, 4))

    def _note_cold_start(self) -> None:
        """The first host-visible token since build: publish the cold
        start (build, kernel builds and the first prefill included)."""
        self.cold_start_s = time.perf_counter() - self.built_at
        _metrics.gauge("serving.cold_start_s").set(self.cold_start_s)
        _metrics.gauge("serving.first_token_s").set(self.cold_start_s)
        _flight.record("cold_start", seconds=round(self.cold_start_s, 4),
                       aot_warmup_s=None,
                       first_token_s=round(self.cold_start_s, 4),
                       paged=self.paged, slots=self.slots)

    def _harvest(self, prefix_cache, tokens, slot: int, pages) -> None:
        """Insert the prefix ``tokens`` whose KV rows slot ``slot`` holds:
        paged, its ``pages`` by reference; contiguous, copies of its rows,
        which the cache then owns (the slot's next admit overwrites the
        rows in place, and a view would see it)."""
        n = len(tokens)
        if self.paged:
            prefix_cache.insert(tokens, pages[:n // self.page_size])
        else:
            prefix_cache.insert(tokens,
                                self._cache["k"][:, slot, :n].clone(),
                                self._cache["v"][:, slot, :n].clone())

    def _replay_segment(self, picked, toks, aq, aslot, steps: int,
                        on_admit=None, on_retire=None, dig=None,
                        chunk_marker: Optional[int] = None, acc=None,
                        spec_stats: Optional[dict] = None):
        """Walk a segment's event log in order, tracking slot occupancy:
        an admit binds a slot and delivers its first token; a decode step
        appends one token to every slot the host knows is live (its
        ``_rem_host`` mirror), so frozen repeats are dropped; steps whose
        aq is ``chunk_marker`` (non-final prefill chunks) carry nothing.
        The hooks ``on_admit(q, slot)`` and ``on_retire(request, slot,
        step)`` run in event order, so a slot freed and re-admitted within
        the segment releases its old pages before the new list installs.
        Each delivered token takes its digest row (``dig``, when given).

        A speculative log (``acc`` [steps, slots] emitted counts, ``toks``
        [steps, slots, K + 1]): an admit's token is column 0, a verify
        tick gives each live slot its first ``acc`` tokens, and each
        request's drafts proposed and accepted accrue to it and to
        ``spec_stats``. Each request's meter counts the weight streams it
        was live for: its admit alone, and each tick shared by the slots
        live in it. Returns (admitted, first_tokens, finished, new_tokens,
        eos_stops)."""
        n = len(picked)
        K = self.speculative
        admitted, first_tokens, finished = [], [], []
        new_tokens = eos_stops = 0

        def retire(r, s, st):
            self._retire(r)
            finished.append(r.rid)
            if on_retire is not None:
                on_retire(r, s, st)

        for st in range(steps):
            q = int(aq[st])
            if chunk_marker is not None and q >= chunk_marker:
                continue                   # a prefill chunk: no token
            if q < n:                      # admit event
                r = picked[q]
                s = int(aslot[st])
                assert self._active[s] is None, "admit into a live slot"
                if on_admit is not None:
                    on_admit(q, s)
                t = int(toks[st, s, 0] if acc is not None else toks[st, s])
                r.tokens.append(t)
                r.meter_ticks += 1
                r.meter_streams += 1.0
                if dig is not None:
                    self._append_digest(r, dig, st, s)
                new_tokens += 1
                admitted.append(r.rid)
                if len(r.tokens) == 1:     # a resumed request already had
                    first_tokens.append(r.rid)  # its first token
                hit_eos = self.eos is not None and t == self.eos
                eos_stops += hit_eos
                if r.done or hit_eos:
                    self._rem_host[s] = 0
                    retire(r, s, st)
                else:
                    self._active[s] = r
                    self._rem_host[s] = r.max_new_tokens - len(r.tokens)
                continue
            live = [(s, r) for s, r in enumerate(self._active)
                    if r is not None and self._rem_host[s] > 0]
            if acc is not None and live and spec_stats is not None:
                spec_stats["verify_steps"] += 1
            share = 1.0 / len(live) if live else 0.0
            for s, r in live:              # decode or verify tick
                r.meter_ticks += 1
                r.meter_streams += share
                if acc is None:
                    emit = [int(toks[st, s])]
                else:
                    k_emit = int(acc[st, s])
                    emit = [int(t) for t in toks[st, s, :k_emit]]
                    r.spec_proposed += K
                    r.spec_accepted += max(k_emit - 1, 0)
                    if spec_stats is not None:
                        spec_stats["slot_ticks"] += 1
                        spec_stats["proposed"] += K
                        spec_stats["accepted"] += max(k_emit - 1, 0)
                for t in emit:
                    if self._rem_host[s] <= 0:
                        break
                    r.tokens.append(t)
                    if dig is not None:
                        self._append_digest(r, dig, st, s)
                    new_tokens += 1
                    if spec_stats is not None:
                        spec_stats["emitted"] += 1
                    if len(r.tokens) == 1:
                        first_tokens.append(r.rid)
                    self._rem_host[s] -= 1
                    if self.eos is not None and t == self.eos:
                        self._rem_host[s] = 0
                        eos_stops += 1
                if self._rem_host[s] == 0:
                    self._active[s] = None
                    retire(r, s, st)
        if new_tokens and self.cold_start_s is None:
            self._note_cold_start()
        return admitted, first_tokens, finished, new_tokens, eos_stops

    @staticmethod
    def _append_digest(r: Request, dig, st: int, s: int) -> None:
        """Give request ``r`` the digest row of step ``st``, slot ``s``:
        (emitted-token logit, top-k ids, top-k values)."""
        dlg, dti, dtv = dig
        if r.digests is None:
            r.digests = []
        r.digests.append((float(dlg[st, s]),
                          [int(i) for i in dti[st, s]],
                          [float(v) for v in dtv[st, s]]))
