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

Greedy decoding only, like the JAX engine's default. Out of this port so
far: chunked prefill, speculative and sampled segments, sequence
parallelism, the quantized engine's program space and journal replay,
meshes, the host tier, meters and telemetry.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..models import llama
from ..ops.kernels.decode_attention import check_heads
from ..quantization.serving import QUANT_MODES, quantize_llama_params
from .paged_kv import PagedKVCache

__all__ = ["Request", "ServingEngine"]

_WAVE_WIDTHS = (8, 4, 2, 1)  # prefill sub-batch sizes


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
    preemptions: int = 0          # lost its slot (resumes from its tokens)
    requeues: int = 0             # lost its replica
    # quality digests (engine built with quality_digest=True): one
    # (emitted_logit, top_k_ids, top_k_values) per generated token
    digests: Optional[List[tuple]] = None

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
class _PendingSegment:
    """A segment whose steps are issued and whose event log is not yet
    read: the picked requests, their reservations and admission views, and
    the host-known half of the log (admit records, step counts)."""
    paged: bool
    picked: List[Request]
    prefix_cache: object
    pre_lens: List[int]            # reused-prefix rows per request
    req_pages: List[List[int]]     # page reservations per request (paged)
    full_prompts: List[np.ndarray]  # the spans the admits prefill
    out: torch.Tensor              # [max_steps, slots] tokens, on device
    toks: Optional[np.ndarray]     # the same log, already read (EOS)
    aq: np.ndarray                 # [max_steps] admitted row; n_pad: decode
    aslot: np.ndarray              # [max_steps] slot of each admit
    steps: int
    qadm: int                      # picked requests admitted
    # quality digests on the device: the emitted token's logit [max_steps,
    # slots] fp32, the top-k ids [max_steps, slots, k] int32 and values
    # fp32 (None without quality_digest)
    dig: Optional[tuple] = None


class ServingEngine:
    def __init__(self, cfg: llama.LlamaConfig, params, slots: int = 8,
                 max_len: Optional[int] = None, chunk: int = 32,
                 prompt_buckets: Sequence[int] = (32, 64, 128, 256),
                 eos_token_id: Optional[int] = None, paged: bool = False,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 quality_digest: bool = False, digest_top_k: int = 4,
                 quant: Optional[str] = None, device="cuda"):
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
        self._next_rid = 0
        self.paged = bool(paged)
        self.page_backpressure_events = 0  # admissions deferred for pages
        self._pending_seg: Optional[_PendingSegment] = None
        self.quality_digest = bool(quality_digest)
        self.digest_top_k = int(digest_top_k)
        if self.quality_digest:
            if not self.paged:
                raise ValueError(
                    "quality_digest requires paged=True (digests extend "
                    "the paged segment event log)")
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
                    "quant requires paged=True (per-row KV scales ride the "
                    "paged pool's pages; the contiguous cache has none)")
            self.params = quantize_llama_params(params, cfg, self.quant)
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
    def add_request(self, prompt, max_new_tokens: int) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) > max(self.buckets):
            raise ValueError(f"prompt length {len(prompt)} exceeds the "
                             f"largest bucket {max(self.buckets)}")
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
                                   submit_time=time.perf_counter()))
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
        self._rem_host = [0] * self.slots
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
        A paged slot's pages are then released."""
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
        return r

    def abort(self) -> List[Request]:
        """Tear the engine down (a replica lost) and return every request
        it still owes, in order: the picked requests of a dispatched
        segment whose log was never read (their host state never advanced,
        so each resumes from its last read token), the live slots, then
        the queue. Slot state and the page pool reset, so the engine
        serves again from empty."""
        orphans: List[Request] = []
        p, self._pending_seg = self._pending_seg, None
        if p is not None:
            for pages in p.req_pages:
                self.pager.release_pages(pages)
            for r in p.picked:
                r.admit_time = 0.0
            orphans += p.picked
        orphans += [r for r in self._active if r is not None]
        orphans += self._queue
        self._queue = []
        self._active = [None] * self.slots
        self._rem_host = [0] * self.slots
        self._pos, self._nxt, self._rem = self._slot_state()
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
        out, toks, aq, aslot, steps, _, _ = self._run_steps(
            n + sum(g - 1 for g in gens), n, gens, admit)
        if toks is None:
            toks = self._fetch(out[:steps])
        wall = time.perf_counter() - t0
        fin = {}

        def on_retire(r, s, st):
            fin[r.rid] = st

        self._replay_segment(picked, toks, aq, aslot, steps,
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
        the time of the read; ``now`` (default ``time.perf_counter()``) is
        each picked request's admit_time. ``dispatch_segment`` followed by
        ``finish_segment``."""
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
        now = time.perf_counter() if now is None else now
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

        out, toks, aq, aslot, steps, qadm, _ = self._run_steps(
            max_steps, n_pad, gens, admit)
        return _PendingSegment(paged=False, picked=picked,
                               prefix_cache=prefix_cache, pre_lens=pre_lens,
                               req_pages=[], full_prompts=[f for f, _ in fulls],
                               out=out, toks=toks, aq=aq, aslot=aslot,
                               steps=steps, qadm=qadm)

    def _dispatch_segment_paged(self, max_steps: int, prefix_cache,
                                n_pad: int, now: float) -> _PendingSegment:
        """Pick FCFS gated on pages free (a request's page span is known
        at admission: its generation length is fixed), reserve page lists
        with any prefix hit shared by reference, then issue the steps."""
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
            fp, remaining = r.resume_view()
            rows = len(fp) + remaining - 1
            total = pgr.pages_needed(rows)
            hit_pages: List[int] = []
            hit_len = 0
            if prefix_cache is not None:
                m = prefix_cache.match(fp)
                if m is not None:
                    hit_pages, hit_len = list(m.pages), m.length
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
            picked.append(r)
            fulls.append(fp)
            req_pages.append(pages)
            pre_lens_l.append(hit_len)
            tables.append(row)
        if deferred:
            self.page_backpressure_events += 1
        n = len(picked)

        # admit window: the largest bucket when nothing was reused (one
        # shape for every admit), the bucket of the longest suffix when
        # prefix hits shorten the prefills
        if prefix_cache is None or not any(pre_lens_l):
            s_max = self.buckets[-1]
        else:
            s_max = self._bucket_for(max(
                (len(fulls[j]) - pre_lens_l[j] for j in range(n)),
                default=1))
        prompts = np.zeros((n, s_max), np.int32)
        for j in range(n):
            suf = fulls[j][pre_lens_l[j]:]
            prompts[j, :len(suf)] = suf
        M = pgr.max_pages
        # the segment's inputs reach the device in one copy that the host
        # does not wait for
        buf = self._upload(np.concatenate([
            prompts.reshape(-1), np.asarray(tables, np.int32).reshape(-1),
            np.asarray(pre_lens_l, np.int32)]))
        prompts_d = buf[:n * s_max].view(n, s_max)
        tables_d = buf[n * s_max:n * (s_max + M)].view(n, M)
        pre_d = buf[n * (s_max + M):]
        lens = [len(f) - pl for f, pl in zip(fulls, pre_lens_l)]
        gens = [r.max_new_tokens - len(r.tokens) for r in picked]

        def admit(q, s):
            return self._admit_paged(s, prompts_d[q:q + 1],
                                     tables_d[q:q + 1], pre_d[q:q + 1],
                                     lens[q], gens[q])

        out, toks, aq, aslot, steps, qadm, dig = self._run_steps(
            max_steps, n_pad, gens, admit)
        return _PendingSegment(paged=True, picked=picked,
                               prefix_cache=prefix_cache,
                               pre_lens=pre_lens_l, req_pages=req_pages,
                               full_prompts=fulls, out=out, toks=toks,
                               aq=aq, aslot=aslot, steps=steps, qadm=qadm,
                               dig=dig)

    @torch.no_grad()
    def _run_steps(self, max_steps: int, n_pad: int, gens: List[int],
                   admit):
        """Issue a segment's steps, either layout: the JAX segment's
        ``while_loop``, driven from the host. ``rem`` mirrors the device's
        remaining counts; each step admits picked request ``qidx`` into
        the first slot with nothing owed (``argmin(rem)``) while one is
        free and requests remain (``admit(qidx, slot)`` -> (first token
        [1], fp32 logits [1, V])), else runs a decode tick over every
        slot. ``gens[q]`` is what request q owes.

        Returns (out, toks, aq, aslot, steps, qadm, dig): the [max_steps,
        slots] device token log; the same log read step by step when EOS
        is set (else None); the host-known admit records (aq = n_pad marks
        a decode step); the steps run and the requests admitted; the
        digest columns on the device (None without quality_digest)."""
        n = len(gens)
        decode = self._decode_paged if self.paged else self._decode_dense
        out = torch.zeros((max_steps, self.slots), dtype=torch.int64,
                          device=self.device)
        toks = None if self.eos is None else np.zeros(
            (max_steps, self.slots), np.int64)
        aq = np.full((max_steps,), n_pad, np.int32)
        aslot = np.zeros((max_steps,), np.int32)
        dig = None
        if self.quality_digest:
            k, dev = self.digest_top_k, self.device
            dig = (torch.zeros((max_steps, self.slots), dtype=torch.float32,
                               device=dev),
                   torch.zeros((max_steps, self.slots, k), dtype=torch.int32,
                               device=dev),
                   torch.zeros((max_steps, self.slots, k),
                               dtype=torch.float32, device=dev))
        rem = list(self._rem_host)
        qidx = step = 0
        while (qidx < n or any(r > 0 for r in rem)) and step < max_steps:
            if qidx < n and 0 in rem:
                s = rem.index(0)
                t0, logits = admit(qidx, s)
                out[step, s] = t0[0]
                if dig is not None:
                    self._record_digest(dig, step, s, logits, t0)
                rem[s] = gens[qidx] - 1
                if toks is not None:
                    toks[step, s] = self._fetch(t0)[0]
                    if toks[step, s] == self.eos:
                        rem[s] = 0
                aq[step], aslot[step] = qidx, s
                qidx += 1
            else:
                out[step], logits = decode()
                if dig is not None:
                    self._record_digest(dig, step, slice(None), logits,
                                        out[step])
                live = [r > 0 for r in rem]
                rem = [r - 1 if r > 0 else 0 for r in rem]
                if toks is not None:
                    toks[step] = self._fetch(out[step])
                    rem = [0 if lv and t == self.eos else r
                           for r, lv, t in zip(rem, live, toks[step])]
            step += 1
        return out, toks, aq, aslot, step, qidx, dig

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

    def _admit_paged(self, s: int, prompt, table, pre_len, ln: int,
                     gen: int):
        """Prefill one picked request's suffix ([1, s_max] at context
        offset ``pre_len``) straight into its pages, and bind it to slot
        ``s``. Shared-prefix rows already sit in the shared pages, so a
        hit costs no prefill of the prefix and no row copy. Returns the
        first token [1] and the fp32 logits [1, V], on the device."""
        logits, _ = llama.forward_with_pages(
            self.params, prompt, self.cfg, self.pager.pool, table, pre_len,
            logit_pos=ln - 1)
        t0 = torch.argmax(logits, dim=-1)
        self.pager.page_table[s] = table[0]
        self._pos[s] = pre_len[0] + ln
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

    def _read_log(self, p: _PendingSegment):
        """The segment's event log on the host: (tokens [steps, slots],
        digests or None). The tokens and the digest columns come back in
        ONE fetch (without EOS; with EOS the tokens were read step by step
        and the digests take one fetch here), packed as int32 words: the
        fp32 columns bit-cast, so nothing is rounded."""
        if p.dig is None:
            return (p.toks if p.toks is not None
                    else self._fetch(p.out[:p.steps])), None
        n, k = p.steps * self.slots, self.digest_top_k
        dlg, dti, dtv = (t[:p.steps].reshape(-1) for t in p.dig)
        parts = [dlg.view(torch.int32), dti, dtv.view(torch.int32)]
        if p.toks is None:
            parts.insert(0, p.out[:p.steps].reshape(-1).to(torch.int32))
        flat = self._fetch(torch.cat(parts))
        toks = p.toks
        if toks is None:
            toks, flat = flat[:n].reshape(p.steps, self.slots), flat[n:]
        dig = (flat[:n].view(np.float32).reshape(p.steps, self.slots),
               flat[n:n + n * k].reshape(p.steps, self.slots, k),
               flat[n + n * k:].view(np.float32).reshape(p.steps,
                                                         self.slots, k))
        return toks, dig

    def finish_segment(self, pending: Optional[_PendingSegment] = None
                       ) -> dict:
        """Read a dispatched segment's event log (its one counted fetch)
        and replay it: tokens to their requests, then the requests the
        step budget did not admit back to the queue head, then each slot's
        latest admitted prompt harvested into the prefix cache. Returns
        the ``run_segment`` result dict."""
        p = pending if pending is not None else self._pending_seg
        if p is None or p is not self._pending_seg:
            raise RuntimeError("finish_segment without a matching "
                               "dispatched segment")
        self._pending_seg = None
        picked, n, prefix_cache = p.picked, len(p.picked), p.prefix_cache
        pgr = self.pager
        toks, dig = self._read_log(p)
        self.last_run_ticks += p.steps
        self.last_run_chunks += 1

        # page bookkeeping rides the replay through hooks; retired slots'
        # releases wait until after the prefix-cache inserts, so harvest
        # by reference can still retain a finished request's prompt pages
        pending_frees: List[List[int]] = []
        on_admit = on_retire = None
        if p.paged:
            def on_admit(q, s):
                pgr.install(s, p.req_pages[q])

            def on_retire(r, s, st):
                pending_frees.append(pgr.slot_pages[s])
                pgr.slot_pages[s] = []

        admitted, first_tokens, finished, new_tokens = self._replay_segment(
            picked, toks, p.aq, p.aslot, p.steps, on_admit, on_retire, dig)
        if p.qadm < n:
            # the step budget ran out before every picked request found a
            # slot: release their reservations and requeue them FCFS
            for j in range(p.qadm, n):
                picked[j].admit_time = 0.0
                if p.paged:
                    pgr.release_pages(p.req_pages[j])
            self._queue[:0] = picked[p.qadm:]

        if prefix_cache is not None:
            last_admit = {}                # slot -> its latest admit event
            for st in range(p.steps):
                if p.aq[st] < n:
                    last_admit[int(p.aslot[st])] = int(p.aq[st])
            for s, q in last_admit.items():
                fp = p.full_prompts[q]     # the span actually prefilled
                plen_b = prefix_cache.round_down(len(fp))
                if plen_b > p.pre_lens[q]:
                    self._harvest(prefix_cache, fp[:plen_b], s,
                                  p.req_pages[q] if p.paged else None)
        for pages in pending_frees:
            pgr.release_pages(pages)
        return {"steps": p.steps, "admitted": admitted,
                "first_tokens": first_tokens, "finished": finished,
                "tokens": new_tokens}

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
                        on_admit=None, on_retire=None, dig=None):
        """Walk a segment's event log in order, tracking slot occupancy:
        an admit binds a slot and delivers its first token; a decode step
        appends one token to every slot the host knows is live (its
        ``_rem_host`` mirror), so frozen repeats are dropped. The hooks
        ``on_admit(q, slot)`` and ``on_retire(request, slot, step)`` run
        in event order, so a slot freed and re-admitted within the segment
        releases its old pages before the new list installs. Each
        delivered token takes its digest row (``dig``, when given).
        Returns (admitted, first_tokens, finished, new_tokens)."""
        n = len(picked)
        admitted, first_tokens, finished = [], [], []
        new_tokens = 0

        def retire(r, s, st):
            self._retire(r)
            finished.append(r.rid)
            if on_retire is not None:
                on_retire(r, s, st)

        for st in range(steps):
            q = int(aq[st])
            if q < n:                      # admit event
                r = picked[q]
                s = int(aslot[st])
                assert self._active[s] is None, "admit into a live slot"
                if on_admit is not None:
                    on_admit(q, s)
                t = int(toks[st, s])
                r.tokens.append(t)
                if dig is not None:
                    self._append_digest(r, dig, st, s)
                new_tokens += 1
                admitted.append(r.rid)
                if len(r.tokens) == 1:     # a resumed request already had
                    first_tokens.append(r.rid)  # its first token
                hit_eos = self.eos is not None and t == self.eos
                if r.done or hit_eos:
                    self._rem_host[s] = 0
                    retire(r, s, st)
                else:
                    self._active[s] = r
                    self._rem_host[s] = r.max_new_tokens - len(r.tokens)
                continue
            for s, r in enumerate(self._active):   # decode tick
                if r is None or self._rem_host[s] <= 0:
                    continue
                t = int(toks[st, s])
                r.tokens.append(t)
                if dig is not None:
                    self._append_digest(r, dig, st, s)
                new_tokens += 1
                if len(r.tokens) == 1:
                    first_tokens.append(r.rid)
                self._rem_host[s] -= 1
                if self.eos is not None and t == self.eos:
                    self._rem_host[s] = 0
                if self._rem_host[s] == 0:
                    self._active[s] = None
                    retire(r, s, st)
        return admitted, first_tokens, finished, new_tokens

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
