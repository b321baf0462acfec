"""Disaggregated prefill/decode serving: two engine pools with a KV
page-set handoff between them.

Port of ``paddle_tpu/inference/disagg.py``. Prefill is compute-bound and
bursty, decode bandwidth-bound and steady; sharing an engine, a long
prompt's prefill stalls the decode batch beside it. ``DisaggRouter``
splits the fleet into a prefill pool and a decode pool:

* **Fresh arrivals route only to the prefill pool** (the
  ``_dispatch_candidates`` hook narrows affinity, least-loaded and
  directory steering to prefill replicas). A prefill replica admits the
  prompt, prefills it and emits the first token.
* **The handoff.** After a prefill replica's segment fetch lands
  (``_post_segment``), every live slot whose first token is out is
  preempted (``preempt_slot`` parks its page-aligned rows in the
  replica's cache by reference and queues their write-through stage to
  the host tier) and the crossing is PARKED. The next dispatch
  (``_pre_dispatch``) lands every parked crossing's staged bytes with
  ONE counted wait (``kv_tiers.wait_for_stages`` over the source tiers:
  several boundaries crossing in one loop turn share it), then moves
  each request's pages across pools as host bytes (``export_host`` ->
  ``import_host``) and requeues it on the chosen decode replica (a fresh
  engine-local rid, the same fleet rid). The decode replica's admission
  hits the imported entry, restores the pages and prefills only the
  unaligned tail; greedy decode makes the tokens those of the
  co-resident fleet.
* **Journaled and budgeted.** Every crossing writes a ``handoff``
  flight record (rid, src, dst, pages, bytes, rows; ``handoff`` is a
  journal decision kind) and appends to ``handoff_log``, whose bytes per
  crossing stay within the request's reserved KV footprint. The request
  is billed (``tier_pages`` / ``tier_bytes``) once, when the decode
  admission restores the imported pages.
* **Per-pool SLOs**: with ``SLOMonitor(pool_objectives=...)`` the router
  feeds ``note_pool_ttft`` at the first-token stamp (first tokens land
  on prefill replicas) and ``note_pool_tbt`` at the finish stamp.

A slot that cannot resume elsewhere (``can_preempt`` False: generation
outgrew the top bucket), or finds no healthy decode replica, finishes in
place (``handoff_fallbacks``); a handoff whose host entry is gone moves
zero pages and the decode replica prefills again. Failover keeps pool
discipline (``_failover_target``): requests that hold tokens resume on
the decode pool, untouched ones on the prefill pool.

The port's ``preempt_slot`` parks the aligned rows before the last
generated token (that token's row is not written yet), where the JAX
engine parks ``round_down(len(prompt + tokens))``; the handoff exports
the entry the port parked, so when prompt + tokens is a whole number of
pages it moves one page fewer than the JAX router and the decode
replica prefills that page's rows again.

**Per-pool envelopes** (``pool_envelope``): a prefill replica admits fresh
prompts only (``resume=False``) in prefill-sized segments, a decode
replica resumed requests in decode-sized segments, so each pool's
``aot_warmup`` runs only its own keys; the journal header records both
envelopes. ``autoscaler=`` takes one ``Autoscaler`` per pool
(``pool="prefill"`` / ``"decode"``), bound once the replicas carry their
pool tags; a standby warmed mid-serve warms its pool's envelope.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..observability import flight as _flight
from ..observability import journal as _journal
from ..observability import metrics as _metrics
from . import kv_tiers as _kv_tiers
from .fleet import FleetRouter, _Replica
from .prefix_cache import make_prefix_cache
from .serving import Request, ServingEngine

__all__ = ["DisaggRouter"]


class DisaggRouter(FleetRouter):
    """A :class:`FleetRouter` over two pools.

    ``prefill_engines`` / ``decode_engines``: the pools; replicas are
    indexed prefill first, then decode. ``prefill_caches`` /
    ``decode_caches``: one ``PagedPrefixCache`` WITH a host tier per
    engine (the handoff's transport), or ``"auto"`` to build them (a host
    tier the size of the whole pool, so a handoff burst never drops
    staged bytes). ``prefill_seg_steps`` / ``decode_seg_steps``: each
    pool's segment budget (default ``seg_steps``). The other keywords are
    ``FleetRouter``'s; ``canary`` is refused (its replica index has no
    pool).
    """

    def __init__(self, prefill_engines: Sequence[ServingEngine],
                 decode_engines: Sequence[ServingEngine],
                 prefill_caches="auto", decode_caches="auto",
                 host_tier_pages: Optional[int] = None,
                 prefill_seg_steps: Optional[int] = None,
                 decode_seg_steps: Optional[int] = None,
                 seg_steps: int = 8, **kw):
        prefill_engines = list(prefill_engines)
        decode_engines = list(decode_engines)
        if not prefill_engines or not decode_engines:
            raise ValueError("disaggregation needs at least one engine "
                             "in each pool")
        if kw.get("canary") is not None:
            raise ValueError("canary serving is not supported on a "
                             "disaggregated fleet — run the canary "
                             "inside one pool's homogeneous FleetRouter")
        engines = prefill_engines + decode_engines
        for e in engines:
            if not e.paged:
                raise ValueError("disaggregation needs paged engines — "
                                 "the handoff moves KV page sets")

        def _auto(es):
            return [make_prefix_cache(
                e, host_tier_pages=(host_tier_pages
                                    or e.pager.num_pages))
                    for e in es]

        pcs = ((_auto(prefill_engines) if prefill_caches == "auto"
                else list(prefill_caches))
               + (_auto(decode_engines) if decode_caches == "auto"
                  else list(decode_caches)))
        for pc in pcs:
            if pc is None or getattr(pc, "host_tier", None) is None:
                raise ValueError(
                    "every disagg replica needs a PagedPrefixCache "
                    "with a host tier — export_host/import_host is the "
                    "handoff transport")
        # a pool's policy binds by pool tag, which exists only after
        # construction: attach the policies then
        ascs = kw.pop("autoscaler", None)
        super().__init__(engines, prefix_caches=pcs,
                         seg_steps=seg_steps, **kw)
        self.n_prefill = len(prefill_engines)
        for r in self._replicas:
            r.pool = "prefill" if r.idx < self.n_prefill else "decode"
        self._attach_autoscalers(ascs)
        self.prefill_seg_steps = int(prefill_seg_steps or seg_steps)
        self.decode_seg_steps = int(decode_seg_steps or seg_steps)
        # the handoff ledger: every crossing, in decision order
        self.handoffs = 0
        self.handoff_pages = 0
        self.handoff_bytes = 0
        self.handoff_fallbacks = 0          # finished in place instead
        self.handoff_flushes = 0            # counted waits for stages
        self.handoff_log: List[dict] = []
        # crossings planned by the boundary sweeps and parked until the
        # next dispatch (or idle turn): (src replica, request, fleet rid)
        self._pending_handoffs: List[tuple] = []

    # --- pools ------------------------------------------------------------
    def pool_replicas(self, pool: str) -> List[_Replica]:
        return [r for r in self._replicas if r.pool == pool]

    def pool_envelope(self, pool: str):
        """The pool's declared ``WorkloadEnvelope``, what its replicas
        warm. Prefill: fresh admissions only (``resume=False``) at the
        prefill segment budget; decode: the whole resume range (every
        admission is a handed-off request entering through a prefix hit)
        at the decode budget. Each pool carries its own steps axis."""
        rep = self.pool_replicas(pool)[0]
        blk = rep.prefix_cache.block
        if pool == "prefill":
            return rep.engine.default_envelope(
                seg_steps=(self.prefill_seg_steps,), resume=False,
                prefix_block=blk)
        return rep.engine.default_envelope(
            seg_steps=(self.decode_seg_steps,), prefix_block=blk)

    def aot_warmup(self, envelope=None) -> Dict[int, dict]:
        """Per-pool warmup: each replica runs its pool's envelope (an
        explicit ``envelope`` overrides both pools)."""
        out: Dict[int, dict] = {}
        for r in self._replicas:
            env = envelope or self.pool_envelope(r.pool)
            with _metrics.scoped_registry(r.registry), \
                    _journal.rank_scope(r.idx):
                out[r.idx] = r.engine.aot_warmup(
                    env, prefix_cache=r.prefix_cache)
        return out

    # --- routing hooks ----------------------------------------------------
    def _dispatch_candidates(self) -> List[_Replica]:
        # fresh prompts start on serving prefill replicas; decode replicas
        # take work only through the handoff (or failover)
        return [r for r in self.pool_replicas("prefill")
                if r.lifecycle == "serving"]

    def _warmup_envelope_for(self, rep: _Replica):
        # a standby warmed mid-serve runs its pool's envelope, as
        # aot_warmup gave its pool-mates
        return self.pool_envelope(rep.pool)

    def _seg_steps_for(self, rep: _Replica) -> int:
        return (self.prefill_seg_steps if rep.pool == "prefill"
                else self.decode_seg_steps)

    def _failover_target(self, survivors: List[_Replica],
                         req: Request) -> _Replica:
        pool = "decode" if req.tokens else "prefill"
        pooled = [x for x in survivors if x.pool == pool]
        return min(pooled or survivors, key=lambda x: (x.load, x.idx))

    def _handoff_target(self, req: Request) -> Optional[_Replica]:
        """The decode replica a request hands off to: healthy, preferring
        page room for its whole resume span and an un-full queue, then
        the least loaded (ties to the lowest index)."""
        cands = [r for r in self._replicas
                 if r.pool == "decode" and r.health == "healthy"
                 and r.lifecycle == "serving"]
        if not cands:
            return None
        span = len(req.prompt) + req.max_new_tokens - 1

        def rank(r):
            need = r.engine.pager.pages_needed(span)
            return (r.engine.pager.pages_free < need,
                    r.queue_depth >= self.max_queue, r.load, r.idx)

        return min(cands, key=rank)

    # --- the handoff --------------------------------------------------------
    def _post_segment(self, rep: _Replica, ev: dict) -> None:
        """The handoff sweep, after ``rep``'s segment fetch was applied
        and stamped, with the engine idle (the only point a slot can be
        preempted). Each live slot whose first token is out is preempted
        when it can resume on a healthy decode replica (else it finishes
        in place, a fallback); the planned crossings are parked, and no
        wait happens here: ``_pre_dispatch`` lands them."""
        if rep.pool != "prefill":
            return
        eng = rep.engine
        pc = rep.prefix_cache
        frid_of = {id(self._reqs[frid][1]): frid for frid in rep.rids}
        planned = []
        for slot in range(eng.slots):
            req = eng._active[slot]
            if req is None or not req.first_token_time or req.done:
                continue
            if not eng.can_preempt(slot):
                self.handoff_fallbacks += 1     # finishes in place
                continue
            if self._handoff_target(req) is None:
                self.handoff_fallbacks += 1
                continue
            planned.append((slot, req))
        if not planned:
            return
        with _metrics.scoped_registry(rep.registry), \
                _journal.rank_scope(rep.idx):
            for slot, req in planned:
                out = eng.preempt_slot(slot, pc)
                assert out is req
        # the target is chosen again at the drain: loads and health can
        # change while the crossing is parked
        self._pending_handoffs.extend(
            (rep, req, frid_of[id(req)]) for _slot, req in planned)

    def _has_deferred_work(self) -> bool:
        return bool(self._pending_handoffs)

    def _pre_dispatch(self, rep) -> None:
        self._drain_handoffs()

    def _drain_handoffs(self) -> None:
        """Land every parked crossing: ONE counted wait
        (``kv_tiers.wait_for_stages``) covers every source tier that
        staged since the last drain, each tier files its stages under
        its own replica's registry and rank scope, then each crossing
        runs export -> import -> bill -> journal -> requeue."""
        if not self._pending_handoffs:
            return
        entries, self._pending_handoffs = self._pending_handoffs, []
        srcs = list({id(e[0]): e[0] for e in entries}.values())
        work = []
        for src in srcs:
            staged = src.prefix_cache.host_tier.take_pending()
            if staged:
                work.append((src, staged))
        if work:
            _kv_tiers.wait_for_stages(
                [src.prefix_cache.host_tier for src, _ in work])
            for src, staged in work:
                with _metrics.scoped_registry(src.registry), \
                        _journal.rank_scope(src.idx):
                    src.prefix_cache.host_tier.complete(staged)
            self.handoff_flushes += 1
        for src, req, frid in entries:
            dst = self._handoff_target(req)
            if dst is None:
                # every decode replica died while the crossing was
                # parked: requeue by the failover rule among the healthy
                survivors = [x for x in self._replicas
                             if x.health == "healthy"]
                if not survivors:
                    raise RuntimeError(
                        f"request {frid} was preempted for handoff but "
                        "no healthy replica remains to receive it")
                dst = self._failover_target(survivors, req)
                self.handoff_fallbacks += 1
            self._do_handoff(src, dst, req, frid)

    def _kill_replica(self, rep: _Replica, reason: str) -> None:
        # crossings parked at the dying replica cannot wait for the next
        # drain (preempt_slot already took their requests off the
        # engine); their unlanded stages die with the tier, so they
        # requeue without an import and the receiver prefills again
        mine = [e for e in self._pending_handoffs if e[0] is rep]
        if mine:
            self._pending_handoffs = [e for e in self._pending_handoffs
                                      if e[0] is not rep]
            rep.prefix_cache.host_tier.take_pending()   # discard stages
            for src, req, frid in mine:
                dst = self._handoff_target(req)
                if dst is not None:
                    self._do_handoff(src, dst, req, frid)
                    continue
                survivors = [x for x in self._replicas
                             if x.health == "healthy" and x is not rep]
                if not survivors:
                    raise RuntimeError(
                        f"request {frid} was preempted for handoff and "
                        f"its source replica {rep.idx} died with no "
                        "healthy survivor to receive it")
                self._do_handoff(src, self._failover_target(survivors,
                                                            req),
                                 req, frid)
                self.handoff_fallbacks += 1
        super()._kill_replica(rep, reason)

    def _do_handoff(self, src: _Replica, dst: _Replica, req: Request,
                    frid: int) -> None:
        pc_src, pc_dst = src.prefix_cache, dst.prefix_cache
        fp, _ = req.resume_view()
        # the entry preempt_slot parked: the aligned rows before the last
        # generated token
        plen_b = pc_src.round_down(len(fp) - 1)
        pages = nbytes = rows = 0
        resident = False
        if plen_b:
            key = np.asarray(fp[:plen_b], np.int32).tobytes()
            exp = pc_src.export_host(key)
            if exp is not None:
                rows = int(len(exp["tokens"]))
                planes = {p: exp[p] for p in exp
                          if p not in ("tokens", "pages")}
                if pc_dst.import_host(exp["tokens"], planes):
                    pages = int(exp["pages"])
                    nbytes = pages * pc_dst.host_tier.page_bytes()
                else:
                    resident = True     # dst already holds the prefix
        self.handoffs += 1
        self.handoff_pages += pages
        self.handoff_bytes += nbytes
        entry = {"rid": frid, "src": src.idx, "dst": dst.idx,
                 "pages": pages, "bytes": nbytes, "rows": rows,
                 "pages_reserved": req.pages_reserved,
                 "tokens_done": len(req.tokens), "resident": resident}
        self.handoff_log.append(entry)
        _metrics.counter("fleet.handoffs").inc()
        _flight.record("handoff", **entry)
        # requeue across pools as a failover does: the decode engine
        # assigns its own rid, the fleet rid (and the client's TTFT and
        # finish stamps) stays
        req.rid = dst.engine._next_rid
        dst.engine._next_rid += 1
        dst.engine._queue.append(req)
        self._reqs[frid] = (dst.idx, req)
        dst.rids.append(frid)
        src.rids.remove(frid)

    # --- per-pool SLO feed --------------------------------------------------
    def _stamp(self, r: _Replica, ev: dict, t_sync: float) -> List[tuple]:
        outcomes = super()._stamp(r, ev, t_sync)
        mon = self.slo_monitor
        if mon is not None and r.pool is not None:
            by_erid = {self._reqs[frid][1].rid: self._reqs[frid][1]
                       for frid in r.rids}
            for erid in ev["first_tokens"]:
                req = by_erid[erid]
                if req.first_token_time == t_sync:   # stamped just now
                    mon.note_pool_ttft(r.pool,
                                       t_sync - req.arrival_time)
            for erid in ev["finished"]:
                req = by_erid[erid]
                if len(req.tokens) > 1 and req.first_token_time:
                    mon.note_pool_tbt(
                        r.pool, (t_sync - req.first_token_time)
                        / (len(req.tokens) - 1))
        return outcomes

    # --- journal / lifecycle / reporting ------------------------------------
    def _journal_header(self, arrivals) -> dict:
        h = super()._journal_header(arrivals)
        h["driver"] = "disagg"
        # the pool topology: role per replica (index order), the pools'
        # segment budgets and envelopes
        h["pools"] = [r.pool for r in self._replicas]
        h["disagg"] = {
            "prefill_seg_steps": self.prefill_seg_steps,
            "decode_seg_steps": self.decode_seg_steps,
            "envelopes": {
                p: _journal.describe_envelope(self.pool_envelope(p))
                for p in ("prefill", "decode")},
        }
        return h

    def reset(self) -> None:
        super().reset()
        for r in self._replicas:
            r.pool = "prefill" if r.idx < self.n_prefill else "decode"
        self.handoffs = 0
        self.handoff_pages = 0
        self.handoff_bytes = 0
        self.handoff_fallbacks = 0
        self.handoff_flushes = 0
        self.handoff_log = []
        self._pending_handoffs = []

    def handoff_report(self) -> dict:
        return {"handoffs": self.handoffs,
                "pages": self.handoff_pages,
                "bytes": self.handoff_bytes,
                "fallbacks": self.handoff_fallbacks,
                "flushes": self.handoff_flushes,
                "log": list(self.handoff_log)}

    def pool_stats(self) -> Dict[str, dict]:
        """Per-pool aggregates (host values): replica membership, summed
        ``pages_free`` and reclaimable cache pages."""
        out: Dict[str, dict] = {}
        for pool in ("prefill", "decode"):
            reps = self.pool_replicas(pool)
            out[pool] = {
                "replicas": [r.idx for r in reps],
                "pages_free": sum(r.engine.pager.pages_free
                                  for r in reps),
                "reclaimable": sum(r.prefix_cache.reclaimable_pages()
                                   for r in reps),
            }
        return out
