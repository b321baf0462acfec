"""Bit-exact replay of a recorded serve.

Port of ``paddle_tpu/observability/replay.py``. ``replay_serve`` rebuilds
the recorded serve from its journal header (the engines, the online or SLO
scheduler or the fleet router, the prefix caches and host tiers, the fault
injector's live schedule, the canary, the autoscaler policies and their
monitors, the whole trace), runs it again with the recorded clock fed back
through ``journal.now()`` and diffs the replayed decision stream against
the journal: identical, or the first divergence as ``(index, seq, kind,
field, recorded, replayed)``.

Every serving decision is a function of the trace, the engines' and
routers' state and the decision clock's reads, and the journal records all
three, so the replay does not depend on the machine's timing. A divergence
means the journal was altered, the code differs from the code that
recorded, or state the recorder missed leaked into a decision.

The model's weights are passed in-process (``replay_serve(path,
params=...)``): the JAX package rebuilds them from the header's
``prng_seed`` with ``jax.random``, which the port does not reproduce, so
the command line refuses a journal without in-process weights, as both
refuse a mesh-sharded journal.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from . import journal as _journal
from . import metrics as _metrics
from .journal import (DECISION_KINDS, Journal, JournalError, read_journal,
                      sections)

__all__ = ["ReplayResult", "rebuild", "replay_serve", "diff_decisions",
           "main"]

# bookkeeping fields never compared: wall stamps and sequence counters
_IGNORED_FIELDS = frozenset({"t", "gseq", "seq", "v"})


@dataclasses.dataclass
class ReplayResult:
    identical: bool
    n_decisions: int               # recorded decision records diffed
    n_replayed: int
    divergence: Optional[dict]     # the first (seq, kind, field) mismatch
    error: Optional[str] = None    # control flow left the recorded path
    kind: Optional[str] = None     # the header's serve kind
    report: Optional[object] = None   # the replayed OnlineReport/FleetReport

    def as_dict(self) -> dict:
        return {"identical": self.identical,
                "n_decisions": self.n_decisions,
                "n_replayed": self.n_replayed,
                "divergence": self.divergence,
                "error": self.error,
                "kind": self.kind}


# --- header -> live objects ------------------------------------------------

def _cfg_from(d: dict):
    from ..models import llama

    d = dict(d)
    d["dtype"] = getattr(torch, d["dtype"])
    return llama.LlamaConfig(**d)


def _engine_from(d: dict, cfg, params):
    from ..inference.serving import ServingEngine

    if d.get("mesh"):
        raise JournalError(
            f"recorded engine is mesh-sharded over {d['mesh']}: the port "
            f"takes no mesh")
    kw: Dict[str, Any] = dict(
        slots=d["slots"], max_len=d["max_len"], chunk=d["chunk"],
        prompt_buckets=tuple(d["prompt_buckets"]),
        eos_token_id=d["eos_token_id"], paged=d["paged"],
        chunked_prefill=d["chunked_prefill"],
        prefill_chunks=tuple(d["prefill_chunks"]),
        speculative=d["speculative"], sampling=d["sampling"],
        sample_seed=d["sample_seed"],
        quality_digest=d.get("quality_digest", False),
        digest_top_k=d.get("digest_top_k", 4),
        # the engine quantizes the fp params at build, as it did when
        # recording
        quant=d.get("quant"),
        seq_parallel=d.get("seq_parallel", 0),
        long_buckets=tuple(d.get("long_buckets") or ()),
        device=next(iter(params.values())).device)
    if d["paged"]:
        kw["page_size"] = d["page_size"]
        kw["num_pages"] = d["num_pages"]
    eng = ServingEngine(cfg, params, **kw)
    # the state the serve started from: rid offsets key sampling seeds and
    # class order; the acceptance EWMA feeds shed estimates
    eng._next_rid = int(d["next_rid"])
    eng.spec_accept_ewma = float(d["spec_accept_ewma"])
    return eng


def _prefix_cache_from(d: Optional[dict], engine):
    if d is None:
        return None
    from ..inference.prefix_cache import PagedPrefixCache, PrefixCache

    if d["kind"] == "paged":
        host_tier = None
        if d.get("host_tier_pages"):
            from ..inference.kv_tiers import HostTier

            host_tier = HostTier(engine.pager,
                                 capacity_pages=d["host_tier_pages"])
        return PagedPrefixCache(engine.pager,
                                capacity_pages=d["capacity_pages"],
                                host_tier=host_tier)
    return PrefixCache(block=d["block"],
                       capacity_tokens=d["capacity_tokens"])


def _injector_from(d: Optional[dict]):
    if d is None:
        return None
    from ..inference.fleet import FaultInjector

    inj = FaultInjector(
        crash={int(k): int(v) for k, v in (d.get("crash") or {}).items()},
        hang={int(k): tuple(v) for k, v in (d.get("hang") or {}).items()},
        recover_after=d.get("recover_after", 1),
        seed=d.get("seed", 0), crash_p=d.get("crash_p", 0.0))
    for _ in range(int(d.get("draws", 0))):
        inj._rng.rand()            # the draws the recording consumed
    inj._draws = int(d.get("draws", 0))
    return inj


def _trace_from(header: dict):
    from ..inference.scheduler import Arrival

    return [Arrival(a["at"], np.asarray(a["prompt"], np.int32),
                    a["gen"], priority=a.get("priority", 0),
                    deadline_s=a.get("deadline_s"))
            for a in header["trace"]]


def rebuild(header: dict, params):
    """(server, trace): the serve the header describes, built fresh: an
    ``OnlineScheduler`` / ``SLOScheduler`` over one engine, or a
    ``FleetRouter`` / ``DisaggRouter`` over its replicas with their caches,
    the fault injector's recorded schedule, the canary and the autoscaler
    policies with their monitors. ``params``: the fp weights dict, on the
    device the engines should run on."""
    from ..inference.fleet import FleetRouter
    from ..inference.scheduler import OnlineScheduler, SLOScheduler

    cfg = _cfg_from(header["llama"])
    trace = _trace_from(header)
    kind = header["driver"]
    engines = [_engine_from(d, cfg, params) for d in header["engines"]]
    if kind in ("fleet", "disagg"):
        fk = header["fleet"]
        pcs = [_prefix_cache_from(d, e)
               for d, e in zip(header["prefix_caches"], engines)]
        # the canary routes, so it is rebuilt; one linked to a quality
        # monitor holds on shadow-diff state the replay does not rebuild
        canary = None
        ck = header.get("canary")
        if ck is not None:
            if ck.get("quality_linked"):
                raise JournalError(
                    "recorded canary was linked to a live quality "
                    "monitor: its holds depend on shadow-diff state the "
                    "replay does not rebuild; replay latency-only "
                    "canaries, or drive rebuild() with the shadow attached")
            from .quality import CanaryController

            canary = CanaryController(
                ck["replica"], weight=ck["weight"], seed=ck["seed"],
                latency_ratio_max=ck["latency_ratio_max"],
                min_outcomes=ck["min_outcomes"],
                verdict_every=ck["verdict_every"])
        kw = dict(
            max_queue=fk["max_queue"], seg_steps=fk["seg_steps"],
            affinity_block=fk["affinity_block"],
            segment_timeout_s=fk["segment_timeout_s"],
            max_finish_retries=fk["max_finish_retries"],
            max_requeues=fk["max_requeues"],
            fault_injector=_injector_from(header.get("fault")),
            probe_after_s=fk["probe_after_s"],
            directory=bool(fk.get("directory", False)))
        # the policies decide: rebuild them and their input monitors
        ak = header.get("autoscaler")
        if ak is not None:
            from ..inference.autoscaler import Autoscaler

            kw["autoscaler"] = [Autoscaler.from_description(p)
                                for p in ak["policies"]]
            if ak.get("slo") is not None:
                from .slo import SLOMonitor

                kw["slo_monitor"] = SLOMonitor.from_description(ak["slo"])
            if ak.get("capacity") is not None:
                from .capacity import CapacityMonitor

                kw["capacity_monitor"] = CapacityMonitor \
                    .from_description(ak["capacity"])
        if kind == "disagg":
            # pools in index order, prefill first (the construction
            # order); the pool envelopes follow from the engines
            from ..inference.disagg import DisaggRouter

            pools = header["pools"]
            dk = header["disagg"]
            pre = [i for i, p in enumerate(pools) if p == "prefill"]
            dec = [i for i, p in enumerate(pools) if p == "decode"]
            if pre + dec != list(range(len(pools))):
                raise JournalError(
                    f"disagg header pools not prefill-first: {pools}")
            router = DisaggRouter(
                [engines[i] for i in pre], [engines[i] for i in dec],
                prefill_caches=[pcs[i] for i in pre],
                decode_caches=[pcs[i] for i in dec],
                prefill_seg_steps=dk["prefill_seg_steps"],
                decode_seg_steps=dk["decode_seg_steps"], **kw)
        else:
            router = FleetRouter(
                engines,
                prefix_caches=(pcs if any(p is not None for p in pcs)
                               else None),
                canary=canary, **kw)
        router._next_rid = int(fk.get("next_rid", 0))
        return router, trace
    sk = header["scheduler"]
    cls = SLOScheduler if kind == "slo" else OnlineScheduler
    kw: Dict[str, Any] = dict(max_queue=sk["max_queue"],
                              seg_steps=sk["seg_steps"])
    if kind == "slo":
        kw["preempt"] = sk["preempt"]
        kw["shed_deadlines"] = sk["shed_deadlines"]
    sched = cls(engines[0],
                prefix_cache=_prefix_cache_from(
                    header.get("prefix_cache"), engines[0]), **kw)
    # the service-rate EWMAs a warm pass left behind decide sheds
    sched._per_tick_s = float(sk.get("per_tick_s", 0.0))
    if kind == "slo":
        sched._per_token_s = float(sk.get("per_token_s", 0.0))
    return sched, trace


# --- the diff --------------------------------------------------------------

def _decision_stream(records: Sequence[dict]) -> List[dict]:
    # shadow-marked records are kept but sit off the decision stream: the
    # shadow observes, and a replay does not rebuild it
    return [r for r in records
            if r["kind"] in DECISION_KINDS and not r.get("shadow")]


def diff_decisions(recorded: Sequence[dict],
                   replayed: Sequence[dict]) -> Optional[dict]:
    """The first divergence between two decision streams, or None when
    they are identical, compared field by field (all but wall stamps and
    sequence counters)."""
    n = min(len(recorded), len(replayed))
    for i in range(n):
        a, b = recorded[i], replayed[i]
        fields = (["kind"] if a["kind"] != b["kind"]
                  else sorted((set(a) | set(b)) - _IGNORED_FIELDS))
        for k in fields:
            if a.get(k) != b.get(k):
                return {"index": i, "seq": a.get("seq"),
                        "rank": a.get("rank"), "kind": a["kind"],
                        "field": k, "recorded": a.get(k),
                        "replayed": b.get(k)}
    if len(recorded) != len(replayed):
        tail = recorded[n] if len(recorded) > n else replayed[n]
        return {"index": n, "seq": tail.get("seq"),
                "rank": tail.get("rank"), "kind": tail.get("kind"),
                "field": "stream_length", "recorded": len(recorded),
                "replayed": len(replayed)}
    return None


# --- the replay ------------------------------------------------------------

def replay_serve(source, params=None, section: int = -1) -> ReplayResult:
    """Replay one recorded serve and diff it against the journal.

    ``source``: a journal directory or file, a ``read_journal`` result or
    a record list; ``section``: which serve of several (default the last:
    a ``warm=True`` pass records its own first). ``params``: the fp
    weights dict the recording served, on the device to replay on.

    The replay runs in a scratch metrics registry with an in-memory
    journal attached and the recorded clock fed back."""
    if isinstance(source, str):
        records = read_journal(source)["records"]
    elif isinstance(source, dict):
        records = source["records"]
    else:
        records = list(source)
    secs = [s for s in sections(records) if s["header"] is not None]
    if not secs:
        raise JournalError("journal holds no serve header: nothing to "
                           "replay")
    sec = secs[section]
    header, sec_records = sec["header"], sec["records"]
    if params is None:
        raise JournalError(
            "replay needs the recorded model's weights in-process "
            "(replay_serve(..., params=...)): the port cannot rebuild "
            "weights from a prng_seed (the JAX package draws them with "
            "jax.random)")
    server, trace = rebuild(header, params)
    clock = [r["c"] for r in sec_records if r["kind"] == "clock"]
    scratch = Journal()                      # in memory
    error = None
    report = None
    prev_enabled = _metrics.set_enabled(
        bool(header.get("telemetry_enabled", True)))
    try:
        with _metrics.scoped_registry(_metrics.Registry()):
            with _journal.attach(scratch):
                try:
                    with _journal.feed_clock(clock):
                        report = server.serve(trace)
                except JournalError as e:
                    error = str(e)           # control flow diverged
                except AssertionError as e:
                    error = f"replay invariant failed: {e}"
    finally:
        _metrics.set_enabled(prev_enabled)
    rec_dec = _decision_stream(sec_records)
    rep_dec = _decision_stream(scratch.records())
    div = diff_decisions(rec_dec, rep_dec)
    return ReplayResult(identical=div is None and error is None,
                        n_decisions=len(rec_dec),
                        n_replayed=len(rep_dec), divergence=div,
                        error=error, kind=header["driver"],
                        report=report)


def main(argv=None) -> int:
    """``python -m paddle_tpu_torch.observability.replay <journal>``: reads
    the journal and its header and refuses, naming why, since the port's
    replay takes the model's weights in-process. Exit code 2."""
    ap = argparse.ArgumentParser(
        prog="paddle_tpu_torch.observability.replay",
        description="Re-run a recorded serve and certify its decision "
                    "stream bit-identical, or report the first "
                    "divergence (in-process: replay_serve(path, "
                    "params=...)).")
    ap.add_argument("journal", help="journal directory (or one rank file)")
    ap.add_argument("--section", type=int, default=-1,
                    help="which recorded serve (default: last)")
    ap.add_argument("--journey", type=int, default=None, metavar="RID",
                    help="also print request RID's journey")
    args = ap.parse_args(argv)

    merged = read_journal(args.journal)
    if merged.get("skipped_files"):
        print(f"warning: skipped corrupt rank files: "
              f"{merged['skipped_files']}")
    secs = [s for s in sections(merged["records"])
            if s["header"] is not None]
    if not secs:
        print("journal holds no serve header: nothing to replay")
        return 2
    header = secs[args.section]["header"]
    if args.journey is not None:
        j = _journal.request_journey(merged["records"], args.journey)
        print(f"journey rid={args.journey}: kinds={j['kinds']} "
              f"replicas={j['replicas']} tokens={j['n_tokens']}")
    print(f"cannot replay from the command line: the {header['driver']!r} "
          f"serve's weights (header params "
          f"{json.dumps(header.get('params'))}) are drawn by the JAX "
          f"package's jax.random, which the port does not reproduce; call "
          f"replay_serve(path, params=...) with the recorded weights")
    return 2


if __name__ == "__main__":
    sys.exit(main())
