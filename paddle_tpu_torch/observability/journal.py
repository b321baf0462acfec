"""Serving journal: the lossless decision recorder, and the decision clock.

Port of the recording side of ``paddle_tpu/observability/journal.py``.
The flight recorder keeps the last events; the journal keeps all of them:
an append-only, schema-versioned JSONL stream per rank, with monotonic
sequence numbers, size rotation, and a reader that merges ranks. Three
kinds of record:

* **header** (``kind="header"``): one per recorded serve: the driver and
  its knobs, each engine's geometry, the prefix cache, the full arrival
  trace, and the mutable state decisions start from.
* **clock** (``kind="clock"``): every host clock read that can steer a
  serving decision goes through ``now()``. Decisions are functions of the
  trace, the engine's state and these reads, so feeding the recorded
  reads back (``feed_clock``) reproduces the decision stream whatever the
  timing of the machine that replays it.
* **decision records**: every flight event (``flight.LISTENERS``), plus
  the records that carry a decision's inputs: shed arithmetic, preempt
  victim selection, and each request's arrival, admit, first token and
  finish (with its tokens).

Every recorded value is a host mirror: ``_jsonable`` refuses a
``torch.Tensor``, so a journal write can never be a device read.

Record shape (one JSON object a line)::

    {"v": 1, "gseq": 17, "rank": 0, "seq": 17, "t": 1699...,
     "kind": "admit", ...fields...}

``seq`` is monotonic per rank; ``gseq`` is the process-wide order. Adding
a field or a kind keeps ``SCHEMA_VERSION``; renaming or removing one bumps
it, and the reader refuses newer files. The offline replay (which rebuilds
a serve from its header) is not part of the port yet.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["SCHEMA_VERSION", "DECISION_KINDS", "Journal", "JournalError",
           "install", "uninstall", "attach", "active", "record", "now",
           "sleep", "rank_scope", "shadow_scope", "in_shadow_scope",
           "feed_clock", "read_journal", "merge_journal_dir", "sections",
           "request_journey", "journey_summary", "describe_engine",
           "describe_config", "describe_arrivals",
           "describe_prefix_cache", "describe_envelope"]

SCHEMA_VERSION = 1

# The kinds a replay must reproduce verbatim: the decision stream. The
# rest (cold-start seconds, monitor alerts, process exit) is context that
# may differ between a recording and its replay. ``clock`` is included:
# a replay echoes every fed value, so a misaligned feed shows as the
# first divergence.
DECISION_KINDS = frozenset({
    "clock", "arrival", "dispatch", "fleet_dispatch",
    "admit", "first_token", "finish",
    "segment", "backpressure", "displaced",
    "shed", "shed_decision", "preempt", "preempt_decision",
    "spec_accept", "fault", "probe",
    "replica_dead", "replica_suspect", "replica_recovered",
    "failover_requeue", "prefix_hit", "prefix_evict",
    "tier_transfer", "tier_migrate", "handoff", "scale_decision",
})


class JournalError(RuntimeError):
    """Journal misuse, or a replay whose control flow left the recorded
    path (the clock feed ran out: the replayed serve read the clock where
    the recorded one did not)."""


def _jsonable(x):
    """numpy scalars and arrays as plain ints and lists; device tensors
    refused (a journal write must never be what synchronises)."""
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return [_jsonable(v) for v in x.tolist()]
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, dict):
        return {str(k): _jsonable(v) for k, v in x.items()}
    if type(x).__module__.startswith("torch"):
        import torch

        if isinstance(x, torch.Tensor):
            raise TypeError(
                f"journal refuses device value {type(x).__name__} — "
                f"record host mirrors only (the zero-extra-sync contract)")
    return x


class Journal:
    """Append-only JSONL decision journal.

    ``log_dir=None`` keeps the records in memory; with a directory, rank
    ``i``'s records append to ``journal_rank<i>.jsonl`` and rotate to
    ``journal_rank<i>.jsonl.<part>`` past ``max_bytes`` (every part is
    kept). A bounded in-memory tail (``tail()``) serves live views."""

    def __init__(self, log_dir: Optional[str] = None, rank: int = 0,
                 max_bytes: int = 8 * 1024 * 1024,
                 tail_events: int = 4096):
        self.dir = log_dir
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
        self.max_bytes = int(max_bytes)
        self._rank_stack: List[int] = [int(rank)]
        # rank -> [file handle, bytes written, next part number]
        self._files: Dict[int, list] = {}
        self._seqs: Dict[int, int] = {}
        self._gseq = 0
        self._lock = threading.Lock()
        self._tail = collections.deque(maxlen=int(tail_events))
        self._memory: Optional[List[dict]] = ([] if log_dir is None
                                              else None)
        self.total_records = 0
        self.serves = 0                     # header records written
        self.header: Optional[dict] = None  # the first serve's header
        self.params_info: Optional[dict] = None

    # --- write path -------------------------------------------------------
    def _rank_path(self, rank: int) -> str:
        return os.path.join(self.dir, f"journal_rank{rank}.jsonl")

    def _file(self, rank: int) -> list:
        ent = self._files.get(rank)
        if ent is None:
            ent = [open(self._rank_path(rank), "a"), 0, 0]
            ent[1] = ent[0].tell()
            self._files[rank] = ent
        return ent

    def _rotate(self, rank: int, ent: list) -> None:
        """Close the active file, rename it to its part number, and open a
        fresh one: rotation bounds file size, never history."""
        ent[0].close()
        os.replace(self._rank_path(rank),
                   self._rank_path(rank) + f".{ent[2]:03d}")
        ent[2] += 1
        ent[0] = open(self._rank_path(rank), "a")
        ent[1] = 0

    def record(self, kind: str, rank: Optional[int] = None, **data) -> dict:
        with self._lock:
            r = self._rank_stack[-1] if rank is None else int(rank)
            self._gseq += 1
            seq = self._seqs.get(r, 0) + 1
            self._seqs[r] = seq
            rec = {"v": SCHEMA_VERSION, "gseq": self._gseq, "rank": r,
                   "seq": seq, "t": time.time(), "kind": kind,
                   **{k: _jsonable(v) for k, v in data.items()}}
            if _SHADOW[0]:
                # written from a shadow path: kept, but marked so a replay
                # diff judges the primary stream alone
                rec["shadow"] = True
            self.total_records += 1
            self._tail.append(rec)
            if self._memory is not None:
                self._memory.append(rec)
            else:
                ent = self._file(r)
                line = json.dumps(rec, separators=(",", ":")) + "\n"
                ent[0].write(line)
                ent[1] += len(line)
                if ent[1] >= self.max_bytes:
                    self._rotate(r, ent)
            return rec

    def begin_serve(self, header: dict) -> None:
        """Record one serve's header. A journal may hold several serves
        (a warm pass records its own section); readers split on
        headers."""
        header = dict(header)
        header.setdefault("schema", SCHEMA_VERSION)
        if self.params_info is not None:
            header.setdefault("params", self.params_info)
        self.serves += 1
        rec = self.record("header", header=header)
        if self.header is None:
            self.header = rec["header"]

    @contextlib.contextmanager
    def rank_scope(self, rank: int):
        """Route the records inside the scope to ``rank``'s file."""
        self._rank_stack.append(int(rank))
        try:
            yield self
        finally:
            self._rank_stack.pop()

    def flush(self) -> None:
        with self._lock:
            for ent in self._files.values():
                ent[0].flush()

    def close(self) -> None:
        with self._lock:
            for ent in self._files.values():
                ent[0].close()
            self._files.clear()

    # --- read path --------------------------------------------------------
    def tail(self, n: int = 64, kind: Optional[str] = None,
             rid: Optional[int] = None) -> List[dict]:
        """Newest-last view of the bounded tail, optionally filtered."""
        with self._lock:
            evs = list(self._tail)
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        if rid is not None:
            evs = [e for e in evs if e.get("rid") == rid]
        return evs[-max(1, int(n)):]

    def records(self) -> List[dict]:
        """The full record stream (a file-backed journal flushes and reads
        its directory back: the files are the source of truth)."""
        if self._memory is not None:
            return list(self._memory)
        self.flush()
        return read_journal(self.dir)["records"]

    def request_journey(self, rid: int) -> dict:
        return request_journey(self.records(), rid)


# --- process-wide attachment ----------------------------------------------

_ACTIVE: List[Optional[Journal]] = [None]
_FEED: List[Optional["_ClockFeed"]] = [None]


def _flight_listener(kind: str, data: dict) -> None:
    j = _ACTIVE[0]
    if j is not None:
        j.record(kind, **data)


def install(journal: Journal) -> None:
    """Make ``journal`` the process-wide journal: ``record`` calls land in
    it, and so does every flight event."""
    from . import flight as _flight

    if _ACTIVE[0] is not None:
        raise JournalError("a journal is already installed")
    _ACTIVE[0] = journal
    _flight.LISTENERS.append(_flight_listener)


def uninstall(journal: Journal) -> None:
    from . import flight as _flight

    if _ACTIVE[0] is not journal:
        raise JournalError("uninstall of a journal that is not installed")
    _ACTIVE[0] = None
    if _flight_listener in _flight.LISTENERS:
        _flight.LISTENERS.remove(_flight_listener)


@contextlib.contextmanager
def attach(journal: Journal):
    """Scoped ``install`` / ``uninstall``::

        with journal.attach(j):
            report = scheduler.serve(trace)
    """
    install(journal)
    try:
        yield journal
    finally:
        uninstall(journal)


def active() -> Optional[Journal]:
    return _ACTIVE[0]


def record(kind: str, **data) -> None:
    """Journal a record if a journal is attached (one list read when
    not)."""
    j = _ACTIVE[0]
    if j is not None:
        j.record(kind, **data)


@contextlib.contextmanager
def rank_scope(rank: int):
    """Route records inside the scope to ``rank`` when a journal is
    attached; a no-op otherwise."""
    j = _ACTIVE[0]
    if j is None:
        yield None
        return
    with j.rank_scope(rank):
        yield j


# Depth-counted shadow marker: records (clock reads included) written
# inside ``shadow_scope`` carry ``shadow: true``.
_SHADOW = [0]


@contextlib.contextmanager
def shadow_scope():
    """Mark every record inside the scope as written by a shadow path.
    Re-entrant."""
    _SHADOW[0] += 1
    try:
        yield
    finally:
        _SHADOW[0] -= 1


def in_shadow_scope() -> bool:
    return bool(_SHADOW[0])


# --- the decision clock -----------------------------------------------------

class _ClockFeed:
    """Hands back a recorded serve's clock reads in order. Running out
    means the replayed control flow read the clock more often than the
    recorded one: a divergence, reported as such."""

    def __init__(self, values: Sequence[float]):
        self._vals = list(values)
        self._i = 0

    def next(self) -> float:
        if self._i >= len(self._vals):
            raise JournalError(
                f"clock feed exhausted after {self._i} reads — the "
                f"replayed serve's control flow diverged from the "
                f"recorded one")
        v = self._vals[self._i]
        self._i += 1
        return v

    @property
    def remaining(self) -> int:
        return len(self._vals) - self._i


def now() -> float:
    """The decision clock. Every clock read that can steer a serving
    decision (arrival due-ness, deadline shedding, segment stamps) comes
    here instead of ``time.perf_counter()``:

    * no journal and no feed: ``perf_counter()``;
    * a journal attached: the read is also journaled as a ``clock``
      record;
    * a feed active (``feed_clock``): the next fed value is returned (and
      journaled, if a journal is attached), whatever the wall clock says.
    """
    feed = _FEED[0]
    if feed is not None:
        v = feed.next()
    else:
        v = time.perf_counter()
    j = _ACTIVE[0]
    if j is not None:
        j.record("clock", c=v)
    return v


def sleep(seconds: float) -> None:
    """An idle wait that a fed clock skips (its time base is the feed)."""
    if _FEED[0] is None:
        time.sleep(seconds)


@contextlib.contextmanager
def feed_clock(values: Sequence[float]):
    """Scope a fed clock: ``now()`` returns ``values`` in order."""
    if _FEED[0] is not None:
        raise JournalError("a clock feed is already active")
    feed = _ClockFeed(values)
    _FEED[0] = feed
    try:
        yield feed
    finally:
        _FEED[0] = None


# --- readers ----------------------------------------------------------------

def _read_file(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)      # raises: the caller skips the file
            v = rec.get("v", 0)
            if v > SCHEMA_VERSION:
                raise JournalError(
                    f"{os.path.basename(path)}:{ln} is schema v{v}; "
                    f"this reader understands <= v{SCHEMA_VERSION}")
            out.append(rec)
    return out


def read_journal(path: str) -> dict:
    """Read one file, or merge a directory's rank files, into one ordered
    record stream. A truncated or corrupt file is skipped and flagged
    (``journal.merge_skipped_files``, a ``journal_merge_skipped`` flight
    event, ``"skipped_files"``); only when no file reads does it raise.
    Records order by ``gseq`` when they come from one process, else by
    ``(t, rank, seq)``."""
    from . import flight as _flight
    from . import metrics as _metrics

    if os.path.isfile(path):
        paths = [path]
    else:
        paths = sorted(glob.glob(os.path.join(path, "journal_rank*.jsonl"))
                       + glob.glob(os.path.join(path,
                                                "journal_rank*.jsonl.*")))
        if not paths:
            raise FileNotFoundError(f"no journal_rank*.jsonl under {path}")
    records: List[dict] = []
    skipped: List[str] = []
    for p in paths:
        try:
            records.extend(_read_file(p))
        except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
            skipped.append(os.path.basename(p))
            _metrics.counter("journal.merge_skipped_files",
                             "journal rank files skipped as truncated/"
                             "corrupt").inc()
            _flight.record("journal_merge_skipped",
                           file=os.path.basename(p),
                           error=f"{type(e).__name__}: {e}")
    if not records:
        raise FileNotFoundError(
            f"no readable journal file under {path} "
            f"({len(skipped)} skipped as corrupt)")
    same_proc = len({r.get("gseq") for r in records}) == len(records)
    records.sort(key=(lambda r: r["gseq"]) if same_proc
                 else (lambda r: (r["t"], r["rank"], r["seq"])))
    out = {"records": records,
           "ranks": sorted({r["rank"] for r in records})}
    if skipped:
        out["skipped_files"] = skipped
    return out


def merge_journal_dir(log_dir: str) -> dict:
    """``read_journal`` of a directory (named like
    ``metrics.merge_log_dir``)."""
    return read_journal(log_dir)


def sections(records: Sequence[dict]) -> List[dict]:
    """Split a record stream at each header: ``[{"header": ...,
    "records": [...]}, ...]``. Records before the first header form a
    headerless section only when there is no header at all."""
    out: List[dict] = []
    cur: Optional[dict] = None
    pre: List[dict] = []
    for r in records:
        if r["kind"] == "header":
            cur = {"header": r["header"], "records": []}
            out.append(cur)
        elif cur is not None:
            cur["records"].append(r)
        else:
            pre.append(r)
    if pre and not out:
        out.append({"header": None, "records": pre})
    return out


def request_journey(records: Sequence[dict], rid: int) -> dict:
    """One request's timeline: every record carrying its rid, in journal
    order (which is causal order: one serve loop wrote them as it
    decided)."""
    evs = [r for r in records if r.get("rid") == rid]
    return {"rid": rid, "events": evs, **journey_summary(evs)}


def journey_summary(evs: Sequence[dict]) -> dict:
    kinds = [e["kind"] for e in evs]
    replicas: List[int] = []
    for e in evs:
        tgt = e.get("replica", e.get("dst", e["rank"]))
        if not replicas or replicas[-1] != tgt:
            if e["kind"] in ("dispatch", "fleet_dispatch",
                             "failover_requeue", "admit", "handoff"):
                replicas.append(tgt)
    fin = next((e for e in evs if e["kind"] == "finish"), None)
    shadow = next((e for e in evs if e["kind"] == "shadow_finish"), None)
    return {
        "kinds": kinds,
        "replicas": replicas,
        "shadow_pair": any(e["kind"] in ("shadow_mirror", "shadow_finish")
                           for e in evs),
        "shadow_match": (shadow or {}).get("match"),
        "dispatch_reason": next((e.get("reason") for e in evs
                                 if e["kind"] in ("dispatch",
                                                  "fleet_dispatch")), None),
        "admits": kinds.count("admit"),
        "preemptions": kinds.count("preempt"),
        "requeues": kinds.count("failover_requeue"),
        "shed": "shed" in kinds or "shed_decision" in kinds,
        "finished": fin is not None,
        "n_tokens": (fin or {}).get("n_tokens"),
    }


# --- header helpers ---------------------------------------------------------

def describe_config(cfg) -> dict:
    """A ``LlamaConfig`` as JSON (its dtype by name: ``"float32"``)."""
    d = dataclasses.asdict(cfg)
    d["dtype"] = str(cfg.dtype).replace("torch.", "")
    return d


def describe_engine(engine) -> dict:
    """What ``ServingEngine.__init__`` needs to rebuild ``engine``, plus
    the mutable state a serve starts from (the next rid, the acceptance
    EWMA)."""
    samp = None
    if engine.sampling is not None:
        t, k, p = engine.sampling
        samp = {"temperature": t, "top_k": k, "top_p": p}
    return {
        "slots": engine.slots, "max_len": engine.max_len,
        "chunk": engine.chunk, "prompt_buckets": list(engine.buckets),
        "eos_token_id": engine.eos, "paged": engine.paged,
        "page_size": engine.page_size if engine.paged else None,
        "num_pages": engine.pager.num_pages if engine.paged else None,
        "chunked_prefill": engine.chunked,
        "prefill_chunks": list(engine.prefill_chunks),
        "speculative": engine.speculative, "sampling": samp,
        "sample_seed": engine.sample_seed, "mesh": None,
        "quality_digest": engine.quality_digest,
        "digest_top_k": engine.digest_top_k,
        "quant": engine.quant,
        "seq_parallel": engine.seq_parallel,
        "long_buckets": list(engine.long_buckets),
        "next_rid": engine._next_rid,
        "spec_accept_ewma": engine.spec_accept_ewma,
    }


def describe_prefix_cache(pc) -> Optional[dict]:
    if pc is None:
        return None
    if hasattr(pc, "pager"):                    # PagedPrefixCache
        d = {"kind": "paged", "block": pc.block,
             "capacity_pages": pc.capacity_pages}
        tier = getattr(pc, "host_tier", None)
        if tier is not None:
            # the host tier decides (restore on a hit, spill instead of
            # drop), so its capacity is part of the rebuild
            d["host_tier_pages"] = tier.capacity_pages
        return d
    return {"kind": "rows", "block": pc.block,
            "capacity_tokens": pc.capacity_tokens}


def describe_envelope(env) -> Optional[dict]:
    """A ``WorkloadEnvelope`` as JSON: a pool's envelope fixes which keys
    its replicas warm, so a disaggregated header records one per pool."""
    if env is None:
        return None
    return {"max_prompt": env.max_prompt,
            "max_new_tokens": env.max_new_tokens,
            "seg_steps": list(env.seg_steps),
            "n_pads": list(env.n_pads),
            "resume": env.resume,
            "prefix_block": env.prefix_block,
            "offline_batch": env.offline_batch}


def describe_arrivals(arrivals) -> List[dict]:
    return [{"at": a.t, "prompt": np.asarray(a.prompt).tolist(),
             "gen": int(a.max_new_tokens),
             "priority": int(getattr(a, "priority", 0)),
             "deadline_s": getattr(a, "deadline_s", None)}
            for a in arrivals]
