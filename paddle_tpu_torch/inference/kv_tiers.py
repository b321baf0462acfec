"""Tiered KV memory: the host-RAM spill tier behind the paged prefix cache.

Port of ``paddle_tpu/inference/kv_tiers.py``. The page pool bounds the
prefix cache's working set: without a tier, a cold prefix evicted under
page pressure is gone and its tenant's next request prefills it again.
The tier keeps such pages in pinned host memory and brings them back on
a hit, so the cache holds as many prefixes as host RAM allows, at the
price of an H2D copy instead of a prefill. The contract, in stream order:

* **Stage** (write-through, at insert): the entry's pages are gathered on
  the device (``pool[name][:, idx]`` for every plane) and copied with
  ``non_blocking=True`` into host buffers taken from PyTorch's caching
  host allocator (``pin_memory=True``: a non-blocking copy into pageable
  memory would be synchronous). Nothing waits. The bytes are valid once
  the stream has passed the copy, which the engine's next counted fetch
  guarantees: ``complete()`` runs in ``finish_segment`` after that fetch,
  and only then does ``has(key)`` hold, so spill decisions fall on the
  same segments as the JAX engine's. A stage still pending when its entry
  is dropped is cancelled.
* **Spill** is metadata only: a staged ("clean") entry's pool pages are
  released; the host copy is the data.
* **Restore**: fresh pages are reserved and the host rows written into
  them in place (``index_copy_`` along the page axis, from a non-blocking
  H2D copy of pinned memory) before the segment's first forward, which
  the stream orders after the copy. Each upload's host sources stay
  referenced until the engine's next counted fetch, so no pinned buffer
  is reused under an H2D copy in flight.
* A quantized pool's ``ks``/``vs`` scale planes (``[L, P, page_size]``
  fp32) travel with their pages: every movement carries every plane, and
  axis 1 is the page axis in all of them.

bf16 and fp8 have no numpy dtype, so the host store holds CPU tensors;
one-byte float planes are gathered and copied through ``torch.uint8``
views (the same bits). ``flush()`` and ``flush_tiers()`` are the only
calls here that wait on the device, once each, for teardown and migration
outside the serve loop; each counts itself in ``flushes``.

Every movement emits a ``tier_transfer`` flight event (direction stage |
spill | restore | import) with page and byte counts and a ``tier_*`` event
on ``paged_kv.POOL_HOOKS``; restores are billed to the admitted request
(``Request.tier_pages`` / ``tier_bytes``).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import metrics as _metrics

__all__ = ["HostTier", "TierMeter", "page_bytes", "flush_tiers",
           "install", "uninstall"]

_ONE_BYTE_FLOATS = tuple(getattr(torch, n) for n in (
    "float8_e4m3fn", "float8_e5m2") if hasattr(torch, n))


def _raw(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as a type every gather and ``index_copy_`` kernel
    takes: one-byte floats as ``uint8``, everything else as is."""
    return t.view(torch.uint8) if t.dtype in _ONE_BYTE_FLOATS else t


def page_bytes(pager) -> int:
    """Bytes one pool page holds across every pool plane (K and V, plus a
    quantized pool's scale planes): the tier's unit of transfer, from the
    live pool tensors, so a narrow pool is priced at its true size."""
    return sum(int(a.shape[0] * np.prod(tuple(a.shape[2:])))
               * a.element_size() for a in pager.pool.values())


class HostTier:
    """Pinned host-RAM store of spilled prefix-cache pages, one per
    ``PagedPrefixCache`` (host bytes belong to the cache that staged
    them; moving them to another cache is an explicit ``get`` /
    ``note_import``). ``capacity_pages`` bounds host residency; the least
    recently used entries drop past it."""

    def __init__(self, pager, capacity_pages: int = 4096):
        if capacity_pages < 1:
            raise ValueError(f"capacity_pages must be >= 1, got "
                             f"{capacity_pages}")
        self.pager = pager
        self.capacity_pages = int(capacity_pages)
        # key -> {<plane>: CPU tensor [L, n, ...] per pool plane, "pages":
        # n, "at": perf_counter}, least recently used first
        self._host: "OrderedDict[bytes, dict]" = OrderedDict()
        # queued stages: [key, n_pages, *per-plane host tensors, their
        # D2H copies issued and not yet known complete]
        self._pending: List[list] = []
        # host sources of the H2D copies issued since the last counted
        # fetch (kept alive until the stream has passed them)
        self._uploads: List[list] = []
        self.pages_host = 0           # host-resident staged pages
        self.stages = 0               # D2H copies completed
        self.spills = 0               # page sets released to the host tier
        self.restores = 0             # host -> fresh pool page uploads
        self.imports = 0              # entries imported from another tier
        self.host_evictions = 0       # host-capacity LRU drops
        self.flushes = 0              # waits on the device (flush only)
        self.bytes_to_host = 0
        self.bytes_to_hbm = 0
        self.bytes_imported = 0

    # --- sizing -----------------------------------------------------------
    def page_bytes(self) -> int:
        return page_bytes(self.pager)

    def planes(self) -> tuple:
        """Pool plane names in pool order: ("k", "v"), plus ("ks", "vs")
        on a quantized pool. A page moves with all of them or not at
        all."""
        return tuple(self.pager.pool)

    def has(self, key: bytes) -> bool:
        return key in self._host

    def prewarm_transfers(self, max_pages: int) -> None:
        """Kept for callers of the JAX tier, which compiles its transfer
        programs here. The port compiles nothing (the gathers and copies
        are eager kernels), so this does nothing and leaves the pool as
        it is."""

    # --- device plumbing --------------------------------------------------
    def _index(self, pages: List[int]) -> torch.Tensor:
        """``pages`` as an int64 index on the pool's device, without
        waiting: a non-blocking copy from pinned memory on a card."""
        idx = torch.tensor(pages, dtype=torch.int64)
        if self.pager.device.type == "cuda":
            idx = idx.pin_memory().to(self.pager.device, non_blocking=True)
        return idx

    def _to_host(self, g: torch.Tensor) -> torch.Tensor:
        """A host tensor that will hold device tensor ``g``'s bytes once
        the stream passes the copy issued here (pinned, non-blocking); on
        the CPU ``g`` itself, a fresh gather."""
        if g.device.type == "cpu":
            return g
        host = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
        host.copy_(g, non_blocking=True)
        return host

    def host_copy(self, a) -> torch.Tensor:
        """A host tensor this tier owns with ``a``'s bytes (a host tensor
        or numpy array): pinned when the pool lives on a card."""
        t = torch.from_numpy(np.ascontiguousarray(a)) \
            if isinstance(a, np.ndarray) else a
        out = torch.empty(t.shape, dtype=t.dtype,
                          pin_memory=self.pager.device.type == "cuda")
        _raw(out).copy_(_raw(t))
        return out

    # --- D2H staging (write-through; lands at the next counted fetch) ----
    def stage(self, key: bytes, pages: List[int]) -> None:
        """Issue the D2H copy of ``pages``'s rows in every plane. Nothing
        waits: the copies land by the engine's next counted fetch, where
        ``complete`` files them. Idempotent per key."""
        if key in self._host or any(p[0] == key for p in self._pending):
            return
        idx = self._index(pages)
        hosts = []
        for a in self.pager.pool.values():
            h = self._to_host(_raw(a)[:, idx])
            hosts.append(h.view(a.dtype) if h.dtype != a.dtype else h)
        self._pending.append([key, len(pages)] + hosts)

    def cancel(self, key: bytes) -> None:
        """Forget a queued stage whose entry was dropped before it
        landed."""
        self._pending = [p for p in self._pending if p[0] != key]

    def take_pending(self) -> List[list]:
        """Hand the queued stages to the engine's segment finish."""
        out, self._pending = self._pending, []
        return out

    def complete(self, staged: List[list]) -> None:
        """File stages whose copies the stream has passed (the caller's
        counted fetch, or ``flush``'s wait, made sure of it), and drop the
        references kept for uploads issued before that point."""
        self._uploads = []
        pb = self.page_bytes()
        names = self.planes()
        for st in staged:
            key, n = st[0], st[1]
            self._put(key, dict(zip(names, st[2:])), n)
            self.stages += 1
            self.bytes_to_host += n * pb
            _metrics.counter("serving.tier.stages").inc()
            _metrics.counter("serving.tier.bytes_to_host").inc(n * pb)
            from .paged_kv import _notify as _pool_notify

            _pool_notify("tier_stage", n, self.pager.allocator)
            _flight.record("tier_transfer", direction="stage", pages=n,
                           bytes=n * pb)

    def flush(self) -> None:
        """Land the queued stages now, with one wait on the device, for
        drains and teardown outside the serve loop (the loop itself lands
        them at its counted fetch)."""
        flush_tiers([self])

    # --- host store -------------------------------------------------------
    def _put(self, key: bytes, planes: Dict[str, torch.Tensor],
             n: int) -> None:
        old = self._host.pop(key, None)
        if old is not None:
            self.pages_host -= old["pages"]
        self._host[key] = {**planes, "pages": int(n),
                           "at": time.perf_counter()}
        self.pages_host += int(n)
        while self.pages_host > self.capacity_pages and len(self._host) > 1:
            _, dropped = self._host.popitem(last=False)
            self.pages_host -= dropped["pages"]
            self.host_evictions += 1
            _metrics.counter("serving.tier.host_evictions").inc()
        _metrics.gauge("serving.tier.pages_host").set(self.pages_host)

    def get(self, key: bytes) -> Optional[dict]:
        ent = self._host.get(key)
        if ent is not None:
            self._host.move_to_end(key)
        return ent

    def drop(self, key: bytes) -> None:
        self.cancel(key)
        ent = self._host.pop(key, None)
        if ent is not None:
            self.pages_host -= ent["pages"]
            _metrics.gauge("serving.tier.pages_host").set(self.pages_host)

    # --- spill / restore / import accounting ------------------------------
    def note_spill(self, n_pages: int) -> None:
        """A clean entry's pool pages released (the bytes live here)."""
        self.spills += 1
        _metrics.counter("serving.tier.spills").inc()
        _metrics.counter("serving.tier.pages_spilled").inc(n_pages)
        from .paged_kv import _notify as _pool_notify

        _pool_notify("tier_spill", n_pages, self.pager.allocator)
        _flight.record("tier_transfer", direction="spill", pages=n_pages,
                       bytes=0)

    def upload(self, pages: List[int],
               planes: Dict[str, torch.Tensor]) -> None:
        """Write host rows into freshly reserved pool pages in place: per
        plane a non-blocking H2D copy of pinned memory, then an
        ``index_copy_`` along the page axis, both in stream order before
        the segment that reads them. Nothing waits; the sources stay
        referenced until the engine's next counted fetch."""
        idx = self._index(pages)
        pool = self.pager.pool
        dev = self.pager.device
        srcs = []
        for p in pool:
            srcs.append(planes[p])
            src = _raw(planes[p])
            if dev.type == "cuda":
                src = src.to(dev, non_blocking=True)
            _raw(pool[p]).index_copy_(1, idx, src)
        self._uploads.append(srcs)
        n = len(pages)
        pb = self.page_bytes()
        self.restores += 1
        self.bytes_to_hbm += n * pb
        _metrics.counter("serving.tier.restores").inc()
        _metrics.counter("serving.tier.bytes_to_hbm").inc(n * pb)
        from .paged_kv import _notify as _pool_notify

        _pool_notify("tier_restore", n, self.pager.allocator)
        _flight.record("tier_transfer", direction="restore", pages=n,
                       bytes=n * pb)

    def note_import(self, key: bytes, planes: Dict[str, object],
                    n: int) -> None:
        """File an entry imported from another tier, as copies this tier
        owns (the source's reset can never invalidate them)."""
        self._put(key, {p: self.host_copy(a) for p, a in planes.items()},
                  n)
        pb = self.page_bytes()
        self.imports += 1
        self.bytes_imported += n * pb
        _metrics.counter("serving.tier.imports").inc()
        _metrics.counter("serving.tier.bytes_imported").inc(n * pb)
        from .paged_kv import _notify as _pool_notify

        _pool_notify("tier_import", n, self.pager.allocator)
        _flight.record("tier_transfer", direction="import", pages=n,
                       bytes=n * pb)

    # --- lifecycle / stats ------------------------------------------------
    def reset(self) -> None:
        """Drop all host state and zero the counters (warm-run
        isolation, with ``PagedPrefixCache.reset``). Uploads issued and
        not yet past a counted fetch keep their sources."""
        self._host.clear()
        self._pending = []
        self.pages_host = 0
        self.stages = self.spills = self.restores = self.imports = 0
        self.host_evictions = 0
        self.flushes = 0
        self.bytes_to_host = self.bytes_to_hbm = self.bytes_imported = 0

    def stats(self) -> dict:
        return {"capacity_pages": self.capacity_pages,
                "pages_host": self.pages_host,
                "entries_host": len(self._host),
                "pending_stages": len(self._pending),
                "stages": self.stages,
                "spills": self.spills,
                "restores": self.restores,
                "imports": self.imports,
                "host_evictions": self.host_evictions,
                "flushes": self.flushes,
                "bytes_to_host": self.bytes_to_host,
                "bytes_to_hbm": self.bytes_to_hbm,
                "bytes_imported": self.bytes_imported,
                "page_bytes": self.page_bytes()}


def flush_tiers(tiers) -> int:
    """Land the queued stages of several tiers with one wait on the
    device (per device), instead of one a tier. Each tier still files its
    own bytes and counts. Returns the number of tiers that had stages (0:
    nothing waited)."""
    work = []
    for t in tiers:
        staged = t.take_pending()
        if staged:
            work.append((t, staged))
    waited = set()
    for t, _ in work:
        dev = t.pager.device
        t.flushes += 1
        if dev.type == "cuda" and dev not in waited:
            waited.add(dev)
            torch.cuda.current_stream(dev).synchronize()
    for t, staged in work:
        t.complete(staged)
    return len(work)


# ---------------------------------------------------------------------------
# Ambient attachment: a pure observer on POOL_HOOKS + SEGMENT_HOOKS that
# counts tier traffic next to segments (host ints only).
# ---------------------------------------------------------------------------


class TierMeter:
    """Process-wide tier-traffic observer: counts ``tier_*`` pool events
    (and their pages) and engine segments."""

    def __init__(self):
        self.segments = 0
        self.events: Dict[str, int] = {}
        self.pages: Dict[str, int] = {}

    def on_pool(self, event: str, n: int, alloc) -> None:
        if event.startswith("tier_"):
            self.events[event] = self.events.get(event, 0) + 1
            self.pages[event] = self.pages.get(event, 0) + int(n)

    def on_segment(self, steps: int, new_tokens: int,
                   finished: int) -> None:
        self.segments += 1


_INSTALLED: List[tuple] = []


def install(meter: TierMeter) -> None:
    from . import paged_kv as _pk
    from . import serving as _serving

    for m, _, _ in _INSTALLED:
        if m is meter:
            return
    ph, sh = meter.on_pool, meter.on_segment
    _pk.POOL_HOOKS.append(ph)
    _serving.SEGMENT_HOOKS.append(sh)
    _INSTALLED.append((meter, ph, sh))


def uninstall(meter: Optional[TierMeter] = None) -> None:
    from . import paged_kv as _pk
    from . import serving as _serving

    keep = []
    for m, ph, sh in _INSTALLED:
        if meter is None or m is meter:
            if ph in _pk.POOL_HOOKS:
                _pk.POOL_HOOKS.remove(ph)
            if sh in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(sh)
        else:
            keep.append((m, ph, sh))
    _INSTALLED[:] = keep
