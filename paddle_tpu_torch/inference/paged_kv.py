"""Paged KV cache: a page-table allocator with copy-on-write prefix sharing.

Port of ``paddle_tpu/inference/paged_kv.py``. KV rows live in one flat
pool of fixed-size pages, ``[L, num_pages, page_size, Hkv, D]``, and each
slot's sequence is the ordered list of pages its row of the
``[slots, max_pages]`` int32 page table names:

* a slot holds ``ceil(rows / page_size)`` pages, reserved at admission from
  the request's known bound (prompt + max_new_tokens), so the pool can be
  sized to the live token load rather than ``slots * max_len``;
* a prefix-cache hit maps the same physical pages into the new slot's
  table (one refcount bump per page, no KV row copied); ``ensure_writable``
  copies a shared page for the paths that write history;
* retiring a request releases its page references; pages still referenced
  elsewhere (the prefix cache, a sharing slot) survive.

Allocation and refcounts are host-side (a Python free list and a numpy
refcount array); the pool and the page table are tensors on the engine's
device. Page 0 is the reserved trash page: dead slots' writes and
table-tail lookups land there (``llama.forward_with_pages``), so a frozen
slot never writes a page the allocator handed to someone else.

A quantized pool (``quant="int8"`` or ``"fp8"``) holds narrow pages plus
the per-row scale planes ``ks``/``vs``; every page-granular operation
(copy-on-write, the trash page) treats all planes alike.

Every allocator change and every page operation reports through the
metrics registry and the flight recorder (host ints only); meshes are
out of this port so far (``mesh`` raises).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from ..observability import flight as _flight
from ..observability import metrics as _metrics

__all__ = ["PageAllocator", "PagedKVCache", "POOL_HOOKS"]

# Process-wide pool observers: ``fn(event, n, allocator)`` after every
# allocator state change ("alloc" / "retain" / "release"; "cache_retain" /
# "cache_release" forwarded by PagedPrefixCache; "tier_stage" /
# "tier_spill" / "tier_restore" / "tier_import" from the host tier). Host
# ints and the allocator object only, so a hook never touches the device.
# ``observability.capacity.PoolMonitor`` subscribes here.
POOL_HOOKS: List = []


def _notify(event: str, n: int, alloc) -> None:
    if POOL_HOOKS:
        for fn in POOL_HOOKS:
            fn(event, n, alloc)


class PageAllocator:
    """Fixed-size-page free list with per-page refcounts.

    Page 0 is reserved (never allocated, never freed). ``alloc`` hands out
    pages at refcount 1; ``retain`` bumps (the COW share); ``release``
    drops and returns a page to the free list when its last reference
    dies. ``check`` audits the free-list/refcount invariant."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"need >= 2 pages (1 is the reserved trash "
                             f"page), got {num_pages}")
        self.num_pages = int(num_pages)
        # LIFO free list: the most recently freed page is reused first
        self._free: List[int] = list(range(self.num_pages - 1, 0, -1))
        self._ref = np.zeros(self.num_pages, np.int32)
        self.total_allocated = 0   # pages handed out since the last reset

    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def ref(self, page: int) -> int:
        return int(self._ref[page])

    def alloc(self, n: int) -> List[int]:
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: need {n}, free {len(self._free)} "
                f"(admission must gate on pages_free)")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        if n:
            self.total_allocated += n
            _metrics.counter("serving.pages.allocated").inc(n)
            _notify("alloc", n, self)
        return pages

    def retain(self, pages: Sequence[int]) -> None:
        """Share ``pages``: one ref bump each (a prefix hit is this call)."""
        for p in pages:
            if p == 0 or self._ref[p] <= 0:
                raise RuntimeError(f"retain of unallocated page {p}")
            self._ref[p] += 1
        if len(pages):
            _metrics.counter("serving.pages.cow_shares").inc(len(pages))
            _notify("retain", len(pages), self)

    def release(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free list. Returns how many pages freed."""
        freed = 0
        for p in pages:
            if p == 0 or self._ref[p] <= 0:
                raise RuntimeError(f"release of unallocated page {p} "
                                   f"(double free?)")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._free.append(p)
                freed += 1
        if freed:
            _metrics.counter("serving.pages.freed").inc(freed)
        if len(pages):
            _notify("release", len(pages), self)
        return freed

    def check(self) -> List[str]:
        """Invariant audit: every page is either free (ref 0, on the list
        exactly once) or held (ref > 0, not on the list)."""
        bad = []
        free_set = set(self._free)
        if len(free_set) != len(self._free):
            bad.append("free list holds duplicates")
        if 0 in free_set:
            bad.append("trash page 0 on the free list")
        for p in range(1, self.num_pages):
            r = int(self._ref[p])
            if r < 0:
                bad.append(f"page {p} refcount {r} < 0")
            if r == 0 and p not in free_set:
                bad.append(f"page {p} leaked (ref 0, not free)")
            if r > 0 and p in free_set:
                bad.append(f"page {p} double-booked (ref {r}, on free "
                           f"list)")
        return bad


class PagedKVCache:
    """Device page pool + per-slot page tables over a ``PageAllocator``.

    ``pool`` is the flat ``{"k", "v"}`` ``[L, num_pages, page_size, Hkv,
    D]`` store and ``page_table`` the ``[slots, max_pages]`` int32 map the
    segment loop reads, both on ``device`` and updated in place;
    ``slot_pages`` is the host mirror. ``max_pages`` bounds one slot's
    virtual length (``max_pages * page_size`` is the engine's max_len);
    ``num_pages`` bounds the pool. ``quant`` ('int8' | 'fp8') makes the
    pool narrow with ``ks``/``vs`` row-scale planes
    (``llama.init_paged_pool``)."""

    def __init__(self, cfg, slots: int, page_size: int, num_pages: int,
                 max_pages: int, device, dtype=None, mesh=None, quant=None):
        if mesh is not None:
            raise NotImplementedError("meshes are not ported yet")
        from ..models import llama

        self.cfg = cfg
        self.slots = int(slots)
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_pages = int(max_pages)
        self.device = torch.device(device)
        self.allocator = PageAllocator(self.num_pages)
        self.pool = llama.init_paged_pool(cfg, self.num_pages,
                                          self.page_size, self.device,
                                          dtype=dtype, quant=quant)
        self.page_table = torch.zeros((self.slots, self.max_pages),
                                      dtype=torch.int32, device=self.device)
        self.slot_pages: List[List[int]] = [[] for _ in range(self.slots)]
        self.cow_breaks = 0
        self.peak_occupancy = 0.0

    # --- sizing -----------------------------------------------------------
    def pages_needed(self, rows: int) -> int:
        return -(-int(rows) // self.page_size)

    @property
    def pages_free(self) -> int:
        return self.allocator.pages_free

    def occupancy(self) -> float:
        return self.allocator.pages_used / max(1, self.num_pages - 1)

    def _gauges(self) -> None:
        occ = self.occupancy()
        self.peak_occupancy = max(self.peak_occupancy, occ)
        _metrics.gauge("serving.pages_free").set(self.allocator.pages_free)
        _metrics.gauge("serving.page_occupancy").set(occ)

    def _table_row(self, pages: Sequence[int]) -> np.ndarray:
        row = np.zeros((self.max_pages,), np.int32)
        row[:len(pages)] = pages
        return row

    # --- admission-side page management -----------------------------------
    def reserve(self, rows: int, shared: Sequence[int] = ()):
        """Reserve pages for a request spanning ``rows`` KV rows, the first
        ``len(shared) * page_size`` of which ride the given allocated pages
        (ref-bumped: the COW prefix share). Returns (pages, table_row): the
        virtual-order page list and its int32 ``[max_pages]`` table row.
        Raises if the pool cannot supply; callers gate on ``pages_free``."""
        total = self.pages_needed(rows)
        shared = list(shared)
        if len(shared) > total:
            raise ValueError(f"{len(shared)} shared pages exceed the "
                             f"{total} the request spans")
        if total > self.max_pages:
            raise ValueError(f"request spans {total} pages > max_pages "
                             f"{self.max_pages}")
        self.allocator.retain(shared)
        try:
            fresh = self.allocator.alloc(total - len(shared))
        except RuntimeError:
            self.allocator.release(shared)
            raise
        pages = shared + fresh
        _flight.record("page_alloc", pages=len(fresh), shared=len(shared),
                       free=self.allocator.pages_free)
        self._gauges()
        return pages, self._table_row(pages)

    def install(self, slot: int, pages: List[int]) -> None:
        """Bind a reserved page list to a slot (host mirror only: the
        segment loop writes the device table row at the admit)."""
        self.slot_pages[slot] = list(pages)

    def free_slot(self, slot: int) -> int:
        """Retire a slot: release its page refs. Returns pages freed."""
        pages, self.slot_pages[slot] = self.slot_pages[slot], []
        freed = self.allocator.release(pages)
        self._gauges()
        return freed

    def release_pages(self, pages: Sequence[int]) -> int:
        """Undo a reservation that never reached a slot."""
        freed = self.allocator.release(pages)
        self._gauges()
        return freed

    # --- copy-on-write ----------------------------------------------------
    def fork_slot(self, src: int, dst: int) -> None:
        """Map ``src``'s pages into empty slot ``dst`` (ref bumps, no
        copies): the share half of COW."""
        if self.slot_pages[dst]:
            raise RuntimeError(f"fork into occupied slot {dst}")
        pages = list(self.slot_pages[src])
        self.allocator.retain(pages)
        self.slot_pages[dst] = pages
        self.page_table[dst] = torch.from_numpy(self._table_row(pages)).to(
            self.device)

    def ensure_writable(self, slot: int, vpage: int) -> int:
        """Break-on-write: if ``slot``'s virtual page ``vpage`` is shared
        (ref > 1), copy its rows into a fresh private page and repoint the
        table, the one place paging copies KV rows (and, in a quantized
        pool, their scales: every plane is copied). Returns the (possibly
        new) physical page id."""
        page = self.slot_pages[slot][vpage]
        if self.allocator.ref(page) <= 1:
            return page
        new = self.allocator.alloc(1)[0]
        for plane in self.pool.values():
            plane[:, new] = plane[:, page]
        self.allocator.release([page])
        self.slot_pages[slot][vpage] = new
        self.page_table[slot, vpage] = new
        self.cow_breaks += 1
        _metrics.counter("serving.pages.cow_breaks").inc()
        _flight.record("cow_break", slot=slot, vpage=vpage,
                       shared_page=page, private_page=new)
        self._gauges()
        return new

    # --- lifecycle --------------------------------------------------------
    def reset(self) -> None:
        """Free every slot's pages and zero the table (pool rows stay:
        table and refcounts make stale rows unreachable)."""
        for s in range(self.slots):
            if self.slot_pages[s]:
                self.allocator.release(self.slot_pages[s])
                self.slot_pages[s] = []
        self.page_table.zero_()
        self.peak_occupancy = 0.0
        self.allocator.total_allocated = 0
        self._gauges()  # pages another holder keeps (a prefix cache)

    def leak_report(self, expected_held: int = 0) -> List[str]:
        """Allocator invariant plus the 'everything returned' audit: with
        no live slots and ``expected_held`` pages referenced elsewhere (the
        prefix cache), every other page must be free."""
        bad = self.allocator.check()
        held = self.allocator.pages_used
        if held != expected_held:
            bad.append(f"{held} pages held, expected {expected_held}")
        return bad

    def stats(self) -> Dict[str, float]:
        return {"num_pages": self.num_pages - 1,  # usable (sans trash)
                "page_size": self.page_size,
                "pages_free": self.allocator.pages_free,
                "pages_used": self.allocator.pages_used,
                "occupancy": round(self.occupancy(), 4),
                "peak_occupancy": round(self.peak_occupancy, 4),
                "cow_breaks": self.cow_breaks}
