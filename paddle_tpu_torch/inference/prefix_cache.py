"""Shared-prefix KV cache over the paged pool: a hit is a page-ref bump.

Port of ``PagedPrefixCache`` in ``paddle_tpu/inference/prefix_cache.py``.
Entries hold page ids, not KV rows: ``insert`` retains the admitted
request's prompt pages (harvest by reference: the slot and the cache
share the physical pages), and a hit hands the same page ids to the next
request's reservation, which retains them again. No KV row is copied on
the hit path.

Granularity is the page: a match covers whole pages, and the suffix a
request prefills starts at the page boundary after its hit, so no sharer
ever writes a shared page. Matching is exact-token over a flat LRU of
entries; capacity is bounded in pages held, and eviction releases page
refs (a page shared with a live slot frees only when that slot retires).
``evict_until`` is the pressure valve: admission reclaims cache-held
pages before it defers a request.

Out of this port so far: the host tier (``host_tier`` raises; ``restore``,
``export_host`` and ``import_host`` wait for it), the listeners, metrics
and flight-recorder calls, and the row-copy ``PrefixCache`` of the
contiguous segment engine.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .paged_kv import _notify as _pool_notify

__all__ = ["PagedPrefixCache", "PagedPrefixMatch"]


@dataclass
class _PagedEntry:
    tokens: np.ndarray   # [n] int32, n a multiple of page_size
    pages: list          # physical page ids


@dataclass
class PagedPrefixMatch:
    length: int          # reusable rows (page multiple, < len(prompt))
    pages: list          # the physical pages holding those rows


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return n if len(neq) == 0 else int(neq[0])


class PagedPrefixCache:
    """Prefix cache of page ids over one engine's ``PagedKVCache``."""

    def __init__(self, pager, capacity_pages: int = 512, host_tier=None):
        if host_tier is not None:
            raise NotImplementedError("the host tier is not ported yet")
        self.pager = pager
        self.block = pager.page_size      # alignment rule = the page
        self.capacity_pages = int(capacity_pages)
        self._entries: "OrderedDict[bytes, _PagedEntry]" = OrderedDict()
        self._pages_held = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0

    def round_down(self, n: int) -> int:
        return (int(n) // self.block) * self.block

    # --- lookup -----------------------------------------------------------
    def match(self, prompt) -> Optional[PagedPrefixMatch]:
        """Longest whole-page common prefix between ``prompt`` and any
        entry, strict (at least one token must remain to prefill).
        Returns page ids without retaining them: the reservation takes
        the refs, so a deferred admission leaves no dangling count."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        cap = self.round_down(len(prompt))
        if cap == len(prompt):
            cap -= self.block
        best_l, best_key = 0, None
        if cap > 0:
            for key, ent in self._entries.items():
                m = self.round_down(min(_common_prefix(prompt, ent.tokens),
                                        cap))
                if m > best_l:
                    best_l, best_key = m, key
        if best_key is None:
            self.misses += 1
            return None
        ent = self._entries[best_key]
        self._entries.move_to_end(best_key)
        self.hits += 1
        self.hit_tokens += best_l
        return PagedPrefixMatch(best_l, ent.pages[:best_l // self.block])

    # --- population -------------------------------------------------------
    def insert(self, tokens, pages) -> None:
        """Insert the prefix ``tokens`` held by the given live pages (one
        per ``page_size`` tokens). The cache retains them. An entry that
        already covers the tokens makes this a no-op; entries the new
        one extends are dropped."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = len(tokens)
        if n % self.block or n == 0:
            raise ValueError(
                f"prefix length {n} is not a positive multiple of "
                f"page_size {self.block}")
        if len(pages) != n // self.block:
            raise ValueError(f"{len(pages)} pages cannot hold {n} rows "
                             f"at {self.block}/page")
        stale = []
        for key, ent in self._entries.items():
            m = _common_prefix(tokens, ent.tokens)
            if m == n and len(ent.tokens) >= n:
                self._entries.move_to_end(key)
                return                      # already covered
            if m == len(ent.tokens):
                stale.append(key)           # subsumed by the new entry
        for key in stale:
            self._evict(key)
        self.pager.allocator.retain(pages)
        _pool_notify("cache_retain", len(pages), self.pager.allocator)
        self._entries[tokens.tobytes()] = _PagedEntry(tokens, list(pages))
        self._pages_held += len(pages)
        self._shrink_to_capacity()

    def _shrink_to_capacity(self) -> None:
        """Pages held back under ``capacity_pages``, LRU first (the newest
        entry always stays)."""
        for key in list(self._entries):
            if self._pages_held <= self.capacity_pages \
                    or len(self._entries) <= 1:
                break
            self._evict(key, count=True)

    def _evict(self, key: bytes, count: bool = False) -> None:
        """The one eviction path: drop the entry and release its pages."""
        ent = self._entries.pop(key)
        self.pager.release_pages(ent.pages)
        _pool_notify("cache_release", len(ent.pages), self.pager.allocator)
        self._pages_held -= len(ent.pages)
        if count:
            self.evictions += 1

    def evict_until(self, pages_free: int) -> int:
        """Release LRU entries until the allocator has ``pages_free`` free
        pages or nothing reclaimable remains; entries whose every page a
        live slot still references would free nothing and are skipped.
        Returns the entries evicted."""
        n = 0
        alloc = self.pager.allocator
        for key in list(self._entries):
            if alloc.pages_free >= pages_free:
                break
            if not any(alloc.ref(p) == 1 for p in self._entries[key].pages):
                continue              # live-shared: frees nothing
            self._evict(key, count=True)
            n += 1
        return n

    def clear(self) -> None:
        while self._entries:
            self._evict(next(iter(self._entries)))

    def reset(self) -> None:
        """Release every page ref and zero the counters (warm-run
        isolation: a warm pass must not leave hits for the measured one)."""
        self.clear()
        self.hits = self.misses = self.hit_tokens = self.evictions = 0

    # --- stats ------------------------------------------------------------
    @property
    def pages_held(self) -> int:
        return self._pages_held

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "pages_held": self._pages_held,
                "tokens_held": self._pages_held * self.block,
                "entries": len(self._entries),
                "evictions": self.evictions}
