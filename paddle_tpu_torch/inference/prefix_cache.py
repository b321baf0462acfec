"""Shared-prefix KV caches: row copies for the contiguous engine, page
references for the paged one.

Port of ``paddle_tpu/inference/prefix_cache.py``. When many requests share
a prompt prefix (a system prompt, few-shot exemplars, a long document),
its KV rows are the same for all of them (prefill is deterministic and
rope keys depend on the absolute position only), so the prefix is
prefilled once and reused. Matching is exact-token and aligned to the
cache's block, over a flat LRU of entries, and strict: at least one token
of a prompt is left to prefill, since admission takes the first generated
token from the prompt's last position. A partial overlap is credited (a
prompt sharing the first 64 rows of a 128-row entry reuses those 64).

* ``PrefixCache`` (the slot-contiguous engine): entries are KV row blocks
  ``[L, n, Hkv, D]`` that the engine harvests from a slot after admitting
  a request, as copies: a slice of the slot cache is a view that the
  slot's next admit overwrites in place, so every caller of ``insert``
  hands over rows it owns. A hit writes the rows into the admit's
  temporary cache and only the suffix is prefilled. Capacity is bounded
  in KV rows held.
* ``PagedPrefixCache`` (the paged engine): entries hold page ids, not
  rows. ``insert`` retains the admitted request's prompt pages (harvest by
  reference: the slot and the cache share the physical pages), and a hit
  hands the same page ids to the next request's reservation, which
  retains them again; no row is copied. The granularity is the page, so
  no sharer ever writes a shared page. Capacity is bounded in pages held,
  and eviction releases page refs (a page shared with a live slot frees
  only when that slot retires). ``evict_until`` is the pressure valve:
  admission reclaims cache-held pages before it defers a request.

``make_prefix_cache`` builds the one that fits an engine. Out of this port
so far: the host tier (``host_tier`` and ``host_tier_pages`` raise;
``restore``, ``export_host`` and ``import_host`` wait for it), the
listeners, metrics and flight-recorder calls.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from .paged_kv import _notify as _pool_notify

__all__ = ["PrefixCache", "PrefixMatch", "PagedPrefixCache",
           "PagedPrefixMatch", "make_prefix_cache"]


def make_prefix_cache(engine, block: int = 32,
                      capacity_tokens: int = 16384,
                      host_tier_pages: int = 0):
    """The prefix cache for one engine: a paged engine gets a
    ``PagedPrefixCache`` over its own pager (page refs must count in the
    allocator the slots draw from), a contiguous engine a ``PrefixCache``
    at ``block``. Capacity is ``capacity_tokens`` rows either way."""
    if host_tier_pages:
        raise NotImplementedError("the host tier is not ported yet")
    if getattr(engine, "paged", False):
        return PagedPrefixCache(engine.pager, capacity_pages=max(
            1, capacity_tokens // engine.pager.page_size))
    return PrefixCache(block=block, capacity_tokens=capacity_tokens)


@dataclass
class _Entry:
    tokens: np.ndarray   # [n] int32, n a multiple of block
    k: object            # [L, n, Hkv, D] tensor the entry owns
    v: object            # [L, n, Hkv, D]


@dataclass
class PrefixMatch:
    length: int          # reusable rows (block multiple, < len(prompt))
    k: object            # [L, >= length, Hkv, D]: use [:, :length]
    v: object


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


class _Lookup:
    """Block alignment and the strict longest-prefix match over the LRU of
    entries, shared by both caches (``self.block``, ``self._entries``)."""

    def round_down(self, n: int) -> int:
        return (int(n) // self.block) * self.block

    def round_up(self, n: int) -> int:
        return -(-int(n) // self.block) * self.block

    def _longest(self, prompt):
        """(rows, key) of the entry sharing the longest block-aligned
        prefix with ``prompt``, strict (at least one token remains), and
        counts the hit or miss; the entry moves to the LRU's end. (0,
        None) on a miss."""
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
            return 0, None
        self._entries.move_to_end(best_key)
        self.hits += 1
        self.hit_tokens += best_l
        return best_l, best_key

    def _stale(self, tokens: np.ndarray):
        """The keys of entries the new prefix ``tokens`` subsumes, or None
        when an entry already covers it (which moves to the LRU's end)."""
        n = len(tokens)
        if n % self.block or n == 0:
            raise ValueError(
                f"prefix length {n} is not a positive multiple of "
                f"block {self.block}")
        stale = []
        for key, ent in self._entries.items():
            m = _common_prefix(tokens, ent.tokens)
            if m == n and len(ent.tokens) >= n:
                self._entries.move_to_end(key)
                return None                 # already covered
            if m == len(ent.tokens):
                stale.append(key)           # subsumed by the new entry
        return stale


class PrefixCache(_Lookup):
    """Prefix cache of KV row blocks for the slot-contiguous engine."""

    def __init__(self, block: int = 32, capacity_tokens: int = 16384):
        if block < 1:
            raise ValueError(f"block must be >= 1, got {block}")
        self.block = int(block)
        self.capacity_tokens = int(capacity_tokens)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._tokens_held = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0       # KV rows not prefilled again thanks to hits
        self.evictions = 0

    def match(self, prompt) -> Optional[PrefixMatch]:
        """Longest block-aligned common prefix between ``prompt`` and any
        entry, strict (never the whole prompt)."""
        n, key = self._longest(prompt)
        if key is None:
            return None
        ent = self._entries[key]
        return PrefixMatch(n, ent.k, ent.v)

    def insert(self, tokens, k, v) -> None:
        """Insert the KV rows ``k``/``v`` [L, len(tokens), Hkv, D] of the
        prefix ``tokens`` (a block multiple long). The cache keeps the
        tensors as given, so the caller passes rows it owns (a copy, never
        a view of a slot). An entry that already covers the tokens makes
        this a no-op; entries the new one extends are dropped; then the
        least recently used entries go until ``capacity_tokens`` holds
        (the newest always stays)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        stale = self._stale(tokens)
        if stale is None:
            return
        for key in stale:
            self._tokens_held -= len(self._entries.pop(key).tokens)
        self._entries[tokens.tobytes()] = _Entry(tokens, k, v)
        self._tokens_held += len(tokens)
        while self._tokens_held > self.capacity_tokens and \
                len(self._entries) > 1:
            _, old = self._entries.popitem(last=False)
            self._tokens_held -= len(old.tokens)
            self.evictions += 1

    def put_prompt(self, params, tokens, cfg) -> None:
        """Register a known prefix ahead of traffic: prefill ``tokens``
        alone (``llama.prompt_kv``, on the parameters' device) and insert
        the block-trimmed rows."""
        from ..models import llama

        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = self.round_down(len(tokens))
        if n == 0:
            raise ValueError(
                f"prompt of {len(tokens)} tokens is shorter than one "
                f"block ({self.block})")
        cache, _ = llama.prompt_kv(params, tokens[:n], cfg,
                                   device=params["embed"].device)
        self.insert(tokens[:n], cache["k"][:, 0], cache["v"][:, 0])

    def reset(self) -> None:
        """Drop every entry and zero the counters (a warm pass must not
        leave hits for the measured one)."""
        self.__init__(block=self.block, capacity_tokens=self.capacity_tokens)

    @property
    def tokens_held(self) -> int:
        return self._tokens_held

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "hit_tokens": self.hit_tokens,
                "tokens_held": self._tokens_held,
                "entries": len(self._entries),
                "evictions": self.evictions}


class PagedPrefixCache(_Lookup):
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

    def match(self, prompt) -> Optional[PagedPrefixMatch]:
        """Longest whole-page common prefix between ``prompt`` and any
        entry, strict (at least one token must remain to prefill).
        Returns page ids without retaining them: the reservation takes
        the refs, so a deferred admission leaves no dangling count."""
        n, key = self._longest(prompt)
        if key is None:
            return None
        return PagedPrefixMatch(n, self._entries[key].pages[:n // self.block])

    def insert(self, tokens, pages) -> None:
        """Insert the prefix ``tokens`` held by the given live pages (one
        per ``page_size`` tokens). The cache retains them. An entry that
        already covers the tokens makes this a no-op; entries the new
        one extends are dropped."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = len(tokens)
        if n and n % self.block == 0 and len(pages) != n // self.block:
            raise ValueError(f"{len(pages)} pages cannot hold {n} rows "
                             f"at {self.block}/page")
        stale = self._stale(tokens)
        if stale is None:
            return
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
