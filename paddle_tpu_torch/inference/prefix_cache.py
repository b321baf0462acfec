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

  With a ``host_tier`` (``inference/kv_tiers.HostTier``) an insert also
  stages its pages to host memory (write-through); capacity and pressure
  eviction then spill a clean entry (its pool pages released, the host
  copy kept) instead of dropping it, and a hit on such an entry
  ``restore``s it into fresh pages. ``export_host`` / ``import_host``
  move a staged entry between two caches' tiers. Every eviction goes
  through one path that emits a ``prefix_evict`` flight event with its
  ``reason`` (capacity | pressure | spill | subsumed | reset), and
  ``listeners`` observe inserts, evictions, spills and restores.

``make_prefix_cache`` builds the one that fits an engine (with
``host_tier_pages``, a paged cache over a host tier of that many pages).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..observability import flight as _flight
from ..observability import metrics as _metrics
from .paged_kv import _notify as _pool_notify

__all__ = ["PrefixCache", "PrefixMatch", "PagedPrefixCache",
           "PagedPrefixMatch", "make_prefix_cache"]


def make_prefix_cache(engine, block: int = 32,
                      capacity_tokens: int = 16384,
                      host_tier_pages: int = 0):
    """The prefix cache for one engine: a paged engine gets a
    ``PagedPrefixCache`` over its own pager (page refs must count in the
    allocator the slots draw from), with a ``HostTier`` of
    ``host_tier_pages`` pages behind it when that is set (host bytes
    belong to the cache that staged them); a contiguous engine a
    ``PrefixCache`` at ``block``. Capacity is ``capacity_tokens`` rows
    either way."""
    if getattr(engine, "paged", False):
        host_tier = None
        if host_tier_pages:
            from .kv_tiers import HostTier

            host_tier = HostTier(engine.pager,
                                 capacity_pages=int(host_tier_pages))
        return PagedPrefixCache(engine.pager, capacity_pages=max(
            1, capacity_tokens // engine.pager.page_size),
            host_tier=host_tier)
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
    # "hbm" (resident), "clean" (resident and staged to the host tier) or
    # "host" (spilled: ``pages`` is empty and the admission must
    # ``restore`` it); ``key`` names the entry for that call
    tier: str = "hbm"
    key: bytes = b""


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
            _metrics.counter("serving.prefix_cache.misses").inc()
            return 0, None
        self._entries.move_to_end(best_key)
        self.hits += 1
        self.hit_tokens += best_l
        _metrics.counter("serving.prefix_cache.hits").inc()
        _metrics.counter("serving.prefix_cache.hit_tokens").inc(best_l)
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
        _flight.record("prefix_hit", rows=n,
                       prompt_len=int(np.asarray(prompt).size))
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
            _metrics.counter("serving.prefix_cache.evictions").inc()
            _flight.record("prefix_evict", rows=len(old.tokens),
                           tokens_held=self._tokens_held,
                           reason="capacity")
        _metrics.gauge("serving.prefix_cache.tokens_held").set(
            self._tokens_held)

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
    """Prefix cache of page ids over one engine's ``PagedKVCache``,
    optionally backed by a host tier.

    Capacity (``capacity_pages``) bounds the pool pages held; a host-tier
    entry holds none and has its own bound. ``listeners`` get
    ``fn(event, key, tokens, tier, n_pages)`` (host values only) for
    insert, evict, spill and restore."""

    def __init__(self, pager, capacity_pages: int = 512, host_tier=None):
        self.pager = pager
        self.block = pager.page_size      # alignment rule = the page
        self.capacity_pages = int(capacity_pages)
        self.host_tier = host_tier
        self._entries: "OrderedDict[bytes, _PagedEntry]" = OrderedDict()
        self._pages_held = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.spills = 0                   # demotions to the host tier
        self.restores = 0                 # promotions back to the pool
        self.listeners: list = []

    # --- tier plumbing (no-ops without a host tier) -----------------------
    def _tier_of(self, key: bytes, ent: _PagedEntry) -> str:
        if not ent.pages:
            return "host"
        if self.host_tier is not None and self.host_tier.has(key):
            return "clean"
        return "hbm"

    def _notify_listeners(self, event: str, key: bytes,
                          ent: _PagedEntry) -> None:
        if self.listeners:
            tier = self._tier_of(key, ent)
            for fn in self.listeners:
                fn(event, key, ent.tokens, tier, len(ent.pages))

    # --- lookup -----------------------------------------------------------
    def match(self, prompt) -> Optional[PagedPrefixMatch]:
        """Longest whole-page common prefix between ``prompt`` and any
        entry, strict (at least one token must remain to prefill).
        Returns page ids without retaining them: the reservation takes
        the refs, so a deferred admission leaves no dangling count. A
        spilled entry matches with ``tier="host"`` and no pages."""
        n, key = self._longest(prompt)
        if key is None:
            return None
        ent = self._entries[key]
        tier = self._tier_of(key, ent)
        _flight.record("prefix_hit", rows=n,
                       prompt_len=int(np.asarray(prompt).size),
                       pages=n // self.block, tier=tier)
        return PagedPrefixMatch(n, ent.pages[:n // self.block], tier=tier,
                                key=key)

    # --- population -------------------------------------------------------
    def insert(self, tokens, pages) -> None:
        """Insert the prefix ``tokens`` held by the given live pages (one
        per ``page_size`` tokens). The cache retains them and, with a host
        tier, stages them (write-through). An entry that already covers
        the tokens makes this a no-op (unless it is a spilled entry whose
        host copy is gone); entries the new one extends are dropped."""
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
                if ent.pages or (self.host_tier is not None
                                 and self.host_tier.has(key)):
                    self._entries.move_to_end(key)
                    return                  # already covered
                stale.append(key)           # a dead host entry: replace
            elif m == len(ent.tokens):
                stale.append(key)           # subsumed by the new entry
        for key in stale:
            self._evict(key, reason="subsumed")
        self.pager.allocator.retain(pages)
        _pool_notify("cache_retain", len(pages), self.pager.allocator)
        key = tokens.tobytes()
        ent = _PagedEntry(tokens, list(pages))
        self._entries[key] = ent
        self._pages_held += len(pages)
        if self.host_tier is not None:
            # the D2H copy is issued now and lands at the engine's next
            # counted fetch; from then on the entry is clean and pressure
            # spills it instead of dropping it
            self.host_tier.stage(key, ent.pages)
        self._notify_listeners("insert", key, ent)
        self._shrink_to_capacity()
        _metrics.gauge("serving.prefix_cache.pages_held").set(
            self._pages_held)

    def _shrink_to_capacity(self, keep: Optional[bytes] = None) -> None:
        """Pool pages held back under ``capacity_pages``, least recently
        used first (host-tier entries hold none and are skipped; the
        newest entry always stays, and so does ``keep``)."""
        if self._pages_held <= self.capacity_pages:
            return
        for key in list(self._entries):
            if self._pages_held <= self.capacity_pages \
                    or len(self._entries) <= 1:
                break
            if self._entries[key].pages and key != keep:
                self._evict(key, reason="capacity", count=True)

    def _evict(self, key: bytes, reason: str = "capacity",
               count: bool = False) -> None:
        """The one eviction path: every page release comes here and
        emits one ``prefix_evict`` flight event with its ``reason``. A
        capacity or pressure eviction of a clean entry becomes a spill:
        its pool pages are released and the entry lives on in the host
        tier."""
        ent = self._entries[key]
        spillable = (self.host_tier is not None and ent.pages
                     and reason in ("capacity", "pressure")
                     and self.host_tier.has(key))
        if spillable:
            self.pager.release_pages(ent.pages)
            _pool_notify("cache_release", len(ent.pages),
                         self.pager.allocator)
            self._pages_held -= len(ent.pages)
            n_pages, ent.pages = len(ent.pages), []
            self.spills += 1
            self.host_tier.note_spill(n_pages)
            _metrics.counter("serving.prefix_cache.spills").inc()
            _flight.record("prefix_evict", pages=n_pages,
                           pages_held=self._pages_held, reason="spill")
            self._notify_listeners("spill", key, ent)
            return
        self._entries.pop(key)
        if ent.pages:
            self.pager.release_pages(ent.pages)
            _pool_notify("cache_release", len(ent.pages),
                         self.pager.allocator)
            self._pages_held -= len(ent.pages)
        if self.host_tier is not None:
            self.host_tier.drop(key)
        if count:
            self.evictions += 1
            _metrics.counter("serving.prefix_cache.evictions").inc()
        _flight.record("prefix_evict", pages=len(ent.pages),
                       pages_held=self._pages_held, reason=reason)
        self._notify_listeners("evict", key, ent)

    def evict_until(self, pages_free: int) -> int:
        """Release the pool pages of least recently used entries until the
        allocator has ``pages_free`` free pages or nothing reclaimable
        remains: admission calls this before it defers a request. Entries
        whose every page a live slot still references would free nothing
        and are skipped, and clean entries go first (they spill, losing
        nothing); then unstaged ones are dropped. Returns the entries
        evicted or spilled."""
        n = 0
        alloc = self.pager.allocator
        for lossless in (True, False):
            for key in list(self._entries):
                if alloc.pages_free >= pages_free:
                    return n
                ent = self._entries.get(key)
                if ent is None or not ent.pages:
                    continue              # host tier: no pool pages
                if not any(alloc.ref(p) == 1 for p in ent.pages):
                    continue              # live-shared: frees nothing
                clean = (self.host_tier is not None
                         and self.host_tier.has(key))
                if lossless != clean:
                    continue
                self._evict(key, reason="pressure", count=True)
                n += 1
        return n

    # --- tier restore and migration ---------------------------------------
    def restore(self, key: bytes, rows: int) -> Optional[list]:
        """Bring a spilled entry's first ``rows`` back into the pool:
        fresh pages (refcount 1, the cache's, as an insert's retain) and
        the host tier's upload into them; the admission's
        ``reserve(shared=...)`` then shares them like any hit. A partial
        restore truncates the entry (and its host copy) to the restored
        span. Returns the pages, or None when the entry cannot restore
        (not staged, or no room)."""
        ent = self._entries.get(key)
        tier = self.host_tier
        if ent is None or ent.pages or tier is None:
            return None
        host = tier.get(key)
        if host is None:
            return None
        n = min(rows // self.block, host["pages"])
        alloc = self.pager.allocator
        if n < 1 or n > alloc.pages_free:
            return None
        pages = alloc.alloc(n)
        _pool_notify("cache_retain", n, alloc)
        names = tier.planes()
        partial = n < len(ent.tokens) // self.block
        # an upload reads whole host buffers, never views: a partial
        # restore uploads contiguous copies of the kept rows, which then
        # become the truncated entry's host copy
        planes = ({p: tier.host_copy(host[p][:, :n]) for p in names}
                  if partial else {p: host[p] for p in names})
        tier.upload(pages, planes)
        if partial:
            del self._entries[key]
            tier.drop(key)
            ent.tokens = ent.tokens[:n * self.block]
            key = ent.tokens.tobytes()
            if key in self._entries:
                self._evict(key, reason="subsumed")
            self._entries[key] = ent
            tier._put(key, planes, n)
        ent.pages = list(pages)
        self._entries.move_to_end(key)
        self._pages_held += n
        self.restores += 1
        _metrics.counter("serving.prefix_cache.restores").inc()
        self._notify_listeners("restore", key, ent)
        # the cache holds the only reference to the restored pages until
        # the admission shares them: spilling them here would hand back
        # freed pages (the reference does, when the span exceeds
        # capacity_pages and spilled entries remain)
        self._shrink_to_capacity(keep=key)
        return list(pages)

    def export_host(self, key: bytes) -> Optional[dict]:
        """A staged entry as portable host data: ``{"tokens", "pages",
        <plane>: host tensor ...}``, or None when the entry never finished
        staging."""
        ent = self._entries.get(key)
        if ent is None or self.host_tier is None:
            return None
        host = self.host_tier.get(key)
        if host is None:
            return None
        n = host["pages"]
        out = {"tokens": ent.tokens[:n * self.block], "pages": n}
        out.update({p: host[p] for p in self.host_tier.planes()})
        return out

    def import_host(self, tokens, planes) -> bool:
        """File an entry exported from another cache's tier as a spilled
        entry of this one (no pool pages: the next hit restores it).
        ``planes`` maps every pool plane's name to its host tensor (or
        numpy array of a numpy dtype); both caches run the same pool
        dtype. Returns False when there is no tier, no whole page, or
        the entry is already here."""
        if self.host_tier is None:
            return False
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n = len(tokens) // self.block
        if n < 1:
            return False
        tokens = tokens[:n * self.block]
        key = tokens.tobytes()
        if key in self._entries:
            return False                  # already present
        ent = _PagedEntry(tokens, [])
        self._entries[key] = ent
        self.host_tier.note_import(
            key, {p: a[:, :n] for p, a in planes.items()}, n)
        self._notify_listeners("insert", key, ent)
        return True

    def clear(self) -> None:
        while self._entries:
            self._evict(next(iter(self._entries)), reason="reset")

    def reset(self) -> None:
        """Release every page ref, empty the host tier and zero the
        counters (a warm pass must not leave hits for the measured
        one)."""
        self.clear()
        if self.host_tier is not None:
            self.host_tier.reset()
        self.hits = self.misses = self.hit_tokens = self.evictions = 0
        self.spills = self.restores = 0

    # --- stats ------------------------------------------------------------
    @property
    def pages_held(self) -> int:
        return self._pages_held

    def physical_pages_held(self) -> int:
        """Distinct physical pages the cache references (entries sharing a
        prefix share its pages, so ``pages_held`` over-counts)."""
        return len({p for ent in self._entries.values()
                    for p in ent.pages})

    @property
    def host_pages(self) -> int:
        """Pages resident in the host tier (0 without one)."""
        return self.host_tier.pages_host if self.host_tier is not None \
            else 0

    def reclaimable_pages(self, tier: str = "hbm") -> int:
        """Pages eviction would return to the free list now: cache-held
        pages no live slot references (``tier="hbm"``); host-resident
        pages (``"host"``); or both (``"all"``)."""
        if tier == "host":
            return self.host_pages
        held = {p for ent in self._entries.values() for p in ent.pages}
        live = {p for pages in self.pager.slot_pages for p in pages}
        hbm = len(held - live)
        return hbm + self.host_pages if tier == "all" else hbm

    def spillable_pages(self) -> int:
        """The reclaimable pool pages whose entries are clean: reclaiming
        them costs no recompute."""
        if self.host_tier is None:
            return 0
        held = set()
        for key, ent in self._entries.items():
            if ent.pages and self.host_tier.has(key):
                held.update(ent.pages)
        live = {p for pages in self.pager.slot_pages for p in pages}
        return len(held - live)

    def stats(self) -> dict:
        out = {"hits": self.hits, "misses": self.misses,
               "hit_tokens": self.hit_tokens,
               "pages_held": self._pages_held,
               "tokens_held": self._pages_held * self.block,
               "entries": len(self._entries),
               "evictions": self.evictions}
        if self.host_tier is not None:
            out.update(spills=self.spills, restores=self.restores,
                       host_pages=self.host_pages,
                       tier=self.host_tier.stats())
        return out
