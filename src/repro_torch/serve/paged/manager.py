"""PagedKVManager: the engine-facing facade over pool + tables + prefix cache.

Owns every host-side paging decision for a `DecodeEngine` running the paged
KV layout: admission planning (shared-prefix acquisition, bulk allocation
with fail-over to queueing), lazy page mapping as slots write past page
boundaries, copy-on-write protection for shared pages, prefix-cache commit
at prefill completion, and release on eviction/preemption. The device side
sees none of this — only the stacked `page_table` array, pushed by the
engine when `dirty`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .block_pool import BlockPool, PoolExhausted
from .block_table import BlockTable
from .prefix_cache import PrefixCache, chain_hashes


@dataclasses.dataclass
class AdmitPlan:
    """Host-side result of a successful paged admission."""
    skip_len: int        # prompt tokens the engine may skip streaming
    materialized: int    # prompt positions already backed by shared pages
    shared_pages: int    # pages acquired from the prefix cache


class PagedAdmissionCore:
    """Owner-routed admission core shared by `PagedKVManager` and
    `ShardedPagedKVManager`: both layouts run this one probe→match→map
    sequence.

    The core is written against per-shard primitives; the single-pool
    manager is the trivial routing (one shard, every logical page owned by
    shard 0). Subclass contract:

    * `owner(lp)` — owning shard of logical page `lp`.
    * `_num_shards` — shard count (1 for the single pool).
    * `_page_demand(num_pages, start=0)` — per-shard count of logical
      pages in [start, num_pages).
    * `_shard_capacity(shard, exclude=())` — pages obtainable from that
      shard without preemption (free + cache-reclaimable; `exclude` drops
      handles the caller plans to acquire as shared).
    * `_cache_view` — the pool facade the (shard-agnostic) `PrefixCache`
      routes incref/decref through; its handles are whatever the cache
      stores (raw ints single-pool, `(shard, page)` sharded).
    * `_handle_page(lp, handle)` — local physical id of a cache handle
      for logical page `lp` (asserts the owner matches, sharded).
    * `_alloc_page(shard)` — allocate from that shard's pool (with the
      shard-filtered prefix-cache reclaim fallback); raises
      `PoolExhausted` carrying the binding shard.
    * `_decref_page(shard, page)` — drop one ref against the owner pool.

    `admit` and the speculative-decode `rewind_slot` live here exactly
    once; everything else stays layout-specific.
    """

    def admit(self, slot: int, prompt) -> Optional[AdmitPlan]:
        """Plan a request's pages: acquire the longest shared prefix chain,
        allocate the rest of the prompt's pages from their owner shards,
        map them. Returns None — with NOTHING acquired — when any owner
        shard (even after reclaiming its cold cached pages) cannot hold its
        span of the non-shared pages: the engine leaves the request queued
        instead of raising (fail-over to queueing)."""
        plen = len(prompt)
        table = self.tables[slot]
        assert not table.mapped(), f"slot {slot} admitted while mapped"
        chain = (chain_hashes(prompt, self.page_size)
                 if self.prefix is not None else [])
        n_prompt_pages = -(-plen // self.page_size)
        # side-effect-free capacity check first: a request that retries
        # every tick under page pressure must not touch LRU order or stats.
        # The hit pages are excluded from the reclaimable budget — they are
        # acquired, not reclaimed, so counting them would let a doomed
        # admission pass this check and reach the match/rollback path (with
        # its telemetry/LRU side effects) every tick it stays queued
        hit_pages = (self.prefix.probe_pages(chain)
                     if self.prefix is not None else [])
        need = self._page_demand(n_prompt_pages, start=len(hit_pages))
        if any(need[s] > self._shard_capacity(s, exclude=hit_pages)
               for s in range(self._num_shards)):
            return None
        shared = (self.prefix.match(self._cache_view, chain)
                  if self.prefix is not None else [])
        need = self._page_demand(n_prompt_pages, start=len(shared))
        if any(need[s] > self._shard_capacity(s)
               for s in range(self._num_shards)):    # unreachable in the
            for handle in shared:                    # single-threaded engine,
                self._cache_view.decref(handle)      # kept as a guard
            return None
        for i, handle in enumerate(shared):
            table.map(i, self._handle_page(i, handle))
        for i in range(len(shared), n_prompt_pages):
            table.map(i, self._alloc_page(self.owner(i)))
        self.dirty = True
        materialized = len(shared) * self.page_size
        # the last prompt token always streams: its step produces the
        # logits that seed generation (and re-arms the feedback buffer)
        skip = min(materialized, plen - 1)
        self.skipped_tokens += skip
        return AdmitPlan(skip_len=skip, materialized=materialized,
                         shared_pages=len(shared))

    def rewind_slot(self, slot: int, keep_len: int) -> int:
        """Speculative-decode rollback hook: unmap (and decref against the
        owner shards) every logical page of the slot that lies WHOLLY
        beyond the accepted prefix's first `keep_len` tokens. After a
        verify tick that accepted fewer tokens than it mapped pages for,
        this restores the block table and ref-counts to exactly what
        non-speculative decode would hold at the same length — the
        rollback-exactness contract (DESIGN.md §spec-decode). Returns the
        number of pages freed."""
        first_free = -(-int(keep_len) // self.page_size)
        row = self.tables[slot].row
        freed = 0
        for rel in np.nonzero(row[first_free:] >= 0)[0]:
            lp = int(rel) + first_free
            self._decref_page(self.owner(lp), self.tables[slot].unmap(lp))
            freed += 1
        if freed:
            self.dirty = True
        return freed

    def pages_in_shard(self, slot: int, shard: Optional[int]) -> int:
        """Mapped pages of `slot` owned by `shard` (all pages when None) —
        the engine's shard-aware preemption victim signal: a victim holding
        no pages in the pressured shard cannot relieve it."""
        row = self.tables[slot].row
        if shard is None:
            return int((row >= 0).sum())
        return sum(1 for lp in np.nonzero(row >= 0)[0]
                   if self.owner(int(lp)) == shard)


class PagedKVManager(PagedAdmissionCore):
    """Page bookkeeping for one engine's slot pool (see module docstring)."""

    def __init__(self, *, num_slots: int, max_len: int, page_size: int,
                 num_pages: int, prefix_caching: bool = True):
        if max_len % page_size != 0:
            raise ValueError(f"max_len ({max_len}) must be a multiple of "
                             f"page_size ({page_size})")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_slot = self.max_len // self.page_size
        self.pool = BlockPool(num_pages, page_size)
        self.tables = [BlockTable(self.pages_per_slot)
                       for _ in range(self.num_slots)]
        self.prefix: Optional[PrefixCache] = (PrefixCache() if prefix_caching
                                              else None)
        self.dirty = True                 # device table needs a push
        self.skipped_tokens = 0           # prompt tokens served from cache
        self.cow_copies = 0

    # ---- allocation with prefix-cache pressure relief -------------------

    def _alloc(self) -> int:
        try:
            return self.pool.alloc()
        except PoolExhausted:
            if self.prefix is not None and self.prefix.reclaim(self.pool, 1):
                return self.pool.alloc()
            raise

    def _free_capacity(self, exclude=()) -> int:
        """Pages obtainable without preemption: free + cache-reclaimable.
        `exclude` drops pages the caller plans to acquire as shared — they
        cannot double as reclaim fodder in the same plan."""
        cap = self.pool.num_free
        if self.prefix is not None:
            cap += self.prefix.reclaimable(self.pool, exclude)
        return cap

    # ---- admission-core primitives (PagedAdmissionCore contract) --------
    # `admit` / `rewind_slot` themselves live on the shared base class —
    # this manager is the trivial routing: one shard owning every page.

    _num_shards = 1

    def owner(self, logical_page: int) -> int:
        return 0

    def _page_demand(self, num_pages: int, start: int = 0) -> List[int]:
        return [max(0, int(num_pages) - int(start))]

    def _shard_capacity(self, shard: int, exclude=()) -> int:
        return self._free_capacity(exclude)

    @property
    def _cache_view(self):
        return self.pool                  # cache handles ARE pool page ids

    def _handle_page(self, logical_page: int, handle: int) -> int:
        return handle

    def _alloc_page(self, shard: int) -> int:
        return self._alloc()

    def _decref_page(self, shard: int, page: int) -> None:
        self.pool.decref(page)

    # ---- steady-state paging --------------------------------------------

    def ensure_mapped(self, slot: int, pos: int) -> None:
        """Map the logical page holding `pos`, allocating on first touch.
        Raises PoolExhausted when no page is obtainable — the engine then
        preempts a PREFILL slot and retries."""
        lp = pos // self.page_size
        if self.tables[slot].get(lp) >= 0:
            return
        self.tables[slot].map(lp, self._alloc())
        self.dirty = True

    def ensure_writable(self, slot: int, pos: int) -> Optional[Tuple[int, int]]:
        """Copy-on-write guard: if `pos` falls in a page shared with other
        owners (ref-count > 1), remap the slot to a fresh page and return
        (src, dst) so the engine copies the page's device rows. Returns
        None when the page is exclusively owned (the engine's normal path:
        shared pages are only ever *read*, because the prefill replay over
        a shared prefix redirects its writes to the sink page)."""
        lp = pos // self.page_size
        phys = self.tables[slot].get(lp)
        if phys < 0 or self.pool.refcount[phys] == 1:
            return None
        dst = self._alloc()
        self.tables[slot].map(lp, dst)
        self.pool.decref(phys)
        self.dirty = True
        self.cow_copies += 1
        return phys, dst

    def commit_prefix(self, slot: int, prompt) -> None:
        """Retain the slot's FULL prompt pages in the prefix cache (called
        once, at prefill completion, when their contents are final)."""
        if self.prefix is None:
            return
        table = self.tables[slot]
        for i, (key, tb) in enumerate(chain_hashes(prompt, self.page_size)):
            phys = table.get(i)
            assert phys >= 0, (slot, i)
            self.prefix.insert(self.pool, key, tb, phys)

    def release_slot(self, slot: int) -> int:
        """Eviction/preemption: drop the slot's refs on all its pages.
        Prefix-cached pages survive on the cache's own ref."""
        released = self.tables[slot].clear()
        for page in released:
            self.pool.decref(page)
        if released:
            self.dirty = True
        return len(released)

    def reclaim(self, n: int) -> int:
        """Free up to `n` cold prefix-cache pages (engine pressure hook)."""
        if self.prefix is None:
            return 0
        return self.prefix.reclaim(self.pool, n)

    def can_ever_hold(self, num_tokens: int) -> bool:
        """Could a request spanning `num_tokens` ever be admitted with the
        pool otherwise empty? (The engine's submit-time sizing check —
        layout-polymorphic with `ShardedPagedKVManager.can_ever_hold`,
        whose accounting is per shard.)"""
        return -(-int(num_tokens) // self.page_size) <= self.pool.num_pages

    def sizing_error(self, num_tokens: int) -> str:
        """Human-readable reason `can_ever_hold` failed."""
        worst = -(-int(num_tokens) // self.page_size)
        return (f"needs up to {worst} pages but the pool holds "
                f"{self.pool.num_pages}")

    # ---- device-table sync + telemetry ----------------------------------

    @property
    def num_pages(self) -> int:
        """Pool capacity. Engine code must use these manager-level
        accessors, never reach into `.pool` — the sequence-sharded manager
        has S pools, and any accounting that assumes one global pool
        under-counts there."""
        return self.pool.num_pages

    @property
    def pages_in_use(self) -> int:
        return self.pool.pages_in_use

    @property
    def num_free(self) -> int:
        return self.pool.num_free

    @property
    def hot_pool_utilization(self) -> float:
        """Utilization of the most-pressured pool — trivially THE pool
        here; the sharded manager reports its max across shards so
        telemetry points at the pool that actually binds."""
        return self.pool.utilization

    def table_array(self) -> np.ndarray:
        """(num_slots, pages_per_slot) int32 for the jitted step."""
        return np.stack([t.row for t in self.tables])

    def stats(self) -> dict:
        s = {
            "pages_in_use": self.pool.pages_in_use,
            "num_pages": self.pool.num_pages,
            "utilization": self.pool.utilization,
            "skipped_tokens": self.skipped_tokens,
            "cow_copies": self.cow_copies,
        }
        if self.prefix is not None:
            s.update(prefix_entries=len(self.prefix),
                     prefix_queries=self.prefix.queries,
                     prefix_hit_pages=self.prefix.hit_pages)
        return s

    def slot_pages(self, slot: int) -> List[int]:
        return self.tables[slot].mapped()
