"""ShardedPagedKVManager: per-shard page pools for sequence-sharded serving
— host-side bookkeeping, copied from the JAX package (it never touches
device arrays, so it is framework-free).

The sequence-sharded engine (`DecodeEngine(kv_layout="paged", seq_shards=S)`)
runs `serve_step_sp_paged` on S ranks of a sequence mesh: rank s owns the KV
pages whose LOGICAL token range falls in shard s's span
[s·max_len/S, (s+1)·max_len/S). This manager is the host-side bookkeeping
for that layout:

* one `BlockPool` per shard (`num_pages_per_shard` pages each) — a page id
  is meaningful only within its owner shard's pool, and the owner of
  logical page `lp` is `lp // (pages_per_slot // seq_shards)` (shard token
  spans are page-aligned, enforced at construction);
* one `BlockTable` per slot over the FULL logical page range, storing
  shard-local physical ids — the stacked `table_array()` is exactly what
  the sharded step's per-device table slice addresses;
* ONE `PrefixCache` shared across shards: cache entries hold composite
  `(shard, local_page)` handles, routed to the owner pool through a small
  pool-view adapter, so a shared prompt prefix that spans a shard boundary
  is acquired page-by-page from every pool it touches (the hash chain is
  logical-space, exactly as in the single-pool manager — sharing survives
  sharding because the chain never sees physical ids).

Page-pressure semantics become per-shard: admission requires every shard
to hold ITS span of the prompt's non-shared pages, `ensure_mapped` raises
`PoolExhausted` when the *owner shard's* pool (after reclaiming that
shard's cold cached pages) is empty — the engine's preemption fallback is
unchanged, but capacity accounting must never assume one global pool
(`pages_in_use`/`num_pages` aggregate; `shard_stats` exposes the split).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .block_pool import BlockPool, PoolExhausted
from .block_table import BlockTable
from .manager import AdmitPlan, PagedAdmissionCore
from .prefix_cache import PrefixCache, chain_hashes


class _RoutedRefcounts:
    """`pool.refcount[handle]` facade over per-shard pools for composite
    `(shard, local_page)` handles. With `only` set, handles owned by other
    shards report an un-reclaimable count (2) so `PrefixCache.reclaim`/
    `reclaimable` skip them — the shard-filtered reclaim view."""

    def __init__(self, pools: List[BlockPool], only: Optional[int] = None):
        self._pools = pools
        self._only = only

    def __getitem__(self, handle: Tuple[int, int]) -> int:
        shard, page = handle
        if self._only is not None and shard != self._only:
            return 2
        return int(self._pools[shard].refcount[page])


class _RoutedPoolView:
    """Duck-typed `BlockPool` facade the (shard-agnostic) `PrefixCache`
    operates through: incref/decref/refcount on `(shard, local_page)`
    handles route to the owner shard's pool."""

    def __init__(self, pools: List[BlockPool], only: Optional[int] = None):
        self._pools = pools
        self.refcount = _RoutedRefcounts(pools, only)

    def incref(self, handle: Tuple[int, int]) -> None:
        self._pools[handle[0]].incref(handle[1])

    def decref(self, handle: Tuple[int, int]) -> None:
        self._pools[handle[0]].decref(handle[1])


class ShardedPagedKVManager(PagedAdmissionCore):
    """Per-shard page bookkeeping for the sequence-sharded engine (see
    module docstring). API-compatible with `PagedKVManager` where the
    engine is layout-blind — `admit`/`rewind_slot` are literally the SAME
    implementation (`manager.PagedAdmissionCore`), routed here through the
    per-shard primitives; copy-on-write descriptors gain a shard field
    (`ensure_writable` returns `(shard, src, dst)`)."""

    def __init__(self, *, num_slots: int, max_len: int, page_size: int,
                 num_pages_per_shard: int, seq_shards: int,
                 prefix_caching: bool = True):
        if seq_shards < 1:
            raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
        if max_len % (page_size * seq_shards) != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of page_size × "
                f"seq_shards ({page_size}×{seq_shards})")
        self.num_slots = int(num_slots)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.seq_shards = int(seq_shards)
        self.pages_per_slot = self.max_len // self.page_size
        self.pages_per_shard_span = self.pages_per_slot // self.seq_shards
        self.num_pages_per_shard = int(num_pages_per_shard)
        self.pools = [BlockPool(self.num_pages_per_shard, page_size)
                      for _ in range(self.seq_shards)]
        self.tables = [BlockTable(self.pages_per_slot)
                       for _ in range(self.num_slots)]
        self.prefix: Optional[PrefixCache] = (PrefixCache() if prefix_caching
                                              else None)
        self._view = _RoutedPoolView(self.pools)
        self.dirty = True
        self.skipped_tokens = 0
        self.cow_copies = 0

    # ---- logical-page → shard routing -----------------------------------

    def owner(self, logical_page: int) -> int:
        return logical_page // self.pages_per_shard_span

    def _shard_view(self, shard: int) -> _RoutedPoolView:
        return _RoutedPoolView(self.pools, only=shard)

    def _alloc(self, shard: int) -> int:
        try:
            return self.pools[shard].alloc()
        except PoolExhausted:
            if (self.prefix is not None
                    and self.prefix.reclaim(self._shard_view(shard), 1)):
                return self.pools[shard].alloc()
            # carry the binding shard: the engine's preemption victim
            # choice prefers victims actually holding pages in it
            raise PoolExhausted(
                f"shard {shard}: all {self.num_pages_per_shard} pages in "
                f"use (page_size={self.page_size})", shard=shard) from None

    def _free_capacity(self, shard: int, exclude=()) -> int:
        """`exclude` drops (shard, page) handles the caller plans to
        acquire as shared — they cannot double as reclaim fodder."""
        cap = self.pools[shard].num_free
        if self.prefix is not None:
            cap += self.prefix.reclaimable(self._shard_view(shard), exclude)
        return cap

    def _page_demand(self, num_pages: int, start: int = 0) -> List[int]:
        """Per-shard count of logical pages in [start, num_pages) — closed
        form (span intersection), O(seq_shards): this runs per queued
        request per tick, and a 512K-context table walk here would put an
        O(max_len/page_size) Python loop in the serving hot path."""
        span = self.pages_per_shard_span
        return [max(0, min(num_pages, (s + 1) * span) - max(start, s * span))
                for s in range(self.seq_shards)]

    def can_ever_hold(self, num_tokens: int) -> bool:
        """Could a request spanning `num_tokens` ever be admitted with
        every other slot empty? Per-shard: a shard holds at most its span's
        worth of one slot's pages. (The single-pool manager's global check
        is NOT sufficient here — a prompt confined to one shard's span can
        exceed that shard's pool while fitting the aggregate.)"""
        pages = -(-int(num_tokens) // self.page_size)
        return all(d <= self.num_pages_per_shard
                   for d in self._page_demand(pages))

    def sizing_error(self, num_tokens: int) -> str:
        """Human-readable reason `can_ever_hold` failed, naming the
        violating shard — the aggregate pool size alone would tell an
        operator 'the pool is big enough' while refusing to admit."""
        pages = -(-int(num_tokens) // self.page_size)
        demand = self._page_demand(pages)
        worst = max(range(self.seq_shards), key=lambda s: demand[s])
        return (f"needs up to {demand[worst]} pages in shard {worst}'s span "
                f"but each shard's pool holds {self.num_pages_per_shard} "
                f"(per-device KV budget)")

    # ---- admission-core primitives (PagedAdmissionCore contract) --------
    # `admit` / `rewind_slot` live on the shared base class; these hooks
    # route each logical page to its owner shard's pool and express cache
    # handles as composite (shard, local_page) pairs.

    @property
    def _num_shards(self) -> int:
        return self.seq_shards

    def _shard_capacity(self, shard: int, exclude=()) -> int:
        return self._free_capacity(shard, exclude)

    @property
    def _cache_view(self):
        return self._view

    def _handle_page(self, logical_page: int,
                     handle: Tuple[int, int]) -> int:
        shard, page = handle
        assert shard == self.owner(logical_page), (logical_page, shard)
        return page

    def _alloc_page(self, shard: int) -> int:
        return self._alloc(shard)

    def _decref_page(self, shard: int, page: int) -> None:
        self.pools[shard].decref(page)

    # ---- steady-state paging --------------------------------------------

    def ensure_mapped(self, slot: int, pos: int) -> None:
        """Map the logical page holding `pos` in its owner shard's pool.
        Raises PoolExhausted when THAT shard (after reclaiming its cold
        cached pages) has no page — the engine then preempts and retries."""
        lp = pos // self.page_size
        if self.tables[slot].get(lp) >= 0:
            return
        self.tables[slot].map(lp, self._alloc(self.owner(lp)))
        self.dirty = True

    def ensure_writable(self, slot: int,
                        pos: int) -> Optional[Tuple[int, int, int]]:
        """Copy-on-write guard; returns `(shard, src, dst)` (the engine's
        device copy must stay within the owner shard's pool slice) or None
        when the page is exclusively owned."""
        lp = pos // self.page_size
        shard = self.owner(lp)
        phys = self.tables[slot].get(lp)
        if phys < 0 or self.pools[shard].refcount[phys] == 1:
            return None
        dst = self._alloc(shard)
        self.tables[slot].map(lp, dst)
        self.pools[shard].decref(phys)
        self.dirty = True
        self.cow_copies += 1
        return shard, phys, dst

    def commit_prefix(self, slot: int, prompt) -> None:
        if self.prefix is None:
            return
        table = self.tables[slot]
        for i, (key, tb) in enumerate(chain_hashes(prompt, self.page_size)):
            phys = table.get(i)
            assert phys >= 0, (slot, i)
            self.prefix.insert(self._view, key, tb, (self.owner(i), phys))

    def release_slot(self, slot: int) -> int:
        """Eviction/preemption: decref every mapped page against its OWNER
        shard's pool (a `BlockTable.clear()` alone would lose the logical
        position the routing needs). Only the mapped entries are walked —
        retirement/preemption is a serving-path event, and a full
        O(max_len/page_size) table scan here would not be."""
        row = self.tables[slot].row
        for lp in np.nonzero(row >= 0)[0]:
            self.pools[self.owner(int(lp))].decref(int(row[lp]))
        released = self.tables[slot].clear()
        if released:
            self.dirty = True
        return len(released)

    def reclaim(self, n: int, shard: Optional[int] = None) -> int:
        """Free up to `n` cold prefix-cache pages (one shard, or any)."""
        if self.prefix is None:
            return 0
        view = self._view if shard is None else self._shard_view(shard)
        return self.prefix.reclaim(view, n)

    # ---- device-table sync + telemetry ----------------------------------

    def table_array(self) -> np.ndarray:
        """(num_slots, pages_per_slot) int32 of SHARD-LOCAL physical ids
        for the jitted sharded step (each device slices its span)."""
        return np.stack([t.row for t in self.tables])

    @property
    def num_pages(self) -> int:
        """Aggregate pool size (for engine telemetry ratios)."""
        return self.num_pages_per_shard * self.seq_shards

    @property
    def pages_in_use(self) -> int:
        return sum(p.pages_in_use for p in self.pools)

    @property
    def num_free(self) -> int:
        return sum(p.num_free for p in self.pools)

    @property
    def hot_pool_utilization(self) -> float:
        """Utilization of the most-pressured SHARD pool. The aggregate
        ratio can read half-empty while one shard saturates and preempts
        (demand concentrates in low shards early in every request) —
        operators must see the pool that binds."""
        return max(p.utilization for p in self.pools)

    def shard_stats(self) -> List[dict]:
        return [{"pages_in_use": p.pages_in_use, "num_free": p.num_free,
                 "utilization": p.utilization} for p in self.pools]

    def stats(self) -> dict:
        s = {
            "pages_in_use": self.pages_in_use,
            "num_pages": self.num_pages,
            "utilization": self.pages_in_use / max(self.num_pages, 1),
            "skipped_tokens": self.skipped_tokens,
            "cow_copies": self.cow_copies,
            "per_shard": self.shard_stats(),
        }
        if self.prefix is not None:
            s.update(prefix_entries=len(self.prefix),
                     prefix_queries=self.prefix.queries,
                     prefix_hit_pages=self.prefix.hit_pages)
        return s

    def slot_pages(self, slot: int) -> List[Tuple[int, int]]:
        """[(shard, local_page)] of the slot's mapped pages, logical order."""
        row = self.tables[slot].row
        return [(self.owner(lp), int(row[lp]))
                for lp in range(self.pages_per_slot) if row[lp] >= 0]

    def assert_consistent(self) -> None:
        for pool in self.pools:
            pool.assert_consistent()
