"""Fixed pool of KV pages: free-list allocation + per-page ref-counts.

The pool is pure host-side bookkeeping over the physical page axis of the
model's paged decode state (`models.transformer.init_paged_decode_state`):
it never touches device arrays. A page is *free* (on the free list,
ref-count 0) or *held* by one or more owners — live slots mapping it in
their block tables and/or the prefix cache retaining it for reuse. Shared
prompt prefixes are expressed purely through ref-counts: admitting a
request over an existing prefix increments the counts of the shared pages
instead of copying them.

Invariant (pinned by tests): every page is either on the free list with
ref-count 0, or off it with ref-count ≥ 1 — `assert_consistent` checks it,
and a drained engine must return to `pages_in_use == ` (pages held by the
prefix cache alone).
"""

from __future__ import annotations

import numpy as np


class PoolExhausted(RuntimeError):
    """No free page available. Callers fail over (queue the admission,
    reclaim prefix-cache pages, or preempt a PREFILL slot) — they do not
    treat this as fatal.

    `shard` names the BINDING pool under the sequence-sharded layout (the
    shard whose span demand could not be met); None for the single-pool
    layout. The engine's preemption victim choice uses it to prefer
    victims that actually hold pages in the pressured shard — evicting a
    slot whose pages all live elsewhere can never relieve the pressure."""

    def __init__(self, *args, shard=None):
        super().__init__(*args)
        self.shard = shard


class BlockPool:
    """Free-list + ref-count allocator over `num_pages` pages of
    `page_size` tokens each."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0:
            raise ValueError(f"num_pages must be positive, got {num_pages}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros((self.num_pages,), np.int32)
        # LIFO free list: recently freed pages are re-used first, which
        # maximizes page-table churn in tests (catches stale-mapping bugs)
        self._free = list(range(self.num_pages - 1, -1, -1))
        self.total_allocs = 0

    # ---- allocation -----------------------------------------------------

    def alloc(self) -> int:
        """Take a free page (ref-count becomes 1)."""
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_pages} pages in use (page_size="
                f"{self.page_size})")
        page = self._free.pop()
        assert self.refcount[page] == 0, (page, self.refcount[page])
        self.refcount[page] = 1
        self.total_allocs += 1
        return page

    def incref(self, page: int) -> None:
        """Add an owner to a held page (shared-prefix admission)."""
        assert self.refcount[page] > 0, f"incref on free page {page}"
        self.refcount[page] += 1

    def decref(self, page: int) -> None:
        """Drop an owner; the page returns to the free list at ref-count 0."""
        assert self.refcount[page] > 0, f"decref on free page {page}"
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(page)

    # ---- introspection --------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def utilization(self) -> float:
        return self.pages_in_use / self.num_pages

    def assert_consistent(self) -> None:
        """Free list and ref-counts must partition the pool exactly."""
        free = set(self._free)
        assert len(free) == len(self._free), "duplicate page on free list"
        for page in range(self.num_pages):
            if page in free:
                assert self.refcount[page] == 0, (page, self.refcount[page])
            else:
                assert self.refcount[page] >= 1, (page, self.refcount[page])
