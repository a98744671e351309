"""Shared-prefix cache: prompt-token hash chains → retained KV pages.

## Hash-chain scheme

Only FULL pages participate: page i of a prompt (tokens
[i*page_size, (i+1)*page_size)) is keyed by

    h_0 = H(SEED      || tokens_0)
    h_i = H(h_{i-1}   || tokens_i)

so a key identifies the page's tokens AND its entire prefix — two prompts
share page i iff they agree on every token up to and including page i.
`H` is blake2b (stdlib, unsalted: keys are stable across processes, unlike
Python's `hash`). Entries additionally store the raw token bytes and
`match` verifies them, so a hash collision can degrade sharing but can
never serve wrong KV content.

## Lifecycle

The cache holds its own ref-count on every retained page, so cached pages
survive the eviction of the request that wrote them. `match` walks the
chain from page 0 and acquires (increfs) each hit for the admitting slot;
`reclaim` drops least-recently-matched entries whose page would actually
free (ref-count 1 — held by the cache alone), which is how pool pressure
converts cold cached prefixes back into free pages.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import List, Tuple

import numpy as np

_SEED = b"\x00" * 16


def chain_hashes(tokens, page_size: int) -> List[Tuple[bytes, bytes]]:
    """[(chain_key, token_bytes)] for every FULL page of `tokens`."""
    toks = np.asarray(tokens, np.int32).reshape(-1)
    out = []
    parent = _SEED
    for i in range(len(toks) // page_size):
        tb = toks[i * page_size:(i + 1) * page_size].tobytes()
        key = hashlib.blake2b(parent + tb, digest_size=16).digest()
        out.append((key, tb))
        parent = key
    return out


class PrefixCache:
    """LRU map from chain keys to retained pool pages."""

    def __init__(self):
        # key → (phys_page, token_bytes); insertion/move order = LRU
        self._entries: "OrderedDict[bytes, Tuple[int, bytes]]" = OrderedDict()
        self.queries = 0
        self.hit_pages = 0
        self.insertions = 0
        self.reclaimed = 0

    def __len__(self) -> int:
        return len(self._entries)

    def probe(self, chain: List[Tuple[bytes, bytes]]) -> int:
        """Length of the matchable chain prefix, with NO side effects — no
        refs taken, no LRU touch, no stats. Admission planning uses this to
        size its page demand; only a *successful* admission then `match`es
        (a request retrying under page pressure must not keep entries warm
        or inflate the hit counters every tick it stays queued)."""
        return len(self.probe_pages(chain))

    def probe_pages(self, chain: List[Tuple[bytes, bytes]]) -> List[int]:
        """The matchable chain prefix's pages, side-effect-free (`probe`
        with identities). Admission capacity planning needs the pages
        themselves: a hit page is *acquired*, not reclaimed, so it must be
        excluded from the reclaimable count the plan leans on — otherwise
        a doomed admission passes the pre-check, `match`es, and rolls back
        with its telemetry/LRU side effects intact, every retry tick."""
        pages: List[int] = []
        for key, tb in chain:
            ent = self._entries.get(key)
            if ent is None or ent[1] != tb:
                break
            pages.append(ent[0])
        return pages

    def match(self, pool, chain: List[Tuple[bytes, bytes]]) -> List[int]:
        """Longest chain of cached pages matching the prompt's full pages,
        each acquired (incref'd) for the admitting slot. Stops at the first
        miss — sharing is only valid for a contiguous prefix."""
        self.queries += 1
        pages: List[int] = []
        for key, tb in chain:
            ent = self._entries.get(key)
            if ent is None or ent[1] != tb:
                break
            self._entries.move_to_end(key)
            pool.incref(ent[0])
            pages.append(ent[0])
        self.hit_pages += len(pages)
        return pages

    def insert(self, pool, key: bytes, token_bytes: bytes, page: int) -> bool:
        """Retain `page` under `key` (cache takes its own ref). No-op when
        the key is already cached — the existing page stays canonical."""
        if key in self._entries:
            self._entries.move_to_end(key)
            return False
        pool.incref(page)
        self._entries[key] = (page, token_bytes)
        self.insertions += 1
        return True

    def reclaimable(self, pool, exclude=()) -> int:
        """Pages that `reclaim` could free right now (cache-only refs).
        `exclude` removes pages the caller intends to ACQUIRE from the
        count — an admission plan must not budget a prefix-hit page as
        both shared and reclaimable."""
        skip = set(exclude)
        return sum(1 for page, _ in self._entries.values()
                   if pool.refcount[page] == 1 and page not in skip)

    def reclaim(self, pool, n: int) -> int:
        """Drop up to `n` least-recently-matched entries whose pages free
        (in-use shared pages are skipped — dropping them frees nothing and
        forfeits reuse). Returns pages actually freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= n:
                break
            page, _ = self._entries[key]
            if pool.refcount[page] == 1:
                del self._entries[key]
                pool.decref(page)
                freed += 1
        self.reclaimed += freed
        return freed

    def drop_all(self, pool) -> None:
        """Release every cached page (test/teardown hook)."""
        for page, _ in self._entries.values():
            pool.decref(page)
        self._entries.clear()
