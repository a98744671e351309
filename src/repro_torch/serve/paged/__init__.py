"""Paged KV-cache subsystem with shared-prefix reuse (serving layer) —
host-side bookkeeping, copied from the JAX package (it never touches device
arrays, so it is framework-free).

A global pool of `num_pages` pages of `page_size` tokens and a per-slot
block table (`BlockTable`) map logical token positions to physical pages;
identical prompt prefixes are stored once and shared by ref-count
(`PrefixCache`, keyed by a rolling blake2b hash chain over full pages and
verified against the raw tokens). Writes into a shared page go through
copy-on-write (`PagedKVManager.ensure_writable`). Everything the GVR
feedback loop sees stays in logical token space, so page-table remaps never
disturb the temporal prediction. `ShardedPagedKVManager` keeps one pool
per shard of the sequence-sharded layout, behind the same admission core.
"""

from .block_pool import BlockPool, PoolExhausted
from .block_table import BlockTable
from .manager import AdmitPlan, PagedAdmissionCore, PagedKVManager
from .prefix_cache import PrefixCache, chain_hashes
from .sharded import ShardedPagedKVManager

__all__ = [
    "AdmitPlan", "BlockPool", "BlockTable", "PagedAdmissionCore",
    "PagedKVManager", "PoolExhausted", "PrefixCache", "ShardedPagedKVManager",
    "chain_hashes",
]
