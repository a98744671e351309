"""The port's `ShardedPagedKVManager` against the JAX package's on the same
operation sequences: every return value, the stacked shard-local block
table, the per-shard and aggregate statistics and the consistency checks
after every operation. Host-side bookkeeping only: no process is
spawned and no device array is touched."""

import numpy as np
import pytest

from repro.serve.paged import ShardedPagedKVManager as JaxSharded
from repro.serve.paged import PoolExhausted as JaxExhausted
from repro_torch.serve import ShardedPagedKVManager, PoolExhausted


def _snapshot(kv):
    return {"table": kv.table_array().tolist(),
            "shards": kv.shard_stats(),
            "stats": kv.stats(),
            "in_use": kv.pages_in_use, "free": kv.num_free,
            "hot": kv.hot_pool_utilization,
            "pages": [kv.slot_pages(s) for s in range(kv.num_slots)],
            "held": [[kv.pages_in_shard(s, sh) for sh in range(kv.seq_shards)]
                     for s in range(kv.num_slots)]}


def _apply(kv, op):
    """One operation; returns its result (exceptions as their message)."""
    name, *args = op
    try:
        out = getattr(kv, name)(*args)
    except (PoolExhausted, JaxExhausted) as exc:
        return ("PoolExhausted", str(exc), exc.shard)
    if name == "admit" and out is not None:
        return (out.skip_len, out.materialized, out.shared_pages)
    return out


def _run_both(kw, ops):
    kvs = (JaxSharded(**kw), ShardedPagedKVManager(**kw))
    for op in ops:
        got = [_apply(kv, op) for kv in kvs]
        assert got[0] == got[1], (op, got)
        snaps = [_snapshot(kv) for kv in kvs]
        assert snaps[0] == snaps[1], op
        for kv in kvs:
            kv.assert_consistent()
    return kvs[1]


def _arange(a, b):
    return np.arange(a, b, dtype=np.int32)


BASE = dict(num_slots=2, max_len=64, page_size=8)

SCENARIOS = {
    # a prompt spanning the boundary draws each page from its owner shard
    "route": (dict(BASE, num_pages_per_shard=4, seq_shards=2),
              [("admit", 0, _arange(0, 40)), ("release_slot", 0)]),
    # per-shard capacity: confined to shard 0's span, the prompt bounces
    "capacity": (dict(BASE, num_pages_per_shard=3, seq_shards=2,
                      prefix_caching=False),
                 [("can_ever_hold", 32), ("can_ever_hold", 24),
                  ("sizing_error", 32), ("admit", 0, _arange(0, 32)),
                  ("admit", 0, _arange(0, 24))]),
    # the owner shard's exhaustion raises, naming the shard
    "exhaust": (dict(BASE, num_pages_per_shard=2, seq_shards=2,
                     prefix_caching=False),
                [("admit", 0, _arange(0, 16)), ("admit", 1, _arange(0, 9)),
                 ("ensure_mapped", 0, 16), ("ensure_mapped", 0, 32)]),
    # a cached prefix crossing the boundary, reacquired from both pools
    "prefix": (dict(BASE, num_pages_per_shard=4, seq_shards=2),
               [("admit", 0, _arange(0, 41)), ("commit_prefix", 0, _arange(0, 41)),
                ("admit", 1, _arange(0, 41)), ("release_slot", 0),
                ("release_slot", 1), ("reclaim", 8)]),
    # copy-on-write keeps the shard in its descriptor
    "cow": (dict(BASE, num_pages_per_shard=4, seq_shards=2),
            [("admit", 0, _arange(0, 40)), ("commit_prefix", 0, _arange(0, 40)),
             ("admit", 1, _arange(0, 40)), ("ensure_writable", 1, 39),
             ("ensure_writable", 1, 39)]),
    # the shard-filtered reclaim frees only the named shard's pages
    "reclaim": (dict(BASE, num_pages_per_shard=4, seq_shards=2),
                [("admit", 0, _arange(0, 40)), ("commit_prefix", 0, _arange(0, 40)),
                 ("release_slot", 0), ("reclaim", 8, 1), ("reclaim", 8, 0)]),
    # a doomed admission leaves the prefix cache untouched
    "doomed": (dict(BASE, num_pages_per_shard=3, seq_shards=2),
               [("admit", 0, _arange(0, 16)), ("commit_prefix", 0, _arange(0, 16)),
                ("release_slot", 0), ("admit", 0, _arange(100, 108)),
                ("commit_prefix", 0, _arange(100, 108)), ("release_slot", 0)]
               + [("admit", 0, np.concatenate([_arange(0, 16), _arange(200, 216)]))] * 3),
    # four shards: a prompt over three spans, rewound and regrown
    "four": (dict(num_slots=3, max_len=128, page_size=8,
                  num_pages_per_shard=5, seq_shards=4),
             [("admit", 0, _arange(0, 70)), ("commit_prefix", 0, _arange(0, 70)),
              ("admit", 1, _arange(0, 75)), ("ensure_mapped", 1, 80),
              ("ensure_writable", 1, 66), ("rewind_slot", 1, 70),
              ("admit", 2, _arange(500, 530)), ("release_slot", 0),
              ("reclaim", 3, 2), ("release_slot", 1), ("release_slot", 2),
              ("reclaim", 20)]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sharded_manager_equals_jax(name):
    kw, ops = SCENARIOS[name]
    _run_both(kw, ops)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_manager_random_sequences_equal_jax(seed):
    """Random admissions (shared prefixes, some doomed), mapping past the
    prompt, copy-on-write, rewinds, releases and reclaims over 2 or 4
    shards, held operation by operation."""
    rng = np.random.default_rng(seed)
    shards = (2, 4)[seed % 2]
    kw = dict(num_slots=3, max_len=32 * shards, page_size=4,
              num_pages_per_shard=int(rng.integers(5, 9)), seq_shards=shards)
    base = rng.integers(0, 50, (40,)).astype(np.int32)
    ops, mapped = [], {}
    for _ in range(60):
        slot = int(rng.integers(0, 3))
        kind = rng.integers(0, 6)
        if slot not in mapped and kind < 4:
            plen = int(rng.integers(1, kw["max_len"] // 2))
            prompt = (base[:plen] if rng.random() < 0.5 and plen <= 40
                      else rng.integers(0, 50, (plen,)).astype(np.int32))
            ops.append(("admit", slot, prompt))
            mapped[slot] = prompt
        elif slot in mapped and kind == 0:
            ops.append(("commit_prefix", slot, mapped[slot]))
        elif slot in mapped and kind in (1, 2):
            pos = int(rng.integers(len(mapped[slot]), kw["max_len"]))
            ops += [("ensure_mapped", slot, pos), ("ensure_writable", slot, pos)]
        elif slot in mapped and kind == 3:
            ops.append(("rewind_slot", slot, len(mapped[slot])))
        elif slot in mapped:
            ops.append(("release_slot", slot))
            mapped.pop(slot)
        else:
            ops.append(("reclaim", int(rng.integers(1, 4)),
                        int(rng.integers(0, shards))))
    # an admission the pools refused leaves the slot unmapped in both, so
    # later operations on it compare the same refusal or no-op
    kvs = (JaxSharded(**kw), ShardedPagedKVManager(**kw))
    for op in ops:
        if op[0] != "admit" and op[0] != "reclaim" and not kvs[0].tables[op[1]].mapped():
            continue
        if op[0] == "admit" and kvs[0].tables[op[1]].mapped():
            continue
        got = [_apply(kv, op) for kv in kvs]
        assert got[0] == got[1], (op, got)
        assert _snapshot(kvs[0]) == _snapshot(kvs[1]), op
        for kv in kvs:
            kv.assert_consistent()
