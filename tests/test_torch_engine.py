"""The port's continuous-batching engine vs the JAX package's paged engine
on the llama3.2-1b smoke config, with the JAX parameters carried over.

On the same trace the two must produce the same tokens, the same per-tick
method log and the same `EngineReport` counters — one trace with a shared
prompt prefix (prefix-cache reuse, replay over shared pages) and one under
page pressure (preemption and deterministic replay). The engine is also
held against a raw batch-1 `serve_step_paged` loop of the port itself.
Sampled requests draw from torch generators, not JAX threefry keys, so
they are held to determinism and seed sensitivity only.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.serve import (BlockPool, DecodeEngine, PagedKVManager,
                               PoolExhausted, PrefixCache, Request,
                               sample_token)
from repro_torch.serve.paged import chain_hashes

REPORT_FIELDS = ("ticks", "decoded_tokens", "prefill_tokens", "completed",
                 "method_counts", "prefill_method_counts",
                 "decode_method_counts", "preemptions", "prefix_hit_tokens",
                 "peak_page_utilization")


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_config("llama3.2-1b", smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def _shared_prefix_specs(rng, vocab):
    prefix = rng.integers(0, vocab, (16,))
    return [(np.concatenate([prefix, rng.integers(0, vocab, (5,))]), 5, 0),
            (prefix.copy(), 5, 8),
            (rng.integers(0, vocab, (12,)), 6, 3),
            (np.concatenate([prefix, rng.integers(0, vocab, (3,))]), 4, 16)]


def _pressure_specs(rng, vocab):
    return [(rng.integers(0, vocab, (20,)), 20, 0),
            (rng.integers(0, vocab, (30,)), 4, 1)]


@pytest.mark.parametrize("trace,engine_kw", [
    ("shared_prefix", dict()),
    ("page_pressure", dict(num_pages=7, prefix_caching=False)),
])
def test_engine_matches_jax_paged_engine(models, trace, engine_kw):
    jm, jparams, tm, tparams = models
    make = _shared_prefix_specs if trace == "shared_prefix" else _pressure_specs
    kw = dict(num_slots=2, max_len=64, prefill_chunk=4, kv_layout="paged",
              page_size=8, **engine_kw)
    runs = []
    for engine_cls, req_cls, model, params in (
            (JaxEngine, JaxRequest, jm, jparams),
            (DecodeEngine, Request, tm, tparams)):
        specs = make(np.random.default_rng(1), 512)
        reqs = [req_cls(uid=i, prompt=p, max_new_tokens=m, arrival=a)
                for i, (p, m, a) in enumerate(specs)]
        eng = engine_cls(model, params, **kw)
        runs.append((eng, reqs, eng.run(reqs, max_ticks=3000)))
    (je, jr, jrep), (te, tr, trep) = runs
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.uid
        assert a.preemptions == b.preemptions, a.uid
    assert te.method_log == je.method_log
    for f in REPORT_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
    if trace == "shared_prefix":
        assert trep.prefix_hit_tokens > 0 and te.kv.stats()["cow_copies"] == 0
    else:
        assert trep.preemptions >= 1
        assert te.kv.pool.pages_in_use == 0
    te.kv.pool.assert_consistent()


def test_engine_matches_raw_serve_step_loop(models):
    """The prompt fed token by token through a raw batch-1 paged step and
    greedy-decoded; the engine, with another request in flight, must
    reproduce it."""
    _, _, tm, tparams = models
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, 512, (7,))
    state = tm.init_paged_decode_state(1, 64, num_pages=8, page_size=8)
    state["page_table"] = torch.arange(8, dtype=torch.int32)[None]
    logits = None
    for t in prompt:
        logits, state = tm.serve_step_paged(tparams, state,
                                            torch.tensor([t], dtype=torch.int32))
    ref = [int(torch.argmax(logits[0]))]
    for _ in range(5):
        logits, state = tm.serve_step_paged(tparams, state,
                                            torch.tensor([ref[-1]], dtype=torch.int32))
        ref.append(int(torch.argmax(logits[0])))
    eng = DecodeEngine(tm, tparams, num_slots=2, max_len=64, prefill_chunk=4,
                       kv_layout="paged", page_size=8)
    reqs = [Request(uid=0, prompt=prompt, max_new_tokens=6),
            Request(uid=1, prompt=rng.integers(0, 512, (11,)), max_new_tokens=6)]
    rep = eng.run(reqs, max_ticks=500)
    assert reqs[0].generated == ref
    methods = [m for _, _, m in eng.method_log[0]]
    assert methods[0] == "radix" and set(methods[1:]) == {"gvr"}
    assert rep.completed == 2 and eng.pool.admissions == eng.pool.evictions == 2


@pytest.mark.parametrize("kw,item", [
    pytest.param(dict(kv_layout="paged", seq_shards=2),
                 "seq_shards=2 needs a process group of 2 ranks and none is "
                 "initialised: start one process per shard",
                 id="kw1-item 4")])
def test_unported_engine_options_raise(models, kw, item):
    """The sharded engine needs a process group of seq_shards ranks: in
    one process with no group it raises `make_seq_mesh`'s actionable
    ValueError, never a silent single-rank run."""
    _, _, tm, tparams = models
    with pytest.raises(ValueError, match=item):
        DecodeEngine(tm, tparams, num_slots=1, max_len=64, page_size=8, **kw)


def test_spec_on_the_dense_layout_raises_as_the_reference(models):
    """Speculation needs the paged layout, and the default layout is dense:
    ValueError, as the JAX engine raises."""
    jm, jparams, tm, tparams = models
    for engine_cls, model, params in ((JaxEngine, jm, jparams),
                                      (DecodeEngine, tm, tparams)):
        with pytest.raises(ValueError, match="paged"):
            engine_cls(model, params, num_slots=1, max_len=64, spec_depth=2)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="dense"), dict(kv_layout="paged", paged_attn="gather"),
    dict(kv_layout="paged", gather_granularity="page"),
    dict(kv_layout="paged", spec_depth=2)])
def test_ported_engine_options_serve_a_request(models, kw):
    _, _, tm, tparams = models
    eng = DecodeEngine(tm, tparams, num_slots=1, max_len=64, page_size=8, **kw)
    req = Request(uid=0, prompt=np.arange(6), max_new_tokens=4)
    rep = eng.run([req], max_ticks=100)
    assert rep.completed == 1 and len(req.generated) == 4
    assert [m for _, _, m in eng.method_log[0]][1:] == ["gvr"] * 3


def test_sampling_deterministic_and_seed_sensitive(models):
    _, _, tm, tparams = models
    prompt = np.random.default_rng(9).integers(0, 512, (6,))

    def run(seed):
        eng = DecodeEngine(tm, tparams, num_slots=1, max_len=64, page_size=8)
        r = Request(uid=0, prompt=prompt, max_new_tokens=6, temperature=50.0,
                    seed=seed)
        eng.run([r], max_ticks=200)
        return r.generated

    assert run(3) == run(3)
    assert run(3) != run(4) or run(3) != run(5)


def test_sample_token_nucleus_keeps_top_token():
    logits = torch.tensor([10.0, 0.0, -1.0, -2.0])
    g = torch.Generator().manual_seed(0)
    assert {sample_token(logits, g, temperature=1.0, top_p=0.5)
            for _ in range(20)} == {0}


# ---------------- host-side paging units (copied modules) -----------------

def test_block_pool_alloc_free_refcount():
    pool = BlockPool(num_pages=3, page_size=8)
    a, b_, c = pool.alloc(), pool.alloc(), pool.alloc()
    assert {a, b_, c} == {0, 1, 2}
    with pytest.raises(PoolExhausted):
        pool.alloc()
    pool.incref(b_)
    pool.decref(b_)
    assert pool.num_free == 0
    pool.decref(b_)
    assert pool.alloc() == b_                  # LIFO reuse
    for p in (a, b_, c):
        pool.decref(p)
    pool.assert_consistent()


def test_prefix_cache_chain_and_manager_copy_on_write():
    kv = PagedKVManager(num_slots=2, max_len=32, page_size=8, num_pages=8)
    prompt = np.arange(16, dtype=np.int32)
    assert kv.admit(0, prompt).shared_pages == 0
    kv.commit_prefix(0, prompt)
    plan = kv.admit(1, prompt)
    assert plan.shared_pages == 2 and plan.skip_len == 15
    src, dst = kv.ensure_writable(1, 15)
    assert kv.pool.refcount[src] == 2 and kv.pool.refcount[dst] == 1
    cache = PrefixCache()
    assert cache.probe(chain_hashes(prompt, 8)) == 0
    kv.release_slot(0)
    kv.release_slot(1)
    kv.prefix.drop_all(kv.pool)
    assert kv.pool.pages_in_use == 0
    kv.pool.assert_consistent()
