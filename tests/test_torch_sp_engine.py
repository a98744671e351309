"""`DecodeEngine(kv_layout="paged", seq_shards=S)` of the port on gloo ranks
on the CPU, with the JAX parameters of the llama3.2-1b smoke config.

The JAX package's traces (`tests/test_sp_engine.py`): a coverage trace
with a shared prefix crossing the shard boundary, and a preemption trace
under per-shard page pressure. At S = 2 the port's sharded engine gives
the JAX package's sharded engine's tokens, per-tick method log, GVR hit
rate, prefix hits and preemptions (one JAX subprocess, a forced 4-device
host mesh), and so does the port's fused single-device engine; at S = 4
the coverage trace too. Speculative runs at depth 3 (oracle drafts
through the scan verify, every third draft wrong through the mq verify)
give the non-speculative tokens and method log. The constructor refuses
what the reference refuses, with its messages.
"""

import jax
import numpy as np
import pytest

from _sp_common import flatten, run_jax, run_ranks
from _sp_traces import engine_runs
from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.serve import DecodeEngine

pytestmark = pytest.mark.mesh

COMPARED = ("tokens", "log", "hit", "decode_counts", "prefix", "preempt",
            "completed")

_JAX = r"""
import sys, json
import numpy as np, jax
sys.path.insert(0, "tests")
from _sp_traces import cov_specs, pre_specs, run_trace
from repro.configs.registry import get_config
from repro.models.api import build_model
from repro.serve import DecodeEngine, Request

tmp = sys.argv[1]
cfg = get_config("llama3.2-1b", smoke=True)
model = build_model(cfg)
params = model.init_params(jax.random.PRNGKey(0))
out = {"cov": run_trace(DecodeEngine, Request, model, params,
                        cov_specs(cfg.vocab), seq_shards=2),
       "pre": run_trace(DecodeEngine, Request, model, params,
                        pre_specs(cfg.vocab), num_pages=5, seq_shards=2)}
np.savez(tmp + "/jax.npz", runs=np.array(json.dumps(out)))
"""


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_config("llama3.2-1b", smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


@pytest.fixture(scope="module")
def runs(tmp_path_factory, models):
    import json
    _, jparams, tm, tparams = models
    tmp = tmp_path_factory.mktemp("sp_engine")
    flat = flatten(jax.tree.map(np.asarray, jparams), "params/")
    for s in (2, 4):
        (tmp / f"s{s}").mkdir()
        np.savez(tmp / f"s{s}" / "inputs.npz", full=np.array(s == 2), **flat)
    jax_out = json.loads(str(run_jax(_JAX, tmp)["runs"]))
    sharded = {s: run_ranks("engine", s, tmp / f"s{s}") for s in (2, 4)}
    fused = engine_runs(tm, tparams, spec=False)
    return jax_out, sharded, fused


def _same(a, b, what):
    for key in COMPARED:
        assert a[key] == b[key], (what, key)


@pytest.mark.parametrize("trace", ["cov", "pre"])
def test_sp_engine_equals_jax_and_fused(runs, trace):
    """S = 2: the port's sharded engine = the JAX sharded engine = the
    port's fused engine, on every rank."""
    jax_out, sharded, fused = runs
    for rank_out in sharded[2]:
        _same(rank_out[trace], jax_out[trace], f"{trace} vs JAX")
        _same(rank_out[trace], fused[trace], f"{trace} vs fused")


def test_sp_engine_traces_are_meaningful(runs):
    """The coverage trace reuses a 3-page prefix, serves warm GVR decode
    ticks and preempts nothing; the preemption trace preempts."""
    _, sharded, _ = runs
    cov, pre = sharded[2][0]["cov"], sharded[2][0]["pre"]
    assert cov["prefix"] == 24 and cov["preempt"] == 0
    assert cov["decode_counts"].get("gvr", 0) > 0 and cov["completed"] == 3
    assert pre["preempt"] >= 1


def test_sp_engine_four_shards_equal_fused(runs):
    _, sharded, fused = runs
    for rank_out in sharded[4]:
        _same(rank_out["cov"], fused["cov"], "cov at S = 4")


@pytest.mark.parametrize("leg", ["replay", "partial"])
def test_sp_spec_engine_equals_nonspec(runs, leg):
    """Depth-3 speculation on the sharded engine gives the non-speculative
    tokens and (phase, method) sequence: oracle drafts (scan verify, all
    accepted) and every third draft wrong (mq verify, some rejected)."""
    _, sharded, _ = runs
    for rank_out in sharded[2]:
        base, spec = rank_out["cov"], rank_out[leg]
        assert spec["tokens"] == base["tokens"]
        # one entry per token, as the non-speculative ticks (the tick
        # numbers differ: a verify tick stands for several)
        assert ({u: [e[1:] for e in v] for u, v in spec["log"].items()}
                == {u: [e[1:] for e in v] for u, v in base["log"].items()})
        assert spec["hit"] == base["hit"]
        if leg == "replay":
            assert spec["accept"] == 1.0
        else:
            assert 0.0 < spec["accept"] < 1.0


@pytest.mark.parametrize("kw", [
    pytest.param(dict(max_len=64, kv_layout="dense"), id="paged"),
    pytest.param(dict(max_len=64, kv_layout="paged", paged_attn="gather"),
                 id="fused"),
    pytest.param(dict(max_len=40, kv_layout="paged", seq_shards=4),
                 id="page_size"),
    pytest.param(dict(max_len=8, kv_layout="paged"), id="dsa-gate"),
    pytest.param(dict(max_len=64, kv_layout="paged",
                      gather_granularity="page"), id="granularity")])
def test_sp_engine_validation_messages_equal_jax(models, kw):
    """Each refusal is a ValueError with the reference's message, raised
    before any process group is needed."""
    jm, jparams, tm, tparams = models
    kw = {"seq_shards": 2, "page_size": 8, **kw}
    msgs = []
    for engine, model, params in ((JaxEngine, jm, jparams),
                                  (DecodeEngine, tm, tparams)):
        with pytest.raises(ValueError) as err:
            engine(model, params, num_slots=2, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_sp_engine_preempts_holders_of_the_pressured_shard():
    """The victim of a shard's exhaustion holds pages in that shard (the
    reference's shard-aware order, on the same stub)."""
    from types import SimpleNamespace
    from repro_torch.serve.scheduler import DECODE, PREFILL

    class KV:
        def __init__(self, holdings):
            self._h = holdings

        def pages_in_shard(self, slot, shard):
            return self._h[slot].get(shard, 0)

    slots = [SimpleNamespace(phase=PREFILL, prompt=np.zeros(40), prefill_pos=0,
                             admitted_at=5, generated=[]),
             SimpleNamespace(phase=PREFILL, prompt=np.zeros(10), prefill_pos=0,
                             admitted_at=1, generated=[]),
             SimpleNamespace(phase=DECODE, prompt=np.zeros(8), prefill_pos=8,
                             admitted_at=0, generated=[1, 2])]
    pick = DecodeEngine._preempt_victim
    stub = SimpleNamespace(slots=slots, kv=KV({0: {1: 4}, 1: {0: 2}, 2: {0: 1}}))
    assert pick(stub, exclude=None, shard=0) == 1
    assert pick(stub, exclude=None, shard=None) == 0
    assert pick(stub, exclude=None, shard=3) is None
    stub2 = SimpleNamespace(slots=slots, kv=KV({0: {1: 4}, 1: {1: 2}, 2: {0: 1}}))
    assert pick(stub2, exclude=None, shard=0) == 2


@pytest.mark.parametrize("rank", [0, 1])
def test_sp_copy_on_write_stays_in_the_owner_shard(rank):
    """A copy-on-write descriptor (shard, src, dst) copies page src to dst
    of that shard's pool, on the rank holding it; the other rank's pool is
    untouched (its page ids mean other pages)."""
    import torch
    from types import SimpleNamespace
    pools = {k: torch.randn(2, 1, 5, 4, 3) for k in ("k_pages", "v_pages",
                                                     "idx_k_pages")}
    before = {k: v.clone() for k, v in pools.items()}
    stub = SimpleNamespace(seq_shards=2, mesh=SimpleNamespace(rank=rank),
                           state=pools)
    DecodeEngine._copy_page(stub, (0, 1, 3))
    for key, arr in pools.items():
        want = before[key].clone()
        if rank == 0:
            want[:, 0, 3] = want[:, 0, 1]
        assert torch.equal(arr, want), key
