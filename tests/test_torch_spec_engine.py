"""The speculative engine of the port against the JAX package's spec engine
and the port's own non-speculative run, on the llama3.2-1b smoke config
(float32) with the JAX parameters carried over (moved here from
`test_torch_spec.py`, which keeps the fixtures and helpers, so that no
test file runs past the tier-1 budget).

Per drafter (replay, reject, partial, n-gram) and verify body (scan, mq):
tokens, the per-tick method log, every report counter and the hit rate
by draft position equal the JAX engine's; tokens, the (phase, method)
sequence and every recorded logit equal the non-speculative run's (bit
for bit under scan, within 1e-5 under mq: `test_torch_spec.py` says why).
"""

import numpy as np
import pytest

from repro.serve import DecodeEngine as JaxEngine
from repro.serve import NgramDrafter as JaxNgram
from repro.serve import ReplayDrafter as JaxReplay
from repro.serve import Request as JaxRequest
from repro.serve import ScriptedDrafter as JaxScripted
from repro_torch.serve import (DecodeEngine, NgramDrafter, ReplayDrafter,
                               Request, ScriptedDrafter)

from test_torch_spec import (SPEC_REPORT, VOCAB, _assert_nonspec_page_shape,
                             _engine, _methods, _trace, models, nonspec)


@pytest.fixture(scope="module")
def jax_spec_engines(models):
    """One JAX spec engine per verify body, reused across drafters (its
    jitted verify tick compiles once): no prefix cache, so a run leaves
    nothing behind for the next."""
    jm, jparams, _, _ = models
    return {vk: _engine(JaxEngine, jm, jparams, spec_depth=2, verify_kernel=vk,
                        prefix_caching=False)
            for vk in ("scan", "mq")}


def _drafter(kind, classes, cont):
    replay, scripted, ngram = classes
    if kind == "replay":
        return replay(cont)
    if kind == "reject":
        return scripted(lambda req, d: [(req.generated[-1] + 1) % VOCAB] * d)
    if kind == "partial":
        def partial(req, d):
            draft = list(cont[req.uid][len(req.generated):
                                       len(req.generated) + d])
            if len(draft) >= 2:
                draft[1] = (draft[1] + 1) % VOCAB
            return draft
        return scripted(partial)
    return ngram()


_JAX_RUNS = {"uid": 0}


@pytest.mark.parametrize("verify_kernel", ["scan", "mq"])
@pytest.mark.parametrize("kind", ["replay", "reject", "partial", "ngram"])
def test_spec_engine_matches_jax_and_nonspec(models, nonspec, jax_spec_engines,
                                             verify_kernel, kind):
    """Against the JAX spec engine on the same trace and drafts: tokens,
    the per-tick method log, every report counter and the hit rate by draft
    position. Against the port's non-speculative run: tokens, the (phase,
    method) sequence and every recorded logit (bit for bit under scan;
    under mq within 1e-5, the head test says why), and after every tick
    each DECODE slot's pages exactly cover [0, length)."""
    _, _, tm, tparams = models
    cont = {i: t for i, t in enumerate(nonspec["tokens"])}
    je = jax_spec_engines[verify_kernel]
    _JAX_RUNS["uid"] += 100
    base, t0 = _JAX_RUNS["uid"], je.tick_count
    je.drafter = _drafter(kind, (JaxReplay, JaxScripted, JaxNgram),
                          {base + u: c for u, c in cont.items()})
    jr = _trace(JaxRequest)
    for r in jr:                   # arrivals count the engine's own ticks
        r.uid += base
        r.arrival += t0
    jrep = je.run(jr, max_ticks=500)

    te = _engine(DecodeEngine, tm, tparams, spec_depth=2,
                 verify_kernel=verify_kernel, prefix_caching=False,
                 record_logits=True,
                 drafter=_drafter(kind, (ReplayDrafter, ScriptedDrafter,
                                         NgramDrafter), cont))
    tick = te.tick

    def checked_tick():
        tick()
        _assert_nonspec_page_shape(te)

    te.tick = checked_tick
    tr = _trace(Request)
    trep = te.run(tr, max_ticks=500)

    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.method_log == {r.uid - base: [(t - t0, ph, m) for t, ph, m
                                            in je.method_log[r.uid]]
                             for r in jr}
    for f in SPEC_REPORT:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.spec_acceptance_rate == jrep.spec_acceptance_rate
    assert trep.prefill_gvr_hit_rate == jrep.prefill_gvr_hit_rate

    assert [r.generated for r in tr] == nonspec["tokens"]
    assert _methods(te, tr) == nonspec["methods"]
    assert trep.gvr_hit_rate == nonspec["report"].gvr_hit_rate
    for r, logits in zip(tr, nonspec["logits"]):
        assert len(r.logits_log) == len(logits)
        for la, lb in zip(r.logits_log, logits):
            if verify_kernel == "scan":
                np.testing.assert_array_equal(la, lb)
            else:
                np.testing.assert_allclose(la, lb, rtol=1e-6, atol=1e-5)
    assert trep.spec_drafted > 0
    if kind == "replay":
        assert trep.spec_accepted == trep.spec_drafted
        assert trep.ticks < nonspec["report"].ticks
    elif kind == "reject":
        assert trep.spec_accepted == 0
    elif kind == "partial":
        assert 0 < trep.spec_accepted < trep.spec_drafted
