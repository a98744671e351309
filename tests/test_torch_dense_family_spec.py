"""Depth-2 speculation on h2o-danube-3-4b's smoke config (its window of 64
cut by the 80-token request) against the JAX spec engine, scan and mq
verify, drafts replayed from the non-speculative run (all right, or every
second one wrong). Moved here from `test_torch_dense_family_engine.py`,
which keeps the helpers, so that no test file runs past the tier-1
budget; the models and the non-speculative run are made once for the
file (`danube`)."""

import pytest

from repro.serve import DecodeEngine as JaxEngine
from repro.serve import ReplayDrafter as JaxReplay
from repro.serve import Request as JaxRequest
from repro.serve import ScriptedDrafter as JaxScripted
from repro_torch.serve import (DecodeEngine, ReplayDrafter, Request,
                               ScriptedDrafter)

from test_torch_dense_family_engine import SPEC_FIELDS, _models, _run


@pytest.fixture(scope="module")
def danube():
    """danube's models and the port's non-speculative paged run."""
    jm, jparams, tm, tparams = _models("h2o-danube-3-4b")
    _, base, _ = _run(DecodeEngine, Request, tm, tparams, kv_layout="paged",
                      page_size=8)
    return jm, jparams, tm, tparams, base


def _drafter(kind, replay, scripted, cont):
    """Drafts from the non-speculative continuations `cont`: all right
    ("replay"), or with every draft's second token wrong ("partial")."""
    if kind == "replay":
        return replay(cont)

    def partial(req, d):
        draft = list(cont[req.uid][len(req.generated):len(req.generated) + d])
        if len(draft) >= 2:
            draft[1] = (draft[1] + 1) % 512
        return draft
    return scripted(partial)


@pytest.mark.parametrize("kind", ["replay", "partial"])
@pytest.mark.parametrize("verify_kernel", ["scan", "mq"])
def test_spec_engine_matches_jax_on_the_windowed_config(danube, verify_kernel,
                                                       kind):
    """Depth-2 speculation on danube's smoke config: tokens, method log and
    report counters (the spec ones too) equal the JAX spec engine's, and
    the tokens the non-speculative engine's."""
    jm, jparams, tm, tparams, base = danube
    cont = {r.uid: list(r.generated) for r in base}
    kw = dict(kv_layout="paged", page_size=8, spec_depth=2,
              verify_kernel=verify_kernel)
    je, jr, jrep = _run(JaxEngine, JaxRequest, jm, jparams,
                        drafter=_drafter(kind, JaxReplay, JaxScripted, cont), **kw)
    te, tr, trep = _run(DecodeEngine, Request, tm, tparams,
                        drafter=_drafter(kind, ReplayDrafter, ScriptedDrafter,
                                         cont), **kw)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    assert te.method_log == je.method_log
    for f in SPEC_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
    assert trep.spec_ticks > 0 and trep.spec_accepted > 0
    assert [r.generated for r in tr] == [r.generated for r in base]
