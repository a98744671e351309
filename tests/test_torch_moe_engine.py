"""The MoE family's engines against the JAX engines, on both MoE smoke
configs (moved here from `test_torch_moe.py`, which keeps the fixtures
and helpers, so that no test file runs past the tier-1 budget): on a
staggered trace the dense and paged engines equal the JAX engines in
tokens, method log and report counters, and paged == dense bit for bit in
tokens, logits and method log."""

import numpy as np

from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.serve import DecodeEngine, Request

from test_torch_moe import REPORT_FIELDS, _engine_run, moe


def test_engines_match_jax_and_paged_equals_dense(moe):
    jm, jparams, tm, tparams = moe
    runs = {}
    for layout, kw in (("dense", dict(kv_layout="dense")),
                       ("paged", dict(kv_layout="paged", page_size=8))):
        je, jr, jrep = _engine_run(JaxEngine, JaxRequest, jm, jparams, **kw)
        te, tr, trep = _engine_run(DecodeEngine, Request, tm, tparams,
                                   record_logits=True, **kw)
        for a, c in zip(jr, tr):
            assert a.generated == c.generated, (layout, a.uid)
        assert te.method_log == je.method_log, layout
        for f in REPORT_FIELDS:
            assert getattr(trep, f) == getattr(jrep, f), (layout, f)
        assert trep.completed == 3 and trep.gvr_hit_rate > 0
        runs[layout] = (te, tr)
    (de, dr), (pe, pr) = runs["dense"], runs["paged"]
    assert pe.method_log == de.method_log
    for a, c in zip(dr, pr):
        assert a.generated == c.generated, a.uid
        assert len(a.logits_log) == len(c.logits_log) > 0
        for la, lc in zip(a.logits_log, c.logits_log):
            np.testing.assert_array_equal(la, lc)
