"""The port's invariants across its engine forms (moved here from
`test_torch_layouts.py`, which keeps the fixtures and helpers, so that no
test file runs past the tier-1 budget): on a trace of unique prompts the
dense layout, the gather oracle and the page-granular gather equal the
fused paged engine in tokens, every logit and the method log — one fused
run (`fused_unique`) is shared by the three — and on shared prefixes the
dense engine's tokens equal the paged engine's."""

import numpy as np
import pytest

from repro_torch.serve import DecodeEngine, Request

from test_torch_layouts import (_run, _shared_prefix_specs, _unique_specs,
                                models)


@pytest.fixture(scope="module")
def fused_unique(models):
    """The fused paged engine on the unique-prompt trace, run once."""
    _, _, tm, tparams = models
    return _run(DecodeEngine, Request, tm, tparams,
                _unique_specs(np.random.default_rng(2), 512),
                record_logits=True, kv_layout="paged", page_size=8)


@pytest.mark.parametrize("form", [
    dict(kv_layout="dense"),
    dict(kv_layout="paged", page_size=8, paged_attn="gather"),
    dict(kv_layout="paged", page_size=8, gather_granularity="page")])
def test_engine_forms_bit_identical_to_fused_paged(models, fused_unique, form):
    """On a trace of unique prompts every form equals the fused paged engine
    in tokens, every logit and the method log."""
    _, _, tm, tparams = models
    fe, fr, frep = fused_unique
    oe, orq, orep = _run(DecodeEngine, Request, tm, tparams,
                         _unique_specs(np.random.default_rng(2), 512),
                         record_logits=True, **form)
    for a, b in zip(fr, orq):
        assert a.generated == b.generated, a.uid
        assert len(a.logits_log) == len(b.logits_log)
        for la, lb in zip(a.logits_log, b.logits_log):
            np.testing.assert_array_equal(la, lb)
    assert oe.method_log == fe.method_log
    assert orep.gvr_hit_rate == frep.gvr_hit_rate > 0


def test_dense_engine_tokens_equal_paged_on_shared_prefixes(models):
    """With shared prefixes the paged engine skips the cached prompt tokens
    and the dense one prefills them: tokens still agree."""
    _, _, tm, tparams = models
    (_, dr, _), (_, pr, prep) = [
        _run(DecodeEngine, Request, tm, tparams,
             _shared_prefix_specs(np.random.default_rng(7), 512), **kw)
        for kw in (dict(kv_layout="dense"), dict(kv_layout="paged", page_size=8))]
    assert prep.prefix_hit_tokens > 0
    for a, b in zip(dr, pr):
        assert a.generated == b.generated, a.uid
