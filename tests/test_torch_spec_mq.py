"""The mq verify body against the scan with drafts from the target model
itself (`tests/test_mq_verify.py`'s pin), on the llama3.2-1b smoke config
with the JAX parameters (moved here from `test_torch_spec.py`, which keeps
the fixtures and helpers; `test_torch_spec_mq_pages.py` holds the cases at
spec depth 2, so that no test file runs past the tier-1 budget).

A cold and a warm row: tokens, the (phase, method) sequence, hit rate,
acceptance and tick count of mq (at token or page granularity) equal the
scan's at token granularity. The scan's trace of a (spec depth, page
size) is run once for the file (`scan_traces`) and shared by its cases.
"""

import pytest

from repro_torch.serve import DecodeEngine, ModelDrafter, Request

from test_torch_spec import MAX_LEN, _engine, _methods, _reqs, models


def mq_trace(models, spec_depth, page_size, vk, gran):
    """One engine run of `_reqs` with drafts from the target model."""
    _, _, tm, tparams = models
    eng = _engine(DecodeEngine, tm, tparams, spec_depth=spec_depth,
                  page_size=page_size, verify_kernel=vk,
                  gather_granularity=gran,
                  drafter=ModelDrafter(tm, tparams, max_len=MAX_LEN))
    reqs = _reqs(Request)
    rep = eng.run(reqs, max_ticks=2000)
    assert rep.completed == len(reqs)
    return ({r.uid: list(r.generated) for r in reqs}, _methods(eng, reqs),
            rep.gvr_hit_rate, rep.spec_acceptance_rate, rep.ticks)


@pytest.fixture(scope="module")
def scan_traces(models):
    """The scan body's trace at token granularity, by (spec depth, page
    size), run once a module."""
    cache = {}

    def get(spec_depth, page_size):
        key = (spec_depth, page_size)
        if key not in cache:
            cache[key] = mq_trace(models, spec_depth, page_size, "scan", "token")
        return cache[key]

    return get


@pytest.mark.parametrize("spec_depth,page_size,granularity", [
    (1, 8, "token"), (3, 4, "token")])
def test_mq_verify_equals_scan_with_model_drafts(models, scan_traces, spec_depth,
                                                 page_size, granularity):
    """tests/test_mq_verify.py's pin: a cold and a warm row, drafts from
    the target model itself; mq (and mq at page granularity) against scan
    at token granularity."""
    assert (mq_trace(models, spec_depth, page_size, "mq", granularity)
            == scan_traces(spec_depth, page_size))
