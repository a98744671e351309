"""The port's engine in its logical-view forms against the JAX engine
(moved here from `test_torch_layouts.py`, which keeps the fixtures and
helpers, so that no test file runs past the tier-1 budget): the dense
layout and the paged gather oracle, on a trace of shared prefixes and on
one that pages out and preempts, equal the JAX engine's tokens,
preemptions, method log and every report counter."""

import numpy as np
import pytest

from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch.serve import DecodeEngine, Request

from test_torch_layouts import (REPORT_FIELDS, _pressure_specs, _run,
                                _shared_prefix_specs, models)


@pytest.mark.parametrize("layout,trace", [
    ("dense", "shared_prefix"), ("dense", "page_pressure"),
    ("gather", "shared_prefix"), ("gather", "page_pressure")])
def test_engine_forms_match_jax_engine(models, layout, trace):
    jm, jparams, tm, tparams = models
    make = _shared_prefix_specs if trace == "shared_prefix" else _pressure_specs
    if layout == "dense":
        kw = dict(kv_layout="dense")
    else:
        kw = dict(kv_layout="paged", paged_attn="gather", page_size=8)
        if trace == "page_pressure":
            kw.update(num_pages=7, prefix_caching=False)
    je, jr, jrep = _run(JaxEngine, JaxRequest, jm, jparams,
                        make(np.random.default_rng(1), 512), **kw)
    te, tr, trep = _run(DecodeEngine, Request, tm, tparams,
                        make(np.random.default_rng(1), 512), **kw)
    for a, b in zip(jr, tr):
        assert a.generated == b.generated, a.uid
        assert a.preemptions == b.preemptions, a.uid
    assert te.method_log == je.method_log
    for f in REPORT_FIELDS:
        assert getattr(trep, f) == getattr(jrep, f), f
    if layout == "dense":
        assert te.kv is None and trep.prefix_hit_tokens == 0
    elif trace == "page_pressure":
        assert trep.preemptions >= 1
