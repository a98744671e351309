"""The engines of the rest of the dense family against the JAX engines, on
the smoke configs of h2o-danube-3-4b, chatglm3-6b, granite-34b and
qwen2-vl-7b (float32, the JAX parameters carried over through
`repro_torch.bridge`).

The trace: two slots, max_len 128, prefill chunk 16, prompts of 80 and 11
tokens made with numpy from a seed, 6 new tokens each. DSA runs from the
first step (max_len > min_n = 8); danube's window of 64 cuts every row of
the 80-token request from its 65th position on. Tokens, the per-tick
method log and the `EngineReport` counters must equal the JAX engine's, in
the dense and the paged layout, and the two layouts must agree. On danube
the window is shown to matter: without it request 0's tokens change
(request 1, shorter than the window, keeps its own). The speculative
engine on danube is in `test_torch_dense_family_spec.py`, and the
engines of chatglm3-6b and granite-34b in
`test_torch_dense_family_engine_gqa.py` (moved there so that no test file
runs past the tier-1 budget).
"""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jax_config
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import Request as JaxRequest
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.serve import DecodeEngine, Request

REPORT_FIELDS = ("ticks", "decoded_tokens", "prefill_tokens", "completed",
                 "method_counts", "prefill_method_counts",
                 "decode_method_counts", "preemptions", "prefix_hit_tokens",
                 "peak_page_utilization")
SPEC_FIELDS = REPORT_FIELDS[:-1] + ("spec_ticks", "spec_drafted",
                                    "spec_accepted",
                                    "gvr_hit_rate_by_draft_pos")
MAX_LEN = 128


def _models(arch, **replace):
    jcfg = dataclasses.replace(jax_config(arch, smoke=True), **replace)
    tcfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jm = jax_build(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(tcfg, device="cpu"), tparams


def _trace(req_cls, vocab):
    rng = np.random.default_rng(2)
    return [req_cls(uid=0, prompt=rng.integers(0, vocab, (80,)), max_new_tokens=6),
            req_cls(uid=1, prompt=rng.integers(0, vocab, (11,)), max_new_tokens=6)]


def _run(engine_cls, req_cls, model, params, **kw):
    reqs = _trace(req_cls, model.cfg.vocab)
    eng = engine_cls(model, params, num_slots=2, max_len=MAX_LEN,
                     prefill_chunk=16, **kw)
    return eng, reqs, eng.run(reqs, max_ticks=500)


def engines_match_jax(arch):
    """Both engines against the JAX engines on `arch`, and paged == dense
    (danube: the window crossed, and shown to matter)."""
    jm, jparams, tm, tparams = _models(arch)
    runs = {}
    for layout, kw in (("dense", dict(kv_layout="dense")),
                       ("paged", dict(kv_layout="paged", page_size=8))):
        je, jr, jrep = _run(JaxEngine, JaxRequest, jm, jparams, **kw)
        te, tr, trep = _run(DecodeEngine, Request, tm, tparams, **kw)
        for a, c in zip(jr, tr):
            assert a.generated == c.generated, (layout, a.uid)
        assert te.method_log == je.method_log, layout
        for f in REPORT_FIELDS:
            assert getattr(trep, f) == getattr(jrep, f), (layout, f)
        assert trep.completed == 2 and trep.gvr_hit_rate > 0
        runs[layout] = (te, tr)
    (de, dr), (pe, pr) = runs["dense"], runs["paged"]
    assert pe.method_log == de.method_log
    assert [r.generated for r in pr] == [r.generated for r in dr]
    if arch == "h2o-danube-3-4b":
        # non-vacuity: the trace crosses the window, and the window matters
        assert len(dr[0].prompt) > tm.cfg.swa_window > len(dr[1].prompt)
        _, _, free, _ = _models(arch, swa_window=None)
        _, fr, _ = _run(DecodeEngine, Request, free, tparams, kv_layout="paged",
                        page_size=8)
        assert fr[0].generated != pr[0].generated
        assert fr[1].generated == pr[1].generated


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "qwen2-vl-7b"])
def test_engines_match_jax_and_paged_equals_dense(arch):
    engines_match_jax(arch)


