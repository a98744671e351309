"""The engine traces of the sequence-sharded tests, for either package's
`DecodeEngine` (the JAX package's `tests/test_sp_engine.py` traces).

`cov`: two prompts share a 24-token (3-page) prefix that spans the shard
boundary at S = 4 and a third arrives between them; `pre`: two requests
whose pages stay in shard 0's span at S = 2, with 5 pages a shard, so
both layouts preempt. `engine_runs` drives both, then, for the port, the
`cov` trace again at spec_depth 3: oracle drafts through the scan verify
and every third draft wrong through the mq verify."""

from __future__ import annotations

import numpy as np

ENGINE_KW = dict(num_slots=2, max_len=64, prefill_chunk=4, kv_layout="paged",
                 page_size=8)


def cov_specs(vocab, seed=5):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, (24,))
    return [(np.concatenate([shared, rng.integers(0, vocab, (13,))]), 8, 0),
            (np.concatenate([shared, rng.integers(0, vocab, (6,))]), 6, 20),
            (rng.integers(0, vocab, (40,)), 10, 6)]


def pre_specs(vocab, seed=9):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, (20,)), 8, 0),
            (rng.integers(0, vocab, (12,)), 16, 0)]


def run_trace(engine_cls, request_cls, model, params, specs, **kw):
    eng = engine_cls(model, params, **ENGINE_KW, **kw)
    reqs = [request_cls(uid=i, prompt=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(specs)]
    rep = eng.run(reqs, max_ticks=500)
    if hasattr(eng.kv, "assert_consistent"):
        eng.kv.assert_consistent()
    return {"tokens": [[int(t) for t in r.generated] for r in reqs],
            "log": {str(u): [list(e) for e in v]
                    for u, v in sorted(eng.method_log.items())},
            "hit": rep.gvr_hit_rate, "decode_counts": rep.decode_method_counts,
            "prefix": rep.prefix_hit_tokens, "preempt": rep.preemptions,
            "completed": rep.completed, "accept": rep.spec_acceptance_rate}


def engine_runs(model, params, pre: bool = True, spec: bool = True, **kw):
    """The port's runs (the sharded engine with `seq_shards`/`mesh` in
    kw, the fused single-device engine without): `cov`, and `pre` and the
    speculative legs where asked."""
    from repro_torch.serve import (DecodeEngine, ReplayDrafter, Request,
                                   ScriptedDrafter)
    vocab = model.cfg.vocab
    out = {"cov": run_trace(DecodeEngine, Request, model, params,
                            cov_specs(vocab), **kw)}
    if pre:
        out["pre"] = run_trace(DecodeEngine, Request, model, params,
                               pre_specs(vocab), num_pages=5, **kw)
    if spec:
        cont = {i: t for i, t in enumerate(out["cov"]["tokens"])}

        def wrong_third(req, d):
            draft = list(cont[req.uid][len(req.generated):len(req.generated) + d])
            if len(draft) >= 3:
                draft[2] = (draft[2] + 1) % vocab
            return draft

        out["replay"] = run_trace(DecodeEngine, Request, model, params,
                                  cov_specs(vocab), spec_depth=3,
                                  drafter=ReplayDrafter(cont), **kw)
        out["partial"] = run_trace(DecodeEngine, Request, model, params,
                                   cov_specs(vocab), spec_depth=3,
                                   drafter=ScriptedDrafter(wrong_third),
                                   verify_kernel="mq", **kw)
    return out
