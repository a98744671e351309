"""The speculative verify slice of the port against the JAX package, on the
llama3.2-1b smoke config (float32) with the JAX parameters carried over
through `repro_torch.bridge`: the drafters, kernels B8 and B9 (their plain
versions, on CPU tensors) against the Pallas kernels in interpret mode, the
mq DSA forms, `serve_step_spec_paged` (scan and mq, fused / gather / page,
above and below the DSA gate) and the speculative engine. Inputs are made
with numpy from seeds; the engine traces are those of `tests/test_spec.py`
(`_trace`) and `tests/test_mq_verify.py` (`_reqs`).

Tolerances: Top-K indices are exact, and so are Top-K values on
integer-valued inputs; other float outputs agree within rtol = atol = 1e-5;
logits of whole steps within rtol = 1e-5, atol = 5e-4 (the bound of
`test_torch_model.py`), with equal argmax.

The port's own invariants hold bit for bit on the CPU: spec == non-spec in
tokens, method log and every recorded logit (scan form), and mq == scan in
tokens, method log, report counters and the rolled-back state. The mq
logits differ from the scan's in the last bits, and only through the tied
output projection: on this CPU build `x @ embed.T` rounds differently at
M = B*(d+1) rows than at M = B (`test_mq_logits_differ_from_scan_only_in_the_head`
pins that cause; ROADMAP Queue C).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels import ops as jops
from repro.models.api import build_model as jax_build
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import NgramDrafter as JaxNgram
from repro.serve import ReplayDrafter as JaxReplay
from repro.serve import Request as JaxRequest
from repro.sparse import dsa as jdsa
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models import transformer
from repro_torch.models.api import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.serve import (DECODE, DecodeEngine, ModelDrafter,
                               NgramDrafter, ReplayDrafter, Request,
                               ScriptedDrafter)
from repro_torch.sparse import dsa as tdsa

MAX_LEN = 64
VOCAB = 512
RNG = np.random.default_rng(13)
SPEC_REPORT = ("ticks", "decoded_tokens", "prefill_tokens", "completed",
               "method_counts", "prefill_method_counts",
               "decode_method_counts", "preemptions", "prefix_hit_tokens",
               "spec_ticks", "spec_drafted", "spec_accepted",
               "gvr_hit_rate_by_draft_pos")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_config("llama3.2-1b", smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


# ---------------------------------------------------------- drafters ------

class _Req:
    def __init__(self, uid, prompt, generated=()):
        self.uid = uid
        self.prompt = np.asarray(prompt, np.int32)
        self.generated = list(generated)


def test_ngram_drafter_matches_most_recent_occurrence():
    d = NgramDrafter(max_ngram=2)
    req = _Req(0, [5, 7, 8, 9, 1, 2, 7, 8])
    assert d.draft(req, 2) == [9, 1]
    assert d.draft(req, 4) == [9, 1, 2, 7]
    assert NgramDrafter(max_ngram=3, min_ngram=2).draft(
        _Req(1, [1, 2, 3, 4, 5]), 4) == []
    # the longer n-gram wins over a shorter, more recent one
    assert NgramDrafter(max_ngram=2).draft(_Req(0, [4, 7, 3, 4, 9, 3, 4]), 1) == [9]
    with pytest.raises(ValueError):
        NgramDrafter(max_ngram=1, min_ngram=2)


def test_replay_and_scripted_drafters():
    r = ReplayDrafter({0: [10, 11, 12, 13]})
    req = _Req(0, [1, 2], generated=[10, 11])
    assert r.draft(req, 3) == [12, 13]
    assert r.draft(_Req(9, [1]), 3) == []
    assert ScriptedDrafter(lambda rq, d: [1] * 10).draft(req, 3) == [1, 1, 1]


def test_host_drafters_match_the_jax_package():
    rng = np.random.default_rng(5)
    for _ in range(40):
        ctx = rng.integers(0, 4, (int(rng.integers(1, 30)),))
        req = _Req(0, ctx[:3], generated=ctx[3:])
        depth = int(rng.integers(1, 5))
        for n in (1, 2, 3):
            assert (NgramDrafter(max_ngram=n).draft(req, depth)
                    == JaxNgram(max_ngram=n).draft(req, depth))
        cont = {0: list(rng.integers(0, 9, (12,)))}
        assert ReplayDrafter(cont).draft(req, depth) == JaxReplay(cont).draft(req, depth)


# ----------------------------------------------------------------- B8 -----

def _pools(p, ps, kvh, d):
    return (RNG.normal(size=(p, ps, kvh, d)).astype(np.float32),
            RNG.normal(size=(p, ps, kvh, d)).astype(np.float32))


def _mq_table():
    table = np.full((2, 4), -1, np.int32)
    table[0, :3] = [2, 0, 5]
    table[1, :4] = [1, 3, 4, 6]
    return table


@pytest.mark.parametrize("kvh,h", [(2, 4), (2, 8)])
def test_b8_mq_attention_matches_pallas(kvh, h):
    """Entries lie in [0, length) or are -1: the Pallas kernel's masks (idx
    < 0, unmapped page) and the served ones then agree."""
    b, qn, d, p, ps, k = 2, 3, 8, 9, 8, 8
    kp, vp = _pools(p, ps, kvh, d)
    table = _mq_table()
    q = RNG.normal(size=(b, qn, h, d)).astype(np.float32)
    lengths = np.array([[20, 21, 22], [28, 29, 30]], np.int32)
    idx = np.stack([[RNG.integers(0, lengths[i, j], (k,)) for j in range(qn)]
                    for i in range(b)]).astype(np.int32)
    idx[0, 1, -2:] = -1
    want = jops.paged_sparse_decode_attn_mq(jnp.asarray(q), jnp.asarray(kp),
                                            jnp.asarray(vp), jnp.asarray(table),
                                            jnp.asarray(idx))
    got = ops.paged_sparse_decode_attn_mq(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(idx), _t(lengths))
    assert got.shape == (b, qn, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert ops.paged_sparse_decode_attn_mq.launches == 0


def test_b8_masks_entries_beyond_each_rows_length():
    """The served form masks idx >= length per query row, as the verify tick
    needs (the rows later positions wrote are in the current page); the
    Pallas kernel does not. Each query row equals B3 over the slots."""
    b, qn, kvh, h, d, p, ps, k = 2, 3, 2, 4, 8, 9, 8, 10
    kp, vp = _pools(p, ps, kvh, d)
    table = _mq_table()
    q = RNG.normal(size=(b, qn, h, d)).astype(np.float32)
    lengths = np.array([[15, 16, 17], [6, 7, 8]], np.int32)
    idx = RNG.integers(0, 24, (b, qn, k)).astype(np.int32)
    idx[:, :, 0] = 16                       # beyond row 0's length, not row 2's
    masked = np.where(idx < lengths[..., None], idx, -1).astype(np.int32)
    got = ops.paged_sparse_decode_attn_mq(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(idx), _t(lengths))
    want = jops.paged_sparse_decode_attn_mq(jnp.asarray(q), jnp.asarray(kp),
                                            jnp.asarray(vp), jnp.asarray(table),
                                            jnp.asarray(masked))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    unmasked = jops.paged_sparse_decode_attn_mq(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(idx))
    assert not np.allclose(got.numpy(), np.asarray(unmasked), atol=1e-3)
    for j in range(qn):
        assert torch.equal(got[:, j], ops.paged_sparse_decode_attn(
            _t(q[:, j]), _t(kp), _t(vp), _t(table), _t(idx[:, j]),
            _t(lengths[:, j])))


# ----------------------------------------------------------------- B9 -----

def _b9_inputs(integer_valued):
    b, qn, h, d, p, ps, k = 2, 3, 4, 8, 9, 8, 8
    if integer_valued:
        pages = RNG.integers(-2, 3, (p, ps, d)).astype(np.float32)
        q = RNG.integers(-2, 3, (b, qn, h, d)).astype(np.float32)
        w = np.full((h,), 0.25, np.float32)
    else:
        pages = RNG.normal(size=(p, ps, d)).astype(np.float32)
        q = RNG.normal(size=(b, qn, h, d)).astype(np.float32)
        w = np.abs(RNG.normal(size=(h,))).astype(np.float32)
    prev = RNG.integers(0, 20, (b, k)).astype(np.int32)
    prev[1, :3] = -1                                   # recycled entries
    lengths = np.stack([np.arange(qn) + 15, np.arange(qn) + 20]).astype(np.int32)
    return q, pages, w, _mq_table(), prev, lengths, k


@pytest.mark.parametrize("integer_valued", [True, False])
def test_b9_mq_indexer_topk_matches_pallas(integer_valued):
    q, pages, w, table, prev, lengths, k = _b9_inputs(integer_valued)
    jv, ji, _ = jops.paged_indexer_topk_mq(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(w), jnp.asarray(table),
        jnp.asarray(prev), k, lengths=jnp.asarray(lengths))
    tv, ti, ts = ops.paged_indexer_topk_mq(_t(q), _t(pages), _t(w), _t(table),
                                           _t(prev), k, lengths=_t(lengths))
    assert ts.shape == q.shape[:2] + (8,)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if integer_valued:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    assert ops.gvr_topk_chain.launches == ops.paged_indexer_scores_mq.launches == 0


def test_b9_chain_equals_sequential_b2():
    """Row q equals B2 on the same slot at its own length, warm-started
    from row q-1's output: score rows, values, indices and all 8 stats."""
    q, pages, w, table, prev, lengths, k = _b9_inputs(False)
    args = (_t(pages), _t(w), _t(table))
    scores = ops.paged_indexer_scores_mq(_t(q), *args, _t(lengths))
    vals, idx, stats = ops.paged_indexer_topk_mq(_t(q), *args, _t(prev), k,
                                                 lengths=_t(lengths))
    pv = _t(prev)
    for j in range(q.shape[1]):
        s1 = ops.paged_indexer_scores(_t(q[:, j]), *args, _t(lengths[:, j]))
        v1, i1, st1 = ops.paged_indexer_topk(_t(q[:, j]), *args, pv, k,
                                             lengths=_t(lengths[:, j]))
        assert torch.equal(scores[:, j], s1)
        assert torch.equal(vals[:, j], v1) and torch.equal(idx[:, j], i1)
        assert torch.equal(stats[:, j], st1)
        pv = i1


def test_mq_wrappers_reject_bad_shapes():
    q, pages, w, table, prev, lengths, k = _b9_inputs(True)
    with pytest.raises(ValueError, match="exactly K"):
        ops.paged_indexer_topk_mq(_t(q), _t(pages), _t(w), _t(table),
                                  _t(prev[:, :5]), k, lengths=_t(lengths))
    kp, vp = _pools(9, 8, 2, 8)
    with pytest.raises(ValueError, match="lengths"):
        ops.paged_sparse_decode_attn_mq(_t(q), _t(kp), _t(vp), _t(table),
                                        _t(prev[:, None].repeat(3, 1)),
                                        _t(lengths[:, :2]))


# ------------------------------------------------------- DSA mq forms -----

@pytest.mark.parametrize("granularity", ["token", "page"])
def test_dsa_sparse_attention_paged_mq_matches_jax(granularity):
    b, qn, kvh, h, d, p, ps, k = 2, 3, 2, 4, 8, 9, 8, 8
    kp, vp = _pools(p, ps, kvh, d)
    table = _mq_table()
    q = RNG.normal(size=(b, qn, h, d)).astype(np.float32)
    idx = RNG.integers(-1, 24, (b, qn, k)).astype(np.int32)
    lens = RNG.integers(10, 24, (b, qn)).astype(np.int32)
    want = jdsa.dsa_sparse_attention_paged_mq(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(idx), jnp.asarray(lens), scale=0.35, granularity=granularity)
    got = tdsa.dsa_sparse_attention_paged_mq(
        _t(q), _t(kp), _t(vp), _t(table), _t(idx), _t(lens), scale=0.35,
        granularity=granularity)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("selector", ["auto", "radix"])
def test_dsa_select_paged_mq_matches_the_jax_row_chain(models, selector):
    """The mq selection equals the reference's per-row `dsa_select` chain
    (`_paged_verify_mq`: row 0 under prev_valid, later rows warm from the
    row before and valid) in indices and in the per-row GVR report."""
    _, jparams, _, tparams = models
    cfg = get_config("llama3.2-1b", smoke=True)
    jidx = jax.tree.map(lambda a: a[0], jparams["layers"]["indexer"])
    tidx = layer_params(tparams["layers"], 0)["indexer"]
    b, qn, p, ps, mp = 3, 3, 24, 8, 8
    pages = RNG.normal(size=(p, ps, cfg.dsa.indexer_dim)).astype(np.float32)
    table = RNG.permutation(p).astype(np.int32).reshape(b, mp)
    table[1, 5:] = -1
    x = RNG.normal(size=(b, qn, cfg.d_model)).astype(np.float32)
    lengths = np.array([40, 20, 9], np.int32)[:, None] + np.arange(1, qn + 1)
    lengths = lengths.astype(np.int32)
    prev = RNG.integers(0, 9, (b, cfg.dsa.k)).astype(np.int32)
    valid = np.array([True, False, True])
    kw = dict(k=cfg.dsa.k, heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
              rope_base=cfg.rope_base, selector=selector, min_n=cfg.dsa.min_n)
    sel = tdsa.dsa_select_paged_mq(tidx, _t(x), _t(pages), _t(table), _t(prev),
                                   _t(lengths), prev_valid=_t(valid), **kw)
    view = jnp.asarray(pages[np.clip(table, 0, p - 1)].reshape(b, mp * ps, -1))
    jprev, jvalid = jnp.asarray(prev), jnp.asarray(valid)
    for j in range(qn):
        js = jdsa.dsa_select(jidx, jnp.asarray(x[:, j]), view, jprev,
                             jnp.asarray(lengths[:, j]), prev_valid=jvalid, **kw)
        np.testing.assert_array_equal(sel.indices[:, j].numpy(), np.asarray(js.indices))
        np.testing.assert_array_equal(sel.gvr_rows[:, j].numpy(), np.asarray(js.gvr_rows))
        jprev, jvalid = js.indices, jnp.ones_like(jvalid)
    assert sel.gvr_rows.any() == (selector == "auto")


# ------------------------------------------------ serve_step_spec_paged ---

def _configs(min_n):
    jcfg = jax_config("llama3.2-1b", smoke=True)
    tcfg = get_config("llama3.2-1b", smoke=True)
    if min_n is not None:
        jcfg = dataclasses.replace(jcfg, dsa=dataclasses.replace(jcfg.dsa, min_n=min_n))
        tcfg = dataclasses.replace(tcfg, dsa=dataclasses.replace(tcfg.dsa, min_n=min_n))
    return jcfg, tcfg


def _spec_state(tm, rng, lengths, b=3, ps=8):
    """A random paged state: pools, a shuffled table mapping [0, length + 3]
    of each slot, lengths, random feedback (slot 1 cold)."""
    cfg = tm.cfg
    mp = MAX_LEN // ps
    st = tm.init_paged_decode_state(b, MAX_LEN, num_pages=b * mp, page_size=ps)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    for s, length in enumerate(lengths):
        table[s, (length + 3) // ps + 1:] = -1
    st["page_table"] = _t(table)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        st[key] = _t(rng.normal(size=st[key].shape).astype(np.float32))
    st["length"] = _t(np.array(lengths, np.int32))
    l, kk = cfg.n_layers, cfg.dsa.k
    st["prev_topk"] = _t(rng.integers(0, min(lengths), (l, b, kk)).astype(np.int32))
    st["topk_valid"] = _t(np.array([[True, False, True]] * l))
    return st


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def _accepting_tokens(tm, tparams, st, tokens, verify_kernel="scan", **kw):
    """Drafts that make slot 0 accept both, slot 1 (draft_len 1) reject and
    slot 2 verify its input token only: two preliminary verify ticks read
    the argmax of positions 0 and 1."""
    tokens = tokens.copy()
    dl = np.array([2, 1, 0], np.int32)
    for j in (1, 2):
        out = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                       draft_len=_t(dl), max_accept=_t(dl),
                                       verify_kernel=verify_kernel, **kw)[0]
        tokens[:, j] = out[:, j - 1].numpy()
    tokens[1, 1] = (tokens[1, 1] + 1) % VOCAB
    return tokens, dl


@pytest.mark.parametrize("verify_kernel", ["scan", "mq"])
@pytest.mark.parametrize("form,min_n", [
    ("fused", None), ("gather", None), ("page", None),
    ("fused", 64), ("gather", 64), ("page", 64)])
def test_serve_step_spec_paged_matches_jax(models, verify_kernel, form, min_n):
    _, jparams, _, tparams = models
    jcfg, tcfg = _configs(min_n)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    kw = dict(paged_attn="gather" if form == "gather" else "fused",
              gather_granularity="page" if form == "page" else "token")
    rng = np.random.default_rng(8)
    st = _spec_state(tm, rng, [30, 12, 50])
    tokens, dl = _accepting_tokens(
        tm, tparams, st, rng.integers(0, VOCAB, (3, 3)).astype(np.int32), **kw)
    mwp = np.zeros((3,), np.int32)
    max_accept = np.array([2, 1, 0], np.int32)
    js = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    jout = jm.serve_step_spec_paged(
        jparams, js, jnp.asarray(tokens), draft_len=jnp.asarray(dl),
        max_accept=jnp.asarray(max_accept), min_write_pos=jnp.asarray(mwp),
        verify_kernel=verify_kernel, **kw)
    tout = tm.serve_step_spec_paged(
        tparams, _clone(st), _t(tokens), draft_len=_t(dl),
        max_accept=_t(max_accept), min_write_pos=_t(mwp),
        verify_kernel=verify_kernel, **kw)
    names = ("out_tokens", "accept_len", "logits", "sel_gvr_pos")
    for name, a, c in zip(names, tout[:4], jout[:4]):
        if name == "logits":
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=5e-4)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=name)
    np.testing.assert_array_equal(tout[1].numpy(), [2, 0, 0])
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        np.testing.assert_array_equal(tout[4][key].numpy(), np.asarray(jout[4][key]),
                                      err_msg=key)
    for key in ("k_pages", "v_pages", "idx_k_pages"):   # the sink page aside
        np.testing.assert_allclose(tout[4][key][:, :-1].numpy(),
                                   np.asarray(jout[4][key])[:, :-1],
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert bool(tout[3].any()) == (min_n is None)


def test_mq_logits_differ_from_scan_only_in_the_head(models, monkeypatch):
    """One DSA verify tick from one state: mq and scan agree bit for bit in
    tokens, acceptance and the rolled-back state; their logits agree bit
    for bit once the mq body runs the output projection position by
    position (M = B rows, as the scan does), so the head GEMM's row count
    is the only source of the difference."""
    _, _, tm, tparams = models
    rng = np.random.default_rng(9)
    st = _spec_state(tm, rng, [30, 12, 50])
    tokens, dl = _accepting_tokens(
        tm, tparams, st, rng.integers(0, VOCAB, (3, 3)).astype(np.int32))
    args = dict(draft_len=_t(dl), max_accept=_t(dl))
    scan = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                    verify_kernel="scan", **args)
    mq = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                  verify_kernel="mq", **args)
    for a, c in zip((scan[0], scan[1], scan[3]), (mq[0], mq[1], mq[3])):
        assert torch.equal(a, c)
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        assert torch.equal(scan[4][key], mq[4][key]), key
    # frozen positions (j > draft_len) compute garbage in both bodies
    live = [(s, j) for s in range(3) for j in range(dl[s] + 1)]
    assert any(not torch.equal(mq[2][s, j], scan[2][s, j]) for s, j in live)
    for s, j in live:
        torch.testing.assert_close(mq[2][s, j], scan[2][s, j], rtol=1e-6, atol=1e-5)
    head = transformer._lm_head
    monkeypatch.setattr(transformer, "_lm_head", lambda p, x, cfg, *lay: torch.stack(
        [head(p, x[:, j], cfg, *lay) for j in range(x.shape[1])], 1)
        if x.dim() == 3 else head(p, x, cfg, *lay))
    mq_rows = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                       verify_kernel="mq", **args)
    for s, j in live:
        assert torch.equal(mq_rows[2][s, j], scan[2][s, j]), (s, j)


# ------------------------------------------------------------ engines -----

def _trace(req_cls, seed=3):
    """tests/test_spec.py:_trace."""
    rng = np.random.default_rng(seed)
    return [req_cls(uid=0, prompt=rng.integers(0, VOCAB, (9,)), max_new_tokens=8),
            req_cls(uid=1, prompt=rng.integers(0, VOCAB, (14,)), max_new_tokens=6,
                    arrival=2),
            req_cls(uid=2, prompt=rng.integers(0, VOCAB, (5,)), max_new_tokens=7,
                    arrival=5)]


def _reqs(req_cls, seed=3):
    """tests/test_mq_verify.py:_reqs — one cold row, one warm row."""
    rng = np.random.default_rng(seed)
    return [req_cls(uid=0, prompt=rng.integers(1, VOCAB, size=3), max_new_tokens=12),
            req_cls(uid=1, prompt=rng.integers(1, VOCAB, size=17), max_new_tokens=12)]


def _engine(engine_cls, model, params, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 4)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("page_size", 8)
    return engine_cls(model, params, **kw)


def _methods(eng, reqs):
    """Per-request (phase, method) sequence: spec ticks compress the tick
    numbers, the sequence of selector decisions stays."""
    return {r.uid: [(ph, m) for _, ph, m in eng.method_log[r.uid]] for r in reqs}


@pytest.fixture(scope="module")
def nonspec(models):
    """The non-speculative run of `_trace` in both engines (they agree)."""
    jm, jparams, tm, tparams = models
    jr, tr = _trace(JaxRequest), _trace(Request)
    _engine(JaxEngine, jm, jparams).run(jr, max_ticks=500)
    eng = _engine(DecodeEngine, tm, tparams, record_logits=True)
    rep = eng.run(tr, max_ticks=500)
    assert [r.generated for r in tr] == [r.generated for r in jr]
    return dict(tokens=[list(r.generated) for r in tr],
                logits=[list(r.logits_log) for r in tr],
                methods=_methods(eng, tr), report=rep)


def _assert_nonspec_page_shape(eng):
    """tests/test_spec.py:_assert_nonspec_page_shape: after any tick a
    DECODE slot's mapped logical pages are exactly those covering [0,
    length), as non-speculative decode keeps them."""
    lengths = eng.state["length"].numpy()
    for s, req in enumerate(eng.slots):
        if req is None or req.phase != DECODE:
            continue
        want = list(range((int(lengths[s]) - 1) // eng.kv.page_size + 1))
        got = [lp for lp in range(eng.kv.pages_per_slot)
               if eng.kv.tables[s].get(lp) >= 0]
        assert got == want, (s, int(lengths[s]), got, want)
    eng.kv.pool.assert_consistent()


def test_spec_eos_truncates_acceptance(models):
    _, _, tm, tparams = models
    prompt = np.random.default_rng(6).integers(0, VOCAB, (6,))
    base = _engine(DecodeEngine, tm, tparams, num_slots=2)
    rb = Request(uid=0, prompt=prompt, max_new_tokens=10)
    base.run([rb], max_ticks=300)
    cut = next(i for i in range(len(rb.generated))
               if rb.generated[i] not in rb.generated[:i])
    eos = rb.generated[cut]
    for vk in ("scan", "mq"):
        eng = _engine(DecodeEngine, tm, tparams, num_slots=2, eos_id=eos,
                      spec_depth=6, verify_kernel=vk,
                      drafter=ReplayDrafter({0: list(rb.generated)}))
        r = Request(uid=0, prompt=prompt, max_new_tokens=10)
        eng.run([r], max_ticks=300)
        assert r.generated == rb.generated[:cut + 1] and r.phase == "DONE"


def test_spec_sampled_requests_decode_unspeculated(models):
    """A sampled request verifies at depth 0: its tokens are the
    non-speculative sampled run's, and it is never asked for a draft."""
    _, _, tm, tparams = models

    def mk():
        rng = np.random.default_rng(17)
        return [Request(uid=0, prompt=rng.integers(0, VOCAB, (7,)),
                        max_new_tokens=5, temperature=0.8, top_p=0.9),
                Request(uid=1, prompt=rng.integers(0, VOCAB, (9,)),
                        max_new_tokens=5)]

    rb = mk()
    _engine(DecodeEngine, tm, tparams).run(rb, max_ticks=300)
    calls = []

    class Spy(ReplayDrafter):
        def draft(self, req, depth):
            calls.append(req.uid)
            return super().draft(req, depth)

    for vk in ("scan", "mq"):
        eng = _engine(DecodeEngine, tm, tparams, spec_depth=3, verify_kernel=vk,
                      drafter=Spy({1: list(rb[1].generated)}))
        rs = mk()
        eng.run(rs, max_ticks=300)
        assert [r.generated for r in rs] == [r.generated for r in rb]
    assert 0 not in calls and 1 in calls


def test_engine_spec_options_validated(models):
    _, _, tm, tparams = models
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(tm, tparams, num_slots=2, max_len=MAX_LEN, spec_depth=2)
    with pytest.raises(ValueError, match="verify_kernel"):
        _engine(DecodeEngine, tm, tparams, verify_kernel="warp")
    with pytest.raises(ValueError, match="spec_depth"):
        _engine(DecodeEngine, tm, tparams, spec_depth=-1)
    with pytest.raises(ValueError, match="spec_depth"):
        Request(uid=0, prompt=np.ones(3, np.int32), spec_depth=-1)
    eng = _engine(DecodeEngine, tm, tparams, spec_depth=2)
    assert isinstance(eng.drafter, NgramDrafter)


# ------------------------------------------------------- ModelDrafter -----

def test_model_drafter_batch_equals_per_slot(models):
    """`draft_batch` (one batched step per position, finished rows frozen
    by `min_write_pos`) gives the per-slot `draft` loop's tokens."""
    _, _, tm, tparams = models

    class SoloOnly(ModelDrafter):
        draft_batch = None

    def run(cls):
        eng = _engine(DecodeEngine, tm, tparams, num_slots=3, spec_depth=3,
                      drafter=cls(tm, tparams, max_len=MAX_LEN))
        rng = np.random.default_rng(7)
        reqs = [Request(uid=i, prompt=rng.integers(1, VOCAB, size=5 + i),
                        max_new_tokens=8 + i) for i in range(3)]
        rep = eng.run(reqs, max_ticks=2000)
        assert rep.completed == len(reqs)
        return {r.uid: list(r.generated) for r in reqs}, rep.spec_acceptance_rate

    assert run(ModelDrafter) == run(SoloOnly)


def test_model_drafter_self_speculation_and_release(models, nonspec):
    _, _, tm, tparams = models
    drafter = ModelDrafter(tm, tparams, max_len=MAX_LEN)
    eng = _engine(DecodeEngine, tm, tparams, spec_depth=3, drafter=drafter,
                  verify_kernel="mq")
    reqs = _trace(Request)
    rep = eng.run(reqs, max_ticks=500)
    assert [r.generated for r in reqs] == nonspec["tokens"]
    assert rep.spec_acceptance_rate == 1.0
    assert not drafter._ctx                 # released at every retirement


def test_model_drafter_by_name_uses_the_ports_own_init():
    d = ModelDrafter("llama3.2-1b", max_len=MAX_LEN, device="cpu", seed=3)
    want = build_model(get_config("llama3.2-1b", smoke=True),
                       device="cpu").init_params(3)
    assert torch.equal(d.params["embed"], want["embed"])
    assert len(d.draft(_Req(0, [1, 2, 3]), 2)) == 2
    with pytest.raises(ValueError):
        ModelDrafter(d.model, None, max_len=MAX_LEN)
