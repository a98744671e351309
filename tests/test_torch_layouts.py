"""The logical-view decode forms of the port against the JAX package: the
dense KV layout, the paged gather oracle and the page-granular gather, on
the llama3.2-1b smoke config (float32) with the JAX parameters carried
over through `repro_torch.bridge`, and the kernels B5, B6, B7 and B10 (their
plain versions, on CPU tensors) against the Pallas kernels in interpret
mode. Inputs are made with numpy from seeds.

Tolerances: Top-K indices are exact, and so are Top-K values and scores on
integer-valued inputs (every product and sum is exact in float32); other
float outputs agree within rtol = atol = 1e-5 (the frameworks sum in other
orders). Logits of whole steps use the bound of `test_torch_model.py`:
rtol = 1e-5, atol = 5e-4 on logits of scale ~10.

The port's own invariants hold bit for bit on the CPU: paged == dense,
fused == gather and page == token, in tokens, logits and method log.
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
from repro.sparse import dsa as jdsa
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.models.api import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.sparse import dsa as tdsa

REPORT_FIELDS = ("ticks", "decoded_tokens", "prefill_tokens", "completed",
                 "method_counts", "prefill_method_counts",
                 "decode_method_counts", "preemptions", "prefix_hit_tokens",
                 "peak_page_utilization")
RNG = np.random.default_rng(12)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(b, mp, p, holes=()):
    table = np.stack([RNG.choice(p, mp, replace=False) for _ in range(b)]).astype(np.int32)
    for r, c in holes:
        table[r, c] = -1
    return table


@pytest.fixture(scope="module")
def models():
    jm = jax_build(jax_config("llama3.2-1b", smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


# ---------------------------------------------------------------- B5 ------

@pytest.mark.parametrize("w_per_slot", [False, True])
@pytest.mark.parametrize("integer_valued", [True, False])
def test_b5_indexer_topk_matches_pallas(integer_valued, w_per_slot):
    b, n, h, d, k = 3, 256, 4, 16, 24
    if integer_valued:
        kc = RNG.integers(-2, 3, (b, n, d)).astype(np.float32)
        q = RNG.integers(-2, 3, (b, h, d)).astype(np.float32)
        w = np.full((b, h) if w_per_slot else (h,), 0.25, np.float32)
    else:
        kc = RNG.normal(size=(b, n, d)).astype(np.float32)
        q = RNG.normal(size=(b, h, d)).astype(np.float32)
        w = np.abs(RNG.normal(size=(b, h) if w_per_slot else (h,))).astype(np.float32)
    lengths = np.array([n, 100, 13], np.int32)        # slot 2 shorter than K
    prev = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    prev[1, :4] = -1
    jv, ji, _ = jops.indexer_topk(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(w),
                                  jnp.asarray(prev), k, lengths=jnp.asarray(lengths))
    tv, ti, _ = ops.indexer_topk(_t(q), _t(kc), _t(w), _t(prev), k,
                                 lengths=_t(lengths))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if integer_valued:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
    assert ops.indexer_scores.launches == 0


def test_b5_scores_equal_b2_scores_over_the_same_keys():
    """The same keys laid out contiguously and in shuffled pages give the
    same score row, NEG beyond each length."""
    b, mp, ps, h, d = 2, 6, 4, 4, 8
    n = mp * ps
    table = _table(b, mp, b * mp)
    pages = RNG.normal(size=(b * mp, ps, d)).astype(np.float32)
    kc = pages[table].reshape(b, n, d)
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    w = np.abs(RNG.normal(size=(h,))).astype(np.float32)
    lengths = _t(np.array([n, 9], np.int32))
    s5 = ops.indexer_scores(_t(q), _t(kc), _t(w), lengths)
    s2 = ops.paged_indexer_scores(_t(q), _t(pages), _t(w), _t(table), lengths)
    assert torch.equal(s5, s2)
    assert (s5[1, 9:] < -1e38).all() and (s5[1, :9] > -1e38).all()


# ---------------------------------------------------------------- B6 ------

@pytest.mark.parametrize("kvh,h", [(2, 8), (4, 4)])
def test_b6_sparse_decode_attn_matches_pallas(kvh, h):
    b, n, d, k = 3, 40, 16, 16
    kc = RNG.normal(size=(b, n, kvh, d)).astype(np.float32)
    vc = RNG.normal(size=(b, n, kvh, d)).astype(np.float32)
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    idx = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    idx[1, 9:] = -1
    idx[2, :3] = [0, 1, 2]                    # valid entries below its length
    lengths = np.array([n, n, 11], np.int32)
    # the served path also masks idx >= length; the Pallas kernel only -1
    masked = np.where(idx < lengths[:, None], idx, -1).astype(np.int32)
    want = jops.sparse_decode_attn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                   jnp.asarray(masked))
    got = ops.sparse_decode_attn(_t(q), _t(kc), _t(vc), _t(idx), _t(lengths))
    assert (idx >= lengths[:, None]).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    served = jdsa.dsa_sparse_attention(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jnp.asarray(idx),
                                       jnp.asarray(lengths), scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(served), rtol=1e-5, atol=1e-5)


def test_b6_equals_b3_over_the_same_rows():
    b, mp, ps, kvh, h, d, k = 2, 5, 4, 2, 4, 8, 12
    n = mp * ps
    table = _table(b, mp, b * mp + 1)
    kp = RNG.normal(size=(b * mp + 1, ps, kvh, d)).astype(np.float32)
    vp = RNG.normal(size=(b * mp + 1, ps, kvh, d)).astype(np.float32)
    q = _t(RNG.normal(size=(b, h, d)).astype(np.float32))
    idx = _t(RNG.integers(-1, n, (b, k)).astype(np.int32))
    lengths = _t(np.array([n, 13], np.int32))
    o6 = ops.sparse_decode_attn(q, _t(kp[table].reshape(b, n, kvh, d)),
                                _t(vp[table].reshape(b, n, kvh, d)), idx, lengths)
    o3 = ops.paged_sparse_decode_attn(q, _t(kp), _t(vp), _t(table), idx, lengths)
    assert torch.equal(o6, o3)


# ---------------------------------------------------------------- B7 ------

@pytest.mark.parametrize("feat", [(2, 16), (8,)])
def test_b7_paged_gather_matches_pallas(feat):
    p, ps, b, mp = 7, 4, 2, 5
    pages = RNG.normal(size=(p, ps) + feat).astype(np.float32)
    table = _table(b, mp, p, holes=[(0, 3), (1, 0)])
    want = jops.paged_gather(jnp.asarray(pages), jnp.asarray(table))
    got = ops.paged_gather(_t(pages), _t(table))
    assert got.shape == (b, mp * ps) + feat
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got[0, 3 * ps:4 * ps] == 0).all()


# --------------------------------------------------------------- B10 ------

@pytest.mark.parametrize("kvh,h", [(2, 8), (4, 4)])
def test_b10_page_granular_attn_matches_pallas(kvh, h):
    p, ps, b, mp, d, k = 11, 4, 2, 6, 16, 10
    n = mp * ps
    kp = RNG.normal(size=(p, ps, kvh, d)).astype(np.float32)
    vp = RNG.normal(size=(p, ps, kvh, d)).astype(np.float32)
    table = _table(b, mp, p, holes=[(0, 2)])
    idx = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    idx[1, 6:] = -1
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    want = jops.paged_sparse_decode_attn_pg(jnp.asarray(q), jnp.asarray(kp),
                                            jnp.asarray(vp), jnp.asarray(table),
                                            jnp.asarray(idx))
    got = ops.paged_sparse_decode_attn_pg(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(idx), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b10_plain_matches_pallas_on_a_table_past_97536_positions():
    """1600 pages of 64 positions (102,400, past the 97,536 whose
    per-position counts once filled a CTA's shared memory on the card):
    both packages serve the width, entries spread over the whole table,
    some past 97,536, on aliased and unmapped pages."""
    rng = np.random.default_rng(97536)     # leaves the module's RNG alone
    b, kvh, h, d, ps, k, mp, p = 1, 1, 4, 32, 64, 64, 1600, 96
    n = mp * ps
    kp = rng.normal(size=(p, ps, kvh, d)).astype(np.float32)
    vp = rng.normal(size=(p, ps, kvh, d)).astype(np.float32)
    table = rng.integers(0, p, (b, mp)).astype(np.int32)
    table[0, ::97] = -1
    idx = np.concatenate([rng.choice(97536, k - 8, replace=False),
                          97536 + rng.choice(n - 97536, 8, replace=False)])
    idx = rng.permutation(idx)[None].astype(np.int32)
    if not (idx // ps == 970).any():
        idx[0, 0] = 970 * ps + 5            # on an unmapped page
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    want = jops.paged_sparse_decode_attn_pg(jnp.asarray(q), jnp.asarray(kp),
                                            jnp.asarray(vp), jnp.asarray(table),
                                            jnp.asarray(idx))
    got = ops.paged_sparse_decode_attn_pg(_t(q), _t(kp), _t(vp), _t(table),
                                          _t(idx), _t(np.full((b,), n, np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b10_plain_equals_token_granular_bit_for_bit():
    """Duplicates, -1 entries, entries past the length and on unmapped
    pages: the page-granular plain version restores Top-K order and so
    equals B3's plain version exactly."""
    p, ps, b, mp, kvh, h, d, k = 9, 4, 3, 6, 2, 4, 8, 20
    n = mp * ps
    kp = _t(RNG.normal(size=(p, ps, kvh, d)).astype(np.float32))
    vp = _t(RNG.normal(size=(p, ps, kvh, d)).astype(np.float32))
    table = _t(_table(b, mp, p, holes=[(2, 1)]))
    idx = RNG.integers(-1, n, (b, k)).astype(np.int32)
    idx[0, :5] = idx[0, 5]                            # duplicates
    lengths = _t(np.array([n, 10, 17], np.int32))
    q = _t(RNG.normal(size=(b, h, d)).astype(np.float32))
    args = (q, kp, vp, table, _t(idx), lengths)
    assert torch.equal(ops.paged_sparse_decode_attn_pg(*args),
                       ops.paged_sparse_decode_attn(*args))


def test_distinct_pages_and_gather_stats_match_jax():
    b, k, ps, mp = 3, 12, 4, 8
    idx = RNG.integers(-1, mp * ps, (b, k)).astype(np.int32)
    idx[2] = 5                                        # one page, all duplicates
    li = np.clip(idx, 0, mp * ps - 1)
    np.testing.assert_array_equal(
        tdsa.distinct_pages(_t(li).long(), page_size=ps, num_logical_pages=mp).numpy(),
        np.asarray(jdsa.distinct_pages(jnp.asarray(li), page_size=ps,
                                       num_logical_pages=mp)))
    np.testing.assert_array_equal(
        tdsa.page_gather_stats(_t(idx), page_size=ps, num_logical_pages=mp).numpy(),
        np.asarray(jdsa.page_gather_stats(jnp.asarray(idx), page_size=ps,
                                          num_logical_pages=mp)))


# ------------------------------------------------------- DSA block --------

def test_dsa_decode_matches_jax(models):
    _, jparams, _, tparams = models
    cfg = get_config("llama3.2-1b", smoke=True)
    jidx = jax.tree.map(lambda a: a[0], jparams["layers"]["indexer"])
    tidx = layer_params(tparams["layers"], 0)["indexer"]
    b, n = 3, 64
    x = RNG.normal(size=(b, cfg.d_model)).astype(np.float32)
    q = RNG.normal(size=(b, cfg.n_heads, cfg.hd)).astype(np.float32)
    kc = RNG.normal(size=(b, n, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    vc = RNG.normal(size=(b, n, cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    ikc = RNG.normal(size=(b, n, cfg.dsa.indexer_dim)).astype(np.float32)
    lengths = np.array([64, 30, 9], np.int32)         # slot 2 shorter than K
    prev = RNG.integers(0, 9, (b, cfg.dsa.k)).astype(np.int32)
    valid = np.array([True, False, True])
    kw = dict(k=cfg.dsa.k, scale=cfg.hd ** -0.5, heads=cfg.dsa.indexer_heads,
              dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base,
              min_n=cfg.dsa.min_n)
    jo = jdsa.dsa_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jidx,
                         jnp.asarray(x), jnp.asarray(ikc), jnp.asarray(prev),
                         jnp.asarray(lengths), prev_valid=jnp.asarray(valid), **kw)
    to = tdsa.dsa_decode(_t(q), _t(kc), _t(vc), tidx, _t(x), _t(ikc), _t(prev),
                         _t(lengths), prev_valid=_t(valid), **kw)
    np.testing.assert_array_equal(to.topk_idx.numpy(), np.asarray(jo.topk_idx))
    np.testing.assert_array_equal(to.gvr_rows.numpy(), np.asarray(jo.gvr_rows))
    np.testing.assert_allclose(to.attn_out.numpy(), np.asarray(jo.attn_out),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------ steps -------

def _configs(min_n):
    jcfg = jax_config("llama3.2-1b", smoke=True)
    tcfg = get_config("llama3.2-1b", smoke=True)
    if min_n is not None:
        jcfg = dataclasses.replace(jcfg, dsa=dataclasses.replace(jcfg.dsa, min_n=min_n))
        tcfg = dataclasses.replace(tcfg, dsa=dataclasses.replace(tcfg.dsa, min_n=min_n))
    return jcfg, tcfg


def _check_step(t, jl, js, tl, ts):
    for key in ("prev_topk", "topk_valid", "sel_gvr", "length"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=f"{key} step {t}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=5e-4)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("regime,min_n", [("dsa", None), ("dense", 64)])
def test_serve_step_matches_jax(models, regime, min_n):
    _, jparams, _, tparams = models
    jcfg, tcfg = _configs(min_n)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    b, max_len, steps = 3, 64, 16
    js = jm.init_decode_state(b, max_len)
    ts = tm.init_decode_state(b, max_len)
    lengths = np.array([0, 0, 10], np.int32)          # slot 2 joins late, cold
    js["length"] = jnp.asarray(lengths)
    ts["length"] = _t(lengths)
    rng = np.random.default_rng(3)
    step = jax.jit(jm.serve_step)
    for t in range(steps):
        tok = rng.integers(0, tcfg.vocab, (b,)).astype(np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok))
        tl, ts = tm.serve_step(tparams, ts, _t(tok))
        _check_step(t, jl, js, tl, ts)
    for key in ("k", "v", "idx_k"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
    assert bool(np.asarray(js["sel_gvr"]).any()) == (regime == "dsa")


@pytest.mark.parametrize("paged_attn,granularity,min_n", [
    ("gather", "token", None), ("gather", "token", 64), ("fused", "page", None)])
def test_serve_step_paged_forms_match_jax(models, paged_attn, granularity, min_n):
    _, jparams, _, tparams = models
    jcfg, tcfg = _configs(min_n)
    jm, tm = jax_build(jcfg), build_model(tcfg, device="cpu")
    b, max_len, ps, steps = 3, 64, 8, 16
    mp = max_len // ps
    js = jm.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    ts = tm.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    rng = np.random.default_rng(4)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    table[1, 5:] = -1                                  # unmapped tail
    js["page_table"], ts["page_table"] = jnp.asarray(table), _t(table)
    lengths = np.array([0, 0, 10], np.int32)
    js["length"], ts["length"] = jnp.asarray(lengths), _t(lengths)
    kw = dict(paged_attn=paged_attn, gather_granularity=granularity)
    step = jax.jit(lambda p, s, t, m: jm.serve_step_paged(p, s, t, min_write_pos=m, **kw))
    for t in range(steps):
        tok = rng.integers(0, tcfg.vocab, (b,)).astype(np.int32)
        mwp = np.array([0, 0, 0 if t % 5 else 2 ** 30], np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok), jnp.asarray(mwp))
        tl, ts = tm.serve_step_paged(tparams, ts, _t(tok), min_write_pos=_t(mwp), **kw)
        _check_step(t, jl, js, tl, ts)
    np.testing.assert_allclose(ts["k_pages"].numpy(), np.asarray(js["k_pages"]),
                               rtol=1e-5, atol=1e-5)


def _paged_and_dense_states(tm, rng, b, max_len, ps, lengths):
    """A random paged state and the dense state holding the same rows."""
    cfg = tm.cfg
    mp = max_len // ps
    ps_state = tm.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    for s, length in enumerate(lengths):
        table[s, (length + ps) // ps:] = -1           # map [0, length] only
    ps_state["page_table"] = _t(table)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        ps_state[key] = _t(rng.normal(size=ps_state[key].shape).astype(np.float32))
    ps_state["length"] = _t(np.array(lengths, np.int32))
    l, kk = cfg.n_layers, cfg.dsa.k
    ps_state["prev_topk"] = _t(rng.integers(0, max_len, (l, b, kk)).astype(np.int32))
    ps_state["topk_valid"] = _t(rng.integers(0, 2, (l, b)).astype(bool))
    dense = tm.init_decode_state(b, max_len)
    for src, dst in (("k_pages", "k"), ("v_pages", "v"), ("idx_k_pages", "idx_k")):
        for i in range(l):
            dense[dst][i] = ops.paged_gather(ps_state[src][i], ps_state["page_table"])
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        dense[key] = ps_state[key].clone()
    return ps_state, dense


def test_one_step_bit_identical_across_layouts_and_forms(models):
    """One DSA step from one state in four forms: paged fused, paged gather,
    paged page-granular and the dense layout holding the same rows. Logits
    and the new feedback state are equal bit for bit."""
    _, _, tm, tparams = models
    rng = np.random.default_rng(21)
    ps_state, dense = _paged_and_dense_states(tm, rng, 3, 64, 8, [40, 13, 5])
    tok = _t(rng.integers(0, tm.cfg.vocab, (3,)).astype(np.int32))

    def clone(st):
        return {k: v.clone() for k, v in st.items()}

    outs = {f: tm.serve_step_paged(tparams, clone(ps_state), tok, paged_attn=a,
                                   gather_granularity=g)
            for f, (a, g) in {"fused": ("fused", "token"),
                              "gather": ("gather", "token"),
                              "page": ("fused", "page")}.items()}
    outs["dense"] = tm.serve_step(tparams, clone(dense), tok)
    lf, sf = outs["fused"]
    for form, (lg, st) in outs.items():
        assert torch.equal(lg, lf), form
        for key in ("prev_topk", "topk_valid", "sel_gvr", "length"):
            assert torch.equal(st[key], sf[key]), (form, key)
    assert sf["sel_gvr"].any() and not sf["sel_gvr"].all()


# ----------------------------------------------------------- engines ------

def _shared_prefix_specs(rng, vocab):
    prefix = rng.integers(0, vocab, (16,))
    return [(np.concatenate([prefix, rng.integers(0, vocab, (5,))]), 5, 0),
            (prefix.copy(), 5, 8),
            (rng.integers(0, vocab, (12,)), 6, 3),
            (np.concatenate([prefix, rng.integers(0, vocab, (3,))]), 4, 16)]


def _pressure_specs(rng, vocab):
    return [(rng.integers(0, vocab, (20,)), 20, 0),
            (rng.integers(0, vocab, (30,)), 4, 1)]


def _unique_specs(rng, vocab):
    return [(rng.integers(0, vocab, (p,)), m, a)
            for p, m, a in ((5, 6, 0), (9, 4, 2), (12, 5, 3), (7, 6, 9))]


def _run(engine_cls, req_cls, model, params, specs, **kw):
    reqs = [req_cls(uid=i, prompt=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(specs)]
    eng = engine_cls(model, params, num_slots=2, max_len=64, prefill_chunk=4,
                     **kw)
    return eng, reqs, eng.run(reqs, max_ticks=3000)


