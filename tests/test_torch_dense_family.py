"""The rest of the dense family in the port against the JAX package, on the
smoke configs of h2o-danube-3-4b (a sliding window of 64), chatglm3-6b
(RoPE on half the head dims), granite-34b (MQA) and qwen2-vl-7b (family
vlm, M-RoPE, head_dim 24), float32, with the JAX parameters from
`init_params(PRNGKey(0))` carried over through `repro_torch.bridge`.
Inputs are made with numpy from seeds.

Tolerances: the rotary embedding agrees within rtol = atol = 1e-6 in
float32: both frameworks form the same float32 angles, but their math
libraries round cos and sin of some large angles (positions up to 9000)
one ulp apart, which x1 cos - x2 sin carries to ~1e-7 of outputs of
scale ~1; within the port, M-RoPE over 2-D positions equals plain RoPE bit
for bit. At head_dim 120 the exponents k/120 are no binary fractions, and
XLA's float32 pow puts one of the 60 frequencies one ulp (1.9e-9) away
from PyTorch's: at positions up to 9000 that moves an angle by ~1.7e-5,
so there the bound is rtol = atol = 1e-4 (the frequencies are checked
ulp by ulp beside it). Steps are held as `test_torch_model.py` holds llama's:
Top-K and feedback leaves exact, logits within rtol = 1e-5, atol = 5e-4
(float32 matmuls summed in other orders), argmax equal. Selection indices
are exact. The plain attention versions B3/B4/B6/B8/B10 agree with the
Pallas kernels in interpret mode within rtol = atol = 1e-5 (float32
softmax averages over the same rows summed in other orders), at the head
groups and head dims of these configs' full widths (G 48, 16, 7, 4 and hd
128, 120) cut to small lengths. The engines are in
`test_torch_dense_family_engine.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.kernels import ops as jops
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build
from repro.sparse import dsa as jdsa
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as tlayers
from repro_torch.models.api import build_model
from repro_torch.models.transformer import layer_params
from repro_torch.sparse import dsa as tdsa

ARCHS = ["h2o-danube-3-4b", "chatglm3-6b", "granite-34b", "qwen2-vl-7b"]
MAX_LEN = 128
RNG = np.random.default_rng(20)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module", params=ARCHS)
def family(request):
    """(JAX model, JAX params, port model, carried params) of one smoke
    config."""
    jm = jax_build(jax_config(request.param, smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config(request.param, smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


def test_configs_are_the_registry_s():
    """Full and smoke configs carry the JAX registry's fields one for one;
    granite-34b's bf16 weights (param_count) exceed one 80 GB card."""
    for arch in ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(get_config(arch, smoke=smoke))
                    == dataclasses.asdict(jax_config(arch, smoke=smoke)))
    assert get_config("qwen2-vl-7b").family == "vlm"
    assert get_config("h2o-danube-3-4b").swa_window == 4096
    assert get_config("granite-34b").param_count() * 2 > 80e9


def test_init_params_layout_matches_jax(family):
    """Leaf by leaf, the port's init has the JAX init's tree, shapes and
    dtypes (qwen2-vl's patch_proj included), and the carried tree is the
    JAX tree value for value."""
    jm, jparams, tm, tparams = family
    mine = tm.init_params(seed=0)
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(leaves) == len(jax.tree_util.tree_leaves(mine))
    for path, leaf in leaves:
        node, carried = mine, tparams
        for p in path:
            node, carried = node[p.key], carried[p.key]
        assert tuple(node.shape) == tuple(leaf.shape), path
        assert str(node.dtype).split(".")[-1] == str(leaf.dtype), path
        np.testing.assert_array_equal(carried.numpy(), np.asarray(leaf))
    assert ("patch_proj" in mine) == bool(tm.cfg.num_patches)


# ------------------------------------------------------------- rotary -----

@pytest.mark.parametrize("kind,fraction,hd,streams", [
    ("rope", 0.5, 32, 0),       # chatglm smoke
    ("rope", 0.5, 128, 0),      # chatglm full
    ("rope2d", 0.5, 128, 0),    # the reference's else branch: plain RoPE
    ("rope", 1.0, 120, 0),      # h2o-danube full
    ("rope", 1.0, 24, 0),       # qwen2-vl smoke as plain RoPE
    ("mrope", 1.0, 128, 0),     # qwen2-vl full, text positions
    ("mrope", 1.0, 128, 3),     # three distinct streams: the sections
    ("mrope", 1.0, 24, 3),      # qwen2-vl smoke: one section only
])
def test_apply_rotary_matches_jax(kind, fraction, hd, streams):
    b, s, h = 2, 5, 3
    x = RNG.normal(size=(b, s, h, hd)).astype(np.float32)
    pos = RNG.integers(0, 9000, (b, s) + ((3,) if streams else ())).astype(np.int32)
    want = jlayers.apply_rotary(jnp.asarray(x), jnp.asarray(pos), kind=kind,
                                base=10000.0, fraction=fraction)
    got = tlayers.apply_rotary(_t(x), _t(pos), kind=kind, base=10000.0,
                               fraction=fraction)
    tol = 1e-4 if hd == 120 else 1e-6
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    jf = np.asarray(jlayers._rope_freqs(hd, 10000.0))
    tf = tlayers._rope_freqs(hd, 10000.0, "cpu").numpy()
    assert (jf != tf).sum() == (hd == 120)
    np.testing.assert_array_less(np.abs(jf - tf), 2 * np.spacing(tf))
    if kind == "mrope" and not streams:
        plain = tlayers.apply_rotary(_t(x), _t(pos), kind="rope", base=10000.0)
        assert torch.equal(got, plain)
    if streams:
        # the sections are live: a 2-D stream (the first) gives another
        # rotation wherever a section reads the other streams
        one = tlayers.apply_rotary(_t(x), _t(pos[..., 0]), kind=kind, base=10000.0)
        assert torch.equal(got, one) == (hd // 2 <= 16)


# -------------------------------------------------------------- steps -----

def _random_caches(st, rng, keys):
    for key in keys:
        st[key] = _t(rng.normal(size=tuple(st[key].shape)).astype(np.float32))


@pytest.mark.parametrize("form", ["dense", "fused", "gather", "page"])
def test_serve_step_forms_match_jax(family, form):
    """6 steps of B=3 slots from random caches at lengths 20, 70 and 100
    (danube's window of 64 cuts the last two), slot 1 cold and its writes
    masked every third step on the paged forms: Top-K and feedback leaves
    exact, logits to the step bound."""
    jm, jparams, tm, tparams = family
    b, ps, steps = 3, 8, 6
    mp = MAX_LEN // ps
    rng = np.random.default_rng(4)
    lengths = np.array([20, 70, 100], np.int32)
    if form == "dense":
        ts = tm.init_decode_state(b, MAX_LEN)
        _random_caches(ts, rng, ("k", "v", "idx_k"))
        step = jax.jit(lambda p, s, t, m: jm.serve_step(p, s, t))
    else:
        ts = tm.init_paged_decode_state(b, MAX_LEN, num_pages=b * mp, page_size=ps)
        _random_caches(ts, rng, ("k_pages", "v_pages", "idx_k_pages"))
        ts["page_table"] = _t(rng.permutation(b * mp).astype(np.int32).reshape(b, mp))
        kw = dict(paged_attn="gather" if form == "gather" else "fused",
                  gather_granularity="page" if form == "page" else "token")
        step = jax.jit(lambda p, s, t, m: jm.serve_step_paged(
            p, s, t, min_write_pos=m, **kw))
    ts["length"] = _t(lengths)
    ts["prev_topk"] = _t(rng.integers(0, 20, tuple(ts["prev_topk"].shape)).astype(np.int32))
    ts["topk_valid"] = _t(np.array([[True, False, True]] * tm.cfg.n_layers))
    js = {k: jnp.asarray(v.numpy()) for k, v in ts.items()}
    for t in range(steps):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        mwp = np.array([0, 0 if t % 3 else 2 ** 30, 0], np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok), jnp.asarray(mwp))
        if form == "dense":
            tl, ts = tm.serve_step(tparams, ts, _t(tok))
        else:
            tl, ts = tm.serve_step_paged(tparams, ts, _t(tok),
                                         min_write_pos=_t(mwp), **kw)
        for key in ("prev_topk", "topk_valid", "sel_gvr", "length"):
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                          err_msg=f"{key} step {t}")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=5e-4)
        np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    assert bool(np.asarray(js["sel_gvr"]).any())


# --------------------------------------------------- windowed selection ---

def _danube_indexer():
    jm = jax_build(jax_config("h2o-danube-3-4b", smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return (jm.cfg, jax.tree.map(lambda a: a[0], jparams["layers"]["indexer"]),
            layer_params(tparams["layers"], 0)["indexer"])


@pytest.mark.parametrize("selector", ["auto", "radix"])
def test_dsa_select_under_the_window_matches_jax(selector):
    """dsa_select, dsa_select_paged and dsa_select_paged_mq with danube's
    window at lengths below, at and across it (40, 64, 65, 90, 128): the
    indices of the reference's windowed `dsa_select` (the mq rows as its
    row chain), and no index below length - window."""
    cfg, jidx, tidx = _danube_indexer()
    win = cfg.swa_window
    b, ps, qn = 5, 8, 2
    mp = MAX_LEN // ps
    p = b * mp
    pages = RNG.normal(size=(p, ps, cfg.dsa.indexer_dim)).astype(np.float32)
    table = RNG.permutation(p).astype(np.int32).reshape(b, mp)
    view = pages[table].reshape(b, MAX_LEN, -1)
    x = RNG.normal(size=(b, qn, cfg.d_model)).astype(np.float32)
    lengths = np.array([40, 64, 65, 90, 127], np.int32)
    lq = (lengths[:, None] + np.arange(qn)).astype(np.int32)
    prev = RNG.integers(0, 40, (b, cfg.dsa.k)).astype(np.int32)
    valid = np.array([True, False, True, True, False])
    kw = dict(k=cfg.dsa.k, heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
              rope_base=cfg.rope_base, selector=selector, min_n=cfg.dsa.min_n,
              swa_window=win)
    jprev, jvalid = jnp.asarray(prev), jnp.asarray(valid)
    mq = tdsa.dsa_select_paged_mq(tidx, _t(x), _t(pages), _t(table), _t(prev),
                                  _t(lq), prev_valid=_t(valid), **kw)
    for j in range(qn):
        want = jdsa.dsa_select(jidx, jnp.asarray(x[:, j]), jnp.asarray(view), jprev,
                               jnp.asarray(lq[:, j]), prev_valid=jvalid, **kw)
        wi = np.asarray(want.indices)
        if j == 0:
            dense = tdsa.dsa_select(tidx, _t(x[:, 0]), _t(view), _t(prev),
                                    _t(lq[:, 0]), prev_valid=_t(valid), **kw)
            paged = tdsa.dsa_select_paged(tidx, _t(x[:, 0]), _t(pages), _t(table),
                                          _t(prev), _t(lq[:, 0]),
                                          prev_valid=_t(valid), **kw)
            np.testing.assert_array_equal(dense.indices.numpy(), wi)
            np.testing.assert_array_equal(paged.indices.numpy(), wi)
            np.testing.assert_array_equal(paged.gvr_rows.numpy(), np.asarray(want.gvr_rows))
        np.testing.assert_array_equal(mq.indices[:, j].numpy(), wi, err_msg=f"row {j}")
        lo = np.maximum(lq[:, j] - win, 0)
        assert (wi >= lo[:, None]).all()
        jprev, jvalid = want.indices, jnp.ones_like(jvalid)
    # the window is live: without it the rows past it select below lo
    free = tdsa.dsa_select(tidx, _t(x[:, 0]), _t(view), _t(prev), _t(lq[:, 0]),
                           prev_valid=_t(valid), **{**kw, "swa_window": None})
    assert (free.indices.numpy()[3:] < (lq[3:, 0] - win)[:, None]).any()


def test_windowed_scores_plain_forms_agree():
    """The three plain scoring versions under a window: positions below
    length - window and at or past the length score NEG, the rest equal
    the unwindowed row; B5 == B2 over the same keys; B9's rows == B2's at
    each row's own length."""
    b, ps, mp, h, d, win = 3, 8, 6, 4, 16, 20
    n = mp * ps
    pages = RNG.normal(size=(b * mp, ps, d)).astype(np.float32)
    table = RNG.permutation(b * mp).astype(np.int32).reshape(b, mp)
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    w = np.full((h,), 1.0 / h, np.float32)
    lengths = np.array([48, 21, 7], np.int32)
    s2 = ref.paged_indexer_scores_ref(_t(q), _t(pages), _t(w), _t(table),
                                      _t(lengths), win)
    free = ref.paged_indexer_scores_ref(_t(q), _t(pages), _t(w), _t(table),
                                        _t(lengths))
    pos = np.arange(n)[None]
    keep = (pos < lengths[:, None]) & (pos >= lengths[:, None] - win)
    np.testing.assert_array_equal(s2.numpy(), np.where(keep, free.numpy(), ref.NEG))
    view = pages[table].reshape(b, n, d)
    s5 = ops.indexer_scores(_t(q), _t(view), _t(w), _t(lengths), window=win)
    np.testing.assert_array_equal(s5.numpy(), s2.numpy())
    lq = np.stack([lengths, lengths + 1], 1).astype(np.int32)
    q9 = np.stack([q, q], 1)
    s9 = ops.paged_indexer_scores_mq(_t(q9), _t(pages), _t(w), _t(table),
                                     _t(lq), window=win)
    for j in range(2):
        np.testing.assert_array_equal(
            s9[:, j].numpy(), ops.paged_indexer_scores(
                _t(q), _t(pages), _t(w), _t(table), _t(lq[:, j]), win).numpy())


# --------------------------------------- attention at the new widths -----

# (KVH, H, hd): granite-34b (G 48), chatglm3-6b (G 16), qwen2-vl-7b (G 7)
# and h2o-danube-3-4b (G 4, hd 120) at full width; qwen2-vl's smoke (hd 24)
NEW_WIDTHS = [(1, 48, 128), (2, 32, 128), (4, 28, 128), (8, 32, 120), (2, 4, 24)]


def test_head_chunks_of_the_attention_body():
    """G heads a CTA, chunks: the least power of two >= grp capped at 8."""
    want = {1: (1, 1), 2: (2, 1), 3: (4, 1), 4: (4, 1), 7: (8, 1), 8: (8, 1),
            16: (8, 2), 48: (8, 6)}
    assert {g: ops.attn_head_chunk(g) for g in want} == want
    assert ops.ATTN_HEAD_DIMS == (32, 64, 120, 128)


@pytest.mark.parametrize("kvh,h,hd", NEW_WIDTHS)
def test_plain_attention_matches_pallas_at_new_widths(kvh, h, hd):
    """B3, B4 (whole extent and a window), B6, B8 and B10 plain versions
    against the Pallas kernels in interpret mode; entries are valid or -1
    (where the Pallas kernels' masks and the served ones agree)."""
    rng = np.random.default_rng(kvh * 1000 + h + hd)
    p, ps, b, mp, k, qn = 10, 4, 2, 4, 8, 2
    n = mp * ps
    kp = rng.normal(size=(p, ps, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(p, ps, kvh, hd)).astype(np.float32)
    table = np.stack([rng.choice(p, mp, replace=False) for _ in range(b)]).astype(np.int32)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    idx = np.stack([rng.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    idx[1, 6:] = -1
    lengths = np.full((b,), n, np.int32)
    J, T = (lambda *a: [jnp.asarray(x) for x in a]), (lambda *a: [_t(x) for x in a])
    tol = dict(rtol=1e-5, atol=1e-5)
    want3 = jops.paged_sparse_decode_attn(*J(q, kp, vp, table, idx))
    got3 = ops.paged_sparse_decode_attn(*T(q, kp, vp, table, idx, lengths))
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), **tol)
    got10 = ops.paged_sparse_decode_attn_pg(*T(q, kp, vp, table, idx, lengths))
    np.testing.assert_allclose(got10.numpy(), np.asarray(jops.paged_sparse_decode_attn_pg(
        *J(q, kp, vp, table, idx))), **tol)
    kc, vc = kp[table].reshape(b, n, kvh, hd), vp[table].reshape(b, n, kvh, hd)
    got6 = ops.sparse_decode_attn(*T(q, kc, vc, idx, lengths))
    np.testing.assert_allclose(got6.numpy(), np.asarray(jops.sparse_decode_attn(
        *J(q, kc, vc, idx))), **tol)
    ln4 = np.array([n, 9], np.int32)
    for window in (None, 5):
        want4 = jops.paged_dense_decode_attn(*J(q, kp, vp, table, ln4), window=window)
        got4 = ops.paged_dense_decode_attn(*T(q, kp, vp, table, ln4), window=window)
        np.testing.assert_allclose(got4.numpy(), np.asarray(want4), **tol)
    q8 = rng.normal(size=(b, qn, h, hd)).astype(np.float32)
    idx8 = np.stack([idx, np.roll(idx, 3, axis=1)], 1)
    got8 = ops.paged_sparse_decode_attn_mq(*T(q8, kp, vp, table, idx8,
                                              np.full((b, qn), n, np.int32)))
    np.testing.assert_allclose(got8.numpy(), np.asarray(jops.paged_sparse_decode_attn_mq(
        *J(q8, kp, vp, table, idx8))), **tol)
    # the split form the kernel computes (runs of entries merged) agrees too
    split = ref.paged_sparse_attn_ref(*T(q, kp, vp, table, idx, lengths),
                                      rows_per_split=4)
    np.testing.assert_allclose(split.numpy(), got3.numpy(), **tol)
