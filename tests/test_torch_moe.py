"""The MoE family of the port against the JAX package, on the two MoE smoke
configs (granite-moe-smoke: 8 experts top-4, 4 heads on 2 KV heads;
moonshot-smoke: 8 experts top-3, 4 heads on 4 KV heads), float32, with the JAX parameters from
`init_params(PRNGKey(0))` carried over through `repro_torch.bridge`. Every
test runs once per config. Inputs are made with numpy from seeds.

The feed-forward is the reference's one-device form,
`moe_mlp_dense_fallback`: the router's expert choice must be equal, and a
tie in the router logits must pick the lower expert index, as
`jax.lax.top_k` does. Its output agrees within max |err| <= 1e-5 of the
output's scale in float32 (the frameworks order the matmul sums
differently: ~1e-7 relative per product, a few of them in a row) and 2e-2
of the scale in bf16 (both round every product to bf16, 2^-8 relative,
at the same places but after sums taken in other orders).

Whole steps are held as `test_torch_model.py` holds llama's: Top-K and
feedback leaves exact, logits within rtol = 1e-5, atol = 5e-4, argmax
equal — in all four forms (dense layout, paged fused, gather and
page-granular), through the engine (tokens, method log and report
counters equal to the JAX engine's) and through the speculative verify
tick (scan and mq). The port's own invariants hold bit for bit: paged ==
dense in tokens, logits and method log, and mq == scan. The engine tests
are in `test_torch_moe_engine.py` and `test_torch_moe_spec.py` (moved
there so that no test file runs past the tier-1 budget).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as jlayers
from repro.models.api import build_model as jax_build
from repro_torch import bridge
from repro_torch.configs.registry import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models.api import build_model

ARCHS = ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"]
REPORT_FIELDS = ("ticks", "decoded_tokens", "prefill_tokens", "completed",
                 "method_counts", "prefill_method_counts",
                 "decode_method_counts", "preemptions", "prefix_hit_tokens",
                 "peak_page_utilization")
MAX_LEN = 64


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    """(JAX model, JAX params, port model, carried params) of one MoE smoke
    config."""
    jm = jax_build(jax_config(request.param, smoke=True))
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(get_config(request.param, smoke=True), device="cpu")
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, tm, tparams


# ------------------------------------------------------ the feed-forward ---

def _layer0_ffn(jparams):
    """Layer 0's router and experts as numpy float32 arrays."""
    return [np.asarray(jparams["layers"][k][0], np.float32)
            for k in ("router", "w_gate", "w_up", "w_down")]


@pytest.mark.parametrize("dtype,bound", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_moe_mlp_dense_fallback_matches_jax(moe, dtype, bound):
    jm, jparams, _, _ = moe
    cfg = jm.cfg
    router, wg, wu, wd = _layer0_ffn(jparams)
    x = np.random.default_rng(5).normal(size=(3, 2, cfg.d_model)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x, jdt), [jnp.asarray(w, jdt) for w in (wg, wu, wd)]
    # the port gets the very values JAX holds after its cast
    tx, *tw = [_t(np.asarray(a.astype(jnp.float32))).to(tdt) for a in (jx, *jw)]
    k = cfg.moe.top_k
    want_idx = jax.lax.top_k(jx @ jnp.asarray(router), k)[1]
    got_gates, got_idx = tlayers.moe_route(tx, _t(router), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert got_gates.dtype == torch.float32
    want = np.asarray(jlayers.moe_mlp_dense_fallback(
        jx, jnp.asarray(router), *jw, top_k=k).astype(jnp.float32))
    got = tlayers.moe_mlp_dense_fallback(tx, _t(router), *tw, top_k=k)
    assert got.dtype == tdt and got.shape == x.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


def test_router_tie_picks_the_lower_expert_index(moe):
    """Crafted equal router logits: token 0 sees five experts at 1.0 (more
    than top_k), token 1 sees every logit equal to 0. Both frameworks keep
    the lower indices; the combined outputs agree too."""
    jm, jparams, _, _ = moe
    cfg = jm.cfg
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    _, wg, wu, wd = _layer0_ffn(jparams)
    router = np.zeros((cfg.d_model, e), np.float32)
    router[0] = [1.0, 1.0, 0.5, 1.0, 1.0, 0.25, 1.0, 0.5]
    x = np.zeros((2, 1, cfg.d_model), np.float32)
    x[0, 0, 0] = 1.0
    x[1, 0, 1] = 1.0
    want_idx = np.asarray(jax.lax.top_k(jnp.asarray(x) @ jnp.asarray(router), k)[1])
    _, got_idx = tlayers.moe_route(_t(x), _t(router), k)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(want_idx[0, 0], [0, 1, 3, 4, 6][:k])
    np.testing.assert_array_equal(want_idx[1, 0], np.arange(k))
    want = jlayers.moe_mlp_dense_fallback(jnp.asarray(x), jnp.asarray(router),
                                          jnp.asarray(wg), jnp.asarray(wu),
                                          jnp.asarray(wd), top_k=k)
    got = tlayers.moe_mlp_dense_fallback(_t(x), _t(router), _t(wg), _t(wu),
                                         _t(wd), top_k=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_init_params_mirror_the_reference_scales(moe):
    """The port's own init (torch generator, seed 0) draws each MoE leaf
    with the reference's dtype and scale: router d^-0.5 in f32, w_gate and
    w_up E^-0.5 (the reference's `_dense` scales by shape[0]), w_down
    f^-0.5; the layers are drawn apart, not copied."""
    jm, jparams, tm, _ = moe
    tparams = tm.init_params(seed=0)
    for key in ("router", "w_gate", "w_up", "w_down"):
        jl, tl = np.asarray(jparams["layers"][key], np.float32), tparams["layers"][key]
        assert str(tl.dtype).split(".")[-1] == str(jparams["layers"][key].dtype), key
        ratio = float(tl.float().std()) / float(jl.std())
        assert abs(ratio - 1.0) < 0.1, (key, ratio)
        assert not torch.equal(tl[0], tl[1]), key


# ---------------------------------------------------------------- steps ---

def _check_step(t, jl, js, tl, ts):
    for key in ("prev_topk", "topk_valid", "sel_gvr", "length"):
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]),
                                      err_msg=f"{key} step {t}")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=5e-4)
    np.testing.assert_array_equal(tl.numpy().argmax(-1), np.asarray(jl).argmax(-1))


@pytest.mark.parametrize("form", ["dense", "fused", "gather", "page"])
def test_serve_step_forms_match_jax(moe, form):
    """12 steps of B=3 slots (slot 2 joins late and cold, its writes masked
    every fifth step on the paged forms) from an empty state: DSA from the
    first step (max_len 64 > min_n 8), GVR once warm."""
    jm, jparams, tm, tparams = moe
    b, ps, steps = 3, 8, 12
    mp = MAX_LEN // ps
    rng = np.random.default_rng(4)
    lengths = np.array([0, 0, 10], np.int32)
    if form == "dense":
        js, ts = jm.init_decode_state(b, MAX_LEN), tm.init_decode_state(b, MAX_LEN)
        step = jax.jit(lambda p, s, t, m: jm.serve_step(p, s, t))
    else:
        js = jm.init_paged_decode_state(b, MAX_LEN, num_pages=b * mp, page_size=ps)
        ts = tm.init_paged_decode_state(b, MAX_LEN, num_pages=b * mp, page_size=ps)
        table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
        js["page_table"], ts["page_table"] = jnp.asarray(table), _t(table)
        kw = dict(paged_attn="gather" if form == "gather" else "fused",
                  gather_granularity="page" if form == "page" else "token")
        step = jax.jit(lambda p, s, t, m: jm.serve_step_paged(
            p, s, t, min_write_pos=m, **kw))
    js["length"], ts["length"] = jnp.asarray(lengths), _t(lengths)
    for t in range(steps):
        tok = rng.integers(0, tm.cfg.vocab, (b,)).astype(np.int32)
        mwp = np.array([0, 0, 0 if t % 5 else 2 ** 30], np.int32)
        jl, js = step(jparams, js, jnp.asarray(tok), jnp.asarray(mwp))
        if form == "dense":
            tl, ts = tm.serve_step(tparams, ts, _t(tok))
        else:
            tl, ts = tm.serve_step_paged(tparams, ts, _t(tok),
                                         min_write_pos=_t(mwp), **kw)
        _check_step(t, jl, js, tl, ts)
    assert bool(np.asarray(js["sel_gvr"]).any())
    pools = ("k", "v", "idx_k") if form == "dense" else ("k_pages", "v_pages", "idx_k_pages")
    for key in pools:
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)


# -------------------------------------------------------------- engines ---

def _staggered(req_cls, vocab, seed=2):
    """Three requests, the third arriving once the first two hold both
    slots."""
    rng = np.random.default_rng(seed)
    return [req_cls(uid=i, prompt=rng.integers(0, vocab, (p,)),
                    max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(((6, 6, 0), (11, 5, 2), (9, 6, 4)))]


def _engine_run(engine_cls, req_cls, model, params, **kw):
    reqs = _staggered(req_cls, model.cfg.vocab)
    eng = engine_cls(model, params, num_slots=2, max_len=MAX_LEN,
                     prefill_chunk=4, **kw)
    return eng, reqs, eng.run(reqs, max_ticks=500)


# ----------------------------------------------------- speculative tick ---

def _spec_state(tm, rng, lengths, ps=8):
    """A random paged state: pools, a shuffled table mapping [0, length + 3]
    of each slot, lengths and random feedback (slot 1 cold)."""
    cfg, b = tm.cfg, len(lengths)
    mp = MAX_LEN // ps
    st = tm.init_paged_decode_state(b, MAX_LEN, num_pages=b * mp, page_size=ps)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    for s, length in enumerate(lengths):
        table[s, (length + 3) // ps + 1:] = -1
    st["page_table"] = _t(table)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        st[key] = _t(rng.normal(size=st[key].shape).astype(np.float32))
    st["length"] = _t(np.array(lengths, np.int32))
    st["prev_topk"] = _t(rng.integers(0, min(lengths), (cfg.n_layers, b, cfg.dsa.k)
                                      ).astype(np.int32))
    st["topk_valid"] = _t(np.array([[True, False, True]] * cfg.n_layers))
    return st


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def test_serve_step_spec_paged_matches_jax_and_mq_equals_scan(moe):
    """One verify tick at spec_depth 2 (draft lengths 2, 1, 0): drafts
    read from two preliminary ticks so that slot 0 accepts both and slot 1
    rejects its one. Scan and mq each equal the JAX tick (tokens,
    acceptance, rolled-back state; logits within the step bound), and mq
    equals scan bit for bit, logits included (these configs have an untied
    head, so the head's row count does not enter; ROADMAP Queue C)."""
    jm, jparams, tm, tparams = moe
    rng = np.random.default_rng(8)
    st = _spec_state(tm, rng, [30, 12, 50])
    tokens = rng.integers(0, tm.cfg.vocab, (3, 3)).astype(np.int32)
    dl = np.array([2, 1, 0], np.int32)
    for j in (1, 2):
        out = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                       draft_len=_t(dl), max_accept=_t(dl))[0]
        tokens[:, j] = out[:, j - 1].numpy()
    tokens[1, 1] = (tokens[1, 1] + 1) % tm.cfg.vocab
    js = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    outs = {}
    for vk in ("scan", "mq"):
        jout = jm.serve_step_spec_paged(jparams, dict(js), jnp.asarray(tokens),
                                        draft_len=jnp.asarray(dl),
                                        max_accept=jnp.asarray(dl), verify_kernel=vk)
        tout = tm.serve_step_spec_paged(tparams, _clone(st), _t(tokens),
                                        draft_len=_t(dl), max_accept=_t(dl),
                                        verify_kernel=vk)
        for name, a, c in zip(("out_tokens", "accept_len", "logits", "sel_gvr_pos"),
                              tout[:4], jout[:4]):
            if name == "logits":
                np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=5e-4)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(c), err_msg=(vk, name))
        np.testing.assert_array_equal(tout[1].numpy(), [2, 0, 0])
        for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
            np.testing.assert_array_equal(tout[4][key].numpy(),
                                          np.asarray(jout[4][key]), err_msg=(vk, key))
        outs[vk] = tout
    scan, mq = outs["scan"], outs["mq"]
    assert torch.equal(scan[1], mq[1])
    # frozen positions (j > draft_len) compute garbage in both bodies
    live = [(s, j) for s in range(3) for j in range(dl[s] + 1)]
    for s, j in live:
        for i in (0, 2, 3):
            assert torch.equal(scan[i][s, j], mq[i][s, j]), (i, s, j)
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        assert torch.equal(scan[4][key], mq[4][key]), key
    assert bool(scan[3].any())


def test_moe_config_widths_are_the_registry_s():
    """The full configs carry the published widths of the JAX registry,
    field by field."""
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jax_config(arch))
        assert (dataclasses.asdict(get_config(arch, smoke=True))
                == dataclasses.asdict(jax_config(arch, smoke=True)))
