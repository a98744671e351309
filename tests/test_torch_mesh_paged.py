"""The paged decode step and the speculative verify tick on a ("data",
"model") mesh against the JAX package's.

Smoke configs on the CPU: llama3.2-1b on (2, 2), moonshot-v1-16b-a3b on
(1, 4) (experts over "model"), h2o-danube-3-4b on (2, 2) (window 64 at
max_len 128). Each steps 3 greedy ticks at B = 4, page 8, over a shuffled
block table and mixed lengths, on 4 gloo ranks of the port
(`_sp_rank.py mesh_paged`, `_mesh_paged_tasks.py`: each rank holds the
blocks `param_specs` and `paged_state_specs` give it) and in JAX
(`_mesh_paged_jax.py`: `serve_step_paged(mesh=, rules=)` on 4 forced host
devices, and the one-device step). Forms: fused/token, fused/page (row 1's
first write masked by `min_write_pos`: it goes to the sink page), gather,
the pre-DSA fallback at max_len 8 = dsa.min_n, and the verify tick (scan
and mq, depth 2, drafts from each side's own greedy tokens).

Equal: tokens, Top-K, sel_gvr, `length`, accept lengths, and the rows each
pool block has written; logits and pool values within 1e-4 of their scale
(float32: the sharded contractions sum in another order than JAX's, on
both sides). Each rank's replicas of a pool block are equal bit for bit,
and its fused/token and gather logits equal its own dense mesh step's
(`serve_step(mesh=)` over the same cache content) bit for bit. One JAX
subprocess and one rank spawn serve the whole file.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest

from _sp_common import flatten, paged_layouts, run_jax_and_ranks

from repro.configs.registry import get_config as jget_config
from repro.models.api import build_model as jbuild

TICKS = 3
PAGE = 8
TOL = 1e-4
NEVER = 2 ** 30
CASES = {
    "llama": dict(arch="llama3.2-1b", shape=(2, 2), n=64,
                  lengths=[40, 17, 55, 30],
                  forms=["token", "page", "gather", "fallback", "scan", "mq"]),
    "moonshot": dict(arch="moonshot-v1-16b-a3b", shape=(1, 4), n=64,
                     lengths=[40, 17, 55, 30], forms=["token", "scan", "mq"]),
    "danube": dict(arch="h2o-danube-3-4b", shape=(2, 2), n=128,
                   lengths=[100, 70, 120, 40], forms=["token", "fallback"]),
}
FALLBACK_N, FALLBACK_LENGTHS = 8, [3, 1, 4, 2]
STEP_FORMS = ("token", "page", "gather", "fallback")
DRAFT_LEN, MAX_ACCEPT = [2, 1, 2, 2], [2, 2, 1, 2]
POOLS = ("k_pages", "v_pages", "idx_k_pages")


def _cases(forms):
    return [(c, f) for c, spec in CASES.items() for f in spec["forms"]
            if f in forms]


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    model = jbuild(jget_config(arch, smoke=True))
    return jax.tree.map(np.asarray, jax.jit(model.init_params)(
        jax.random.PRNGKey(0)))


def _states(rng, cfg, n, lengths):
    """The paged state over a random cache (shuffled pages) and the dense
    state of the same content."""
    lay = paged_layouts(rng, cfg, len(lengths), n, PAGE, 1, lengths)
    sel = np.zeros(lay["topk_valid"].shape, bool)
    feedback = {"length": lay["length"], "prev_topk": lay["prev_topk"],
                "topk_valid": lay["topk_valid"], "sel_gvr": sel}
    paged = {"page_table": lay["table"], **feedback,
             **{k: lay[k] for k in POOLS}}
    l, b = cfg.n_layers, len(lengths)
    dense = {name: lay[name + "_pages"][:, lay["table"]].reshape(
        (l, b, n) + lay[name + "_pages"].shape[3:])
        for name in ("k", "v", "idx_k")}
    return paged, {**dense, **feedback}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_paged")
    rng = np.random.default_rng(28)
    inp = {"cases": np.asarray(list(CASES)), "ticks": np.asarray(TICKS)}
    for c, spec in CASES.items():
        cfg = jget_config(spec["arch"], smoke=True)
        paged, dense = _states(rng, cfg, spec["n"], spec["lengths"])
        inp.update({f"{c}/arch": np.asarray(spec["arch"]),
                    f"{c}/shape": np.asarray(spec["shape"]),
                    f"{c}/forms": np.asarray(spec["forms"]),
                    f"{c}/tokens": rng.integers(0, cfg.vocab, (4,)).astype(np.int32),
                    f"{c}/draft_len": np.asarray(DRAFT_LEN, np.int32),
                    f"{c}/max_accept": np.asarray(MAX_ACCEPT, np.int32)})
        inp.update(flatten(_jax_params(spec["arch"]), f"{c}/params/"))
        inp.update(flatten(paged, f"{c}/paged/"))
        inp.update(flatten(dense, f"{c}/dense/"))
        if "fallback" in spec["forms"]:
            inp.update(flatten(_states(rng, cfg, FALLBACK_N, FALLBACK_LENGTHS)[0],
                               f"{c}/fallback/"))
        if "page" in spec["forms"]:
            inp[f"{c}/mwp/page"] = np.asarray([0, NEVER, 0, 0], np.int32)
    np.savez(tmp / "inputs.npz", **inp)
    jax_out, ranks = run_jax_and_ranks(open("tests/_mesh_paged_jax.py").read(),
                                       "mesh_paged", 4, tmp)
    return inp, jax_out, ranks


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _eq(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=str(what))


def _kv_block(c, coords):
    """The slice of KV heads a rank's pools hold."""
    cfg = jget_config(CASES[c]["arch"], smoke=True)
    m = CASES[c]["shape"][1]
    if cfg.n_kv_heads % m:
        return slice(None)
    n = cfg.n_kv_heads // m
    return slice(coords["model"] * n, (coords["model"] + 1) * n)


@pytest.mark.parametrize("c,form", _cases(STEP_FORMS))
def test_mesh_paged_step_matches_jax(runs, c, form):
    """Every tick: JAX's mesh step equals its one-device step (tokens,
    Top-K, sel_gvr); each rank's rows equal JAX's mesh step's (tokens,
    Top-K, sel_gvr, global `length`; logits within TOL)."""
    _, jax_out, ranks = runs
    mesh_key, ref_key = f"{c}/mesh/{form}", f"{c}/ref/{form}"
    for t in range(TICKS):
        for k in ("tokens", "prev_topk", "sel_gvr", "length"):
            _eq(jax_out[f"{mesh_key}/{k}{t}"], jax_out[f"{ref_key}/{k}{t}"],
                (c, form, t, k))
        _close(jax_out[f"{mesh_key}/logits{t}"], jax_out[f"{ref_key}/logits{t}"],
               (c, form, t))
        for r, res in enumerate(ranks):
            rows = res[c]["rows"]
            tick = res[c][form]["ticks"][t]
            what = (c, form, t, r)
            _close(tick["logits"].numpy(),
                   jax_out[f"{mesh_key}/logits{t}"][rows], what)
            _eq(tick["tokens"], jax_out[f"{mesh_key}/tokens{t}"], what)
            _eq(tick["length"], jax_out[f"{mesh_key}/length{t}"], what)
            for k in ("prev_topk", "topk_valid", "sel_gvr"):
                _eq(tick[k], jax_out[f"{mesh_key}/{k}{t}"][:, rows], (k,) + what)


@pytest.mark.parametrize("c,form", _cases(STEP_FORMS + ("scan", "mq")))
def test_mesh_paged_pools_match_jax(runs, c, form):
    """Each rank's pool blocks after the ticks: the rows written (against
    the start state) are JAX's, the values within TOL of JAX's, and the
    ranks holding one block hold the same bits."""
    inp, jax_out, ranks = runs
    start = "fallback" if form == "fallback" else "paged"
    for k in POOLS:
        want = jax_out[f"{c}/mesh/{form}/{k}"]
        _close(want, jax_out[f"{c}/ref/{form}/{k}"], (c, form, k, "ref"))
        before = inp[f"{c}/{start}/{k}"]
        blocks = {}
        for r, res in enumerate(ranks):
            got = res[c][form][k].numpy()
            sl = (slice(None),) * 3 + (_kv_block(c, res[c]["coords"]),)
            if k == "idx_k_pages":
                sl = ()
            w, b0 = want[sl], before[sl]
            feat = tuple(range(3, got.ndim))
            _eq((got != b0).any(feat), (w != b0).any(feat), (c, form, k, r))
            _close(got, w, (c, form, k, r))
            key = None if not sl else (sl[3].start, sl[3].stop)
            if key in blocks:
                _eq(got, blocks[key], (c, form, k, r, "replica"))
            blocks[key] = got


@pytest.mark.parametrize("c,form", _cases(("token", "gather")))
def test_mesh_paged_equals_dense_mesh_step(runs, c, form):
    """On every rank the paged ticks equal the dense mesh step's over the
    same cache content bit for bit: logits, tokens, Top-K."""
    _, _, ranks = runs
    for r, res in enumerate(ranks):
        for t, (got, want) in enumerate(zip(res[c][form]["ticks"],
                                            res[c]["dense"])):
            for k in ("logits", "tokens", "prev_topk", "sel_gvr", "length"):
                _eq(got[k], want[k], (c, form, t, r, k))


@pytest.mark.parametrize("c,vk", _cases(("scan", "mq")))
def test_mesh_verify_matches_jax(runs, c, vk):
    """The verify tick: JAX's mesh tick equals its one-device tick; each
    rank's rows equal JAX's mesh tick's (drafts, out tokens, accept
    lengths, layer-0 GVR path, rolled-back feedback, global `length`;
    logits within TOL); some rows accept every draft, some fewer."""
    _, jax_out, ranks = runs
    mk, rk = f"{c}/mesh/{vk}", f"{c}/ref/{vk}"
    for k in ("drafts", "out_tokens", "accept", "sel_pos", "prev_topk",
              "topk_valid", "sel_gvr", "length"):
        _eq(jax_out[f"{mk}/{k}"], jax_out[f"{rk}/{k}"], (c, vk, k))
    accept = jax_out[f"{mk}/accept"]
    assert accept.max() == 2 and accept.min() < 2, accept
    for r, res in enumerate(ranks):
        rows, got = res[c]["rows"], res[c][vk]
        for k in ("out_tokens", "accept", "sel_pos"):
            _eq(got[k], jax_out[f"{mk}/{k}"][rows], (c, vk, r, k))
        for k in ("prev_topk", "topk_valid", "sel_gvr"):
            _eq(got[k], jax_out[f"{mk}/{k}"][:, rows], (c, vk, r, k))
        _eq(got["length"], jax_out[f"{mk}/length"], (c, vk, r))
        _close(got["logits"].numpy(), jax_out[f"{mk}/logits"][rows], (c, vk, r))


@pytest.mark.parametrize("c", [c for c, s in CASES.items() if "mq" in s["forms"]])
def test_mesh_verify_mq_equals_scan(runs, c):
    """The port's two verify bodies on the mesh: the same tokens, accept
    lengths, GVR paths and rolled-back state on every rank; logits within
    TOL (the tied head's GEMM rounds by row count on the CPU)."""
    _, _, ranks = runs
    for r, res in enumerate(ranks):
        scan, mq = res[c]["scan"], res[c]["mq"]
        for k in ("out_tokens", "accept", "sel_pos", "prev_topk",
                  "topk_valid", "sel_gvr", "length"):
            _eq(mq[k], scan[k], (c, r, k))
        _close(mq["logits"].numpy(), scan["logits"].numpy(), (c, r))


@pytest.mark.parametrize("c", list(CASES))
def test_mesh_paged_bill(runs, c):
    """A paged tick's collectives: where the batch is sharded over "data",
    one all-gather of the new rows a layer ("paged_write") and, in the
    verify tick, one of the accept lengths ("accept"); over "model" the
    dense mesh step's tags. Where "data" has one rank, nothing on it."""
    _, _, ranks = runs
    cfg = jget_config(CASES[c]["arch"], smoke=True)
    data = CASES[c]["shape"][0]
    for r, res in enumerate(ranks):
        bill = res[c]["token"]["ticks"][0]["bill"]
        dense = res[c]["dense"][0]["bill"]
        assert bill["model"] == dense["model"], (c, r, bill, dense)
        if data == 1:
            assert "data" not in bill, bill
            continue
        assert set(bill["data"]) == {"paged_write"}, bill
        assert bill["data"]["paged_write"]["calls"] == cfg.n_layers, bill
        for vk in ("scan", "mq"):
            if vk in res[c]:
                assert res[c][vk]["bill"]["data"]["accept"]["calls"] == 1


def test_mesh_paged_min_write_pos_writes_the_sink(runs):
    """llama's page form masks row 1's first write: its page row at
    length is the start state's on every side, and the sink page took
    the write."""
    inp, jax_out, ranks = runs
    pre = "llama/paged/"
    length = int(inp[pre + "length"][1])
    page = inp[pre + "page_table"][1, length // PAGE]
    at = (slice(None), page, length % PAGE)
    sink = inp[pre + "k_pages"].shape[1] - 1
    for run in ("mesh", "ref"):
        pools = jax_out[f"llama/{run}/page/k_pages"]
        _eq(pools[at], inp[pre + "k_pages"][at], run)
        assert (pools[:, sink] != inp[pre + "k_pages"][:, sink]).any(), run
    for r, res in enumerate(ranks):
        got = res["llama"]["page"]["k_pages"].numpy()
        sl = _kv_block("llama", res["llama"]["coords"])
        _eq(got[at], inp[pre + "k_pages"][at][..., sl, :], r)


def test_facade_mesh_keywords():
    """`Model.serve_step_paged` / `serve_step_spec_paged` take `mesh=,
    rules=` and refuse a mesh with no rank (an AbstractMesh); the other
    families' facades keep raising, as the reference's."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    from repro_torch.parallel.sharding import AbstractMesh, make_rules
    mesh = AbstractMesh((2, 2), ("data", "model"))
    rules = make_rules(mesh)
    model = build_model(get_config("llama3.2-1b", smoke=True), device="cpu")
    st = model.init_paged_decode_state(4, 64, num_pages=32, page_size=PAGE)
    tok = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="live Mesh"):
        model.serve_step_paged({}, st, tok, mesh=mesh, rules=rules)
    with pytest.raises(ValueError, match="live Mesh"):
        model.serve_step_spec_paged({}, st, tok[:, None], draft_len=[0] * 4,
                                    max_accept=[0] * 4, mesh=mesh, rules=rules)
    whisper = build_model(get_config("whisper-medium", smoke=True), device="cpu")
    for call in (lambda: whisper.serve_step_paged({}, {}, tok, mesh=mesh,
                                                  rules=rules),
                 lambda: whisper.paged_state_specs(rules, batch=4, max_len=64,
                                                   num_pages=32, page_size=PAGE)):
        with pytest.raises(NotImplementedError):
            call()
