"""PyTorch port vs the JAX package: GVR, radix/exact Top-K, the selector
and the temporal feedback helpers, on identical rows made with numpy.

Indices, values, threshold, n_gt, n_ge and every iteration count must be
equal. The phase-1 mean `t0` is compared to float32 rounding only: it is a
sum of the predicted values, and XLA and torch add them in different orders
(logged as a reference caveat in ROADMAP Queue C); the secant iterations it
seeds still agree on every case here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gvr as jgvr
from repro.core import temporal as jtemp
from repro.core import topk_baselines as jbase
from repro.sparse import selector as jsel
from repro_torch.core import gvr as tgvr
from repro_torch.core import temporal as ttemp
from repro_torch.core import topk_baselines as tbase
from repro_torch.sparse import selector as tsel

RNG = np.random.default_rng(0)

DISTS = {
    "normal": lambda b, n: RNG.normal(size=(b, n)),
    "lognormal": lambda b, n: RNG.lognormal(0, 2, size=(b, n)),
    "ties8": lambda b, n: RNG.integers(0, 8, size=(b, n)).astype(float),
    "const": lambda b, n: np.ones((b, n)),
    "negzero": lambda b, n: -np.abs(RNG.normal(size=(b, n))),
}


def _both(x, prev=None, lengths=None):
    tx = torch.from_numpy(x)
    jx = jnp.asarray(x)
    out = [(jx, tx)]
    for a in (prev, lengths):
        out.append((None, None) if a is None else (jnp.asarray(a), torch.from_numpy(a)))
    return out


def _assert_stats_equal(js, ts):
    for f in js._fields:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        if f == "t0":
            np.testing.assert_allclose(b, a, rtol=2e-6, equal_nan=True)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


def _prev(b, n, m, kind):
    if kind == "random":
        return np.stack([RNG.choice(n, m, replace=False) for _ in range(b)]).astype(np.int32)
    if kind == "recycled":
        return np.full((b, m), -1, np.int32)
    if kind == "all_dup":
        return np.zeros((b, m), np.int32)
    raise ValueError(kind)


@pytest.mark.parametrize("dist", sorted(DISTS))
@pytest.mark.parametrize("k", [1, 64])
def test_gvr_threshold_and_extract_match_jax(dist, k):
    b, n = 3, 4096
    x = DISTS[dist](b, n).astype(np.float32)
    prev = _prev(b, n, max(k, 16), "random")
    (jx, tx), (jp, tp), _ = _both(x, prev)
    js = jgvr.gvr_threshold(jx, jp, k)
    ts = tgvr.gvr_threshold(tx, tp, k)
    _assert_stats_equal(js, ts)
    jv, ji = jgvr.extract_topk(jx, js.threshold, k)
    tv, ti = tgvr.extract_topk(tx, ts.threshold, k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["perfect", "adversarial", "all_dup",
                                  "recycled", "m_lt_k", "neg_tail"])
def test_gvr_topk_prediction_cases_match_jax(case):
    """Prediction quality, recycled (-1) slots, fewer predictions than K and
    NEG-masked tails (length < K: more than C ties at the sentinel)."""
    b, n, k = 2, 2048, 128
    x = RNG.normal(size=(b, n)).astype(np.float32)
    lengths = None
    if case == "perfect":
        prev = np.argsort(-x, -1)[:, :k].astype(np.int32)
    elif case == "adversarial":
        prev = np.argsort(x, -1)[:, :k].astype(np.int32)
    elif case == "m_lt_k":
        prev = _prev(b, n, k // 4, "random")
    elif case == "neg_tail":
        prev = _prev(b, n, k, "random")
        lengths = np.array([100, 700], np.int32)
    else:
        prev = _prev(b, n, k, case)
    (jx, tx), (jp, tp), (jl, tl) = _both(x, prev, lengths)
    jr = jgvr.gvr_topk(jx, jp, k, lengths=jl)
    tr = tgvr.gvr_topk(tx, tp, k, lengths=tl)
    _assert_stats_equal(jr.stats, tr.stats)
    np.testing.assert_array_equal(tr.indices.numpy(), np.asarray(jr.indices))
    np.testing.assert_array_equal(tr.values.numpy(), np.asarray(jr.values))


def test_gvr_fallback_net_matches_jax():
    """Budgets too small for the refine to converge: the `done=2` safety net
    takes over, flags the row, and the result stays exact."""
    b, n, k = 2, 1024, 32
    x = RNG.integers(0, 50, size=(b, n)).astype(np.float32)
    prev = _prev(b, n, k, "random")
    (jx, tx), (jp, tp), _ = _both(x, prev)
    js = jgvr.gvr_threshold(jx, jp, k, max_secant_iters=1, max_snap_iters=1,
                            max_hist_levels=0)
    ts = tgvr.gvr_threshold(tx, tp, k, max_secant_iters=1, max_snap_iters=1,
                            max_hist_levels=0)
    assert bool(np.asarray(js.fallback).any())
    _assert_stats_equal(js, ts)


@pytest.mark.parametrize("dist", ["normal", "ties8", "negzero", "const"])
@pytest.mark.parametrize("k", [16, 300])
def test_radix_select_matches_jax(dist, k):
    b, n = 3, 3000
    x = DISTS[dist](b, n).astype(np.float32)
    jv, ji, js = jbase.radix_select_topk(jnp.asarray(x), k)
    tv, ti, ts = tbase.radix_select_topk(torch.from_numpy(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for f in js._fields:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_exact_and_sort_topk_tie_order():
    x = np.array([[3, 1, 3, 2, 3, 0, 1, 2]], np.float32)
    jv, ji = jbase.exact_topk(jnp.asarray(x), 4)
    tv, ti = tbase.exact_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    sv, si = tbase.sort_topk(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(si.numpy(), np.asarray(ji))


@pytest.mark.parametrize("method", ["mixed", "radix", "exact", "gvr", "auto"])
def test_select_topk_matches_jax(method):
    b, n, k = 4, 512, 32
    x = RNG.normal(size=(b, n)).astype(np.float32)
    x[2, :40] = 5.0                                   # a tie block
    prev = _prev(b, n, k, "random")
    prev[3] = -1                                      # recycled row
    valid = np.array([True, False, True, False])
    lengths = np.array([n, 300, 64, 20], np.int32)
    kw = dict(method=method, min_n_for_selection=128)
    jo = jsel.select_topk(jnp.asarray(x), k, prev_idx=jnp.asarray(prev),
                          prev_valid=jnp.asarray(valid),
                          lengths=jnp.asarray(lengths), **kw)
    to = tsel.select_topk(torch.from_numpy(x), k, prev_idx=torch.from_numpy(prev),
                          prev_valid=torch.from_numpy(valid),
                          lengths=torch.from_numpy(lengths), **kw)
    assert to.method == jo.method
    np.testing.assert_array_equal(to.indices.numpy(), np.asarray(jo.indices))
    np.testing.assert_array_equal(to.values.numpy(), np.asarray(jo.values))
    np.testing.assert_array_equal(to.gvr_rows.numpy(), np.asarray(jo.gvr_rows))
    if jo.secant_iters is not None:
        np.testing.assert_array_equal(to.secant_iters.numpy(),
                                      np.asarray(jo.secant_iters))


@pytest.mark.parametrize("n,gate,has_valid,want", [
    (100, 200_000, True, "exact"), (5000, 200_000, True, "mixed"),
    (5000, 200_000, False, "gvr"), (300_000, 200_000, True, "radix")])
def test_selector_auto_gate(n, gate, has_valid, want):
    assert tsel.resolve_method("auto", n, has_prev=True, has_valid=has_valid,
                               gate_max_n=gate, min_n_for_selection=4096) == want


@pytest.mark.parametrize("k", [1, 16, 2048])
@pytest.mark.parametrize("hint", [1, 7, 64, 2300, 8192, None])
def test_seed_slot_idx_matches_jax(k, hint):
    np.testing.assert_array_equal(ttemp.seed_slot_idx(k, hint).numpy(),
                                  np.asarray(jtemp.seed_slot_idx(k, hint)))


def test_reset_and_recycle_slot_arrays_match_jax():
    l, b, k = 2, 3, 16
    prev = RNG.integers(0, 50, (l, b, k)).astype(np.int32)
    valid = np.ones((l, b), bool)
    jp, jv = jtemp.reset_slot_arrays(jnp.asarray(prev), jnp.asarray(valid), 1, 9)
    tp, tv = ttemp.reset_slot_arrays(torch.from_numpy(prev), torch.from_numpy(valid), 1, 9)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    jp, jv = jtemp.recycle_slot_arrays(jp, jv, 2)
    tp, tv = ttemp.recycle_slot_arrays(tp, tv, 2)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert prev[0, 1, 0] == torch.from_numpy(prev)[0, 1, 0]   # inputs untouched
