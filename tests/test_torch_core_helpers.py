"""The port's `core` helpers against the JAX package's: the RoPE / YaRN
score structure (`core/rope.py`), the Top-K feedback buffer and hit
ratios (`core/temporal.py`) and GVR's uniform warm start and global-pass
count (`core/gvr.py`), on identical inputs made with numpy from seeds.

Tolerances: the inverse frequencies come from the same numpy lines, so
they are equal. g(Delta) sums 32 float32 cosines whose arguments reach
1.3e5 rad at n = 131072, and the two frameworks' cosines differ in the
last bits there: g within 1e-4 of its largest value (|g| <= 64) in
absolute terms, relatively 1e-4. The static prior is an argtopk of g, so
the two index sets may differ only where the K-th and (K+1)-th values of
g lie within that tolerance of each other. `apply_rope` and the synthetic
scores (products and sums of 64 terms, cos/sin as above) within rtol =
1e-5, atol = 1e-4 · max|scores|. The hit ratios, the feedback buffer,
`uniform_pre_idx` and `global_passes` are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore
from repro.core import gvr as jgvr
from repro.core import rope as jrope
from repro.core import temporal as jtemp
from repro_torch.core import gvr as tgvr
from repro_torch.core import rope as trope
from repro_torch.core import temporal as ttemp


def test_core_exports_every_name_but_sp_gvr():
    """`repro_torch.core` exports every name of the reference's,
    the sequence-parallel GVR's included."""
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


@pytest.mark.parametrize("dim", [64, 32, 128])
def test_inv_freq_equal(dim):
    np.testing.assert_array_equal(trope.yarn_inv_freq(dim).numpy(),
                                  np.asarray(jrope.yarn_inv_freq(dim)))
    np.testing.assert_array_equal(trope.rope_inv_freq(dim).numpy(),
                                  np.asarray(jrope.rope_inv_freq(dim)))
    assert trope.yarn_inv_freq(dim).dtype == torch.float32
    assert (trope.D_ROPE, trope.ROPE_BASE, trope.YARN_SCALING) == \
        (jrope.D_ROPE, jrope.ROPE_BASE, jrope.YARN_SCALING)


def _g_tol(g):
    return 1e-4 * np.abs(g).max()


@pytest.mark.parametrize("yarn", [True, False])
@pytest.mark.parametrize("n", [8192, 131072])
def test_g_delta_matches_jax(n, yarn):
    want = np.asarray(jrope.g_delta(n, yarn=yarn))
    got = trope.g_delta(n, yarn=yarn).numpy()
    assert got.shape == want.shape == (n,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=_g_tol(want))


@pytest.mark.parametrize("n, k", [(8192, 2048), (131072, 2048), (1000, 2048)])
def test_static_pre_idx_matches_jax_as_a_set(n, k):
    """The static prior as an index set: every index the packages do not
    share has a g value within the g tolerance of the K-th largest g,
    where the argtopk of the two g's may rightly split."""
    _same_prior(trope.compute_static_pre_idx(n, k),
                jrope.compute_static_pre_idx(n, k), n, k)


def _same_prior(got, want, n, k):
    want = np.asarray(want)
    assert got.dtype == torch.int32 and got.shape == want.shape == (min(k, n),)
    assert len(set(got.tolist())) == got.shape[0]
    g = np.asarray(jrope.g_delta(n))
    kth = np.sort(g)[::-1][min(k, n) - 1]
    for i in set(got.tolist()) ^ set(want.tolist()):
        assert abs(g[i] - kth) <= _g_tol(g), (i, g[i], kth)


def test_apply_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 64)).astype(np.float32)
    ang = rng.uniform(0, 6.3, size=(5, 32)).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    want = np.asarray(jrope.apply_rope(*(jnp.asarray(a) for a in (x, c, s))))
    got = trope.apply_rope(*(torch.from_numpy(a) for a in (x, c, s))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _jax_scores(q, kmat, d_rope):
    """The reference's `_generate_scores` after its draws, line for line."""
    n = kmat.shape[0]
    inv_freq = jrope.yarn_inv_freq(d_rope)
    pos = jnp.arange(n, dtype=jnp.float32)
    cos_t = jnp.cos(pos[:, None] * inv_freq[None, :])
    sin_t = jnp.sin(pos[:, None] * inv_freq[None, :])
    return (jrope.apply_rope(q, cos_t[:1], sin_t[:1])
            @ jrope.apply_rope(kmat, cos_t, sin_t).T).squeeze(0)


def _close_scores(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("n", [8192, 131072])
def test_scores_from_qk_matches_jax(n):
    """The deterministic half of `generate_indexer_scores` on the same
    numpy q (1, 64) and keys (n, 64), drawn as the reference draws them
    (1 + 0.1 N(0, 1))."""
    rng = np.random.default_rng(n)
    q = (1 + 0.1 * rng.normal(size=(1, 64))).astype(np.float32)
    kmat = (1 + 0.1 * rng.normal(size=(n, 64))).astype(np.float32)
    want = np.asarray(jax.jit(_jax_scores, static_argnums=2)(
        jnp.asarray(q), jnp.asarray(kmat), 64))
    got = trope.scores_from_qk(torch.from_numpy(q), torch.from_numpy(kmat), 64)
    assert got.dtype == torch.float32 and got.shape == (n,)
    _close_scores(got.numpy(), want)


def test_generate_indexer_scores_at_am_0_matches_jax():
    """With am = 0 the draws drop out (q and every key are all ones), so
    the whole generator is deterministic: scores and static prior."""
    n, k = 8192, 2048
    js, jp = jrope.generate_indexer_scores(jax.random.PRNGKey(0), n, k, am=0.0)
    ts, tp = trope.generate_indexer_scores(torch.Generator().manual_seed(0), n,
                                           k, am=0.0)
    _close_scores(ts.numpy(), np.asarray(js))
    _same_prior(tp, jp, n, k)
    # the random generator draws from its generator: two seeds, two rows
    a = trope.generate_indexer_scores(torch.Generator().manual_seed(1), 256, 16)[0]
    b = trope.generate_indexer_scores(torch.Generator().manual_seed(2), 256, 16)[0]
    assert a.shape == (256,) and not torch.equal(a, b)


def _idx_pairs(rng, n, shape, k):
    """Index rows with out-of-range entries on both sides (clipped)."""
    a = rng.integers(-3, n + 3, shape + (k,)).astype(np.int32)
    b = rng.integers(-3, n + 3, shape + (k,)).astype(np.int32)
    b[..., : k // 2] = a[..., : k // 2]               # some real overlap
    return a, b


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_hit_ratios_equal(shape):
    rng = np.random.default_rng(len(shape))
    n, k = 64, 16
    a, b = _idx_pairs(rng, n, shape, k)
    want = np.asarray(jtemp.hit_ratio(jnp.asarray(a), jnp.asarray(b), n))
    got = ttemp.hit_ratio(torch.from_numpy(a), torch.from_numpy(b), n)
    assert got.dtype == torch.float32 and got.shape == want.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)
    for shift in (1, 5, -2):
        want = np.asarray(jtemp.shifted_hit_ratio(jnp.asarray(a), jnp.asarray(b),
                                                  n, shift))
        got = ttemp.shifted_hit_ratio(torch.from_numpy(a), torch.from_numpy(b),
                                      n, shift).numpy()
        np.testing.assert_array_equal(got, want)


def _fb_equal(t, j):
    assert t.prev_idx.dtype == torch.int32 and t.valid.dtype == torch.bool
    np.testing.assert_array_equal(t.prev_idx.numpy(), np.asarray(j.prev_idx))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))


@pytest.mark.parametrize("hint", [None, 5000, 1])
def test_feedback_buffer_equal(hint):
    """init, update (an int layer), reset (a hint or none) and recycle, in
    turns, on (L=3, B=4, K=16)."""
    l, b, k = 3, 4, 16
    j = jtemp.init_feedback(l, b, k, hint)
    t = ttemp.init_feedback(l, b, k, hint)
    _fb_equal(t, j)
    rng = np.random.default_rng(7)
    for layer in (1, 0, 2):
        new = rng.integers(0, 5000, (b, k)).astype(np.int64)
        j = jtemp.update_feedback(j, layer, jnp.asarray(new))
        t = ttemp.update_feedback(t, layer, torch.from_numpy(new))
        _fb_equal(t, j)
    before = t.prev_idx.clone()
    j, t = jtemp.recycle_slot(j, 2), ttemp.recycle_slot(t, 2)
    _fb_equal(t, j)
    j, t = jtemp.reset_slot(j, 1, hint), ttemp.reset_slot(t, 1, hint)
    _fb_equal(t, j)
    j, t = jtemp.reset_slot(j, 2), ttemp.reset_slot(t, 2)
    _fb_equal(t, j)
    assert torch.equal(before[:, 0], t.prev_idx[:, 0])


@pytest.mark.parametrize("n, m, batch", [(8192, 2048, None), (131072, 2048, 4),
                                         (1000, 2048, 2), (7, 1, None)])
def test_uniform_pre_idx_equal(n, m, batch):
    want = np.asarray(jgvr.uniform_pre_idx(n, m, batch))
    got = tgvr.uniform_pre_idx(n, m, batch)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_global_passes_equal():
    """I + 1 per row from each package's own GVR on the same rows,
    warm-started from the uniform prior and from a near-exact one."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 4096)).astype(np.float32)
    k = 256
    exact = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k], axis=1)
    for prev in (np.array(jgvr.uniform_pre_idx(4096, k, 4)), exact.astype(np.int32)):
        js = jgvr.gvr_topk(jnp.asarray(x), jnp.asarray(prev), k).stats
        ts = tgvr.gvr_topk(torch.from_numpy(x), torch.from_numpy(prev), k).stats
        want = np.asarray(jgvr.global_passes(js))
        got = tgvr.global_passes(ts)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got >= 1).all()
