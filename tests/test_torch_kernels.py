"""The port's kernel wrappers B1–B4 on CPU tensors (their plain versions)
against the JAX package's Pallas kernels run in interpret mode, and B3
against the served XLA form. Inputs are made with numpy from seeds.

Tolerances: Top-K indices are exact. Score values are exact on the
integer-valued inputs (every product and sum is exact in float32) and
within 1e-6 relative otherwise (the two frameworks sum the dot products in
different orders). Attention outputs are float32 softmax averages over the
same rows summed in different orders: rtol = atol = 1e-5. That holds for
the split form of B3/B4 too (`rows_per_split`: each split's max, sum and
PV taken alone, then merged as the kernel merges them): the merge rescales
each partial by exp(m_s - m), one more rounding per split.

The Hopper kernels themselves are held against these plain versions on
the card by `tests/test_torch_cuda.py` and `python3 chip_smoke.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.sparse.dsa import dsa_sparse_attention_paged
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(b, mp, p, holes=()):
    table = np.stack([RNG.choice(p, mp, replace=False) for _ in range(b)]).astype(np.int32)
    for r, c in holes:
        table[r, c] = -1
    return table


# ---------------------------------------------------------------- B1 ------

@pytest.mark.parametrize("dist", ["normal", "ties", "neg_tail"])
@pytest.mark.parametrize("n,k", [(1024, 32), (4096, 256)])
def test_b1_gvr_topk_matches_pallas(dist, n, k):
    b = 2
    if dist == "ties":
        x = RNG.integers(0, 7, size=(b, n)).astype(np.float32)
    else:
        x = RNG.normal(size=(b, n)).astype(np.float32)
    if dist == "neg_tail":                  # length < K: ties at the sentinel
        x[0, k // 2:] = -3.4028234663852886e38
    prev = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    prev[1, :5] = -1
    jv, ji, js = jops.gvr_topk(jnp.asarray(x), jnp.asarray(prev), k)
    tv, ti, ts = ops.gvr_topk(_t(x), _t(prev), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # threshold, n_gt, n_ge: exact in both forms
    np.testing.assert_array_equal(ts[:, 4:7].numpy(), np.asarray(js)[:, 4:7])
    assert ops.gvr_topk.launches == 0       # the CPU path launches nothing


def test_b1_fewer_predictions_than_k():
    b, n, k = 2, 2048, 128
    x = RNG.normal(size=(b, n)).astype(np.float32)
    prev = RNG.integers(0, n, (b, 20)).astype(np.int32)
    jv, ji, _ = jops.gvr_topk(jnp.asarray(x), jnp.asarray(prev), k)
    tv, ti, _ = ops.gvr_topk(_t(x), _t(prev), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------- B2 ------

@pytest.mark.parametrize("integer_valued", [True, False])
@pytest.mark.parametrize("page_size", [4, 8])
def test_b2_paged_indexer_topk_matches_pallas(page_size, integer_valued):
    p, b, mp, h, d, k = 10, 2, 8, 4, 16, 12
    n = mp * page_size
    if integer_valued:
        pages = RNG.integers(-2, 3, (p, page_size, d)).astype(np.float32)
        q = RNG.integers(-2, 3, (b, h, d)).astype(np.float32)
        w = np.full((h,), 0.25, np.float32)
    else:
        pages = RNG.normal(size=(p, page_size, d)).astype(np.float32)
        q = RNG.normal(size=(b, h, d)).astype(np.float32)
        w = np.abs(RNG.normal(size=(h,))).astype(np.float32)
    table = _table(b, mp, p, holes=[(1, mp - 1)])
    lengths = np.array([n, n - page_size - 3], np.int32)
    prev = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    jv, ji, _ = jops.paged_indexer_topk(jnp.asarray(q), jnp.asarray(pages),
                                        jnp.asarray(w), jnp.asarray(table),
                                        jnp.asarray(prev), k,
                                        lengths=jnp.asarray(lengths))
    tv, ti, _ = ops.paged_indexer_topk(_t(q), _t(pages), _t(w), _t(table),
                                       _t(prev), k, lengths=_t(lengths))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if integer_valued:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)


def test_b2_unmapped_and_out_of_length_positions_score_neg():
    p, ps, b, mp, h, d = 4, 4, 1, 4, 2, 8
    pages = RNG.normal(size=(p, ps, d)).astype(np.float32)
    pages[0] = 100.0                        # what a clipped -1 would read
    table = np.array([[1, -1, 2, 3]], np.int32)
    q = np.abs(RNG.normal(size=(b, h, d))).astype(np.float32)
    s = ops.paged_indexer_scores(_t(q), _t(pages), _t(np.ones(h, np.float32)),
                                 _t(table), _t(np.array([14], np.int32)))
    neg = s.numpy() < -1e38
    assert neg[0, 4:8].all() and neg[0, 14:].all() and not neg[0, :4].any()


# ------------------------------------------------------------ B3 / B4 -----

def _pools(p, ps, kvh, d):
    return (RNG.normal(size=(p, ps, kvh, d)).astype(np.float32),
            RNG.normal(size=(p, ps, kvh, d)).astype(np.float32))


@pytest.mark.parametrize("kvh,h", [(2, 8), (4, 4)])
def test_b3_paged_sparse_attn_matches_pallas(kvh, h):
    p, ps, b, mp, d, k = 9, 4, 2, 5, 16, 12
    n = mp * ps
    kp, vp = _pools(p, ps, kvh, d)
    table = _table(b, mp, p, holes=[(0, 2)])
    idx = np.stack([RNG.choice(n, k, replace=False) for _ in range(b)]).astype(np.int32)
    idx[1, 7:] = -1
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    lengths = np.full((b,), n, np.int32)
    want = jops.paged_sparse_decode_attn(jnp.asarray(q), jnp.asarray(kp),
                                         jnp.asarray(vp), jnp.asarray(table),
                                         jnp.asarray(idx))
    got = ops.paged_sparse_decode_attn(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(idx), _t(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b3_masks_idx_beyond_length_like_the_served_path():
    """Whenever length < K the Top-K holds NEG-scored positions at or past
    the length; the served XLA path masks them (the Pallas kernel does
    not). B3 must agree with the served path on every slot that has a
    valid entry."""
    p, ps, b, mp, kvh, h, d, k = 8, 4, 3, 6, 2, 4, 8, 16
    n = mp * ps
    kp, vp = _pools(p, ps, kvh, d)
    table = _table(b, mp, p)
    lengths = np.array([5, 13, n], np.int32)
    idx = np.stack([np.sort(RNG.choice(n, k, replace=False)) for _ in range(b)]).astype(np.int32)
    idx[0, :3] = [0, 2, 4]                   # ensure valid entries in slot 0
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    want = dsa_sparse_attention_paged(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(table),
                                      jnp.asarray(idx), jnp.asarray(lengths),
                                      scale=d ** -0.5)
    got = ops.paged_sparse_decode_attn(_t(q), _t(kp), _t(vp), _t(table),
                                       _t(idx), _t(lengths))
    assert ((idx >= lengths[:, None]).sum(-1) > 0).any()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b3_all_masked_slot_gives_zero():
    p, ps, kvh, h, d = 3, 4, 1, 2, 8
    kp, vp = _pools(p, ps, kvh, d)
    out = ops.paged_sparse_decode_attn(
        _t(RNG.normal(size=(1, h, d)).astype(np.float32)), _t(kp), _t(vp),
        _t(np.array([[0, 1]], np.int32)), _t(np.array([[-1, 6, 7]], np.int32)),
        _t(np.array([3], np.int32)))
    assert np.array_equal(out.numpy(), np.zeros((1, h, d), np.float32))


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("kvh,h", [(2, 8), (4, 4)])
def test_b4_paged_dense_attn_matches_pallas(kvh, h, window):
    p, ps, b, mp, d = 10, 4, 3, 4, 16
    kp, vp = _pools(p, ps, kvh, d)
    lengths = np.array([16, 9, 1], np.int32)
    table = _table(b, mp, p)
    table[1, 3] = -1                          # unmapped beyond the extent
    table[2, 1:] = -1
    q = RNG.normal(size=(b, h, d)).astype(np.float32)
    want = jops.paged_dense_decode_attn(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(table),
                                        jnp.asarray(lengths), window=window)
    got = ops.paged_dense_decode_attn(_t(q), _t(kp), _t(vp), _t(table),
                                      _t(lengths), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ------------------------------------------------ B3 / B4 split form -----

# (KVH, H, hd): G = H/KVH in {1, 2, 4, 8}, hd in {32, 64, 128}
_SPLIT_WIDTHS = [(4, 4, 32), (2, 4, 64), (1, 4, 128), (1, 8, 32)]


def _split_inputs(rng, b, p, ps, mp, kvh, h, hd):
    kp = rng.normal(size=(p, ps, kvh, hd)).astype(np.float32)
    vp = rng.normal(size=(p, ps, kvh, hd)).astype(np.float32)
    table = np.stack([rng.choice(p, mp, replace=False) for _ in range(b)]).astype(np.int32)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    return kp, vp, table, q


def _sparse_split_case(case, rng, b, n):
    """(K, R, lengths, idx) of one edge case of B3's split over entries;
    every slot keeps at least one valid entry (the served JAX form averages
    uniformly over an all-masked slot where the port gives 0)."""
    if case == "k_not_multiple_of_r":
        k, r, lengths = 11, 4, np.array([n, n - 5, n // 2], np.int32)
    elif case == "k_below_r":
        k, r, lengths = 3, 8, np.array([n, 9, n], np.int32)
    elif case == "split_all_masked":
        k, r, lengths = 12, 4, np.array([n, n, n - 3], np.int32)
    elif case == "one_valid_entry":
        k, r, lengths = 12, 4, np.array([n, 6, n], np.int32)
    else:                                   # length < K: NEG ties in the Top-K
        k, r, lengths = 12, 4, np.array([5, 9, n], np.int32)
    idx = np.stack([rng.choice(int(L), k, replace=int(L) < k)
                    for L in lengths]).astype(np.int32)
    if case == "split_all_masked":
        idx[:, 4:8] = -1                    # the second split of every slot
        idx[2, 9] = n - 1                   # and one entry >= length
    elif case == "one_valid_entry":
        idx[1] = -1
        idx[1, 6] = 2                       # alone in its split
        idx[1, 0] = 7                       # >= length 6: masked
    elif case == "neg_ties":
        # what GVR emits when length < K: the live positions, then the
        # lowest-index NEG ties at and past the length, ascending
        for s, L in enumerate(lengths[:2]):
            idx[s] = np.arange(k)
    return k, r, lengths, idx


@pytest.mark.parametrize("case", ["k_not_multiple_of_r", "k_below_r",
                                  "split_all_masked", "one_valid_entry",
                                  "neg_ties"])
@pytest.mark.parametrize("kvh,h,hd", _SPLIT_WIDTHS)
def test_b3_split_form_matches_unsplit_and_served_jax(kvh, h, hd, case):
    rng = np.random.default_rng(hd + h + len(case))
    p, ps, b, mp = 9, 4, 3, 5
    n = mp * ps
    kp, vp, table, q = _split_inputs(rng, b, p, ps, mp, kvh, h, hd)
    k, r, lengths, idx = _sparse_split_case(case, rng, b, n)
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(idx), _t(lengths))
    split = ref.paged_sparse_attn_ref(*args, rows_per_split=r)
    whole = ref.paged_sparse_attn_ref(*args)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    want = dsa_sparse_attention_paged(jnp.asarray(q), jnp.asarray(kp),
                                      jnp.asarray(vp), jnp.asarray(table),
                                      jnp.asarray(idx), jnp.asarray(lengths),
                                      scale=hd ** -0.5)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_b3_split_form_all_masked_slot_gives_zero():
    """Every split of slot 1 is masked; the merge's guards give 0."""
    rng = np.random.default_rng(3)
    p, ps, b, mp, kvh, h, hd = 6, 4, 2, 3, 2, 4, 32
    kp, vp, table, q = _split_inputs(rng, b, p, ps, mp, kvh, h, hd)
    idx = np.array([[0, 5, 9, 1, 2, 3, 4], [-1, 8, 9, -1, 11, -1, -1]], np.int32)
    lengths = np.array([12, 8], np.int32)
    out = ref.paged_sparse_attn_ref(_t(q), _t(kp), _t(vp), _t(table), _t(idx),
                                    _t(lengths), rows_per_split=2)
    assert np.array_equal(out[1].numpy(), np.zeros((h, hd), np.float32))
    np.testing.assert_allclose(
        out[0].numpy(), ref.paged_sparse_attn_ref(
            _t(q), _t(kp), _t(vp), _t(table), _t(idx), _t(lengths))[0].numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [None, 13])
@pytest.mark.parametrize("kvh,h,hd", _SPLIT_WIDTHS)
def test_b4_split_form_matches_unsplit_and_pallas(kvh, h, hd, window):
    """Splits of R = 8 positions (two pages of 4); window 13 at length 27
    begins at position 14, inside the split [8, 16); the slot of length 1
    has one live split."""
    rng = np.random.default_rng(hd + h + (window or 0))
    p, ps, b, mp = 12, 4, 3, 8
    kp, vp, table, q = _split_inputs(rng, b, p, ps, mp, kvh, h, hd)
    lengths = np.array([27, 9, 1], np.int32)
    table[1, 5:] = -1                       # unmapped beyond the extents
    table[2, 1:] = -1
    args = (_t(q), _t(kp), _t(vp), _t(table), _t(lengths))
    split = ref.paged_dense_attn_ref(*args, window=window, rows_per_split=2 * ps)
    whole = ref.paged_dense_attn_ref(*args, window=window)
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    want = jops.paged_dense_decode_attn(jnp.asarray(q), jnp.asarray(kp),
                                        jnp.asarray(vp), jnp.asarray(table),
                                        jnp.asarray(lengths), window=window)
    np.testing.assert_allclose(split.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_split_counts_depend_on_the_entry_count_alone():
    """The kernel's grid: splits = ceil(count / R), whatever B, Q or the
    mode; B4 and B10 split whole pages (B10: 32 splits of 256 positions at
    N = 8192)."""
    r = ops.ROWS_PER_SPLIT
    for mode in ("paged_sparse", "contig_sparse", "paged_sparse_mq"):
        assert ops.decode_attn_splits(mode, 2048, 8192, 64) == (r, 16)
        assert ops.decode_attn_splits(mode, r + 1, 8192, 64) == (r, 2)
        assert ops.decode_attn_splits(mode, 3, 8192, 64) == (r, 1)
    assert ops.decode_attn_splits("paged_dense", 0, 8192, 64) == (128, 64)
    assert ops.decode_attn_splits("paged_dense", 0, 100, 3) == (129, 1)
    assert ops.decode_attn_splits("paged_dense", 0, 1024, 256) == (256, 4)
    assert ops.decode_attn_splits("paged_pages", 2048, 8192, 64) == (256, 32)


# (n, ps): the kernel phase, the long row, the widths past the one-split
# kernel's shared memory (97,536 positions at ps 64), short and ragged
# tables, odd and large pages
_PG_TABLES = [(8192, 64), (131072, 64), (102400, 64), (97536 + 64, 64),
              (1024, 64), (320, 64), (4096, 16), (100, 3), (8256, 64),
              (3 * 7 * 1000, 7), (65536, 256), (1 << 20, 64)]


@pytest.mark.parametrize("n,ps", _PG_TABLES)
def test_b10_splits_are_whole_pages(n, ps):
    r, _ = ops.decode_attn_splits("paged_pages", 2048, n, ps)
    assert r % ps == 0 and r >= ops.PG_MIN_ROWS


@pytest.mark.parametrize("n,ps", _PG_TABLES)
def test_b10_splits_cover_the_table(n, ps):
    """Every position lies in a split and no split lies wholly past the
    table."""
    r, s = ops.decode_attn_splits("paged_pages", 2048, n, ps)
    assert s * r >= n > (s - 1) * r


@pytest.mark.parametrize("n,ps", _PG_TABLES)
def test_b10_split_count_depends_on_the_table_alone(n, ps):
    """The same schedule whatever K: a row's output depends on its own
    inputs only, and rows of different K share it."""
    got = {ops.decode_attn_splits("paged_pages", kc, n, ps)
           for kc in (0, 1, 64, 2048, 65535)}
    assert got == {ops.decode_attn_splits("paged_pages", 2048, n, ps)}


@pytest.mark.parametrize("n,ps", _PG_TABLES)
def test_b10_split_count_is_capped(n, ps):
    """At most PG_MAX_SPLITS splits, exactly that many where
    n / PG_MAX_SPLITS is a whole number of pages of at least PG_MIN_ROWS
    positions, one where the table holds no more than PG_MIN_ROWS."""
    r, s = ops.decode_attn_splits("paged_pages", 2048, n, ps)
    assert 1 <= s <= ops.PG_MAX_SPLITS
    if n % (ops.PG_MAX_SPLITS * ps) == 0 and n // ops.PG_MAX_SPLITS >= ops.PG_MIN_ROWS:
        assert (r, s) == (n // ops.PG_MAX_SPLITS, ops.PG_MAX_SPLITS)
    if n <= ops.PG_MIN_ROWS:
        assert s == 1


def test_wrappers_reject_mixed_devices():
    x = torch.zeros((1, 8))
    with pytest.raises(ValueError):
        ops._on_cpu(x, torch.zeros((1, 2), device="meta"))
