"""The DSA indexer scoring route of the port (kernels B2, B5, B9's scoring
launch): its plain versions against the JAX package's served path at
llama3.2-1b's indexer widths, and the pure helpers that fix the Hopper
body's schedule. Inputs are made with numpy from seeds.

The plain versions (`ref.indexer_scores_ref`, `ref.paged_indexer_scores_ref`)
run on the CPU wherever the port scores; on the card each kernel is held
against them by `tests/test_torch_cuda.py` and `python3 chip_smoke.py`.

Tolerances. The query is made exact in both frameworks (x and wq are
small integers and bf16 values whose products and sums are exact in f32,
RoPE at position 0 is the identity), so both score the same bf16 q and
keys. On integer-valued inputs every product and sum is exact in f32 and
the rows are equal bit for bit. Otherwise each head's 128 products are
exact in f32 and the two frameworks add them, and then the 64 weighted
heads, in different orders: a few ulps of the largest partial sum, held
at 1e-5 of the row's largest |score|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import indexer_scores_ref as jax_indexer_scores_ref
from repro.sparse import dsa as jdsa
from repro_torch.kernels import ops, ref
from repro_torch.sparse import dsa as tdsa

H_I, D_I = 64, 128                  # llama3.2-1b's indexer heads and dim
NEG = -3.4028234663852886e38


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 values, kept as float32."""
    return torch.from_numpy(a.astype(np.float32)).bfloat16().float().numpy()


def _inputs(seed, b, n, integer_valued):
    """x (B, 4), wq (4, H*d), w (H,) and a (B, N, d) key cache in bf16
    values: x @ wq is exact in f32 in any order."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (b, 4)).astype(np.float32)
    if integer_valued:
        wq = rng.choice([-1.0, 1.0], (4, H_I * D_I)).astype(np.float32)
        kc = rng.integers(-2, 3, (b, n, D_I)).astype(np.float32)
        w = rng.integers(-3, 4, (H_I,)).astype(np.float32) / 4
    else:
        wq = _bf16(rng.choice([-1.0, 1.0], (4, H_I * D_I))
                   * rng.uniform(0.5, 2.0, (4, H_I * D_I)))
        kc = _bf16(rng.normal(size=(b, n, D_I)))
        w = rng.normal(size=(H_I,)).astype(np.float32)
    return x, wq, w, kc


def _jax_served(x, wq, w, kc, lengths):
    """src/repro/sparse/dsa.py:indexer_scores on a bf16 cache, RoPE at
    position 0."""
    return np.asarray(jdsa.indexer_scores(
        {"wq": jnp.asarray(wq), "w": jnp.asarray(w)}, jnp.asarray(x),
        jnp.asarray(kc, dtype=jnp.bfloat16), jnp.zeros(len(x), jnp.int32),
        jnp.asarray(lengths), heads=H_I, dim=D_I, rope_base=500000.0))


def _port_q(x, wq):
    """The port's served query (the B5 wrapper's input), bf16."""
    return tdsa.indexer_q({"wq": torch.from_numpy(wq)}, torch.from_numpy(x),
                          torch.zeros(len(x), dtype=torch.int32), heads=H_I,
                          dim=D_I, rope_base=500000.0, dtype=torch.bfloat16)


def _close(got, want):
    if np.array_equal(got, want):
        return
    live = want > -1e38
    assert np.array_equal(got > -1e38, live)
    scale = np.abs(want[live]).max()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("integer_valued", [True, False])
def test_plain_contiguous_scoring_matches_jax_served_path(integer_valued):
    b, n = 3, 512
    x, wq, w, kc = _inputs(11, b, n, integer_valued)
    lengths = np.array([n, 300, 1], np.int32)
    want = _jax_served(x, wq, w, kc, lengths)
    got = ref.indexer_scores_ref(_port_q(x, wq), torch.from_numpy(kc).bfloat16(),
                                 torch.from_numpy(w), torch.from_numpy(lengths))
    if integer_valued:
        np.testing.assert_array_equal(got.numpy(), want)
    _close(got.numpy(), want)
    # the B5 wrapper on CPU tensors is that plain version, and launches nothing
    ops.reset_launch_counts()
    via_ops = ops.indexer_scores(_port_q(x, wq), torch.from_numpy(kc).bfloat16(),
                                 torch.from_numpy(w), torch.from_numpy(lengths))
    assert torch.equal(via_ops, got) and ops.indexer_scores.launches == 0


@pytest.mark.parametrize("integer_valued", [True, False])
@pytest.mark.parametrize("ps", [16, 64])
def test_plain_paged_scoring_matches_jax_served_path(ps, integer_valued):
    """The paged plain version over a shuffled pool with an unmapped page
    inside slot 1's extent: the served path's scores on the logical view
    at every mapped position, NEG on the unmapped page."""
    b, n = 3, 512
    x, wq, w, kc = _inputs(12 + ps, b, n, integer_valued)
    lengths = np.array([n, 300, 1], np.int32)
    mp = n // ps
    rng = np.random.default_rng(ps)
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    pages = np.zeros((b * mp, ps, D_I), np.float32)
    pages[table.reshape(-1)] = kc.reshape(b * mp, ps, D_I)
    table[1, 100 // ps] = -1
    want = _jax_served(x, wq, w, kc, lengths)
    got = ref.paged_indexer_scores_ref(
        _port_q(x, wq), torch.from_numpy(pages).bfloat16(), torch.from_numpy(w),
        torch.from_numpy(table), torch.from_numpy(lengths)).numpy()
    mapped = np.repeat(table >= 0, ps, axis=1)
    assert (got[~mapped] == NEG).all()
    want = np.where(mapped, want, got)
    if integer_valued:
        np.testing.assert_array_equal(got, want)
    _close(got, want)


def test_plain_paged_scoring_takes_per_slot_weights_like_jax():
    """w (B, H) in the paged plain version, against the JAX package's plain
    Eq. 1 over the gathered view (the Pallas kernels take w (H,) or
    (B, H))."""
    rng = np.random.default_rng(4)
    b, ps, mp = 2, 16, 6
    q = _bf16(rng.normal(size=(b, H_I, D_I)))
    pages = _bf16(rng.normal(size=(b * mp, ps, D_I)))
    table = rng.permutation(b * mp).astype(np.int32).reshape(b, mp)
    w = rng.normal(size=(b, H_I)).astype(np.float32)
    lengths = np.array([mp * ps, 40], np.int32)
    got = ref.paged_indexer_scores_ref(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(pages).bfloat16(),
        torch.from_numpy(w), torch.from_numpy(table), torch.from_numpy(lengths))
    view = pages[table].reshape(b, mp * ps, D_I)
    want = np.asarray(jax_indexer_scores_ref(
        jnp.asarray(q), jnp.asarray(view), jnp.asarray(w),
        lengths=jnp.asarray(lengths)))
    _close(got.numpy(), np.where(want > -1e38, want, NEG))
    same = ref.paged_indexer_scores_ref(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(pages).bfloat16(),
        torch.from_numpy(w[0]), torch.from_numpy(table), torch.from_numpy(lengths))
    wide = ref.paged_indexer_scores_ref(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(pages).bfloat16(),
        torch.from_numpy(np.stack([w[0], w[0]])), torch.from_numpy(table),
        torch.from_numpy(lengths))
    assert torch.equal(same, wide)


# ------------------------------------------------- the body's schedule ----

def test_score_route_is_decided_by_dtype_alone():
    assert ops.score_route(torch.bfloat16) == "mma"
    assert ops.score_route(torch.float32) == "fma"
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.score_route(torch.float16)
    for rows, n, h, d, ps in [(4, 8192, 64, 128, 64), (12, 8192, 64, 128, 64),
                              (3, 320, 8, 64, 4), (1, 1, 16, 16, 0)]:
        assert ops.score_schedule(torch.bfloat16, rows, n, h, d, ps)["route"] == "mma"
        assert ops.score_schedule(torch.float32, rows, n, h, d, ps)["route"] == "fma"


def test_heads_are_padded_to_whole_warps():
    assert [ops.padded_heads(h) for h in (1, 8, 16, 17, 64, 65, 256)] == \
        [16, 16, 16, 32, 64, 80, 256]
    assert ops.score_schedule(torch.bfloat16, 3, 320, 8, 64)["heads"] == 16
    assert ops.score_schedule(torch.float32, 3, 320, 8, 64)["heads"] == 8


def test_score_ctas_fill_the_card_at_the_kernel_phase():
    """(tiles per CTA, CTAs per row): two tiles per CTA through a double
    buffer where that still gives each of the 132 SMs a CTA, else one."""
    assert ops.SCORE_TILE == 64
    assert ops.score_ctas_per_row(4, 8192) == (2, 64)       # B2/B5: 256 CTAs
    assert ops.score_ctas_per_row(12, 8192) == (2, 64)      # B9 at Q=3: 768
    assert ops.score_ctas_per_row(4, 16 * 283) == (2, 36)   # 71 tiles: 144
    assert ops.score_ctas_per_row(1, 16 * 283) == (1, 71)   # alone: 71
    assert ops.score_ctas_per_row(3, 320) == (1, 5)
    assert ops.score_ctas_per_row(1, 1) == (1, 1)
    assert ops.score_ctas_per_row(4, 131072) == (2, 1024)
    stages = [ops.score_schedule(torch.bfloat16, rows, n, 64, 128, 64)["stages"]
              for rows, n in [(4, 8192), (12, 8192), (3, 320), (1, 16 * 283)]]
    assert stages == [2, 2, 1, 1]          # a CTA's tiles all in flight
    for rows, n in [(4, 8192), (12, 8192), (1, 100_000), (64, 4096), (2, 8448)]:
        per, ctas = ops.score_ctas_per_row(rows, n)
        assert rows * ctas >= 132 and per * ctas >= -(-n // 64)


def test_score_sum_order_depends_on_heads_and_dim_alone():
    """What orders a score's sums (the body, its padded heads, the tile of
    the bf16 body, the float32 body's heads per thread) is the same for
    every page size, layout (ps 0) and row count; only the grid moves."""
    for h, d in [(8, 64), (64, 128), (48, 16)]:
        for dtype, keys in ((torch.bfloat16, ("route", "tile", "heads")),
                            (torch.float32, ("route", "heads_per_thread"))):
            seen = {tuple(ops.score_schedule(dtype, rows, n, h, d, ps)[k]
                          for k in keys)
                    for rows in (1, 4, 12) for n in (64, 320, 8192)
                    for ps in (0, 4, 8, 16, 64)}
            assert len(seen) == 1, (dtype, h, d, seen)


@pytest.mark.parametrize("h,d", [(64, 72), (64, 8), (64, 272), (300, 128)])
def test_bf16_schedule_refuses_shapes_off_the_mma_grid(h, d):
    with pytest.raises(ValueError, match=rf"\(4, {h}, {d}\)"):
        ops.score_schedule(torch.bfloat16, 4, 8192, h, d, 64)
    if h <= 64:                        # the float32 body takes any d
        assert ops.score_schedule(torch.float32, 4, 8192, h, d, 64)["tile"] == 64
