"""The cluster schedule of kernel B1 (GVR Top-K) and B9's chain:
`ops.gvr_schedule(n, k, chain, wide)`, a pure function of the shape and of
whether the device runs a cluster of 16 CTAs (`wide`, which the wrappers
take from `ops.gvr_hosts_wide_cluster`), shared by the wrappers and these
CPU tests.

For each row length, with k and C as the wrappers derive them (K = 2048
of llama3.2-1b's DSA, at most n; C from `ref.resolve_cmax`), the ranks'
ranges must tile [0, n) in ascending order, each rank's slice must fit its
CTA's shared memory within the kernel's budget, the chain's two k-entry
buffers must be counted, and the cluster size and thread count must be
ones the kernel is built for. Nothing here needs a card.
"""

import pytest

from repro_torch.kernels import ops, ref

LENGTHS = [1000, 5001, 8192, 60000, 131072, 200000]
K = 2048


def _k_c(n):
    k = min(K, n)
    return k, ref.resolve_cmax(k, n, 6144)


@pytest.mark.parametrize("chain", [False, True])
@pytest.mark.parametrize("n", LENGTHS)
def test_ranges_tile_the_row_in_order(n, chain):
    k, _ = _k_c(n)
    sch = ops.gvr_schedule(n, k, chain)
    ranges = [(r * sch.span, min(n, (r + 1) * sch.span)) for r in range(sch.ranks)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(lo < hi for lo, hi in ranges)          # no rank is idle
    per = -(-sch.span // sch.threads)
    assert per * sch.threads >= sch.span              # the threads' runs cover a slice


@pytest.mark.parametrize("n", LENGTHS)
def test_shared_memory_within_budget_and_chain_buffers_counted(n):
    k, _ = _k_c(n)
    one, chain = ops.gvr_schedule(n, k), ops.gvr_schedule(n, k, chain=True)
    for sch in (one, chain):
        assert 4 * sch.span + 2048 * sch.ranks <= sch.smem <= ops._SMEM_BUDGET
    assert (chain.ranks, chain.threads) == (one.ranks, one.threads)
    k4 = -(-k // 4) * 4
    assert chain.smem == one.smem + 8 * k4 + 4 * k    # values in and out, indices


@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("n", LENGTHS)
def test_cluster_size_and_threads_are_legal(n, wide):
    k, cmax = _k_c(n)
    assert k <= cmax
    sch = ops.gvr_schedule(n, k, wide=wide)
    assert sch.ranks in ops.GVR_RANKS
    # the least R up to 8 giving each rank at most 1024 positions; 16
    # (non-portable) only for long rows, and only where the device runs it
    least = next((r for r in (1, 2, 4, 8) if -(-n // r) <= 1024), 8)
    assert sch.ranks == (16 if wide and n > 65536 else least)
    assert sch.threads in ops.GVR_THREADS
    assert sch.span == -(-n // sch.ranks)
    assert sch.smem <= ops._SMEM_BUDGET


def test_schedule_by_shape():
    """R = 1 for a row of up to 1024 positions (a choice of shape, stated in
    the helper), R = 8 with 256 threads at the main path's N = 8192, and
    the gate's largest N = 200,000 on R = 16 (a 50 KB slice per CTA) where
    the device runs a cluster of 16, else on R = 8 (100 KB per CTA)."""
    assert ops.gvr_schedule(1000, 1000)[:2] == (1, 256)
    assert ops.gvr_schedule(8192, K) == ops.GvrSchedule(8, 256, 1024, 20480)
    assert ops.gvr_schedule(8192, K, wide=False) == ops.gvr_schedule(8192, K)
    assert ops.gvr_schedule(200000, K) == ops.GvrSchedule(16, 1024, 12500, 86016)
    assert ops.gvr_schedule(200000, K, wide=False) == ops.GvrSchedule(
        8, 1024, 25000, 118784)


def test_rows_beyond_a_wide_cluster_raise():
    """A row whose slice outgrows shared memory at 16 is refused by name;
    without a cluster of 16, the limit is 8's (376,832 positions)."""
    assert ops.gvr_schedule(600000, K).ranks == 16
    with pytest.raises(ValueError, match="n=900000"):
        ops.gvr_schedule(900000, K)
    assert ops.gvr_schedule(376832, K, wide=False).ranks == 8
    with pytest.raises(ValueError, match="n=376833 .* 8-CTA cluster"):
        ops.gvr_schedule(376833, K, wide=False)
    with pytest.raises(ValueError, match="n=600000"):
        ops.gvr_schedule(600000, K, wide=False)


@pytest.mark.parametrize("answer", [True, False])
def test_wrapper_schedule_takes_the_devices_answer(answer, monkeypatch):
    """The wrappers' schedule follows `gvr_hosts_wide_cluster`: a row of
    131072 positions takes R = 16 where the device runs a cluster of 16 and
    R = 8 where it does not (the answer is planted in the per-device cache
    here, as no card is present)."""
    import torch
    monkeypatch.setitem(ops._WIDE_CLUSTER, (0, False), answer)
    scores = torch.zeros((1, 131072))
    prev = torch.zeros((1, K), dtype=torch.int32)
    sch = ops._gvr_args(scores, prev, K, None, "gvr_topk")[-1]
    assert sch == ops.gvr_schedule(131072, K, wide=answer)
    assert sch.ranks == (16 if answer else 8)


@pytest.mark.parametrize("ranks", ops.GVR_RANKS)
@pytest.mark.parametrize("threads", ops.GVR_THREADS)
def test_layout_of_any_legal_schedule(ranks, threads):
    """`gvr_layout` (the sweep's schedules) holds a rank's slice in
    per * threads transposed floats and the R 256-bin histograms it
    receives, two parities."""
    sch = ops.gvr_layout(8192, K, ranks, threads)
    assert sch.smem == 4 * -(-sch.span // threads) * threads + 2048 * ranks
    assert sch.smem >= 4 * sch.span
