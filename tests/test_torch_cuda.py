"""The port's Hopper kernels against their plain versions, on the card.

Marked `cuda`: skips where `torch.cuda.is_available()` is false. Imports
no JAX, so it runs on a machine with the card and PyTorch alone:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: Top-K bit-exact; the score row within 1e-5 (bf16 or f32
products are exact or rounded once in f32, the sums run in another order);
attention within 1e-4 (f32 softmax and PV sums over the same rows in
another order); the page gather exact. The contiguous forms must equal the
paged ones over the same keys bit for bit (B5 == B2, B6 == B3), and the
multi-query forms the single-row ones (B8 == B3 on the folded rows, B9's
score rows == B2's, its chain == sequential B1 launches at Q = 1, 3, 5).
B1 runs a thread-block cluster per row: every (R, threads) schedule must
give the same values, indices and stats, a row alone the same as in a
batch, and a row shorter than K (every secant probe, the full-row refine)
the single-CTA kernel's stats. Shapes cover what `chip_smoke.py` does
not: long rows in the cluster's shared memory (up to the gate's N =
200,000), ragged N, other GQA groups, head dims and page sizes, float32 caches, and
pages whose size in bytes is not a multiple of 16 (B7's byte path). The
split over rows of B3/B4 (and B6/B8, which take B3's schedule) is held at
its boundaries: K not a multiple of the split length R, K < R, a split
with every entry masked, a slot with one valid entry, length < K with NEG
ties, a B4 window that begins inside a split; two calls and one slot
computed alone must equal the batched call bit for bit. B10's split over
positions is held the same way, with a slot whose splits lie wholly past
its length, an all-masked slot (0), the mq page form's folded rows, and
rows of 131,072 positions. The scoring body
of B2/B5/B9 is held at its edges in both dtypes (bf16 on the tensor
cores, float32 on the CUDA cores): padded heads, head dims, page sizes,
ragged lengths, unmapped pages inside a row, w (H,) and (B, H), rows long
enough that a CTA walks two tiles; B5 == B2, B9's rows == B2's, two calls
and each slot alone (another schedule) bit-identical. moonshot-v1-16b-a3b's
widths (G = 1, hd 128, KVH 16, bf16) run through the B3/B4, B6/B10 and
split cases, and its MoE feed-forward (one layer, 64 experts) is held on
the card against the CPU. The rest of the dense family's widths (G 48,
16 and 7 as head chunks of 8, hd 120 on 128 lanes) run through the same
split cases, and h2o-danube's sliding window through the scoring body
and B1. whisper-medium's width (G = 1, hd 64, KVH 16, bf16) runs through
B6/B10, and the smoke configs of whisper-medium (DSA: B5, B1, B6) and
rwkv6-3b (plain PyTorch) step on the card against the CPU. The
sequence-sharded step runs on two gloo ranks sharing the card against the
fused single-device step, bit for bit. The training path (no kernel of
the port: autograd and the plain blockwise attention) takes one train step
of six smoke configs on the card against the CPU, and a 6-step run equals
3 steps + checkpoint + resume + 3 bit for bit under deterministic
algorithms, in a child process; the train CLI resumes on the card.
"""

import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import layers

NEG = -3.4028234663852886e38


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m,dist", [
    (5001, 300, 100, "normal"),          # ragged N, fewer predictions than K
    (8192, 2048, 2048, "ties"),
    (60_000, 2048, 2048, "normal"),      # past the single-CTA form's 38K
    (200_000, 2048, 2048, "neg_tail"),   # the gate's largest N, NEG ties
])
def test_b1_gvr_topk_on_card(dev, n, k, m, dist):
    g = torch.Generator(device=dev).manual_seed(n)
    b = 3
    if dist == "ties":
        x = torch.randint(0, 9, (b, n), generator=g, device=dev).float()
    else:
        x = torch.randn((b, n), generator=g, device=dev)
    if dist == "neg_tail":
        x[0, 1000:] = NEG
    prev = torch.randint(-1, n, (b, m), generator=g, device=dev).int()
    v1, i1, st1 = ops.gvr_topk(x, prev, k, max_candidates=6144)
    v0, i0, st0 = ref.gvr_topk_ref(x, prev, k, max_candidates=6144)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)
    assert torch.equal(st1[:, 5:], st0[:, 5:])           # n_gt, n_ge, emitted


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ps,hi,di", [
    (torch.bfloat16, 64, 64, 128), (torch.float32, 16, 4, 32),
    (torch.bfloat16, 8, 8, 64)])
def test_b2_paged_indexer_scores_on_card(dev, dtype, ps, hi, di):
    g = torch.Generator(device=dev).manual_seed(ps)
    b, mp = 3, 12
    p = b * mp
    table = torch.randperm(p, generator=g, device=dev).int().reshape(b, mp)
    table[1, 7:] = -1
    lengths = torch.tensor([mp * ps, 7 * ps - 3, 1], dtype=torch.int32, device=dev)
    pages = torch.randn((p, ps, di), generator=g, device=dev).to(dtype)
    q = torch.randn((b, hi, di), generator=g, device=dev).to(dtype)
    w = torch.rand((hi,), generator=g, device=dev)
    s1 = ops.paged_indexer_scores(q, pages, w, table, lengths)
    s0 = ref.paged_indexer_scores_ref(q, pages, w, table, lengths)
    assert torch.equal(s1 < -1e38, s0 < -1e38)
    torch.testing.assert_close(s1, s0, rtol=1e-5, atol=1e-5)


# moonshot-v1-16b-a3b's decode attention: G = 1, hd 128, KVH 16, bf16
_MOE_WIDTH = (torch.bfloat16, 16, 16, 128, 64)
# whisper-medium's decoder self-attention: G = 1, hd 64, KVH 16, bf16
_WHISPER_WIDTH = (torch.bfloat16, 16, 16, 64, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", [
    (torch.bfloat16, 8, 32, 64, 64), (torch.float32, 2, 4, 32, 8),
    (torch.bfloat16, 1, 8, 128, 16), (torch.float32, 4, 4, 64, 4),
    _MOE_WIDTH])
def test_b3_b4_paged_attention_on_card(dev, dtype, kvh, h, hd, ps):
    g = torch.Generator(device=dev).manual_seed(hd + h)
    b, mp, k = 3, 40, 300
    n = mp * ps
    p = b * mp + 1
    table = torch.randperm(p, generator=g, device=dev)[:b * mp].int().reshape(b, mp)
    table[2, 20:] = -1
    lengths = torch.tensor([n, n // 3, 20 * ps - 5], dtype=torch.int32, device=dev)
    kp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    idx = torch.randint(-1, n, (b, k), generator=g, device=dev).int()
    torch.testing.assert_close(
        ops.paged_sparse_decode_attn(q, kp, vp, table, idx, lengths),
        ref.paged_sparse_attn_ref(q, kp, vp, table, idx, lengths),
        rtol=1e-4, atol=1e-4)
    for window in (None, 37):
        torch.testing.assert_close(
            ops.paged_dense_decode_attn(q, kp, vp, table, lengths, window=window),
            ref.paged_dense_attn_ref(q, kp, vp, table, lengths, window=window),
            rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ps,hi,di", [
    (torch.bfloat16, 64, 64, 128), (torch.float32, 16, 4, 32),
    (torch.bfloat16, 8, 8, 64)])
def test_b5_indexer_scores_on_card_equal_b2(dev, dtype, ps, hi, di):
    g = torch.Generator(device=dev).manual_seed(ps + 5)
    b, mp, k = 3, 12, 40
    n = mp * ps
    table = torch.randperm(b * mp, generator=g, device=dev).int().reshape(b, mp)
    pages = torch.randn((b * mp, ps, di), generator=g, device=dev).to(dtype)
    kc = pages[table.long()].reshape(b, n, di).contiguous()
    q = torch.randn((b, hi, di), generator=g, device=dev).to(dtype)
    w = torch.rand((hi,), generator=g, device=dev)
    lengths = torch.tensor([n, 7 * ps - 3, 1], dtype=torch.int32, device=dev)
    s5 = ops.indexer_scores(q, kc, w, lengths)
    assert torch.equal(s5, ops.paged_indexer_scores(q, pages, w, table, lengths))
    torch.testing.assert_close(s5, ref.indexer_scores_ref(q, kc, w, lengths),
                               rtol=1e-5, atol=1e-5)
    wb = torch.rand((b, hi), generator=g, device=dev)
    torch.testing.assert_close(ops.indexer_scores(q, kc, wb, lengths),
                               ref.indexer_scores_ref(q, kc, wb, lengths),
                               rtol=1e-5, atol=1e-5)
    prev = torch.randint(-1, n, (b, k), generator=g, device=dev).int()
    v1, i1, _ = ops.indexer_topk(q, kc, w, prev, k, lengths=lengths)
    v0, i0, _ = ref.gvr_topk_ref(s5, prev, k)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", [
    (torch.bfloat16, 8, 32, 64, 64), (torch.float32, 2, 4, 32, 8),
    (torch.bfloat16, 1, 8, 128, 16),
    (torch.bfloat16, 2, 16, 32, 128),      # B10: 20 splits of 256 positions
    _MOE_WIDTH, _WHISPER_WIDTH])
def test_b6_b10_sparse_attention_on_card(dev, dtype, kvh, h, hd, ps):
    g = torch.Generator(device=dev).manual_seed(hd + ps)
    b, mp, k = 3, 40, 300
    n = mp * ps
    p = b * mp + 1
    table = torch.randperm(p, generator=g, device=dev)[:b * mp].int().reshape(b, mp)
    lengths = torch.tensor([n, n // 3, 20 * ps - 5], dtype=torch.int32, device=dev)
    table[2, 20:] = -1
    kp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    idx = torch.randint(-1, n, (b, k), generator=g, device=dev).int()
    idx[0, :7] = idx[0, 7]                                # duplicates
    kc = kp[table.clamp(min=0).long()].reshape(b, n, kvh, hd).contiguous()
    vc = vp[table.clamp(min=0).long()].reshape(b, n, kvh, hd).contiguous()
    o6 = ops.sparse_decode_attn(q, kc, vc, idx, lengths)
    assert torch.equal(o6, ops.paged_sparse_decode_attn(q, kp, vp, table, idx, lengths))
    torch.testing.assert_close(o6, ref.sparse_attn_ref(q, kc, vc, idx, lengths),
                               rtol=1e-4, atol=1e-4)
    o10 = ops.paged_sparse_decode_attn_pg(q, kp, vp, table, idx, lengths)
    torch.testing.assert_close(
        o10, ref.paged_sparse_attn_pg_ref(q, kp, vp, table, idx, lengths),
        rtol=1e-4, atol=1e-4)
    assert torch.equal(o10, ops.paged_sparse_decode_attn_pg(
        q, kp, vp, table, idx, lengths))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,feat", [
    (torch.bfloat16, (8, 64)), (torch.float32, (128,)), (torch.bfloat16, (3,))])
def test_b7_paged_gather_on_card(dev, dtype, feat):
    g = torch.Generator(device=dev).manual_seed(len(feat))
    p, ps, b, mp = 30, 16, 3, 9
    pages = torch.randn((p, ps) + feat, generator=g, device=dev).to(dtype)
    table = torch.randperm(p, generator=g, device=dev)[:b * mp].int().reshape(b, mp)
    table[1, 4:] = -1
    table[2, 0] = p + 3                                   # out of the pool
    assert torch.equal(ops.paged_gather(pages, table),
                       ref.paged_gather_ref(pages, table))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", [
    (torch.bfloat16, 8, 32, 64, 64), (torch.float32, 2, 4, 32, 8)])
def test_b8_mq_attention_on_card(dev, dtype, kvh, h, hd, ps):
    g = torch.Generator(device=dev).manual_seed(hd + 8)
    b, qn, mp, k = 3, 3, 40, 300
    n = mp * ps
    p = b * mp + 1
    table = torch.randperm(p, generator=g, device=dev)[:b * mp].int().reshape(b, mp)
    table[2, 20:] = -1
    lengths = (torch.tensor([n - 3, n // 3, 20 * ps - 5], device=dev)[:, None]
               + torch.arange(1, qn + 1, device=dev)).int().contiguous()
    kp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((b, qn, h, hd), generator=g, device=dev).to(dtype)
    idx = torch.randint(-1, n, (b, qn, k), generator=g, device=dev).int()
    idx[:, :, 0] = lengths[:, 1:2] - 1        # masked in row 0 only
    o8 = ops.paged_sparse_decode_attn_mq(q, kp, vp, table, idx, lengths)
    torch.testing.assert_close(
        o8, ref.paged_sparse_attn_mq_ref(q, kp, vp, table, idx, lengths),
        rtol=1e-4, atol=1e-4)
    folded = ops.paged_sparse_decode_attn(
        q.reshape(b * qn, h, hd), kp, vp,
        table.repeat_interleave(qn, 0).contiguous(), idx.reshape(b * qn, k),
        lengths.reshape(b * qn))
    assert torch.equal(o8.reshape(b * qn, h, hd), folded)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,ps,hi,di", [
    (torch.bfloat16, 64, 64, 128), (torch.float32, 16, 4, 32)])
def test_b9_mq_indexer_topk_on_card(dev, dtype, ps, hi, di):
    g = torch.Generator(device=dev).manual_seed(ps + 9)
    b, qn, mp, k = 3, 3, 12, 40
    n = mp * ps
    table = torch.randperm(b * mp, generator=g, device=dev).int().reshape(b, mp)
    table[1, 7:] = -1
    lengths = (torch.tensor([n - 3, 7 * ps - 6, 1], device=dev)[:, None]
               + torch.arange(qn, device=dev)).int().contiguous()
    pages = torch.randn((b * mp, ps, di), generator=g, device=dev).to(dtype)
    q = torch.randn((b, qn, hi, di), generator=g, device=dev).to(dtype)
    w = torch.rand((hi,), generator=g, device=dev)
    prev = torch.randint(-1, n, (b, k), generator=g, device=dev).int()
    s9 = ops.paged_indexer_scores_mq(q, pages, w, table, lengths)
    for j in range(qn):
        assert torch.equal(s9[:, j], ops.paged_indexer_scores(
            q[:, j].contiguous(), pages, w, table, lengths[:, j].contiguous()))
    torch.testing.assert_close(
        s9, ref.paged_indexer_scores_mq_ref(q, pages, w, table, lengths),
        rtol=1e-5, atol=1e-5)
    v9, i9, st9 = ops.gvr_topk_chain(s9, prev, k)
    v0, i0, st0 = ref.gvr_topk_chain_ref(s9, prev, k)
    assert torch.equal(i9, i0) and torch.equal(v9, v0)
    assert torch.equal(st9[..., 4:], st0[..., 4:])
    pv = prev
    for j in range(qn):
        v1, i1, st1 = ops.gvr_topk(s9[:, j].contiguous(), pv, k)
        assert torch.equal(v9[:, j], v1) and torch.equal(i9[:, j], i1)
        assert torch.equal(st9[:, j], st1)
        pv = i1


@pytest.mark.cuda
def test_mq_wrappers_count_launches_and_raise_on_bad_input(dev):
    ops.reset_launch_counts()
    b, qn, ps, mp, hi, di, k = 2, 3, 16, 4, 4, 32, 8
    table = torch.arange(b * mp, device=dev).int().reshape(b, mp)
    pages = torch.randn((b * mp, ps, di), device=dev)
    q = torch.randn((b, qn, hi, di), device=dev)
    w = torch.rand((hi,), device=dev)
    lengths = torch.full((b, qn), mp * ps, dtype=torch.int32, device=dev)
    prev = torch.zeros((b, k), dtype=torch.int32, device=dev)
    ops.paged_indexer_topk_mq(q, pages, w, table, prev, k, lengths=lengths)
    kp = torch.randn((b * mp, ps, 2, 32), device=dev)
    idx = torch.zeros((b, qn, k), dtype=torch.int32, device=dev)
    ops.paged_sparse_decode_attn_mq(torch.randn((b, qn, 4, 32), device=dev),
                                    kp, kp, table, idx, lengths)
    counts = ops.launch_counts()
    assert (counts["paged_indexer_scores_mq"], counts["gvr_topk_chain"],
            counts["paged_sparse_decode_attn_mq"]) == (1, 1, 1)
    assert counts["gvr_topk"] == counts["paged_sparse_decode_attn"] == 0
    with pytest.raises(ValueError):                        # M != K
        ops.paged_indexer_topk_mq(q, pages, w, table, prev[:, :4], k,
                                  lengths=lengths)
    with pytest.raises(ValueError):                        # lengths (B,)
        ops.paged_indexer_scores_mq(q, pages, w, table, lengths[:, 0])
    with pytest.raises(ValueError):                        # table rows
        ops.paged_sparse_decode_attn_mq(
            torch.randn((b, qn, 4, 32), device=dev), kp, kp, table[:1], idx,
            lengths)
    counts = ops.launch_counts()
    assert (counts["paged_indexer_scores_mq"], counts["gvr_topk_chain"],
            counts["paged_sparse_decode_attn_mq"]) == (1, 1, 1)


@pytest.mark.cuda
def test_wrappers_count_launches_and_raise_on_bad_input(dev):
    ops.reset_launch_counts()
    x = torch.randn((2, 512), device=dev)
    prev = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    ops.gvr_topk(x, prev, 16)
    assert ops.launch_counts()["gvr_topk"] == 1
    with pytest.raises(ValueError):
        ops.gvr_topk(x.double(), prev, 16)                 # dtype
    with pytest.raises(ValueError):
        ops.gvr_topk(x, prev, 1024)                        # k > n
    with pytest.raises(ValueError):
        ops.gvr_topk(x, prev.cpu(), 16)                    # mixed devices
    assert ops.launch_counts()["gvr_topk"] == 1


# the rest of the dense family at full width: granite-34b (G 48, six head
# chunks of 8), chatglm3-6b (G 16, two), qwen2-vl-7b (G 7, one chunk of 8
# with a masked head), h2o-danube-3-4b (G 4, hd 120 on 128 lanes)
_FAMILY_WIDTHS = [
    (torch.bfloat16, 1, 48, 128, 64), (torch.bfloat16, 2, 32, 128, 64),
    (torch.bfloat16, 4, 28, 128, 64), (torch.bfloat16, 8, 32, 120, 64),
    (torch.float32, 8, 32, 120, 16), (torch.float32, 2, 6, 64, 8)]

# (dtype, KVH, H, hd, ps): G in {1, 2, 4, 8} and the family's, hd in
# {32, 64, 120, 128}
_SPLIT_WIDTHS = [
    (torch.bfloat16, 8, 32, 64, 64), (torch.float32, 2, 4, 32, 8),
    (torch.bfloat16, 1, 8, 128, 16), (torch.float32, 4, 4, 64, 4),
    (torch.bfloat16, 2, 16, 32, 64), (torch.float32, 1, 8, 128, 16),
    _MOE_WIDTH] + _FAMILY_WIDTHS


def _split_pools(g, dev, dtype, b, n, ps, kvh, h, hd):
    """Pools of b*MP + 1 pages, slots 2s and 2s+1 on one table row (so
    the batch is also B/2 slots of Q = 2 verify rows for B8)."""
    mp = n // ps
    p = b * mp + 1
    t2 = torch.randperm(p, generator=g, device=dev)[:b // 2 * mp].int().reshape(b // 2, mp)
    kp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((p, ps, kvh, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    return t2, kp, vp, q


def _split_case(case, g, dev, b, n):
    """(lengths, idx) of one edge case of the split over K entries."""
    r = ops.ROWS_PER_SPLIT
    k = {"k_below_r": r - 28, "split_all_masked": 3 * r}.get(case, 2 * r + 44)
    lengths = torch.tensor([n, n - 5, n // 2, 700], dtype=torch.int32, device=dev)
    if case == "neg_ties":
        lengths = torch.tensor([100, 250, n, 5], dtype=torch.int32, device=dev)
    idx = torch.stack([torch.randint(0, int(L), (k,), generator=g, device=dev)
                       for L in lengths]).int()
    if case == "split_all_masked":
        idx[:, r:2 * r] = -1                  # the second split of every slot
        idx[0, 2 * r + 3] = n + 5             # past the table
        idx[3] = -1                           # and a slot with nothing valid
    elif case == "one_valid_entry":
        idx[1] = -1
        idx[1, r + 9] = 7
        idx[1, 0] = n - 1                     # >= length n - 5: masked
    elif case == "neg_ties":                  # live positions, then NEG ties
        for s in (0, 1, 3):
            idx[s] = torch.arange(k, device=dev)
    return lengths, idx.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k_not_multiple_of_r", "k_below_r",
                                  "split_all_masked", "one_valid_entry",
                                  "neg_ties"])
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", _SPLIT_WIDTHS)
def test_b3_b6_b8_split_over_rows_on_card(dev, dtype, kvh, h, hd, ps, case):
    g = torch.Generator(device=dev).manual_seed(hd + h + ps + len(case))
    b, n = 4, 1024
    t2, kp, vp, q = _split_pools(g, dev, dtype, b, n, ps, kvh, h, hd)
    table = t2.repeat_interleave(2, 0).contiguous()
    lengths, idx = _split_case(case, g, dev, b, n)
    args = (q, kp, vp, table, idx, lengths)
    o3 = ops.paged_sparse_decode_attn(*args)
    torch.testing.assert_close(o3, ref.paged_sparse_attn_ref(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(o3, ops.paged_sparse_decode_attn(*args))   # two calls
    for s in range(b):                                            # B=1 vs B=4
        alone = ops.paged_sparse_decode_attn(
            q[s:s + 1], kp, vp, table[s:s + 1], idx[s:s + 1], lengths[s:s + 1])
        assert torch.equal(alone, o3[s:s + 1])
    kc = kp[table.long()].reshape(b, n, kvh, hd).contiguous()
    vc = vp[table.long()].reshape(b, n, kvh, hd).contiguous()
    assert torch.equal(ops.sparse_decode_attn(q, kc, vc, idx, lengths), o3)
    o8 = ops.paged_sparse_decode_attn_mq(
        q.reshape(b // 2, 2, h, hd), kp, vp, t2, idx.reshape(b // 2, 2, -1),
        lengths.reshape(b // 2, 2))
    assert torch.equal(o8.reshape(b, h, hd), o3)
    if case == "split_all_masked":
        assert torch.equal(o3[3], torch.zeros_like(o3[3]))


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", _SPLIT_WIDTHS)
def test_b4_split_over_pages_on_card(dev, dtype, kvh, h, hd, ps, window):
    """Splits of whole pages (R = 128 positions at ps <= 128); window 300
    at length 1000 begins at position 700, inside the split [640, 768)."""
    g = torch.Generator(device=dev).manual_seed(hd + h + ps + (window or 0))
    b, n = 4, 1024
    t2, kp, vp, q = _split_pools(g, dev, dtype, b, n, ps, kvh, h, hd)
    table = t2.repeat_interleave(2, 0).contiguous()
    table[3, (777 + ps - 1) // ps:] = -1          # unmapped past the extent
    lengths = torch.tensor([n, 1000, 1, 777], dtype=torch.int32, device=dev)
    args = (q, kp, vp, table, lengths)
    o4 = ops.paged_dense_decode_attn(*args, window=window)
    torch.testing.assert_close(
        o4, ref.paged_dense_attn_ref(*args, window=window), rtol=1e-4, atol=1e-4)
    assert torch.equal(o4, ops.paged_dense_decode_attn(*args, window=window))
    for s in range(b):
        alone = ops.paged_dense_decode_attn(q[s:s + 1], kp, vp, table[s:s + 1],
                                            lengths[s:s + 1], window=window)
        assert torch.equal(alone, o4[s:s + 1])


def _pg_case(case, g, dev, b, n, k):
    """(lengths, idx) of one edge case of B10's split over positions."""
    lengths = torch.tensor([n, n - 5, 700, n // 2], dtype=torch.int32, device=dev)
    idx = torch.randint(-1, n, (b, k), generator=g, device=dev).int()
    idx[0, :9] = idx[0, 9]                        # duplicates
    if case == "past_length":                     # splits wholly past 700
        idx[2] = torch.randint(0, 1024, (k,), generator=g, device=dev).int()
    elif case == "all_masked":                    # -1, past the length, past n
        idx[1] = -1
        idx[3] = torch.randint(n // 2, n + 40, (k,), generator=g, device=dev).int()
    elif case == "one_split":                     # every entry in one split
        idx[0] = torch.randint(256, 512, (k,), generator=g, device=dev).int()
    return lengths, idx.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spread", "past_length", "all_masked",
                                  "one_split"])
@pytest.mark.parametrize("dtype,kvh,h,hd,ps", _SPLIT_WIDTHS)
def test_b10_split_over_positions_on_card(dev, dtype, kvh, h, hd, ps, case):
    """B10 on 16 splits of 256 positions (n = 4096): allclose to its plain
    version; two calls, each slot alone and the folded B*Q rows of the mq
    page form against single-row launches bit-identical; a slot of length
    700 whose splits 3-15 lie wholly past it; an all-masked slot gives 0."""
    from repro_torch.sparse import dsa
    g = torch.Generator(device=dev).manual_seed(hd + h + ps + len(case) + 10)
    b, n, k = 4, 4096, 600
    assert ops.decode_attn_splits("paged_pages", k, n, ps)[1] == 16
    t2, kp, vp, q = _split_pools(g, dev, dtype, b, n, ps, kvh, h, hd)
    table = t2.repeat_interleave(2, 0).contiguous()
    lengths, idx = _pg_case(case, g, dev, b, n, k)
    args = (q, kp, vp, table, idx, lengths)
    o10 = ops.paged_sparse_decode_attn_pg(*args)
    torch.testing.assert_close(o10, ref.paged_sparse_attn_pg_ref(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(o10, ops.paged_sparse_decode_attn_pg(*args))
    for s in range(b):
        alone = ops.paged_sparse_decode_attn_pg(
            q[s:s + 1], kp, vp, table[s:s + 1], idx[s:s + 1], lengths[s:s + 1])
        assert torch.equal(alone, o10[s:s + 1])
    folded = dsa.dsa_sparse_attention_paged_mq(
        q.reshape(b // 2, 2, h, hd), kp, vp, t2, idx.reshape(b // 2, 2, -1),
        lengths.reshape(b // 2, 2), scale=hd ** -0.5, granularity="page")
    assert torch.equal(folded.reshape(b, h, hd), o10)
    if case == "all_masked":
        assert not o10[1].any() and not o10[3].any()


@pytest.mark.cuda
def test_b10_long_rows_on_card(dev):
    """B10 at B = 4 over a table of 2048 pages of 64 (131,072 positions,
    past the 97,536 that a one-split kernel with a count per position of
    the table could hold in shared memory), llama3.2-1b head shapes, bf16:
    allclose to its plain version, two calls and each slot alone
    bit-identical."""
    g = torch.Generator(device=dev).manual_seed(131072)
    b, n, ps, kvh, h, hd, k = 4, 131072, 64, 8, 32, 64, 2048
    mp = n // ps
    table = torch.randperm(b * mp, generator=g, device=dev).int().reshape(b, mp)
    table[3, mp // 2:] = -1                       # unmapped past slot 3's extent
    lengths = torch.tensor([n, n - 100, 97536 + 777, n // 2], dtype=torch.int32,
                           device=dev)
    kp = torch.randn((b * mp, ps, kvh, hd), generator=g, device=dev).bfloat16()
    vp = torch.randn((b * mp, ps, kvh, hd), generator=g, device=dev).bfloat16()
    q = torch.randn((b, h, hd), generator=g, device=dev).bfloat16()
    idx = torch.stack([torch.randperm(int(L), generator=g, device=dev)[:k]
                       for L in lengths]).int()
    idx[1, :16] = -1
    idx[2, :64] = torch.arange(97536, 97600, device=dev)   # past 97,536
    idx[0, 100:120] = idx[0, 99]                            # duplicates
    idx = idx.contiguous()
    args = (q, kp, vp, table, idx, lengths)
    o10 = ops.paged_sparse_decode_attn_pg(*args)
    torch.testing.assert_close(o10, ref.paged_sparse_attn_pg_ref(*args),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(o10, ops.paged_sparse_decode_attn_pg(*args))
    for s in range(b):
        alone = ops.paged_sparse_decode_attn_pg(
            q[s:s + 1], kp, vp, table[s:s + 1], idx[s:s + 1], lengths[s:s + 1])
        assert torch.equal(alone, o10[s:s + 1])


@pytest.mark.cuda
def test_b10_launch_beyond_its_counts_raises(dev):
    """K >= 65536 overflows the kernel's 16-bit selection counts: the launch
    is refused and the wrapper raises, with no fallback."""
    b, mp, ps, kvh, h, hd = 1, 2, 64, 1, 2, 32
    kp = torch.randn((mp, ps, kvh, hd), device=dev)
    table = torch.arange(mp, device=dev).int()[None]
    idx = torch.zeros((b, 65536), dtype=torch.int32, device=dev)
    lengths = torch.full((b,), mp * ps, dtype=torch.int32, device=dev)
    before = ops.launch_counts()["paged_sparse_decode_attn_pg"]
    with pytest.raises(RuntimeError):
        ops.paged_sparse_decode_attn_pg(torch.randn((b, h, hd), device=dev),
                                        kp, kp, table, idx, lengths)
    assert ops.launch_counts()["paged_sparse_decode_attn_pg"] == before


@pytest.mark.cuda
def test_b3_launches_overlapping_on_two_streams_keep_their_own_tickets(dev):
    """Multi-split launches alternating between two streams, queued with no
    synchronisation between them, each merge their own partials."""
    g = torch.Generator(device=dev).manual_seed(7)
    b, n, kvh, h, hd, ps = 4, 1024, 8, 32, 64, 64
    t2, kp, vp, q = _split_pools(g, dev, torch.bfloat16, b, n, ps, kvh, h, hd)
    table = t2.repeat_interleave(2, 0).contiguous()
    lengths, idx = _split_case("k_not_multiple_of_r", g, dev, b, n)
    args = (q, kp, vp, table, idx, lengths)
    want = ops.paged_sparse_decode_attn(*args)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(device=dev) for _ in range(2)]
    outs = []
    for i in range(16):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(ops.paged_sparse_decode_attn(*args))
    torch.cuda.synchronize()
    for o in outs:
        assert torch.equal(o, want)


# The scoring body's edges. B2, B5 and B9 share one body per cache dtype
# (bf16: tensor cores, H padded to a multiple of 16; float32: CUDA cores):
# H in {8, 64}, d in {64, 128}, ps in {4, 8, 16, 64}; lengths that are no
# multiple of the 64-position tile, a length of 1, an unmapped page inside
# a row's extent; w (H,) and (B, H).

def _score_pools(g, dev, dtype, h, d, ps, n, lengths, hole_at):
    """Pools of B*MP + 2 pages through a shuffled table; the page holding
    position `hole_at` of the last slot unmapped."""
    b, mp = len(lengths), n // ps
    p = b * mp + 2
    table = torch.randperm(p, generator=g, device=dev)[:b * mp].int().reshape(b, mp)
    table[-1, hole_at // ps] = -1
    pages = torch.randn((p, ps, d), generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dtype)
    return (table.contiguous(), pages, q,
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _check_scoring_forms(g, dev, table, pages, q, lengths):
    """B2 against its plain version; B5 == B2 on the mapped positions;
    two calls and each slot alone bit-identical; for w (H,) and (B, H)."""
    b, mp = table.shape
    ps, d = pages.shape[1:]
    h, n = q.shape[1], mp * ps
    mapped = (table >= 0).repeat_interleave(ps, dim=1)
    kc = pages[table.clamp(min=0).long()].reshape(b, n, d).contiguous()
    for w in (torch.rand((h,), generator=g, device=dev),
              torch.rand((b, h), generator=g, device=dev)):
        s2 = ops.paged_indexer_scores(q, pages, w, table, lengths)
        s0 = ref.paged_indexer_scores_ref(q, pages, w, table, lengths)
        assert torch.equal(s2 < -1e38, s0 < -1e38)
        torch.testing.assert_close(s2, s0, rtol=1e-5, atol=1e-5)
        s5 = ops.indexer_scores(q, kc, w, lengths)
        torch.testing.assert_close(s5, ref.indexer_scores_ref(q, kc, w, lengths),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(s5[mapped], s2[mapped])                 # B5 == B2
        assert torch.equal(ops.paged_indexer_scores(q, pages, w, table, lengths), s2)
        assert torch.equal(ops.indexer_scores(q, kc, w, lengths), s5)
        for s in range(b):
            ws = w[s:s + 1] if w.dim() == 2 else w
            one = slice(s, s + 1)
            assert torch.equal(ops.paged_indexer_scores(
                q[one], pages, ws, table[one], lengths[one]), s2[one])
            assert torch.equal(ops.indexer_scores(
                q[one], kc[one], ws, lengths[one]), s5[one])


@pytest.mark.cuda
@pytest.mark.parametrize("ps", [4, 8, 16, 64])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("h", [8, 64])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scoring_body_edges_on_card(dev, dtype, h, d, ps):
    g = torch.Generator(device=dev).manual_seed(h + d + ps)
    n = 320
    table, pages, q, lengths = _score_pools(g, dev, dtype, h, d, ps, n,
                                            [n - 5, 1, 145], hole_at=80)
    _check_scoring_forms(g, dev, table, pages, q, lengths)
    # B9: each of Q = 3 query rows == B2 at that row's length
    qn = 3
    q9 = torch.randn((3, qn, h, d), generator=g, device=dev).to(dtype)
    l9 = (lengths[:, None] + torch.arange(qn, device=dev)).int().contiguous()
    w = torch.rand((h,), generator=g, device=dev)
    s9 = ops.paged_indexer_scores_mq(q9, pages, w, table, l9)
    for j in range(qn):
        assert torch.equal(s9[:, j], ops.paged_indexer_scores(
            q9[:, j].contiguous(), pages, w, table, l9[:, j].contiguous()))
    torch.testing.assert_close(
        s9, ref.paged_indexer_scores_mq_ref(q9, pages, w, table, l9),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scoring_schedules_agree_on_card(dev, dtype):
    """Rows of 71 tiles (the last one partial): at B=4 a CTA of the bf16
    body walks two tiles through its double buffer (the last CTA one),
    alone (B=1) one; the rows stay bit-identical across the two
    schedules."""
    g = torch.Generator(device=dev).manual_seed(71)
    ps, n = 16, 16 * 283
    assert ops.score_schedule(torch.bfloat16, 4, n, 64, 128)["tiles_per_cta"] == 2
    assert ops.score_schedule(torch.bfloat16, 1, n, 64, 128)["tiles_per_cta"] == 1
    table, pages, q, lengths = _score_pools(
        g, dev, dtype, 64, 128, ps, n, [n, n - 100, 3000, 1], hole_at=3000)
    table[1, 100:110] = -1
    _check_scoring_forms(g, dev, table, pages, q, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [1, 100, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_windowed_scoring_on_card(dev, dtype, window):
    """h2o-danube's sliding window in B2/B5/B9 (64 heads of 128, pages of
    64, rows of 8192): allclose to the plain versions, every position
    below length - window (and at or past the length) exactly NEG, B5 ==
    B2, B9's rows == B2's at their own lengths, two calls and each slot
    alone bit-identical; B1 exact on the windowed rows (a NEG prefix, and
    for the short slot a NEG suffix too)."""
    g = torch.Generator(device=dev).manual_seed(window + 7)
    n, ps, h, d, k = 8192, 64, 64, 128, 2048
    lengths = [8192, 5000, 1000, 4097]
    table, pages, q, ln = _score_pools(g, dev, dtype, h, d, ps, n, lengths,
                                       hole_at=6000)
    b = len(lengths)
    w = torch.full((h,), 1.0 / h, device=dev)
    s2 = ops.paged_indexer_scores(q, pages, w, table, ln, window)
    s0 = ref.paged_indexer_scores_ref(q, pages, w, table, ln, window)
    pos = torch.arange(n, device=dev)[None]
    inside = (pos < ln[:, None]) & (pos >= ln[:, None] - window)
    assert torch.equal(s2 > -1e38, s0 > -1e38)
    assert (s2[~inside] == NEG).all()
    torch.testing.assert_close(s2, s0, rtol=1e-5, atol=1e-5)
    kc = pages[table.clamp(min=0).long()].reshape(b, n, d).contiguous()
    mapped = (table >= 0).repeat_interleave(ps, dim=1)
    s5 = ops.indexer_scores(q, kc, w, ln, window)
    assert torch.equal(s5[mapped], s2[mapped])                     # B5 == B2
    assert torch.equal(ops.paged_indexer_scores(q, pages, w, table, ln, window), s2)
    for s in range(b):
        one = slice(s, s + 1)
        assert torch.equal(ops.paged_indexer_scores(
            q[one], pages, w, table[one], ln[one], window), s2[one])
    qn = 3
    q9 = torch.randn((b, qn, h, d), generator=g, device=dev).to(dtype)
    l9 = (ln[:, None] - qn + 1 + torch.arange(qn, device=dev)).int().contiguous()
    s9 = ops.paged_indexer_scores_mq(q9, pages, w, table, l9, window)
    for j in range(qn):
        assert torch.equal(s9[:, j], ops.paged_indexer_scores(
            q9[:, j].contiguous(), pages, w, table, l9[:, j].contiguous(), window))
    prev = torch.randint(0, 8192, (b, k), generator=g, device=dev).int()
    v1, i1, st1 = ops.gvr_topk(s2, prev, k, max_candidates=6144)
    v0, i0, st0 = ref.gvr_topk_ref(s2, prev, k, max_candidates=6144)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)
    assert torch.equal(st1[:, 4:], st0[:, 4:])
    v1, i1, _ = ops.paged_indexer_topk(q, pages, w, table, prev, k, lengths=ln,
                                       max_candidates=6144, window=window)
    assert torch.equal(i1, i0)


@pytest.mark.cuda
def test_scoring_route_follows_dtype_on_card(dev):
    """bf16 runs the tensor-core kernel and float32 the CUDA-core one (by
    the kernels' names in the profiler); a bf16 head dim that is no
    multiple of 16 raises, naming the shape, where float32 takes it."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(3)
    lengths = torch.tensor([100, 37], dtype=torch.int32, device=dev)
    for dtype, body in ((torch.bfloat16, "mma"), (torch.float32, "fma")):
        kc = torch.randn((2, 128, 64), generator=g, device=dev).to(dtype)
        q = torch.randn((2, 8, 64), generator=g, device=dev).to(dtype)
        w = torch.rand((8,), generator=g, device=dev)
        names = set()
        for _ in range(3):                 # the profiler may drop an event
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    ops.indexer_scores(q, kc, w, lengths)
                torch.cuda.synchronize()
            names |= {e.name for e in prof.events() if "indexer_scores" in e.name}
            if names:
                break
        assert names and all(f"indexer_scores_{body}_kernel" in nm for nm in names), names
    q72 = torch.randn((2, 8, 72), generator=g, device=dev)
    kc72 = torch.randn((2, 128, 72), generator=g, device=dev)
    w = torch.rand((8,), generator=g, device=dev)
    torch.testing.assert_close(ops.indexer_scores(q72, kc72, w, lengths),
                               ref.indexer_scores_ref(q72, kc72, w, lengths),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match=r"\(2, 8, 72\)"):
        ops.indexer_scores(q72.bfloat16(), kc72.bfloat16(), w, lengths)


# ---- B1 / B9's chain on a thread-block cluster per row -------------------

_K, _C = 2048, 6144


def _gvr_rows(dev, b, n, lengths=None, seed=0):
    """Normal scores with NEG at and past each row's length."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, n), generator=g, device=dev)
    if lengths is not None:
        pos = torch.arange(n, device=dev)
        x = torch.where(pos < torch.tensor(lengths, device=dev)[:, None], x,
                        torch.full_like(x, NEG))
    return x.contiguous(), g


def _warm_prev(x, g):
    noisy = x + 0.01 * torch.randn(x.shape, generator=g, device=x.device)
    return torch.topk(noisy, _K, dim=-1).indices.sort(-1).values.int().contiguous()


def _b1_exact(x, prev):
    v1, i1, st1 = ops.gvr_topk(x, prev, _K, max_candidates=_C)
    v0, i0, st0 = ref.gvr_topk_ref(x, prev, _K, max_candidates=_C)
    assert torch.equal(i1, i0) and torch.equal(v1, v0)
    assert torch.equal(st1[:, 4:], st0[:, 4:])
    return st1, st0


@pytest.mark.cuda
def test_b1_neg_plateau_row_takes_every_probe_on_card(dev):
    """A row of length 1000 < K padded with NEG to 8192, predictions -1 (a
    recycled slot, slot 2 of chip_smoke's kernel phase): no threshold gives
    K <= |x >= T| <= C, so all 12 secant probes run and P4/P5 take the
    whole row. Stats 0, 2 and 3 as the single-CTA kernel gave them (12,
    8192, 1); column 1 counts no radix pass, where that kernel always ran
    four: fewer than K keys lie above the row's minimum (NEG), so the K-th
    value is that minimum."""
    x, _ = _gvr_rows(dev, 1, 8192, [1000], seed=1)
    prev = torch.full((1, _K), -1, dtype=torch.int32, device=dev)
    assert ops.gvr_schedule(8192, _K).ranks > 1
    st1, _ = _b1_exact(x, prev)
    assert st1[0, :4].tolist() == [12.0, 0.0, 8192.0, 1.0]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [131072, 200000])
def test_b1_long_rows_in_shared_memory_on_card(dev, n):
    """Rows past the single-CTA form's 38K limit now sit in the cluster's
    shared memory (R = 16: slices of 32 KB and 50 KB per CTA); warm and
    random predictions, one row with a NEG tail below K."""
    sch = ops.gvr_schedule(n, _K, wide=True)
    assert sch.ranks == 16 and sch.span * 4 <= sch.smem <= 200 * 1024
    assert ops.gvr_hosts_wide_cluster(dev)          # an H100 runs 16
    x, g = _gvr_rows(dev, 3, n, [n, n, 1500], seed=n)
    prev = _warm_prev(x, g)
    prev[1] = torch.randint(0, n, (_K,), generator=g, device=dev).int()
    _b1_exact(x, prev)


@pytest.mark.cuda
@pytest.mark.parametrize("chain", [False, True])
def test_long_rows_on_eight_where_the_device_runs_no_cluster_of_16_on_card(
        dev, chain, monkeypatch):
    """Where the device answers that it cannot run a cluster of 16 (planted
    in the per-device cache here, as the H100 answers yes), a row of
    131072 positions takes R = 8 and its outputs equal the R = 16 launch's
    bit for bit, B1 and the chain alike."""
    n = 131072
    x, g = _gvr_rows(dev, 2, n, [n, 1500], seed=n + 3)
    prev = _warm_prev(x, g)
    if chain:
        x = torch.stack([x, x + 0.01], dim=1).contiguous()
        run = lambda: ops.gvr_topk_chain(x, prev, _K, max_candidates=_C)
    else:
        run = lambda: ops.gvr_topk(x, prev, _K, max_candidates=_C)
    key = (dev.index or 0, chain)
    assert ops.gvr_hosts_wide_cluster(dev, chain)
    wide = run()
    monkeypatch.setitem(ops._WIDE_CLUSTER, key, False)
    assert ops._gvr_args(x, prev, _K, _C, "t", chain)[-1].ranks == 8
    eight = run()
    assert all(torch.equal(a, b) for a, b in zip(eight, wide))


@pytest.mark.cuda
def test_b1_rows_alone_and_repeated_calls_bit_identical_on_card(dev):
    """Each row computed alone (B = 1) equals the same row in the batch,
    and two calls on the same inputs agree bit for bit, stats included."""
    x, g = _gvr_rows(dev, 4, 8192, [8192, 5000, 1000, 3001], seed=7)
    prev = _warm_prev(x, g)
    prev[1] = torch.randint(0, 8192, (_K,), generator=g, device=dev).int()
    prev[2] = -1
    out = ops.gvr_topk(x, prev, _K, max_candidates=_C)
    again = ops.gvr_topk(x, prev, _K, max_candidates=_C)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    for r in range(4):
        alone = ops.gvr_topk(x[r:r + 1].contiguous(), prev[r:r + 1].contiguous(),
                             _K, max_candidates=_C)
        assert all(torch.equal(a, b[r:r + 1]) for a, b in zip(alone, out))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 8192, 60000])
def test_b1_every_cluster_schedule_bit_identical_on_card(dev, n, monkeypatch):
    """Values, indices and all 8 stats columns do not depend on the cluster
    size R or the threads per CTA: every (R, threads) the kernel takes
    gives the default schedule's outputs (B1 and the chain)."""
    k = min(_K, n // 2)
    x, g = _gvr_rows(dev, 2, n, [n, n // 3], seed=n + 1)
    prev = torch.stack([torch.randint(0, n, (k,), generator=g, device=dev),
                        torch.full((k,), -1, device=dev)]).int().contiguous()
    xq = torch.stack([x, x + 0.01], dim=1).contiguous()
    want = ops.gvr_topk(x, prev, k)
    want_chain = ops.gvr_topk_chain(xq, prev, k)
    for ranks in ops.GVR_RANKS:
        for threads in ops.GVR_THREADS:
            if ops.gvr_layout(n, k, ranks, threads, True).smem > ops._SMEM_BUDGET:
                continue                   # the slice outgrows shared memory
            monkeypatch.setattr(ops, "gvr_schedule",
                                lambda n_, k_, chain=False, wide=True: ops.gvr_layout(
                                    n_, k_, ranks, threads, chain))
            got = ops.gvr_topk(x, prev, k)
            got_chain = ops.gvr_topk_chain(xq, prev, k)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (ranks, threads)
            assert all(torch.equal(a, b) for a, b in zip(got_chain, want_chain)), (ranks, threads)


@pytest.mark.cuda
@pytest.mark.parametrize("qn", [1, 3, 5])
def test_b9_chain_equals_sequential_b1_on_card(dev, qn):
    """The chain at Q rows per slot equals Q sequential B1 launches in
    values, indices and all 8 stats columns, at the main path's K and C,
    across warm, random, recycled and short rows."""
    n = 8192
    x, g = _gvr_rows(dev, 4, n, None, seed=qn)
    rows = [x]
    for _ in range(qn - 1):
        rows.append(rows[-1] + 0.01 * torch.randn(x.shape, generator=g, device=dev))
    pos = torch.arange(n, device=dev)
    xq = torch.stack([torch.where(pos < torch.tensor(
        [n, 5000 + q, 700 + q, 3001 + q], device=dev)[:, None], r,
        torch.full_like(r, NEG)) for q, r in enumerate(rows)], dim=1).contiguous()
    prev = _warm_prev(xq[:, 0], g)
    prev[1] = torch.randint(0, n, (_K,), generator=g, device=dev).int()
    prev[2] = -1
    v9, i9, st9 = ops.gvr_topk_chain(xq, prev, _K, max_candidates=_C)
    pv = prev
    for j in range(qn):
        v1, i1, st1 = ops.gvr_topk(xq[:, j].contiguous(), pv, _K, max_candidates=_C)
        assert torch.equal(v9[:, j], v1) and torch.equal(i9[:, j], i1)
        assert torch.equal(st9[:, j], st1)
        pv = i1


def _regime(dev, name):
    """tools/gvr_regimes.py's inputs of one regime (B=4, N=8192 or 131072,
    or B=1 for the plateau), made the same way from the same seeds."""
    names = ("kernel-mix", "warm", "random", "recycled", "even", "plateau",
             "warm-131072")
    g = torch.Generator(device=dev).manual_seed(1234 + names.index(name))
    b, n = (1, 8192) if name == "plateau" else (
        4, 131072 if name == "warm-131072" else 8192)
    x = torch.randn((b, n), generator=g, device=dev)
    if name in ("warm", "warm-131072"):
        prev = _warm_prev(x, g)
    elif name == "random":
        prev = torch.randint(0, n, (b, _K), generator=g, device=dev).int()
    elif name == "even":
        prev = torch.linspace(0, n - 1, _K, device=dev).int().expand(b, _K)
    else:
        if name == "plateau":
            x = torch.where(torch.arange(n, device=dev) < 1000, x,
                            torch.full_like(x, NEG))
        prev = torch.full((b, _K), -1, dtype=torch.int32, device=dev)
    return x.contiguous(), prev.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("name,cols", [
    ("warm", (0, 2, 3)), ("random", (0, 2, 3)), ("recycled", (0, 2, 3)),
    ("even", (0, 2, 3)), ("warm-131072", (0, 2, 3)), ("plateau", (0,))])
def test_b1_path_stats_match_plain_where_the_single_cta_form_did_on_card(dev, name, cols):
    """Stats columns 0 (secant probes), 2 (candidates) and 3 (full-row
    refine) equal the plain version's wherever the single-CTA kernel's did
    (checked on an H100 before the redesign): columns 0, 2 and 3 on the
    buffered regimes; column 0 alone on a row shorter than K, where the
    plain version's histogram refine counts its candidates otherwise."""
    x, prev = _regime(dev, name)
    st1, st0 = _b1_exact(x, prev)
    for c in cols:
        assert torch.equal(st1[:, c], st0[:, c]), (c, st1[:, :4], st0[:, :4])


@pytest.mark.cuda
def test_moe_mlp_dense_fallback_card_equals_cpu_at_moonshot_widths(dev):
    """One layer of moonshot-v1-16b-a3b's feed-forward (64 experts of
    2048 x 1408, top-6, bf16) for a B=4 decode step on the card against
    the same call on the CPU: the same experts (the f32 router's logits
    differ by f32 rounding only), the output within 2e-2 of its scale
    (bf16 products rounded at the same places after sums in other orders,
    as the CPU tests hold the port against JAX)."""
    g = torch.Generator(device=dev).manual_seed(2048)
    e, d, f, k = 64, 2048, 1408, 6

    def rnd(shape, scale, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    x = rnd((4, 1, d), 1.0)
    args = (rnd((d, e), d ** -0.5, torch.float32), rnd((e, d, f), e ** -0.5),
            rnd((e, d, f), e ** -0.5), rnd((e, f, d), f ** -0.5))
    gates, idx = layers.moe_route(x, args[0], k)
    gates_c, idx_c = layers.moe_route(x.cpu(), args[0].cpu(), k)
    assert torch.equal(idx.cpu(), idx_c)
    torch.testing.assert_close(gates.cpu(), gates_c, rtol=1e-5, atol=1e-6)
    out = layers.moe_mlp_dense_fallback(x, *args, top_k=k)
    out_c = layers.moe_mlp_dense_fallback(x.cpu(), *(a.cpu() for a in args), top_k=k)
    assert out.dtype == torch.bfloat16 and out.shape == x.shape
    err = float((out.cpu().float() - out_c.float()).abs().max())
    assert err <= 2e-2 * float(out_c.float().abs().max()), err


# bytes of 0xA5 on each side of every buffer in the write checks below
_GUARD = 1 << 20


def _writes_only_outputs(monkeypatch, fn, *args, **kw):
    """Call fn (a kernel wrapper) once as it is, then once on copies of
    its tensor arguments that lie inside guard bands, with every buffer
    the wrapper allocates on the card (its output, the split workspace,
    the combine tickets) inside guard bands too. The bands and the inputs
    must come back unchanged, the tickets zero and the output bit-equal to
    the first call's: the kernel wrote only inside its outputs."""
    want = fn(*args, **kw)
    bufs, tickets = [], []
    real_empty = torch.empty

    def guarded(t):
        nbytes = t.numel() * t.element_size()
        buf = torch.full((nbytes + 2 * _GUARD,), 0xA5, dtype=torch.uint8,
                         device=t.device)
        view = buf[_GUARD:_GUARD + nbytes].view(t.dtype).view(t.shape)
        view.copy_(t)
        bufs.append(buf)
        return view

    def make_tickets(device, stream, n):
        tickets.append(guarded(torch.zeros(n, dtype=torch.int32, device=device)))
        return tickets[-1]

    ins = [guarded(a) if isinstance(a, torch.Tensor) else a for a in args]
    before = [a.clone() for a in ins if isinstance(a, torch.Tensor)]
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", lambda *s, **k: guarded(real_empty(*s, **k)))
        m.setattr(ops, "_tickets", make_tickets)
        got = fn(*ins, **kw)
    torch.cuda.synchronize()
    for buf in bufs:
        assert (buf[:_GUARD] == 0xA5).all() and (buf[-_GUARD:] == 0xA5).all()
    after = [a for a in ins if isinstance(a, torch.Tensor)]
    assert all(torch.equal(a, c) for a, c in zip(after, before))
    assert all(int(t.abs().sum()) == 0 for t in tickets)
    assert torch.equal(got, want)
    return len(tickets)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kvh,h,hd", [
    (torch.bfloat16, 8, 32, 64),                 # llama3.2-1b
    (torch.bfloat16, 1, 48, 128), (torch.bfloat16, 2, 32, 128),
    (torch.bfloat16, 4, 28, 128), (torch.bfloat16, 8, 32, 120)])
def test_attention_writes_only_its_outputs(dev, monkeypatch, dtype, kvh, h, hd):
    """B3, B4 (with and without window 4096), B6, B8 and B10 at llama's
    and the dense family's widths, at the kernel phase's shapes (B=4,
    N=8192, K=2048, pages of 64, lengths 8192/5000/1000/3001, slot 2's
    pages past its extent unmapped): every launch splits, so each writes
    its output, a workspace and tickets; none writes outside them."""
    g = torch.Generator(device=dev).manual_seed(kvh * 1000 + h + hd)
    b, n, ps, k = 4, 8192, 64, 2048
    mp = n // ps
    lengths = torch.tensor([8192, 5000, 1000, 3001], dtype=torch.int32,
                           device=dev)
    table = torch.randperm(b * mp + 1, generator=g, device=dev)[:b * mp]
    table = table.int().reshape(b, mp)
    table[2, -(-1000 // ps):] = -1
    table = table.contiguous()
    kp = torch.randn((b * mp + 1, ps, kvh, hd), generator=g, device=dev).to(dtype)
    vp = torch.randn((b * mp + 1, ps, kvh, hd), generator=g, device=dev).to(dtype)
    q = torch.randn((b, h, hd), generator=g, device=dev).to(dtype)
    idx = torch.stack([torch.randint(0, int(L), (k,), generator=g, device=dev)
                       for L in lengths]).int()
    idx[1, :100] = -1
    idx = idx.contiguous()
    kc = kp[table.clamp(min=0).long()].reshape(b, n, kvh, hd).contiguous()
    vc = vp[table.clamp(min=0).long()].reshape(b, n, kvh, hd).contiguous()
    t8 = table[0::2].contiguous()
    calls = [
        (ops.paged_sparse_decode_attn, (q, kp, vp, table, idx, lengths), {}),
        (ops.paged_dense_decode_attn, (q, kp, vp, table, lengths), {}),
        (ops.paged_dense_decode_attn, (q, kp, vp, table, lengths),
         dict(window=4096)),
        (ops.sparse_decode_attn, (q, kc, vc, idx, lengths), {}),
        (ops.paged_sparse_decode_attn_mq,
         (q.reshape(2, 2, h, hd), kp, vp, t8, idx.reshape(2, 2, k),
          lengths.reshape(2, 2)), {}),
        (ops.paged_sparse_decode_attn_pg, (q, kp, vp, table, idx, lengths), {})]
    for fn, args, kw in calls:
        assert _writes_only_outputs(monkeypatch, fn, *args, **kw) == 1, fn


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 4096])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_scoring_writes_only_its_outputs(dev, monkeypatch, dtype, window):
    """B2, B5 and B9's scoring body (64 heads of 128, pages of 64, rows of
    8192, an unmapped page inside a row), with and without h2o-danube's
    window of 4096: none writes outside its score rows."""
    g = torch.Generator(device=dev).manual_seed(4096 + (window or 0))
    n, ps, h, d = 8192, 64, 64, 128
    table, pages, q, ln = _score_pools(g, dev, dtype, h, d, ps, n,
                                       [8192, 5000, 1000, 3001], hole_at=2000)
    b = ln.shape[0]
    w = torch.full((h,), 1.0 / h, device=dev)
    kc = pages[table.clamp(min=0).long()].reshape(b, n, d).contiguous()
    q9 = torch.randn((b, 3, h, d), generator=g, device=dev).to(dtype)
    l9 = (ln[:, None] - 2 + torch.arange(3, device=dev)).int().contiguous()
    for fn, args in ((ops.paged_indexer_scores, (q, pages, w, table, ln)),
                     (ops.indexer_scores, (q, kc, w, ln)),
                     (ops.paged_indexer_scores_mq, (q9, pages, w, table, l9))):
        _writes_only_outputs(monkeypatch, fn, *args, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-medium", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_family_serve_step_on_card_matches_cpu(dev, arch):
    """The enc-dec, ssm and hybrid smoke configs (float32): six
    `serve_step`s on the card and through the plain path on the CPU from
    one random state (whisper and jamba: random caches, whisper's cross
    K/V, jamba's `h` and `conv`, lengths 0, 5 and 20 in a cache of 48 >
    min_n 8, so every step runs B5 -> B1 -> B6 in each attention layer:
    every decoder layer of whisper's, jamba's one in its superblock of
    8). Logits within rtol = 1e-4, atol = 1e-3 (float32 GEMMs and softmax sums in other
    orders), the Top-K equal, every state leaf within 1e-4."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(arch, smoke=True)
    gm, cm = build_model(cfg, device=dev), build_model(cfg, device="cpu")
    params = gm.init_params(seed=0)

    def cpu(tree):
        return ({k: cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    cparams = cpu(params)
    b = 3
    st = gm.init_decode_state(b, 48)
    g = torch.Generator(device=dev).manual_seed(48)
    for key in ("k", "v", "ck", "cv", "idx_k", "s", "x_att", "x_ffn", "h", "conv"):
        if key in st:
            st[key].copy_(torch.randn(st[key].shape, generator=g, device=dev))
    if "k" in st:
        st["length"] = torch.tensor([0, 5, 20], dtype=torch.int32, device=dev)
    cst = {k: v.cpu().clone() for k, v in st.items()}
    ops.reset_launch_counts()
    for _ in range(6):
        tok = torch.randint(0, cfg.vocab, (b,), generator=g, device=dev).int()
        lg, st = gm.serve_step(params, st, tok)
        lc, cst = cm.serve_step(cparams, cst, tok.cpu())
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-3)
        if "prev_topk" in st:
            assert torch.equal(st["prev_topk"].cpu(), cst["prev_topk"])
    for key, v in st.items():
        torch.testing.assert_close(v.cpu(), cst[key], rtol=1e-4, atol=1e-4)
    counts = ops.launch_counts()
    want = (() if arch == "rwkv6-3b" else
            ("indexer_scores", "gvr_topk", "sparse_decode_attn"))
    attn_layers = cfg.n_layers // 8 if cfg.family == "hybrid" else cfg.n_layers
    assert all(counts[name] == 6 * attn_layers for name in want), counts


@pytest.mark.cuda
@pytest.mark.parametrize("phase", ["tp", "ep"])
def test_mesh_step_on_card_matches_the_single_device_step(dev, phase):
    """chip_smoke's [tp] / [ep]: four gloo ranks on the card (llama3.2-1b,
    8 layers, on (2, 2); moonshot, 4 layers, bf16, on (1, 4)) against the
    single-device step over the same seeded cache: logits within the
    phase's tolerance, tokens equal but for near-ties, router flips only
    as near-ties their margin shows, B5, B1 and B6
    launched on every rank and equal to their plain versions at the
    rank's shapes, and ([ep]) the drops of an overflowing `moe_mlp_ep`
    call equal to the CPU's count. The same ranks then run the paged
    forms over the same cache (fused/token, gather and every live verify
    position equal to the rank's dense mesh ticks bit for bit, mq ==
    scan; B2, B3, B8, B9 and on [tp] B4, B7, B10 launched and equal to
    their plain versions) and the cells the phase carries ([tp]:
    [train-mesh] and [family-mesh]; [ep]: [ep-train]), each failing the
    phase on its own checks."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke as cs
    counts, checks, _ = cs.phase_mesh(phase)
    paged = {"tp": ("B2", "B3", "B4", "B7", "B8", "B9", "B10"),
             "ep": ("B2", "B3", "B8", "B9")}[phase]
    assert min(counts[k] for k in ("indexer_scores", "gvr_topk",
                                   "sparse_decode_attn")) > 0
    assert min(counts[cs.PAGED_MESH_KERNELS[k]] for k in paged) > 0
    assert set(checks) == {"B5 scoring", "B1", "B6"} | {
        k + " scoring" if k in ("B2", "B9") else k for k in paged}


@pytest.mark.cuda
def test_sequence_sharded_step_on_card_bit_identical_to_fused(dev, tmp_path):
    """Two gloo ranks on the card (`chip_smoke.py --sp-rank`, llama3.2-1b
    at full width, 2 layers, N = 16384, 3 greedy ticks) against the fused
    single-device step here over the same seeded logical cache: logits,
    feedback and telemetry bit for bit on both ranks; B2's scoring half
    and B6 ran on each rank and agree with their plain versions at those
    shapes; the step-4 assembly alone (bf16 rows with -0.0 entries, one
    owner a row, summed as int32 bit patterns) equals the whole buffer
    bit for bit."""
    import dataclasses
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    n, ticks = 16384, 3
    procs = cs.start_sp_children(tmp_path, depth=2, n=n, ticks=ticks,
                                 bill_n=0, engine=0)
    try:
        model = build_model(dataclasses.replace(get_config("llama3.2-1b"),
                                                n_layers=2), device=dev)
        params = model.init_params(seed=0)
        st = cs.sp_state(model, n=n, lengths=[n - 9, n // 2 - 6],
                         seed=cs.SP_SEED)
        fused, _ = cs._sp_ticks(model, params, st, lambda s, t:
                                model.serve_step_paged(params, s, t), ticks)
    finally:
        ranks = cs.join_sp_children(procs, tmp_path, "[sp] test")
    for res in ranks:
        for got, want in zip(res["ticks"], fused):
            for key in ("logits", "prev_topk", "sel_gvr", "topk_valid", "length"):
                assert torch.equal(got[key], want[key]), key
        assert res["counts"]["paged_indexer_scores"] == 2 * ticks
        assert res["counts"]["sparse_decode_attn"] == 2 * ticks
        assert res["counts"]["gvr_topk"] == 0
        assert res["assembly"]["bit_equal"] and res["assembly"]["neg_zeros"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-1b", "moonshot-v1-16b-a3b",
                                  "qwen2-vl-7b", "whisper-medium", "rwkv6-3b",
                                  "jamba-1.5-large-398b"])
def test_train_step_on_card_matches_cpu(dev, arch):
    """One train step (`loss_and_grads`, then `adamw.update`: the halves
    of `make_train_step`) of the smoke config (float32, TF32 off) on the
    card and through the plain path on the CPU from the same parameters
    and data-pipeline batch (frames for whisper, patch embeddings for
    qwen2-vl), B = 2, S = 64: loss within 1e-5 relative, every gradient
    leaf within 1e-4 relative L2 (float32 GEMMs and reductions in other
    orders), the indexer's exactly zero on both, every updated parameter
    and moment within 1e-5."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import batch_to, loss_and_grads
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths, tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    gm, cm = build_model(cfg, device=dev), build_model(cfg, device="cpu")
    params = gm.init_params(seed=0)
    cparams = tree_map(lambda t: t.cpu(), params)
    batch = batch_for_step(1, vocab=cfg.vocab, batch=2, seq=64,
                           family=cfg.family, cfg=cfg)
    lg, gg = loss_and_grads(gm, params, batch_to(batch, dev))
    lc, gc = loss_and_grads(cm, cparams, batch_to(batch, "cpu"))
    assert abs(float(lg) - float(lc)) <= 1e-5 * abs(float(lc))

    def rel(a, b):
        return float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))

    for (path, a), (_, c) in zip(flatten_with_paths(gg), flatten_with_paths(gc)):
        if "['indexer']" in path:
            assert not a.any() and not c.any(), path
        else:
            assert rel(a, c) <= 1e-4, path
    ocfg = adamw.AdamWConfig()
    pg, og, _ = adamw.update(gg, adamw.init(params), params, ocfg)
    pc, oc, _ = adamw.update(gc, adamw.init(cparams), cparams, ocfg)
    for (path, a), (_, c) in zip(flatten_with_paths((pg, og.m, og.v)),
                                 flatten_with_paths((pc, oc.m, oc.v))):
        assert rel(a, c) <= 1e-5, path


@pytest.mark.cuda
def test_train_resume_bit_exact_on_card(dev, tmp_path):
    """`chip_smoke.py --train-resume` on llama3.2-1b's smoke config (2
    layers, B = 2, S = 64) in a child process under deterministic
    algorithms with CUBLAS_WORKSPACE_CONFIG=:4096:8: 6 steps straight
    equal 3 + save + restore_latest + 3 in every parameter and moment bit
    for bit, and the train CLI resumes on the card from its step-4
    checkpoint and prints `done`."""
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    child = cs.start_train_resume_child(tmp_path, arch="llama3.2-1b",
                                        smoke=True, depth=2, b=2, s=64)
    res = cs.join_train_resume_child(child, tmp_path)
    assert res["differ"] == [] and res["restored_step"] == 3
