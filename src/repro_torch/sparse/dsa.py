"""DeepSeek Sparse Attention (DSA) decode block: indexer → Top-K → sparse
attention over the selected rows (paper §2), PyTorch port.

Indices live in logical token space end to end: `prev_topk` (the temporal
feedback buffer) and the selected indices are positions within the
request's own context, whatever the physical page layout.

Two physical forms share the same front half (indexer scoring + exact
Top-K, bit-identical on the card because B2 and B5 sum every score in the
same order):

* `dsa_decode` — caches arrive as contiguous logical views (the dense
  layout, or the paged `paged_attn="gather"` oracle, which builds the
  views first with kernel B7): `dsa_select` scores and selects (kernels B5
  + B1 on the card), then `dsa_sparse_attention` attends the K selected
  rows (kernel B6);
* `dsa_decode_paged` — block-table-native: `dsa_select_paged` scores
  through the block table (B2 + B1), then `dsa_sparse_attention_paged`
  reads exactly the K selected rows from the page pools, one row per entry
  (B3) or each distinct touched page whole (`granularity="page"`, B10).

The speculative verify tick's multi-query forms run all Q = d+1 draft
positions of each slot at once: `dsa_select_paged_mq` scores the Q rows
and selects them as a chain, row q warm-started from row q-1's Top-K
(B9: scoring + chained GVR), and `dsa_sparse_attention_paged_mq` attends
every (slot, row) selection in one launch (B8, or B10 over the folded
rows at page granularity).

On the CPU the same wrappers run their plain versions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import distinct_pages
from repro_torch.models.layers import apply_rotary
from .selector import SelectorOutput, resolve_method, select_topk


def indexer_init(generator: torch.Generator, d_model: int, heads: int,
                 dim: int, dtype, device, *, layers: Optional[int] = None):
    """Indexer parameters (stacked over `layers` when given): wq (d, H·dim),
    wk (d, dim) — N(0, 1/d) — and head weights w = 1/H in f32."""
    lead = () if layers is None else (layers,)
    s = d_model ** -0.5

    def normal(shape):
        return (torch.randn(lead + shape, generator=generator, device=device)
                * s).to(dtype)

    return {
        "wq": normal((d_model, heads * dim)),
        "wk": normal((d_model, dim)),
        "w": torch.ones(lead + (heads,), dtype=torch.float32, device=device) / heads,
    }


def indexer_q(params, x: torch.Tensor, positions: torch.Tensor, *, heads: int,
              dim: int, rope_base: float, dtype) -> torch.Tensor:
    """Indexer queries of the decode token (B, H, dim), RoPE'd at its
    position and cast to the cache dtype (the served path's numerics)."""
    b = x.shape[0]
    q = (x @ params["wq"]).reshape(b, 1, heads, dim)
    q = apply_rotary(q, positions[:, None], kind="rope", base=rope_base)[:, 0]
    return q.to(dtype).contiguous()


def indexer_scores(params, x: torch.Tensor, idx_kcache: torch.Tensor,
                   positions: torch.Tensor, lengths: torch.Tensor, *,
                   heads: int, dim: int, rope_base: float) -> torch.Tensor:
    """Eq. 1 over a contiguous indexer view: I = sum_j w_j ReLU(q_j ·
    K_I^T) (kernel B5's scoring launch on the card). idx_kcache: (B, N,
    dim). Returns (B, N) f32, NEG beyond `lengths`."""
    q = indexer_q(params, x, positions, heads=heads, dim=dim,
                  rope_base=rope_base, dtype=idx_kcache.dtype)
    return ops.indexer_scores(q, idx_kcache.contiguous(),
                              params["w"].float().contiguous(),
                              lengths.int().contiguous())


def indexer_k(params, x: torch.Tensor, positions: torch.Tensor, *, dim: int,
              rope_base: float) -> torch.Tensor:
    """Indexer key of the new token (B, dim), RoPE'd at its position."""
    kk = (x @ params["wk"]).reshape(x.shape[0], 1, 1, dim)
    return apply_rotary(kk, positions[:, None], kind="rope",
                        base=rope_base)[:, 0, 0]


class DSAOutput(NamedTuple):
    attn_out: torch.Tensor                   # (B, H, HD) f32
    topk_idx: torch.Tensor                   # (B, K) int32 — next prediction
    secant_iters: Optional[torch.Tensor]
    gvr_rows: Optional[torch.Tensor] = None  # (B,) bool — selector path


def _select(scoring, topk, q, w, prev_topk, lengths, n: int, *, k: int,
            selector: str, prev_valid, max_candidates, gate_max_n: int,
            min_n: int) -> SelectorOutput:
    """Shared Top-K dispatch of both layouts. Under the GVR methods every
    row goes through the scoring + GVR kernels (`topk`: exact for warm and
    cold rows alike, so `gvr_rows` stays the `prev_valid` warm mask the
    selector's per-row dispatch reports); the other methods score with
    `scoring` and select with the plain `select_topk`. Both branches score
    inside the caller's sliding window, which `scoring` and `topk` carry."""
    method = resolve_method(selector, n, has_prev=prev_topk is not None,
                            has_valid=prev_valid is not None,
                            gate_max_n=gate_max_n, min_n_for_selection=min_n)
    if method in ("gvr", "mixed"):
        vals, idx, stats = topk(q, w, prev_topk.int().contiguous(), k,
                                lengths=lengths, max_candidates=max_candidates)
        rows = (prev_valid.bool() if method == "mixed"
                else torch.ones_like(lengths, dtype=torch.bool))
        return SelectorOutput(idx, vals, method, stats[:, 0].int(), rows)
    scores = scoring(q, w, lengths)
    return select_topk(scores, k, prev_idx=prev_topk, prev_valid=prev_valid,
                       method=method, max_candidates=max_candidates,
                       gate_max_n=gate_max_n, min_n_for_selection=min_n)


def dsa_select(indexer_params, x: torch.Tensor, idx_kcache: torch.Tensor,
               prev_topk: torch.Tensor, lengths: torch.Tensor, *, k: int,
               heads: int, dim: int, rope_base: float, selector: str = "auto",
               prev_valid: Optional[torch.Tensor] = None,
               max_candidates: Optional[int] = None,
               gate_max_n: int = 200_000, min_n: int = 4096,
               swa_window: Optional[int] = None) -> SelectorOutput:
    """Indexer scoring + exact Top-K over a contiguous indexer view
    (B, N, dim): kernels B5 (scoring) + B1 (GVR) on the card. Under a
    sliding window only [length - swa_window, length) may be selected:
    the positions below score NEG, as the reference masks them."""
    kc = idx_kcache.contiguous()
    lengths = lengths.int().contiguous()
    q = indexer_q(indexer_params, x, lengths - 1, heads=heads, dim=dim,
                  rope_base=rope_base, dtype=kc.dtype)
    w = indexer_params["w"].float().contiguous()
    return _select(
        lambda q_, w_, ln: ops.indexer_scores(q_, kc, w_, ln, swa_window),
        lambda q_, w_, prev, kk, **kw: ops.indexer_topk(
            q_, kc, w_, prev, kk, window=swa_window, **kw),
        q, w, prev_topk, lengths, kc.shape[1], k=k, selector=selector,
        prev_valid=prev_valid, max_candidates=max_candidates,
        gate_max_n=gate_max_n, min_n=min_n)


def dsa_select_paged(indexer_params, x: torch.Tensor, idx_k_pages: torch.Tensor,
                     table: torch.Tensor, prev_topk: torch.Tensor,
                     lengths: torch.Tensor, *, k: int, heads: int, dim: int,
                     rope_base: float, selector: str = "auto",
                     prev_valid: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None,
                     gate_max_n: int = 200_000, min_n: int = 4096,
                     swa_window: Optional[int] = None) -> SelectorOutput:
    """Indexer scoring + exact Top-K over the paged indexer-K pool: kernels
    B2 (scoring through the block table) + B1 (GVR) on the card; the
    sliding window as in `dsa_select`."""
    lengths = lengths.int().contiguous()
    q = indexer_q(indexer_params, x, lengths - 1, heads=heads, dim=dim,
                  rope_base=rope_base, dtype=idx_k_pages.dtype)
    w = indexer_params["w"].float().contiguous()
    return _select(
        lambda q_, w_, ln: ops.paged_indexer_scores(q_, idx_k_pages, w_, table,
                                                    ln, swa_window),
        lambda q_, w_, prev, kk, **kw: ops.paged_indexer_topk(
            q_, idx_k_pages, w_, table, prev, kk, window=swa_window, **kw),
        q, w, prev_topk, lengths, table.shape[1] * idx_k_pages.shape[1], k=k,
        selector=selector, prev_valid=prev_valid,
        max_candidates=max_candidates, gate_max_n=gate_max_n, min_n=min_n)


def dsa_select_paged_mq(indexer_params, x: torch.Tensor,
                        idx_k_pages: torch.Tensor, table: torch.Tensor,
                        prev_topk: torch.Tensor, lengths: torch.Tensor, *,
                        k: int, heads: int, dim: int, rope_base: float,
                        selector: str = "auto",
                        prev_valid: Optional[torch.Tensor] = None,
                        max_candidates: Optional[int] = None,
                        gate_max_n: int = 200_000, min_n: int = 4096,
                        swa_window: Optional[int] = None) -> SelectorOutput:
    """The Q query rows of each slot — x (B, Q, D), lengths (B, Q), row q
    at position L0 + q — selected as a chain over the paged indexer keys:
    row 0 warm-started from `prev_topk` (B, K) under `prev_valid`, row q > 0
    from row q-1's Top-K, valid. Equals `dsa_select_paged` run row by row
    with that threading, in indices and in `gvr_rows`.

    Under the GVR methods all Q rows go through kernel B9 (scoring, then
    the chained GVR, exact for warm and cold rows alike); `gvr_rows` is
    `prev_valid` for row 0 under "mixed" and true elsewhere, as the
    per-row selector reports it. Under radix or exact, B9's scoring half
    scores the rows and the plain `select_topk` selects them one by one.
    A sliding window masks each row at its own length, as the reference's
    row-by-row selection does. Returns a `SelectorOutput` whose fields
    carry a Q axis after B."""
    b, qn = lengths.shape
    lengths = lengths.int().contiguous()
    q = indexer_q(indexer_params, x.reshape(b * qn, -1),
                  (lengths - 1).reshape(b * qn), heads=heads, dim=dim,
                  rope_base=rope_base, dtype=idx_k_pages.dtype)
    q = q.reshape(b, qn, heads, dim)
    w = indexer_params["w"].float().contiguous()
    n = table.shape[1] * idx_k_pages.shape[1]
    method = resolve_method(selector, n, has_prev=True,
                            has_valid=prev_valid is not None,
                            gate_max_n=gate_max_n, min_n_for_selection=min_n)
    if method in ("gvr", "mixed"):
        vals, idx, stats = ops.paged_indexer_topk_mq(
            q, idx_k_pages, w, table, prev_topk.int().contiguous(), k,
            lengths=lengths, max_candidates=max_candidates, window=swa_window)
        rows = torch.ones((b, qn), dtype=torch.bool, device=lengths.device)
        if method == "mixed":
            rows[:, 0] = prev_valid.bool()
        return SelectorOutput(idx, vals, method, stats[..., 0].int(), rows)
    scores = ops.paged_indexer_scores_mq(q, idx_k_pages, w, table, lengths,
                                         swa_window)
    sels, prev, valid = [], prev_topk, prev_valid
    for j in range(qn):
        sel = select_topk(scores[:, j], k, prev_idx=prev, prev_valid=valid,
                          method=method, max_candidates=max_candidates,
                          gate_max_n=gate_max_n, min_n_for_selection=min_n)
        sels.append(sel)
        prev = sel.indices
        valid = None if valid is None else torch.ones_like(valid)
    iters = [s_.secant_iters for s_ in sels]
    return SelectorOutput(
        torch.stack([s_.indices for s_ in sels], 1),
        torch.stack([s_.values for s_ in sels], 1), method,
        None if iters[0] is None else torch.stack(iters, 1),
        torch.stack([s_.gvr_rows for s_ in sels], 1))


def dsa_sparse_attention(q: torch.Tensor, kcache: torch.Tensor,
                         vcache: torch.Tensor, topk_idx: torch.Tensor,
                         lengths: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Attention over the Top-K selected rows of contiguous caches
    (B, N, KVH, HD) — kernel B6 on the card. An entry counts iff it lies in
    [0, length). Returns (B, H, HD) f32."""
    return ops.sparse_decode_attn(q.to(kcache.dtype).contiguous(), kcache,
                                  vcache, topk_idx.int().contiguous(),
                                  lengths.int().contiguous(), scale=scale)


def page_gather_stats(topk_idx: torch.Tensor, *, page_size: int,
                      num_logical_pages: int) -> torch.Tensor:
    """(B,) int32 distinct-page counts of a Top-K selection: the
    page-granular gather moves count × page_size rows where the
    token-granular one moves K."""
    n = num_logical_pages * page_size
    up = distinct_pages(topk_idx.long().clamp(0, n - 1), page_size=page_size,
                        num_logical_pages=num_logical_pages)
    return (up < num_logical_pages).sum(1).int()


def dsa_sparse_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, table: torch.Tensor,
                               topk_idx: torch.Tensor, lengths: torch.Tensor,
                               *, scale: float,
                               granularity: str = "token") -> torch.Tensor:
    """Block-table-native attention over the K selected LOGICAL rows: each
    read from page `table[b, idx // page_size]` at offset `idx % page_size`
    ("token": kernel B3), or each distinct touched page read whole and the
    unselected rows masked ("page": kernel B10). Masking: an entry counts
    iff it lies in [0, length) and its page is mapped."""
    attn = {"token": ops.paged_sparse_decode_attn,
            "page": ops.paged_sparse_decode_attn_pg}[granularity]
    return attn(q.to(k_pages.dtype).contiguous(), k_pages, v_pages, table,
                topk_idx.int().contiguous(), lengths.int().contiguous(),
                scale=scale)


def dsa_sparse_attention_paged_mq(q: torch.Tensor, k_pages: torch.Tensor,
                                  v_pages: torch.Tensor, table: torch.Tensor,
                                  topk_idx: torch.Tensor,
                                  lengths: torch.Tensor, *, scale: float,
                                  granularity: str = "token") -> torch.Tensor:
    """`dsa_sparse_attention_paged` over the Q query rows of each slot: q
    (B, Q, H, HD), topk_idx (B, Q, K) logical, lengths (B, Q) each row's
    causal extent, the slot's table row shared by its rows. "token": one
    launch of kernel B8; "page": B10 over the folded (B*Q) rows with the
    table repeated. Each row's result is the single-row form's. Returns
    (B, Q, H, HD) f32."""
    q = q.to(k_pages.dtype).contiguous()
    idx = topk_idx.int().contiguous()
    lengths = lengths.int().contiguous()
    if granularity == "token":
        return ops.paged_sparse_decode_attn_mq(q, k_pages, v_pages, table,
                                               idx, lengths, scale=scale)
    b, qn = lengths.shape
    out = dsa_sparse_attention_paged(
        q.reshape((b * qn,) + q.shape[2:]), k_pages, v_pages,
        table.repeat_interleave(qn, dim=0).contiguous(),
        idx.reshape(b * qn, -1), lengths.reshape(b * qn), scale=scale,
        granularity=granularity)
    return out.reshape(q.shape)


def dsa_decode(q: torch.Tensor, kcache: torch.Tensor, vcache: torch.Tensor,
               indexer_params, x: torch.Tensor, idx_kcache: torch.Tensor,
               prev_topk: torch.Tensor, lengths: torch.Tensor, *, k: int,
               scale: float, heads: int, dim: int, rope_base: float,
               selector: str = "auto",
               prev_valid: Optional[torch.Tensor] = None,
               max_candidates: Optional[int] = None,
               gate_max_n: int = 200_000, min_n: int = 4096,
               swa_window: Optional[int] = None) -> DSAOutput:
    """DSA decode step for one layer over contiguous logical views: select
    over the indexer cache (B5 + B1), then attend over exactly the K
    selected rows (B6)."""
    sel = dsa_select(indexer_params, x, idx_kcache, prev_topk, lengths, k=k,
                     heads=heads, dim=dim, rope_base=rope_base,
                     selector=selector, prev_valid=prev_valid,
                     max_candidates=max_candidates, gate_max_n=gate_max_n,
                     min_n=min_n, swa_window=swa_window)
    out = dsa_sparse_attention(q, kcache, vcache, sel.indices, lengths,
                               scale=scale)
    return DSAOutput(out, sel.indices, sel.secant_iters, sel.gvr_rows)


def dsa_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     indexer_params, x: torch.Tensor, idx_k_pages: torch.Tensor,
                     prev_topk: torch.Tensor, lengths: torch.Tensor, *,
                     k: int, scale: float, heads: int, dim: int,
                     rope_base: float, selector: str = "auto",
                     prev_valid: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None,
                     gate_max_n: int = 200_000, min_n: int = 4096,
                     swa_window: Optional[int] = None,
                     gather_granularity: str = "token") -> DSAOutput:
    """Block-table-native DSA decode step for one layer: select over the
    paged indexer keys (B2 + B1), then attend over exactly the K selected
    rows straight from the page pools (B3, or B10 at page granularity)."""
    sel = dsa_select_paged(indexer_params, x, idx_k_pages, table, prev_topk,
                           lengths, k=k, heads=heads, dim=dim,
                           rope_base=rope_base, selector=selector,
                           prev_valid=prev_valid,
                           max_candidates=max_candidates,
                           gate_max_n=gate_max_n, min_n=min_n,
                           swa_window=swa_window)
    out = dsa_sparse_attention_paged(q, k_pages, v_pages, table, sel.indices,
                                     lengths, scale=scale,
                                     granularity=gather_granularity)
    return DSAOutput(out, sel.indices, sel.secant_iters, sel.gvr_rows)
