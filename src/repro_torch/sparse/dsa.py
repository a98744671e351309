"""DeepSeek Sparse Attention (DSA) decode block: indexer → Top-K → sparse
attention over the selected rows (paper §2), PyTorch port.

Indices live in logical token space end to end: `prev_topk` (the temporal
feedback buffer) and the selected indices are positions within the
request's own context, whatever the physical page layout.

The served paged step runs `dsa_decode_paged`:
  1. `dsa_select_paged` — the indexer query (RoPE'd, cast to the cache
     dtype) scores every logical position through the block table and the
     exact Top-K is selected: kernels B2 (scoring) + B1 (GVR) on the card;
  2. `ops.paged_sparse_decode_attn` — attention over exactly the K
     selected rows, each read from `table[b, idx // ps]` (kernel B3).
On the CPU the same wrappers run their plain versions. `indexer_scores`
is the plain score row over a contiguous indexer view, kept for tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rotary
from .selector import SelectorOutput, resolve_method, select_topk

NEG = -3.4028234663852886e38


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
    """Eq. 1 over a contiguous indexer view (plain form): I = sum_j w_j
    ReLU(q_j · K_I^T). idx_kcache: (B, N, dim). Returns (B, N) f32, NEG
    beyond `lengths`."""
    n = idx_kcache.shape[1]
    q = indexer_q(params, x, positions, heads=heads, dim=dim,
                  rope_base=rope_base, dtype=idx_kcache.dtype)
    s = torch.einsum("bhd,bnd->bhn", q.float(), idx_kcache.float()).clamp_min(0.0)
    scores = torch.einsum("h,bhn->bn", params["w"].float(), s)
    pos = torch.arange(n, device=x.device)
    return torch.where(pos[None, :] < lengths[:, None], scores,
                       torch.full_like(scores, NEG))


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


def dsa_select(indexer_params, x: torch.Tensor, idx_kcache: torch.Tensor,
               prev_topk: torch.Tensor, lengths: torch.Tensor, *, k: int,
               heads: int, dim: int, rope_base: float, selector: str = "auto",
               prev_valid: Optional[torch.Tensor] = None,
               max_candidates: Optional[int] = None,
               gate_max_n: int = 200_000, min_n: int = 4096) -> SelectorOutput:
    """Indexer scoring + Top-K selection over a contiguous indexer view
    (plain form of the front half of the DSA pipeline)."""
    scores = indexer_scores(indexer_params, x, idx_kcache, lengths - 1,
                            lengths, heads=heads, dim=dim, rope_base=rope_base)
    return select_topk(scores, k, prev_idx=prev_topk, prev_valid=prev_valid,
                       method=selector, max_candidates=max_candidates,
                       gate_max_n=gate_max_n, min_n_for_selection=min_n)


def dsa_select_paged(indexer_params, x: torch.Tensor, idx_k_pages: torch.Tensor,
                     table: torch.Tensor, prev_topk: torch.Tensor,
                     lengths: torch.Tensor, *, k: int, heads: int, dim: int,
                     rope_base: float, selector: str = "auto",
                     prev_valid: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None,
                     gate_max_n: int = 200_000, min_n: int = 4096,
                     swa_window: Optional[int] = None) -> SelectorOutput:
    """Indexer scoring + exact Top-K over the paged indexer-K pool.

    Under the GVR methods every row goes through `ops.paged_indexer_topk`
    (B2 scoring + B1 selection) — exact for warm and cold rows alike, so
    `gvr_rows` stays the `prev_valid` warm mask the selector's per-row
    dispatch reports. The other methods score with B2 and select with the
    plain `select_topk`.
    """
    if swa_window is not None:
        raise NotImplementedError(
            "DSA selection under a sliding window is not ported yet (ROADMAP "
            "Queue A item 5: the SWA families)")
    ps = idx_k_pages.shape[1]
    n = table.shape[1] * ps
    positions = lengths - 1
    q = indexer_q(indexer_params, x, positions, heads=heads, dim=dim,
                  rope_base=rope_base, dtype=idx_k_pages.dtype)
    method = resolve_method(selector, n, has_prev=prev_topk is not None,
                            has_valid=prev_valid is not None,
                            gate_max_n=gate_max_n, min_n_for_selection=min_n)
    w = indexer_params["w"].float().contiguous()
    if method in ("gvr", "mixed"):
        vals, idx, stats = ops.paged_indexer_topk(
            q, idx_k_pages, w, table, prev_topk.int().contiguous(), k,
            lengths=lengths, max_candidates=max_candidates)
        rows = (prev_valid.bool() if method == "mixed"
                else torch.ones_like(lengths, dtype=torch.bool))
        return SelectorOutput(idx, vals, method, stats[:, 0].int(), rows)
    scores = ops.paged_indexer_scores(q, idx_k_pages, w, table, lengths)
    return select_topk(scores, k, prev_idx=prev_topk, prev_valid=prev_valid,
                       method=method, max_candidates=max_candidates,
                       gate_max_n=gate_max_n, min_n_for_selection=min_n)


def dsa_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, table: torch.Tensor,
                     indexer_params, x: torch.Tensor, idx_k_pages: torch.Tensor,
                     prev_topk: torch.Tensor, lengths: torch.Tensor, *,
                     k: int, scale: float, heads: int, dim: int,
                     rope_base: float, selector: str = "auto",
                     prev_valid: Optional[torch.Tensor] = None,
                     max_candidates: Optional[int] = None,
                     gate_max_n: int = 200_000, min_n: int = 4096,
                     swa_window: Optional[int] = None) -> DSAOutput:
    """Block-table-native DSA decode step for one layer: select over the
    paged indexer keys, then attend over exactly the K selected rows
    straight from the page pools (kernel B3). Masking: an entry counts iff
    it lies in [0, length) and its page is mapped."""
    sel = dsa_select_paged(indexer_params, x, idx_k_pages, table, prev_topk,
                           lengths, k=k, heads=heads, dim=dim,
                           rope_base=rope_base, selector=selector,
                           prev_valid=prev_valid,
                           max_candidates=max_candidates,
                           gate_max_n=gate_max_n, min_n=min_n,
                           swa_window=swa_window)
    out = ops.paged_sparse_decode_attn(q.to(k_pages.dtype).contiguous(),
                                       k_pages, v_pages, table,
                                       sel.indices.contiguous(), lengths,
                                       scale=scale)
    return DSAOutput(out, sel.indices, sel.secant_iters, sel.gvr_rows)
