"""Plain PyTorch versions of the port's kernels B1–B10.

Each function computes what its Hopper kernel computes, from the same
arguments, in straightforward tensor code. The CPU path of
`repro_torch.kernels.ops` runs them, the CPU tests hold them against the
JAX package, and `chip_smoke.py` holds each kernel against them on the
card. They repeat the kernels' arithmetic and are no yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.gvr import extract_topk, gvr_threshold

NEG = -3.4028234663852886e38


def resolve_cmax(k: int, n: int, max_candidates: Optional[int]) -> int:
    """Candidate-buffer capacity C, as `core.gvr.gvr_threshold` derives it."""
    cmax = max_candidates if max_candidates is not None else min(3 * k, n)
    return max(cmax, k)


def gvr_topk_ref(scores: torch.Tensor, prev_idx: torch.Tensor, k: int, *,
                 max_candidates: Optional[int] = None,
                 max_secant_iters: int = 12):
    """B1: exact Top-K of each (B, N) f32 row, ascending index order,
    lowest-index ties, warm-started from (B, M) predictions.

    Returns (values (B,K) f32, indices (B,K) int32, stats (B,8) f32) with
    stats columns [secant_iters, refine_iters, cand_count, fallback,
    threshold, n_gt, n_ge, emitted]. Columns 4–7 are exact and agree with
    the kernel's; columns 0–3 describe the path each form took (here the
    histogram + snap refine of `core.gvr`, there a radix select).
    """
    st = gvr_threshold(scores, prev_idx, k, max_candidates=max_candidates,
                       max_secant_iters=max_secant_iters)
    vals, idx = extract_topk(scores, st.threshold, k)
    b = scores.shape[0]
    stats = torch.stack([
        st.secant_iters.float(), (st.hist_levels + st.snap_iters).float(),
        st.cand_count.float(), st.fallback.float(), st.threshold,
        st.n_gt.float(), st.n_ge.float(),
        torch.full((b,), float(k), device=scores.device)], dim=1)
    return vals, idx, stats


def gvr_topk_chain_ref(scores: torch.Tensor, prev_idx: torch.Tensor, k: int,
                       *, max_candidates: Optional[int] = None,
                       max_secant_iters: int = 12):
    """B9's selection: Q chained Top-Ks per slot. Row 0 of scores (B, Q, N)
    warm-starts from prev_idx (B, K), row q > 0 from row q-1's indices.
    Returns (values (B,Q,K), indices (B,Q,K), stats (B,Q,8)) as
    `gvr_topk_ref` per row."""
    outs, prev = [], prev_idx
    for j in range(scores.shape[1]):
        out = gvr_topk_ref(scores[:, j], prev, k, max_candidates=max_candidates,
                           max_secant_iters=max_secant_iters)
        outs.append(out)
        prev = out[1]
    return tuple(torch.stack(parts, dim=1) for parts in zip(*outs))


def _in_extent(n: int, lengths: torch.Tensor,
               window: Optional[int]) -> torch.Tensor:
    """(B, n) mask of the positions a score row keeps: below the length
    and, with a sliding window, at or above length - window (the
    reference's `pos > length - 1 - window`)."""
    pos = torch.arange(n, device=lengths.device)[None, :]
    keep = pos < lengths[:, None]
    if window is not None:
        keep &= pos > lengths[:, None] - 1 - window
    return keep


def paged_indexer_scores_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             w: torch.Tensor, table: torch.Tensor,
                             lengths: torch.Tensor,
                             window: Optional[int] = None) -> torch.Tensor:
    """B2 scoring stage, paper Eq. 1 over page-addressed indexer keys:
    score[b, n] = sum_h w_h ReLU(q[b,h] . k[n]) in f32, NEG at positions
    >= length, below length - window (a sliding window) and on unmapped
    (-1) pages.

    q: (B, H, D) in the cache dtype; k_pages: (P, ps, D); w: (H,) or
    (B, H) f32; table: (B, MP) int32; lengths: (B,). Returns (B, MP*ps)
    f32.
    """
    b, mp = table.shape
    p, ps, d = k_pages.shape
    view = k_pages[table.long().clamp(0, p - 1)].reshape(b, mp * ps, d)
    s = torch.einsum("bhd,bnd->bhn", q.float(), view.float()).clamp_min(0.0)
    if w.dim() == 1:
        scores = torch.einsum("h,bhn->bn", w.float(), s)
    else:
        scores = torch.einsum("bh,bhn->bn", w.float(), s)
    mapped = (table >= 0).repeat_interleave(ps, dim=1)
    keep = _in_extent(mp * ps, lengths, window) & mapped
    return torch.where(keep, scores, torch.full_like(scores, NEG))


def paged_indexer_scores_mq_ref(q: torch.Tensor, k_pages: torch.Tensor,
                                w: torch.Tensor, table: torch.Tensor,
                                lengths: torch.Tensor,
                                window: Optional[int] = None) -> torch.Tensor:
    """B9 scoring stage: B2 over the Q query rows of each slot, q (B, Q, H,
    D), lengths (B, Q), the slot's table row shared by its rows. Row q is
    `paged_indexer_scores_ref` of the B slots at lengths[:, q] (its window
    too begins at its own length), as the kernel's rows equal B2's.
    Returns (B, Q, MP*ps) f32."""
    return torch.stack([paged_indexer_scores_ref(q[:, j], k_pages, w, table,
                                                 lengths[:, j], window)
                        for j in range(q.shape[1])], dim=1)


def indexer_scores_ref(q: torch.Tensor, kcache: torch.Tensor, w: torch.Tensor,
                       lengths: torch.Tensor,
                       window: Optional[int] = None) -> torch.Tensor:
    """B5 scoring stage, paper Eq. 1 over a contiguous indexer cache:
    score[b, n] = sum_h w_h ReLU(q[b,h] . k[b,n]) in f32, NEG at positions
    >= length and below length - window.

    q: (B, H, D) in the cache dtype; kcache: (B, N, D); w: (H,) or (B, H)
    f32; lengths: (B,). Returns (B, N) f32.
    """
    s = torch.einsum("bhd,bnd->bhn", q.float(), kcache.float()).clamp_min(0.0)
    if w.dim() == 1:
        scores = torch.einsum("h,bhn->bn", w.float(), s)
    else:
        scores = torch.einsum("bh,bhn->bn", w.float(), s)
    return torch.where(_in_extent(kcache.shape[1], lengths, window), scores,
                       torch.full_like(scores, NEG))


def paged_gather_ref(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """B7: the contiguous logical view of a page pool. pages: (P, ps, ...)
    with any trailing feature dims; table: (B, MP) int32. Row [b, m*ps + o]
    is pages[table[b, m], o], zeros where the page is unmapped (table < 0 or
    >= P). Returns (B, MP*ps, ...) in the pool dtype."""
    p, ps = pages.shape[:2]
    b, mp = table.shape
    mapped = (table >= 0) & (table < p)
    out = pages[table.long().clamp(0, p - 1)]             # (B, MP, ps, ...)
    mask = mapped.reshape((b, mp) + (1,) * (pages.dim() - 1))
    out = torch.where(mask, out, torch.zeros_like(out))
    return out.reshape((b, mp * ps) + tuple(pages.shape[2:]))


def distinct_pages(topk_idx: torch.Tensor, *, page_size: int,
                   num_logical_pages: int) -> torch.Tensor:
    """Per-row ascending distinct LOGICAL pages touched by the selected
    indices (already clipped to [0, MP*page_size)), padded with the
    sentinel MP: the descriptor list a page-granular gather walks.
    Shape (B, min(K, MP))."""
    b, k = topk_idx.shape
    mp = num_logical_pages
    pg = torch.sort(topk_idx // page_size, dim=1).values.int()
    first = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=pg.device),
                       pg[:, 1:] > pg[:, :-1]], dim=1)
    slot = torch.cumsum(first.int(), dim=1) - 1                     # (B, K)
    out = torch.full((b, min(k, mp)), mp, dtype=torch.int32, device=pg.device)
    # duplicates of a page write the same value into the same slot
    return out.scatter_(1, slot.long(), pg)


def _attend_rows(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 flat: torch.Tensor, valid: torch.Tensor, scale: float,
                 rows_per_split: Optional[int] = None) -> torch.Tensor:
    """Softmax attention of q (B, H, hd) over the rows `flat` (B, R) of the
    flattened pools where `valid`; f32 throughout, 0 for a slot with no
    valid row. With `rows_per_split`, the R entries are cut into runs of
    that length as the kernel splits them: each split's (max, sum, PV) is
    taken alone and the partials are merged with the kernel's guards (a
    split with no valid row is skipped, the sum clamped to 1e-30)."""
    b, h, hd = q.shape
    p, ps, kvh = k_pages.shape[:3]
    g = h // kvh
    kg = k_pages.reshape(p * ps, kvh, hd)[flat].float()     # (B, R, KVH, hd)
    vg = v_pages.reshape(p * ps, kvh, hd)[flat].float()
    logits = torch.einsum("bkgd,brkd->bkgr", q.float().reshape(b, kvh, g, hd),
                          kg) * scale
    if rows_per_split is not None:
        return _merge_splits(logits, vg, valid, rows_per_split).reshape(b, h, hd)
    mask = valid[:, None, None, :]
    m = torch.where(mask, logits, torch.full_like(logits, -torch.inf)).amax(-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pr = torch.where(mask, torch.exp(logits - m[..., None]),
                     torch.zeros_like(logits))
    l = pr.sum(-1).clamp_min(1e-30)
    out = torch.einsum("bkgr,brkd->bkgd", pr, vg) / l[..., None]
    return out.reshape(b, h, hd)


def _merge_splits(logits: torch.Tensor, vg: torch.Tensor, valid: torch.Tensor,
                  rows_per_split: int) -> torch.Tensor:
    """The split form of `_attend_rows`: logits (B, KVH, G, R), values
    (B, R, KVH, hd), valid (B, R). Returns (B, KVH, G, hd)."""
    b, kvh, g, r = logits.shape
    ns = max(1, -(-r // rows_per_split))
    pad = ns * rows_per_split - r
    logits = torch.nn.functional.pad(logits, (0, pad))
    vg = torch.nn.functional.pad(vg, (0, 0, 0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad), value=False)
    lg = logits.reshape(b, kvh, g, ns, rows_per_split)
    mk = valid.reshape(b, 1, 1, ns, rows_per_split)
    m_s = torch.where(mk, lg, torch.full_like(lg, -torch.inf)).amax(-1)
    live = torch.isfinite(m_s)                                # (B, KVH, G, S)
    m_safe = torch.where(live, m_s, torch.zeros_like(m_s))
    pr = torch.where(mk, torch.exp(lg - m_safe[..., None]), torch.zeros_like(lg))
    l_s = pr.sum(-1)
    acc_s = torch.einsum("bkgsr,bsrkd->bkgsd", pr,
                         vg.reshape(b, ns, rows_per_split, kvh, -1))
    m_all = m_s.amax(-1)                                      # -inf: no live split
    any_live = torch.isfinite(m_all)
    f = torch.where(live, torch.exp(m_s - torch.where(
        any_live, m_all, torch.zeros_like(m_all))[..., None]), torch.zeros_like(m_s))
    l_all = (l_s * f).sum(-1)
    acc = (acc_s * f[..., None]).sum(-2) / l_all.clamp_min(1e-30)[..., None]
    return torch.where(any_live[..., None], acc, torch.zeros_like(acc))


def _paged_entries(idx: torch.Tensor, table: torch.Tensor,
                   lengths: torch.Tensor, p: int, ps: int):
    """Top-K entries idx (B, K) through the block table: (logical row
    clipped to the extent, physical page, valid). An entry is valid iff
    0 <= idx < length and its page is mapped."""
    n = table.shape[1] * ps
    li = idx.long().clamp(0, n - 1)
    phys = table.long().gather(1, li // ps)
    valid = ((idx >= 0) & (idx < lengths[:, None]) & (idx < n)
             & (phys >= 0) & (phys < p))
    return li, phys, valid


def paged_sparse_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          idx: torch.Tensor, lengths: torch.Tensor, *,
                          scale: Optional[float] = None,
                          rows_per_split: Optional[int] = None) -> torch.Tensor:
    """B3: one query token per slot attends over exactly the K selected
    logical rows idx (B, K), each read from page table[b, idx // ps] at
    offset idx % ps. An entry counts iff 0 <= idx < length and its page is
    mapped. Returns (B, H, hd) f32. `rows_per_split` computes the kernel's
    split form (runs of that many entries merged); None the one softmax."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p, ps = k_pages.shape[:2]
    li, phys, valid = _paged_entries(idx, table, lengths, p, ps)
    flat = phys.clamp(0, p - 1) * ps + li % ps
    return _attend_rows(q, k_pages, v_pages, flat, valid, scale, rows_per_split)


def paged_sparse_attn_mq_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, table: torch.Tensor,
                             idx: torch.Tensor, lengths: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """B8: B3 over the Q query rows of each slot — q (B, Q, H, hd), idx
    (B, Q, K), lengths (B, Q) — the slot's table row shared by its rows.
    Row q is `paged_sparse_attn_ref` of the B slots, as the kernel's rows
    equal B3's. Returns (B, Q, H, hd) f32."""
    return torch.stack([paged_sparse_attn_ref(q[:, j], k_pages, v_pages,
                                              table, idx[:, j], lengths[:, j],
                                              scale=scale)
                        for j in range(q.shape[1])], dim=1)


def sparse_attn_ref(q: torch.Tensor, kcache: torch.Tensor, vcache: torch.Tensor,
                    idx: torch.Tensor, lengths: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """B6: one query token per slot attends over exactly the K selected
    rows idx (B, K) of its own contiguous caches (B, N, KVH, hd). An entry
    counts iff 0 <= idx < min(length, N). Returns (B, H, hd) f32."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    n = kcache.shape[1]
    valid = (idx >= 0) & (idx < lengths[:, None]) & (idx < n)
    # a (B, N) cache is a pool of B pages of N rows: slot b's row i is b*N + i
    base = torch.arange(q.shape[0], device=q.device)[:, None] * n
    flat = base + idx.long().clamp(0, n - 1)
    return _attend_rows(q, kcache, vcache, flat, valid, scale)


def paged_sparse_attn_pg_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, table: torch.Tensor,
                             idx: torch.Tensor, lengths: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """B10: B3 at page granularity. Each distinct touched page is taken
    whole (`distinct_pages`), the selected rows are sliced out of the page
    buffer and put back in Top-K order, so the result is bit-identical to
    `paged_sparse_attn_ref` (the kernel accumulates in page order instead).
    Same masking: an entry counts iff 0 <= idx < length and its page is
    mapped. Returns (B, H, hd) f32."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p, ps = k_pages.shape[:2]
    b, mp = table.shape
    li, _, valid = _paged_entries(idx, table, lengths, p, ps)
    up = distinct_pages(li, page_size=ps, num_logical_pages=mp)     # (B, S)
    s = up.shape[1]
    tpad = torch.cat([table, torch.full((b, 1), -1, dtype=table.dtype,
                                        device=table.device)], dim=1)
    uphys = tpad.long().gather(1, up.long()).clamp(0, p - 1)
    slot = torch.searchsorted(up.long(), li // ps)                 # (B, K)
    # the page buffers (B*S pages) act as the pool the rows are read from
    kbuf = k_pages[uphys].reshape((b * s,) + tuple(k_pages.shape[1:]))
    vbuf = v_pages[uphys].reshape((b * s,) + tuple(v_pages.shape[1:]))
    base = torch.arange(b, device=q.device)[:, None] * s
    flat = (base + slot) * ps + li % ps
    return _attend_rows(q, kbuf, vbuf, flat, valid, scale)


def paged_dense_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, table: torch.Tensor,
                         lengths: torch.Tensor, *, scale: Optional[float] = None,
                         window: Optional[int] = None,
                         rows_per_split: Optional[int] = None) -> torch.Tensor:
    """B4: one query token per slot attends over its whole causal extent
    [0, length) (inside the optional window) straight off the page pools.
    Returns (B, H, hd) f32. `rows_per_split` computes the kernel's split
    form: positions [s*R, (s+1)*R) per split, merged."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p, ps = k_pages.shape[:2]
    b, mp = table.shape
    pos = torch.arange(mp * ps, device=q.device).expand(b, mp * ps)
    phys = table.long().repeat_interleave(ps, dim=1)
    valid = (pos < lengths[:, None]) & (phys >= 0) & (phys < p)
    if window is not None:
        valid &= pos > lengths[:, None] - 1 - window
    flat = phys.clamp(0, p - 1) * ps + pos % ps
    return _attend_rows(q, k_pages, v_pages, flat, valid, scale, rows_per_split)
