"""Plain PyTorch versions of the port's kernels B1–B4.

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


def paged_indexer_scores_ref(q: torch.Tensor, k_pages: torch.Tensor,
                             w: torch.Tensor, table: torch.Tensor,
                             lengths: torch.Tensor) -> torch.Tensor:
    """B2 scoring stage, paper Eq. 1 over page-addressed indexer keys:
    score[b, n] = sum_h w_h ReLU(q[b,h] . k[n]) in f32, NEG at positions
    >= length and on unmapped (-1) pages.

    q: (B, H, D) in the cache dtype; k_pages: (P, ps, D); w: (H,) f32;
    table: (B, MP) int32; lengths: (B,). Returns (B, MP*ps) f32.
    """
    b, mp = table.shape
    p, ps, d = k_pages.shape
    view = k_pages[table.long().clamp(0, p - 1)].reshape(b, mp * ps, d)
    s = torch.einsum("bhd,bnd->bhn", q.float(), view.float()).clamp_min(0.0)
    scores = torch.einsum("h,bhn->bn", w.float(), s)
    pos = torch.arange(mp * ps, device=q.device)
    mapped = (table >= 0).repeat_interleave(ps, dim=1)
    keep = (pos[None, :] < lengths[:, None]) & mapped
    return torch.where(keep, scores, torch.full_like(scores, NEG))


def _attend_rows(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 flat: torch.Tensor, valid: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """Softmax attention of q (B, H, hd) over the rows `flat` (B, R) of the
    flattened pools where `valid`; f32 throughout, 0 for a slot with no
    valid row."""
    b, h, hd = q.shape
    p, ps, kvh = k_pages.shape[:3]
    g = h // kvh
    kg = k_pages.reshape(p * ps, kvh, hd)[flat].float()     # (B, R, KVH, hd)
    vg = v_pages.reshape(p * ps, kvh, hd)[flat].float()
    logits = torch.einsum("bkgd,brkd->bkgr", q.float().reshape(b, kvh, g, hd),
                          kg) * scale
    mask = valid[:, None, None, :]
    m = torch.where(mask, logits, torch.full_like(logits, -torch.inf)).amax(-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pr = torch.where(mask, torch.exp(logits - m[..., None]),
                     torch.zeros_like(logits))
    l = pr.sum(-1).clamp_min(1e-30)
    out = torch.einsum("bkgr,brkd->bkgd", pr, vg) / l[..., None]
    return out.reshape(b, h, hd)


def paged_sparse_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          idx: torch.Tensor, lengths: torch.Tensor, *,
                          scale: Optional[float] = None) -> torch.Tensor:
    """B3: one query token per slot attends over exactly the K selected
    logical rows idx (B, K), each read from page table[b, idx // ps] at
    offset idx % ps. An entry counts iff 0 <= idx < length and its page is
    mapped. Returns (B, H, hd) f32."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    p, ps = k_pages.shape[:2]
    mp = table.shape[1]
    li = idx.long().clamp(0, mp * ps - 1)
    phys = table.long().gather(1, li // ps)
    valid = ((idx >= 0) & (idx < lengths[:, None]) & (idx < mp * ps)
             & (phys >= 0) & (phys < p))
    flat = phys.clamp(0, p - 1) * ps + li % ps
    return _attend_rows(q, k_pages, v_pages, flat, valid, scale)


def paged_dense_attn_ref(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, table: torch.Tensor,
                         lengths: torch.Tensor, *, scale: Optional[float] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """B4: one query token per slot attends over its whole causal extent
    [0, length) (inside the optional window) straight off the page pools.
    Returns (B, H, hd) f32."""
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
    return _attend_rows(q, k_pages, v_pages, flat, valid, scale)
