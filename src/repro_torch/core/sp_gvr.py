"""SP-GVR: sequence-parallel Guess-Verify-Refine exact Top-K, PyTorch port.

A score row sharded over S ranks (each holding a contiguous slice) gets its
exact global Top-K without ever being gathered: GVR's threshold search is
the part of Top-K that distributes with O(1)-sized collectives.

  Phase 1   : local statistics over the shard-resident predictions →
              one exchange of scalars (sum, count, min, max).
  Phase 2   : each secant iteration = local count + one scalar psum; the
              iteration count, and with it the collective schedule's
              length, follows the temporal correlation.
  Phase 4a/b: histogram narrowing = one psum of `hist_bins` int32 lanes.
  Phase 4d  : each snap iteration = one exchange of the counts and the
              snap candidates.
  Extract   : local. Each rank keeps the selected indices in its own
              shard, ties by a shard-ordered quota (one exchange of the
              counts above and at the threshold).

The threshold state is replicated: every rank computes it from the same
collective results, so every rank takes the same branch of every
data-dependent loop (which is what keeps the ranks' collective sequences
aligned). The result is the unique exact Top-K with the lowest global
indices among ties, as the single-device selector's. The loops test their
conditions on the host, once per iteration, as `core.gvr` does; on the
meta device (the dry run) each loop runs to its cap and the fallback
gather is taken (`gvr.loop_on`, `gvr.branch_on`), so the dry run bills
the collectives of every round a row may take.

`sp_gvr_topk_local` runs on each rank over its slice; `sp_canonical_topk`
turns the per-rank winners into the replicated ascending buffer of the
single-device selector; `sp_gvr_topk` takes a full row on every rank and
returns the reference wrapper's compacted outputs (tests).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.parallel.sharding import SeqGroup

from .gvr import (DEFAULT_MAX_SECANT, DEFAULT_MAX_SNAP, FMAX, branch_on,
                  loop_on)


class SPGVRResult(NamedTuple):
    local_indices: torch.Tensor  # (B, K) int32 — GLOBAL indices owned by
                                 # this shard, -1 past local_count
    local_count: torch.Tensor    # (B,) int32 — valid entries per row
    threshold: torch.Tensor      # (B,) float32 — exact global K-th value
    n_gt: torch.Tensor           # (B,) int32 — global count > threshold
    secant_iters: torch.Tensor   # (B,) int32
    snap_iters: torch.Tensor     # (B,) int32
    hist_levels: torch.Tensor    # (B,) int32


def _f(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full(like.shape, v, dtype=torch.float32, device=like.device)


def _exchange(mesh: SeqGroup, ints, floats, tag: str):
    """Every rank's (B,) int32 and float32 vectors in ONE all-gather (the
    floats travel as their bit patterns): (ints (S, n_i, B), floats
    (S, n_f, B)). The callers reduce them on every rank — sums in rank
    order, maxima — so one collective serves what would be several
    psum/pmax calls, with the same result on every rank."""
    packed = torch.stack([v.int() for v in ints]
                         + [v.float().view(torch.int32) for v in floats])
    every = mesh.all_gather(packed, dim=0, tiled=False, tag=tag)
    return every[:, :len(ints)], every[:, len(ints):].view(torch.float32)


def _rank_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """parts (S, ...) summed in rank order (the float psum's order)."""
    out = parts[0]
    for i in range(1, parts.shape[0]):
        out = out + parts[i]
    return out


def sp_gvr_topk_local(scores_local: torch.Tensor, prev_idx: torch.Tensor,
                      k: int, mesh: SeqGroup, *,
                      max_candidates: Optional[int] = None,
                      max_secant_iters: int = DEFAULT_MAX_SECANT,
                      max_snap_iters: int = DEFAULT_MAX_SNAP,
                      hist_bins: int = 2048,
                      max_hist_levels: int = 10,
                      f_target: Optional[int] = None) -> SPGVRResult:
    """Exact distributed Top-K of a score row sharded over `mesh`.

    scores_local: (B, N_local) — this rank's contiguous shard (rank r holds
    [r·N_local, (r+1)·N_local)). prev_idx: (B, M) int — GLOBAL indices,
    the same on every rank."""
    b, n_local = scores_local.shape
    x = scores_local.float()
    dev = x.device
    d, my = mesh.size, mesh.rank
    n = n_local * d
    offset = my * n_local
    cmax = max_candidates if max_candidates is not None else min(3 * k, n)
    cmax = max(cmax, k)
    ftarget = torch.tensor(float(f_target if f_target is not None
                                 else (k + cmax) // 2), device=dev)
    half = torch.tensor(0.5, device=dev)
    m = prev_idx.shape[-1]

    # ---- Phase 1: distributed pre-indexed statistics (one exchange) ----
    rel = prev_idx.long() - offset
    in_shard = (rel >= 0) & (rel < n_local)
    pv = x.gather(-1, rel.clamp(0, n_local - 1))
    ints, floats = _exchange(
        mesh, [in_shard.sum(-1, dtype=torch.int32)],
        [torch.where(in_shard, pv, 0.0).sum(-1),
         torch.where(in_shard, -pv, -FMAX).amax(-1),
         torch.where(in_shard, pv, -FMAX).amax(-1),
         (-x).amax(-1), x.amax(-1)], "phase1")
    psum_v = _rank_order_sum(floats[:, 0])
    pcnt = ints[:, 0].sum(0).float()
    ext = floats[:, 1:].amax(0)
    p_lo, p_hi, row_min, row_max = -ext[0], ext[1], -ext[2], ext[3]
    t0 = psum_v / torch.clamp(pcnt, min=1.0)
    if m < k:
        p_lo, p_hi = torch.minimum(p_lo, row_min), torch.maximum(p_hi, row_max)

    def gcount(t: torch.Tensor, tag: str) -> torch.Tensor:
        """Distributed f(T): local count + one scalar psum."""
        return mesh.psum((x >= t[:, None]).sum(-1, dtype=torch.int32), tag)

    # ---- Phase 2: secant with scalar-collective counts ----------------
    t_lo = p_lo
    c_lo = _f(float(min(n, max(1.25 * m, k))), t_lo)
    t_hi = torch.maximum(p_hi, p_lo)
    c_hi = _f(1.0, t_lo)
    t = torch.minimum(torch.maximum(t0, p_lo), p_hi)
    t_probe = t.clone()
    cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
    hi_probed = torch.zeros((b,), dtype=torch.bool, device=dev)
    prev_over = torch.zeros_like(hi_probed)
    done = torch.zeros_like(hi_probed)
    it = torch.zeros_like(cnt)
    rounds = 0
    while loop_on(~done & (it < max_secant_iters), rounds, max_secant_iters):
        rounds += 1
        active = ~done & (it < max_secant_iters)
        n_ge = gcount(t, "secant")
        in_window = (n_ge >= k) & (n_ge <= cmax)
        done_n = done | (active & in_window)
        too_many = active & (n_ge > cmax)
        too_few = active & (n_ge < k)
        t_lo = torch.where(too_many, t, t_lo)
        c_lo = torch.where(too_many, n_ge.float(), c_lo)
        t_hi = torch.where(too_few, t, t_hi)
        c_hi = torch.where(too_few, n_ge.float(), c_hi)
        denom = c_lo - c_hi
        frac = torch.where(denom.abs() > 0, (c_lo - ftarget) / denom, half)
        frac = torch.where(it == 0, torch.minimum(frac, half), frac)
        t_new = t_lo + frac * (t_hi - t_lo)
        inside = (t_new > t_lo) & (t_new < t_hi) & torch.isfinite(t_new)
        t_new = torch.where(inside, t_new, half * (t_lo + t_hi))
        probe_lo = (frac <= 0) & (t_lo != t)
        t_new = torch.where(probe_lo, t_lo, t_new)
        probe_hi = too_many & prev_over & ~hi_probed & (t_hi != t)
        t_new = torch.where(probe_hi, t_hi, t_new)
        collapsed = ~((t_new > t_lo) & (t_new < t_hi)) & ~probe_lo & ~probe_hi
        rescue_hi = collapsed & too_many & (row_max > t_hi)
        t_hi = torch.where(rescue_hi, row_max, t_hi)
        c_hi = torch.where(rescue_hi, torch.ones_like(c_hi), c_hi)
        rescue_lo = collapsed & too_few & (row_min < t_lo)
        t_lo = torch.where(rescue_lo, row_min, t_lo)
        c_lo = torch.where(rescue_lo, torch.full_like(c_lo, float(n)), c_lo)
        rescued = rescue_hi | rescue_lo
        t_new = torch.where(rescued, half * (t_lo + t_hi), t_new)
        collapsed = collapsed & ~rescued
        t_new = torch.where(collapsed, t_lo, t_new)
        done_n = done_n | (active & collapsed)
        t_probe = torch.where(active, t, t_probe)
        t = torch.where(active & ~done_n, t_new, t)
        cnt = torch.where(active, n_ge, cnt)
        hi_probed = torch.where(rescue_hi, torch.zeros_like(hi_probed),
                                hi_probed | probe_hi)
        prev_over = torch.where(active, too_many, prev_over)
        done = done_n
        it = torch.where(active, it + 1, it)
    secant_iters = it
    t_exit = torch.where(cnt >= k, t_probe, t_lo)

    # ---- Phase 4a/b: distributed histogram narrowing ------------------
    n_ge0 = gcount(t_exit, "hist0")
    lo = torch.where(n_ge0 >= k, t_exit, row_min)
    hi = row_max
    done = torch.zeros_like(hi_probed)
    it = torch.zeros_like(cnt)
    one = torch.tensor(1.0, device=dev)
    rounds = 0
    while loop_on(~done & (it < max_hist_levels), rounds, max_hist_levels):
        rounds += 1
        active = ~done & (it < max_hist_levels)
        width = (hi - lo) / hist_bins
        degenerate = ~(width > 0) | ~torch.isfinite(width)
        safe_w = torch.where(degenerate, one, width)
        mask = x >= lo[:, None]
        # the quotient is clamped before the cast, as the reference's
        # saturating cast then clip leaves it
        q = ((x - lo[:, None]) / safe_w[:, None]).clamp(0, hist_bins - 1)
        bin_idx = torch.where(mask, q, torch.zeros_like(q)).long()
        hist_local = torch.zeros((b, hist_bins), dtype=torch.int32, device=dev)
        hist_local.scatter_add_(1, bin_idx, mask.int())
        hist = mesh.psum(hist_local, "hist")
        ctop = hist.flip(-1).cumsum(-1).flip(-1)
        jstar = ((ctop >= k).int().sum(-1) - 1).clamp(min=0)
        new_lo = lo + jstar.float() * width
        new_hi = torch.minimum(hi, lo + (jstar + 1).float() * width)
        in_bin = hist.gather(1, jstar.long()[:, None])[:, 0]
        done_now = degenerate | (in_bin <= 8) | (new_hi <= new_lo)
        lo = torch.where(active & ~degenerate, new_lo, lo)
        hi = torch.where(active & ~degenerate, new_hi, hi)
        done = done | (active & done_now)
        it = torch.where(active, it + 1, it)
    hist_levels = it

    # ---- Phase 4d: distributed snap ------------------------------------
    t = lo
    done = torch.zeros_like(hi_probed)
    it = torch.zeros_like(cnt)
    rounds = 0
    while loop_on(~done & (it < max_snap_iters), rounds, max_snap_iters):
        rounds += 1
        active = ~done & (it < max_snap_iters)
        tb = t[:, None]
        ge, gt = x >= tb, x > tb
        ints, floats = _exchange(
            mesh, [ge.sum(-1, dtype=torch.int32), gt.sum(-1, dtype=torch.int32)],
            [-torch.where(gt, x, FMAX).amin(-1),
             torch.where(~ge, x, -FMAX).amax(-1)], "snap")
        n_ge, n_gt = ints.sum(0).int()
        snaps = floats.amax(0)
        snap_up, snap_dn = -snaps[0], snaps[1]
        converged = (n_gt < k) & (n_ge >= k)
        t_next = torch.where(n_gt >= k, snap_up,
                             torch.where(n_ge < k, snap_dn, t))
        t = torch.where(active & ~converged, t_next, t)
        done = done | (active & converged)
        it = torch.where(active & ~converged, it + 1, it)
    snap_iters = it
    # safety net: the exact K-th value from the gathered per-rank Top-Ks
    # (k floats a rank; rare, and every rank takes it together)
    fb = ~done
    kk = min(k, n_local)
    if branch_on(fb):
        loc_top = torch.topk(x, kk, dim=-1).values
        all_top = mesh.all_gather(loc_top, dim=1, tiled=True, tag="fallback")
        kth = torch.topk(all_top, k, dim=-1).values[:, -1]
        t = torch.where(fb, kth, t)
    tb = t[:, None]
    gt = x > tb
    eq = x == tb

    # ---- Extraction: local, shard-ordered tie quota ---------------------
    my_gt = gt.sum(-1, dtype=torch.int32)
    my_eq = eq.sum(-1, dtype=torch.int32)
    ints, _ = _exchange(mesh, [my_gt, my_eq], [], "extract")
    n_gt = ints[:, 0].sum(0).int()
    eq_all = ints[:, 1]                                         # (D, B)
    my_eq_prefix = (eq_all.cumsum(0) - eq_all)[my]
    tie_budget = (k - n_gt).clamp(min=0)
    my_quota = torch.minimum((tie_budget - my_eq_prefix).clamp(min=0), my_eq)
    my_count = (my_gt + my_quota).int()
    # rank key: every x > T first, then the ties, lowest index first
    key = gt.int() * 2 + eq.int()
    lidx = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :kk]
    take = torch.arange(kk, device=dev)[None, :] < my_count[:, None]
    gidx = torch.where(take, lidx + offset, -1).int()
    if kk < k:                         # pad to the fixed (B, K) contract
        gidx = torch.nn.functional.pad(gidx, (0, k - kk), value=-1)
    return SPGVRResult(local_indices=gidx, local_count=my_count, threshold=t,
                       n_gt=n_gt, secant_iters=secant_iters,
                       snap_iters=snap_iters, hist_levels=hist_levels)


def sp_canonical_topk(local_indices: torch.Tensor, k: int, n: int,
                      mesh: SeqGroup) -> torch.Tensor:
    """The replicated global Top-K buffer from the per-rank results, in
    the single-device canonical order (ascending global index, the order
    `core.gvr.extract_topk` emits): one K-int all-gather, O(1) in the
    context length. `local_indices` is `SPGVRResult.local_indices`."""
    all_idx = mesh.all_gather(local_indices.int(), dim=1, tiled=True,
                              tag="canonical")                  # (B, D*K)
    # -1 pads sort past every valid index (valid < n); exactly K survive
    keyed = torch.where(all_idx < 0, n, all_idx)
    return torch.sort(keyed, dim=-1).values[:, :k].int()


def sp_gvr_topk(scores: torch.Tensor, prev_idx: torch.Tensor, k: int,
                mesh: SeqGroup, **kw):
    """The full row on every rank: rank r runs SP-GVR over its slice
    [r·N/S, (r+1)·N/S), and the per-rank index buffers are gathered and
    compacted shard by shard into the exact global Top-K (the order the
    reference's wrapper returns: each shard's entries above the threshold
    first, then its ties). Returns (indices (B, K), threshold (B,),
    secant_iters (B,)), the same on every rank."""
    b, n = scores.shape
    if n % mesh.size:
        raise ValueError(f"a row of {n} positions does not split over "
                         f"{mesh.size} ranks")
    nl = n // mesh.size
    part = scores[:, mesh.rank * nl:(mesh.rank + 1) * nl]
    r = sp_gvr_topk_local(part, prev_idx, k, mesh, **kw)
    idx_sh = mesh.all_gather(r.local_indices, dim=0, tiled=False,
                             tag="wrapper")                     # (D, B, K)
    flat = idx_sh.permute(1, 0, 2).reshape(b, -1)
    order = torch.sort((flat < 0).int(), dim=-1, stable=True).indices
    return flat.gather(1, order)[:, :k], r.threshold, r.secant_iters
