"""Guess-Verify-Refine (GVR) exact Top-K — plain PyTorch batched form.

A line-for-line port of the JAX package's `core/gvr.py` (paper §4.2):

  Phase 1 (Guess/stats)   : gather the previous step's Top-K values; their
                            min/mean/max seed a threshold bracket.
  Phase 2 (Guess/secant)  : secant search for T with K <= f(T) <= C, where
                            f(T) = |{i : x_i >= T}|.
  Phase 4 (Refine)        : histogram narrowing, then snap through distinct
                            data values until n_gt(T) < K <= n_ge(T); T is
                            then the exact K-th largest value.
  Extraction              : all x > T* plus the lowest-index ties, emitted in
                            ascending index order.

The data-dependent loops run on the host (`while ... .any()`), so this form
is the reference and the CPU path; on the card the selection runs in the
hand-written kernel behind `repro_torch.kernels.ops.gvr_topk`. On the meta
device (the dry run, `launch.dryrun`) no value can be tested: each loop
runs to its iteration cap and the fallback is taken (`loop_on`,
`branch_on`), here and in `sp_gvr`.

Exactness is unconditional: if the phase budgets run out, the row falls back
to a direct exact selection and is flagged (the paper's `done=2` net).
Tie policy: lowest index first.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .temporal import linspace_i32

# Finite sentinel for masked-out (beyond-length) elements: -FLT_MAX keeps
# the secant/bisection arithmetic finite.
NEG_SENTINEL = -3.4028234663852886e38
FMAX = 3.4028234663852886e38


def loop_on(cond: torch.Tensor, done_iters: int, cap: int) -> bool:
    """A data-dependent loop's test, on the host once per iteration:
    whether any row of `cond` holds. On the meta device there is no value
    to test, and the loop runs `cap` iterations, as the JAX package's dry
    run bills a while body at its iteration cap."""
    if cond.is_meta:
        return done_iters < cap
    return bool(cond.any())


def branch_on(cond: torch.Tensor) -> bool:
    """A data-dependent branch's test (any row of `cond`); taken on the
    meta device."""
    return cond.is_meta or bool(cond.any())


DEFAULT_K = 2048
DEFAULT_CAND_FACTOR = 3
DEFAULT_MAX_SECANT = 12
DEFAULT_MAX_SNAP = 32


class GVRStats(NamedTuple):
    """Per-row phase statistics (shapes (B,))."""
    secant_iters: torch.Tensor   # int32
    hist_levels: torch.Tensor    # int32
    snap_iters: torch.Tensor     # int32
    threshold: torch.Tensor      # float32 — exact K-th largest value T*
    n_gt: torch.Tensor           # int32 — |{x > T*}|  (< K)
    n_ge: torch.Tensor           # int32 — |{x >= T*}| (>= K)
    cand_count: torch.Tensor     # int32 — f(T) at phase-2 exit
    fallback: torch.Tensor       # bool  — safety-net path taken
    t0: torch.Tensor             # float32 — initial guess (pmean)


class GVRResult(NamedTuple):
    values: torch.Tensor         # (B, K) float32
    indices: torch.Tensor        # (B, K) int32
    stats: GVRStats


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v, dtype=torch.float32)


def masked(scores: torch.Tensor, lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Scores beyond each row's length become the NEG sentinel."""
    if lengths is None:
        return scores
    n = scores.shape[-1]
    pos = torch.arange(n, device=scores.device)
    return torch.where(pos[None, :] < lengths[:, None], scores,
                       torch.tensor(NEG_SENTINEL, dtype=scores.dtype,
                                    device=scores.device))


def _fused_pass(x: torch.Tensor, t: torch.Tensor):
    """One row sweep: (n_ge, n_gt, snap_up, snap_down)."""
    tb = t[:, None]
    ge = x >= tb
    gt = x > tb
    n_ge = ge.sum(-1, dtype=torch.int32)
    n_gt = gt.sum(-1, dtype=torch.int32)
    big = torch.tensor(FMAX, dtype=torch.float32, device=x.device)
    snap_up = torch.where(gt, x, big).amin(-1)
    snap_dn = torch.where(~ge, x, -big).amax(-1)
    return n_ge, n_gt, snap_up, snap_dn


def take_predictions(x: torch.Tensor, prev_idx: torch.Tensor) -> torch.Tensor:
    """`jnp.take_along_axis` semantics: indices in [-N, 0) wrap (a recycled
    slot's -1 reads the last element), indices outside [-N, N) read NaN."""
    n = x.shape[-1]
    pi = prev_idx.long()
    wrapped = torch.where(pi < 0, pi + n, pi)
    oob = (wrapped < 0) | (wrapped >= n)
    pv = x.gather(-1, wrapped.clamp(0, n - 1))
    return torch.where(oob, torch.full_like(pv, float("nan")), pv)


def _phase1_stats(x: torch.Tensor, prev_idx: torch.Tensor):
    pv = take_predictions(x, prev_idx)
    return pv.amin(-1), pv.amax(-1), pv.mean(-1)


def _phase2_secant(x, t0, p_lo, p_hi, k, cmax, f_target, max_iters, m):
    """Secant threshold search (paper §4.2.2) — see the JAX form for the
    bracket-rescue and anchor-probe rationale; the arithmetic is identical."""
    b, n = x.shape
    dev = x.device
    ftarget = torch.tensor(float(f_target), dtype=torch.float32, device=dev)
    half = torch.tensor(0.5, dtype=torch.float32, device=dev)
    t_lo = p_lo
    c_lo = torch.full((b,), float(min(n, max(1.25 * m, k))), dtype=torch.float32,
                      device=dev)
    t_hi = torch.maximum(p_hi, p_lo)
    c_hi = torch.ones((b,), dtype=torch.float32, device=dev)
    t = torch.minimum(torch.maximum(t0, p_lo), p_hi)
    t_probe = t.clone()
    cnt = torch.zeros((b,), dtype=torch.int32, device=dev)
    row_min = torch.full((b,), FMAX, dtype=torch.float32, device=dev)
    row_max = torch.full((b,), -FMAX, dtype=torch.float32, device=dev)
    hi_probed = torch.zeros((b,), dtype=torch.bool, device=dev)
    prev_over = torch.zeros((b,), dtype=torch.bool, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = torch.zeros((b,), dtype=torch.int32, device=dev)

    rounds = 0
    while loop_on(~done & (it < max_iters), rounds, max_iters):
        rounds += 1
        active = ~done & (it < max_iters)
        n_ge, _, _, _ = _fused_pass(x, t)
        row_max = torch.maximum(row_max, x.amax(-1))
        row_min = torch.minimum(row_min, x.amin(-1))
        in_window = (n_ge >= k) & (n_ge <= cmax)
        done = done | (active & in_window)

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
        c_lo = torch.where(rescue_lo, _f32(float(n), c_lo), c_lo)
        rescued = rescue_hi | rescue_lo
        t_new = torch.where(rescued, half * (t_lo + t_hi), t_new)
        collapsed = collapsed & ~rescued

        t_new = torch.where(collapsed, t_lo, t_new)
        done = done | (active & collapsed)

        t_probe = torch.where(active, t, t_probe)
        t = torch.where(active & ~done, t_new, t)
        cnt = torch.where(active, n_ge, cnt)
        hi_probed = torch.where(rescue_hi, torch.zeros_like(hi_probed),
                                hi_probed | probe_hi)
        prev_over = torch.where(active, too_many, prev_over)
        it = torch.where(active, it + 1, it)

    t_exit = torch.where(cnt >= k, t_probe, t_lo)
    return t_exit, cnt, it


def _phase4_histogram(x, t_init, k, nbins, max_levels):
    """Histogram narrowing to the K-th bin (paper Fig. 7). Invariant:
    n_ge(lo) >= k."""
    b, n = x.shape
    dev = x.device
    row_min = x.amin(-1)
    row_max = x.amax(-1)
    n_ge0 = (x >= t_init[:, None]).sum(-1, dtype=torch.int32)
    lo = torch.where(n_ge0 >= k, t_init, row_min)
    hi = row_max
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = torch.zeros((b,), dtype=torch.int32, device=dev)
    one = torch.tensor(1.0, dtype=torch.float32, device=dev)

    rounds = 0
    while loop_on(~done & (it < max_levels), rounds, max_levels):
        rounds += 1
        active = ~done & (it < max_levels)
        width = (hi - lo) / nbins
        degenerate = ~(width > 0) | ~torch.isfinite(width)
        safe_w = torch.where(degenerate, one, width)
        mask = x >= lo[:, None]
        # bins of masked-out entries are never counted; clamping before the
        # cast keeps their (possibly infinite) quotient well defined
        q = ((x - lo[:, None]) / safe_w[:, None]).clamp(0, nbins - 1)
        bin_idx = torch.where(mask, q, torch.zeros_like(q)).long()
        hist = torch.zeros((b, nbins), dtype=torch.int32, device=dev)
        hist.scatter_add_(1, bin_idx, mask.int())
        ctop = hist.flip(-1).cumsum(-1).flip(-1)
        jstar = ((ctop >= k).sum(-1) - 1).clamp(min=0)
        new_lo = lo + jstar.float() * width
        new_hi = torch.minimum(hi, lo + (jstar + 1).float() * width)
        in_bin = hist.gather(1, jstar[:, None])[:, 0]
        done_now = degenerate | (in_bin <= 8) | (new_hi <= new_lo)
        lo = torch.where(active & ~degenerate, new_lo, lo)
        hi = torch.where(active & ~degenerate, new_hi, hi)
        done = done | (active & done_now)
        it = torch.where(active, it + 1, it)
    return lo, it


def _phase4_snap(x, t_init, k, max_iters):
    """Snap to the exact K-th value: n_gt(T) < K <= n_ge(T)."""
    b = x.shape[0]
    dev = x.device
    t = t_init
    n_ge = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_gt = torch.zeros((b,), dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    it = torch.zeros((b,), dtype=torch.int32, device=dev)
    rounds = 0
    while loop_on(~done & (it < max_iters), rounds, max_iters):
        rounds += 1
        active = ~done & (it < max_iters)
        ge, gt, up, dn = _fused_pass(x, t)
        converged = (gt < k) & (ge >= k)
        t_next = torch.where(gt >= k, up, torch.where(ge < k, dn, t))
        t = torch.where(active & ~converged, t_next, t)
        n_ge = torch.where(active, ge, n_ge)
        n_gt = torch.where(active, gt, n_gt)
        done = done | (active & converged)
        it = torch.where(active & ~converged, it + 1, it)
    return t, n_gt, n_ge, it, done


def gvr_threshold(scores: torch.Tensor, prev_idx: torch.Tensor,
                  k: int = DEFAULT_K, *, lengths: Optional[torch.Tensor] = None,
                  max_candidates: Optional[int] = None,
                  max_secant_iters: int = DEFAULT_MAX_SECANT,
                  max_snap_iters: int = DEFAULT_MAX_SNAP,
                  f_target: Optional[int] = None,
                  hist_bins: int = 2048,
                  max_hist_levels: int = 10) -> GVRStats:
    """Phases 1+2+4: the exact K-th-largest threshold (plus n_gt/n_ge)."""
    squeeze = scores.dim() == 1
    if squeeze:
        scores, prev_idx = scores[None], prev_idx[None]
        if lengths is not None:
            lengths = lengths[None]
    x = masked(scores.float(), lengths)
    b, n = x.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    cmax = max_candidates if max_candidates is not None else min(DEFAULT_CAND_FACTOR * k, n)
    cmax = max(cmax, k)
    ft = f_target if f_target is not None else (k + cmax) // 2

    p_lo, p_hi, t0 = _phase1_stats(x, prev_idx)
    if prev_idx.shape[-1] < k:
        # prediction set smaller than K: widen the bracket to the row extrema
        p_lo = torch.minimum(p_lo, x.amin(-1))
        p_hi = torch.maximum(p_hi, x.amax(-1))

    t_exit, cand_count, secant_iters = _phase2_secant(
        x, t0, p_lo, p_hi, k, cmax, ft, max_secant_iters, prev_idx.shape[-1])
    t_hist, hist_levels = _phase4_histogram(x, t_exit, k, hist_bins,
                                            max_hist_levels)
    t_star, n_gt, n_ge, snap_iters, snap_done = _phase4_snap(
        x, t_hist, k, max_snap_iters)

    fallback = ~snap_done
    if branch_on(fallback):
        kth = torch.topk(x, k, dim=-1).values[:, -1]
        t2 = torch.where(fallback, kth, t_star)
        ge2, gt2, _, _ = _fused_pass(x, t2)
        t_star = t2
        n_gt = torch.where(fallback, gt2, n_gt)
        n_ge = torch.where(fallback, ge2, n_ge)

    stats = GVRStats(secant_iters=secant_iters, hist_levels=hist_levels,
                     snap_iters=snap_iters, threshold=t_star, n_gt=n_gt,
                     n_ge=n_ge, cand_count=cand_count, fallback=fallback, t0=t0)
    if squeeze:
        stats = GVRStats(*[s[0] for s in stats])
    return stats


def extract_topk(scores: torch.Tensor, t_star: torch.Tensor, k: int,
                 *, lengths: Optional[torch.Tensor] = None):
    """Exact Top-K set from the exact threshold: all x > T* plus the
    lowest-index ties x == T*, in ascending index order (mask → prefix
    sum → scatter compaction)."""
    x = masked(scores.float(), lengths)
    b, n = x.shape
    tb = t_star[..., None]
    gt = x > tb
    eq = x == tb
    eq_rank = eq.long().cumsum(-1)
    n_gt = gt.sum(-1)
    quota = (k - n_gt).clamp(min=0)[:, None]
    sel = gt | (eq & (eq_rank <= quota))
    pos = sel.long().cumsum(-1) - 1
    slot = torch.where(sel & (pos < k), pos, torch.full_like(pos, k))
    col = torch.arange(n, device=x.device).expand(b, n)
    idx = torch.zeros((b, k + 1), dtype=torch.long, device=x.device)
    idx.scatter_(1, slot, col)
    idx = idx[:, :k]
    return x.gather(1, idx), idx.int()


def gvr_topk(scores: torch.Tensor, prev_idx: torch.Tensor, k: int = DEFAULT_K,
             *, lengths: Optional[torch.Tensor] = None,
             max_candidates: Optional[int] = None,
             max_secant_iters: int = DEFAULT_MAX_SECANT,
             max_snap_iters: int = DEFAULT_MAX_SNAP,
             f_target: Optional[int] = None) -> GVRResult:
    """Full GVR exact Top-K. scores: (B, N) or (N,); prev_idx: (B, M) or (M,)."""
    squeeze = scores.dim() == 1
    sb = scores[None] if squeeze else scores
    pb = prev_idx[None] if squeeze else prev_idx
    lb = lengths if (lengths is None or not squeeze) else lengths[None]
    stats = gvr_threshold(sb, pb, k, lengths=lb, max_candidates=max_candidates,
                          max_secant_iters=max_secant_iters,
                          max_snap_iters=max_snap_iters, f_target=f_target)
    vals, idx = extract_topk(sb, stats.threshold, k, lengths=lb)
    if squeeze:
        return GVRResult(vals[0], idx[0], GVRStats(*[s[0] for s in stats]))
    return GVRResult(vals, idx, stats)


def uniform_pre_idx(n: int, m: int = DEFAULT_K, batch: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Evenly spaced predictions, `jnp.linspace(0, n - 1, m)` to the bit:
    the 'no temporal signal' warm start (paper Table 9 row (b)). (M,)
    int32, or (batch, M)."""
    idx = linspace_i32(n - 1, m, device)
    return idx if batch is None else idx[None].expand(batch, m).clone()


def global_passes(stats: GVRStats) -> torch.Tensor:
    """Modeled full-row global-memory passes: I + 1 (paper Table 1; the +1
    is the collect pass). Snap passes touch only the candidate buffer."""
    return stats.secant_iters + 1
