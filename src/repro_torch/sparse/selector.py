"""Pluggable Top-K selector with the paper's dispatch semantics (§5.5).

The GVR path takes priority when a prediction (preIdx) is available and
the `canUseHeuristic` gate passes (N <= gate_max_n); otherwise radix-select
handles the request, and rows too short for selection take the exact path:

    gvr   (prediction available, n <= gate_max_n)
    radix (no prediction, or n beyond the gate)
    exact (n <= min_n_for_selection)

`prev_valid` (B,) carries the row-level `canUseHeuristic` signal of a
continuous-batching pool: under `method="auto"` warm rows are served by
GVR and cold rows by radix ("mixed"). Both paths are exact with the same
lowest-index tie policy and ascending-index output order, so outputs are
row-for-row identical either way; `gvr_rows` reports which rows the GVR
path served, which the serving engine logs per tick.

Every index this module consumes or produces lives in logical token space
(position within the request's own context), never a physical page id.

This is the plain form over a materialized (B, N) score row. The served
paged step selects through `sparse.dsa.dsa_select_paged`, which routes the
GVR methods through the fused scoring + selection kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.gvr import extract_topk, gvr_threshold, masked
from repro_torch.core.topk_baselines import exact_topk, radix_select_topk


class SelectorOutput(NamedTuple):
    indices: torch.Tensor                   # (B, K) int32
    values: torch.Tensor                    # (B, K) f32
    method: str                             # resolved method
    secant_iters: Optional[torch.Tensor] = None
    gvr_rows: Optional[torch.Tensor] = None  # (B,) bool — rows GVR served


def resolve_method(method: str, n: int, *, has_prev: bool, has_valid: bool,
                   gate_max_n: int, min_n_for_selection: int) -> str:
    """The `auto` gate, resolved from shapes and availability alone."""
    if method != "auto":
        return method
    if n <= min_n_for_selection:
        return "exact"
    if has_prev and n <= gate_max_n:
        return "mixed" if has_valid else "gvr"
    return "radix"


def select_topk(scores: torch.Tensor, k: int, *,
                prev_idx: Optional[torch.Tensor] = None,
                prev_valid: Optional[torch.Tensor] = None,
                method: str = "auto",
                lengths: Optional[torch.Tensor] = None,
                max_candidates: Optional[int] = None,
                gate_max_n: int = 200_000,
                min_n_for_selection: int = 4096) -> SelectorOutput:
    """Exact Top-K with the paper's dispatch policy. scores: (B, N)."""
    n = scores.shape[-1]
    b = scores.shape[0]
    dev = scores.device
    method = resolve_method(method, n, has_prev=prev_idx is not None,
                            has_valid=prev_valid is not None,
                            gate_max_n=gate_max_n,
                            min_n_for_selection=min_n_for_selection)
    if method in ("gvr", "mixed") and prev_idx is None:
        raise ValueError(f"selector method {method!r} needs a prediction "
                         f"signal (prev_idx)")
    if method == "gvr":
        stats = gvr_threshold(scores, prev_idx, k, lengths=lengths,
                              max_candidates=max_candidates)
        vals, idx = extract_topk(scores, stats.threshold, k, lengths=lengths)
        return SelectorOutput(idx, vals, "gvr", stats.secant_iters,
                              torch.ones((b,), dtype=torch.bool, device=dev))
    if method == "mixed":
        if prev_valid is None:
            raise ValueError("mixed dispatch needs prev_valid")
        warm = prev_valid.bool()
        stats = gvr_threshold(scores, prev_idx, k, lengths=lengths,
                              max_candidates=max_candidates)
        g_vals, g_idx = extract_topk(scores, stats.threshold, k,
                                     lengths=lengths)
        r_vals, r_idx, st = radix_select_topk(masked(scores, lengths), k)
        idx = torch.where(warm[:, None], g_idx, r_idx)
        vals = torch.where(warm[:, None], g_vals, r_vals)
        iters = torch.where(warm, stats.secant_iters, st.passes)
        return SelectorOutput(idx, vals, "mixed", iters, warm)
    if method == "radix":
        vals, idx, st = radix_select_topk(masked(scores, lengths), k)
        return SelectorOutput(idx, vals, "radix", st.passes,
                              torch.zeros((b,), dtype=torch.bool, device=dev))
    if method == "exact":
        vals, idx = exact_topk(masked(scores, lengths), k)
        # canonical ascending-index order, like the extraction-based paths:
        # downstream attention then sums gathered rows in the same order
        # whichever path served a row
        order = torch.sort(idx, dim=-1).indices
        return SelectorOutput(idx.gather(-1, order), vals.gather(-1, order),
                              "exact", None,
                              torch.zeros((b,), dtype=torch.bool, device=dev))
    raise ValueError(f"unknown selector method {method!r}")
