"""The numbers that decide `correct`, each worked out from the reference.

* `token_gaps`: for a served request, at each position the reference's
  best logit minus its logit of the token the program served there. Greedy
  serving in exact arithmetic gives 0 everywhere; rounding gives near-ties
  a small gap; a wrong token or state a large one.
* `selection`: for one selected row, the entries that are no valid
  position (out of range, or repeated), and the largest shortfall of a
  selected position's reference score below the reference's K-th score,
  and the largest error of a returned value against the reference's score
  there, both as shares of the K-th score.
"""

from __future__ import annotations

from typing import Dict

import torch


def token_gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """(T,) gaps of `tokens` (T,) under the reference's logits (T, V)."""
    ref = ref_logits.float()
    chosen = ref.gather(1, tokens.long().reshape(-1, 1))[:, 0]
    return ref.max(dim=-1).values - chosen


def selection(idx: torch.Tensor, vals: torch.Tensor, score: torch.Tensor,
              k: int) -> Dict[str, float]:
    """idx, vals (K,) the program's answer for a row whose reference scores
    are `score` (L,)."""
    n = score.shape[0]
    kk = min(k, n)
    idx = idx.long().flatten()
    ok = (idx >= 0) & (idx < n)
    bad = int((~ok).sum()) + (int(ok.sum()) - int(torch.unique(idx[ok]).numel()))
    bad += max(0, kk - int(idx.numel()))
    tau = torch.topk(score, kk).values[-1]
    unit = tau.abs().clamp_min(1e-12)
    picked = score[idx[ok]]
    shortfall = float(((tau - picked).clamp_min(0) / unit).max()) if ok.any() else float("inf")
    value_err = (float(((vals.flatten()[ok].float() - picked).abs() / unit).max())
                 if ok.any() else float("inf"))
    return {"bad_entries": float(bad), "shortfall": shortfall,
            "value_err": value_err}
