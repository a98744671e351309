"""DSA selection of one layer for a batch of rows, exactly.

For row r with hidden row x_r at length L_r (its last position L_r - 1):
indexer queries qI = RoPE(x_r WqI) at position L_r - 1 (Hi heads of di),
the score of position j < L_r is I_j = sum_h w_h ReLU(qI_h . kI_j), and the
answer is the K positions of largest score. Float32 throughout; the
control (`low="fp8"`) rounds the queries and keys to float8 per row.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from .ops import mm, rnd, rope


def scores(x: torch.Tensor, indexer: Dict, lengths: List[int],
           keys: Callable[[int, int], torch.Tensor], *, heads: int, dim: int,
           rope_base: float, low=None) -> List[torch.Tensor]:
    """Per row r its (L_r,) float32 scores; keys(r, L_r) gives the row's
    indexer keys (L_r, di) at positions [0, L_r)."""
    pos = torch.tensor([n - 1 for n in lengths], device=x.device)
    q = rope(mm(x, indexer["wq"], low).reshape(len(lengths), heads, dim), pos,
             base=rope_base)
    w = indexer["w"].float()
    out = []
    for r, n in enumerate(lengths):
        kr, qr = rnd(keys(r, n), low), rnd(q[r], low)
        out.append(torch.relu(qr @ kr.T).T @ w)
    return out


def topk(score: torch.Tensor, k: int) -> torch.Tensor:
    """The K positions of largest score, ascending."""
    return torch.sort(torch.topk(score, min(k, score.shape[0])).indices).values
