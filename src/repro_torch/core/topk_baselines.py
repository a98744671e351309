"""Baseline exact Top-K implementations (paper §2.2–2.3), plain PyTorch.

* `radix_select_topk` — the TensorRT-LLM radix-select structure: monotone
  FP32→uint32 key transform, digit-group narrowing (histogram →
  cumulative-from-top → K-th bucket → recurse), early exit to a direct
  selection once the surviving bucket is small. Digit schedule 11→11→10.
* `sort_topk` — full stable descending sort, take K.
* `exact_topk` — the same stable sort: lowest index first among ties,
  which is the tie order of the JAX package's `lax.top_k` oracle.

All return (values, indices) with lowest-index-first tie semantics. Keys
are held in int64 (torch has no full uint32 arithmetic), masked to 32 bits.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .gvr import extract_topk

RADIX_SCHEDULE = (11, 11, 10)
EARLY_EXIT = 2048
_MASK32 = 0xFFFFFFFF


class RadixStats(NamedTuple):
    passes: torch.Tensor        # int32 (B,)
    survivors: torch.Tensor     # int32 (B,)
    threshold: torch.Tensor     # float32 (B,)


def float_to_sortable_u32(x: torch.Tensor) -> torch.Tensor:
    """Monotone map: f32 total order (incl. -0.0 < +0.0) → uint32 order,
    returned as int64 in [0, 2^32)."""
    u = x.float().contiguous().view(torch.int32).long() & _MASK32
    sign = (u >> 31) == 1
    return torch.where(sign, (~u) & _MASK32, u | 0x80000000)


def radix_select_topk(scores: torch.Tensor, k: int, *,
                      schedule: tuple = RADIX_SCHEDULE,
                      early_exit: int = EARLY_EXIT):
    """Exact Top-K via radix select. scores: (B, N) or (N,)."""
    squeeze = scores.dim() == 1
    x = (scores[None] if squeeze else scores).float()
    b, n = x.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    dev = x.device
    u = float_to_sortable_u32(x)

    early_exit = max(int(early_exit), k)
    prefix = torch.zeros((b,), dtype=torch.long, device=dev)
    bits_done = 0
    bits_res = torch.zeros((b,), dtype=torch.long, device=dev)
    k_rem = torch.full((b,), k, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    passes = torch.zeros((b,), dtype=torch.int32, device=dev)
    survivors = torch.full((b,), n, dtype=torch.int32, device=dev)

    for d in schedule:
        shift = 32 - bits_done - d
        nb = 1 << d
        if bits_done == 0:
            active = torch.ones((b, n), dtype=torch.bool, device=dev)
        else:
            active = (u >> (32 - bits_done)) == prefix[:, None]
        digit = (u >> shift) & (nb - 1)
        hist = torch.zeros((b, nb), dtype=torch.long, device=dev)
        hist.scatter_add_(1, digit, active.long())
        ctop = hist.flip(-1).cumsum(-1).flip(-1)
        jstar = ((ctop >= k_rem[:, None]).sum(-1) - 1).clamp(min=0)
        above = torch.where(
            jstar + 1 < nb,
            ctop.gather(1, (jstar + 1).clamp(max=nb - 1)[:, None])[:, 0],
            torch.zeros_like(jstar))
        in_bucket = hist.gather(1, jstar[:, None])[:, 0]
        k_rem = torch.where(done, k_rem, k_rem - above)
        prefix = torch.where(done, prefix, (prefix << d) | jstar)
        passes = torch.where(done, passes, passes + 1)
        survivors = torch.where(done, survivors, in_bucket.int())
        bits_res = torch.where(done, bits_res, bits_res + d)
        done = done | (in_bucket <= early_exit)
        bits_done += d

    # the per-row prefix pins the K-th key's bucket: the exact K-th value is
    # the k_rem-th largest among the (<= early_exit) keys matching it
    shift = (32 - bits_res).clamp(max=31)
    in_pref = torch.where(bits_res[:, None] == 0,
                          torch.ones_like(u, dtype=torch.bool),
                          (u >> shift[:, None]) == prefix[:, None])
    neg = torch.tensor(torch.finfo(torch.float32).min, device=dev)
    surv_vals = torch.where(in_pref, x, neg)
    topv = torch.topk(surv_vals, min(int(early_exit) + 1, n), dim=-1).values
    t_star = topv.gather(1, (k_rem - 1)[:, None])[:, 0]

    vals, idx = extract_topk(x, t_star, k)
    stats = RadixStats(passes=passes, survivors=survivors, threshold=t_star)
    if squeeze:
        return vals[0], idx[0], RadixStats(*[s[0] for s in stats])
    return vals, idx, stats


def sort_topk(scores: torch.Tensor, k: int):
    """Full stable descending sort, take K."""
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return scores.gather(-1, idx), idx.int()


def exact_topk(scores: torch.Tensor, k: int):
    """The oracle: exact Top-K, lowest index first among ties."""
    return sort_topk(scores.float(), k)
