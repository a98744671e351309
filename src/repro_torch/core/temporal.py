"""Temporal-correlation measurement and the prev-Top-K feedback state
(paper §3.1), PyTorch port.

Each DSA layer's Top-K output at step t is carried to step t+1 as the
prediction signal (the paper's `heuristic_prev_topk` buffer, L × B × K
int32). Here are the `TopKFeedback` buffer and its updates, the
array-level slot operations the decode state and the serving engine's
`FeedbackPool` share, and the hit ratios that measure the correlation
(paper Fig. 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import numpy as np
import torch


class TopKFeedback(NamedTuple):
    """Per-layer previous-step Top-K indices (the paper's prev_topk buffer)."""
    prev_idx: torch.Tensor   # (L, B, K) int32
    valid: torch.Tensor      # (L, B) bool — False until a first decode step ran


def linspace_i32(stop: float, k: int, device=None) -> torch.Tensor:
    """`jnp.linspace(0, stop, k).astype(int32)` to the bit: float32
    i · (stop · (1 / (k - 1))), the stop appended, truncated. XLA folds
    the reference's start·(1-s) + stop·s with s = i/(k-1) into that form,
    and the unfolded one truncates some entries one lower (7 of 2048 at
    stop = 131071)."""
    stop = np.float32(stop)
    if k == 1:
        vals = np.zeros((1,), np.float32)
    else:
        scale = stop * (np.float32(1.0) / np.float32(k - 1))
        vals = np.append(np.arange(k - 1, dtype=np.float32) * scale,
                         stop).astype(np.float32)
    return torch.as_tensor(vals.astype(np.int32), device=device)


def seed_slot_idx(k: int, seq_len_hint: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """Even-spacing warm-start seed: (K,) int32 inside [0, seq_len_hint)
    (paper Table 9 row b), the JAX package's to the bit."""
    n = seq_len_hint if seq_len_hint is not None else k
    return linspace_i32(max(n - 1, 0), k, device)


def init_feedback(num_layers: int, batch: int, k: int,
                  seq_len_hint: Optional[int] = None,
                  device=None) -> TopKFeedback:
    """Step-0 state: indices seeded evenly over the KV prefix (or [0, k)
    with no hint), every layer and row invalid."""
    base = seed_slot_idx(k, seq_len_hint, device)
    prev = base[None, None].expand(num_layers, batch, k).clone()
    return TopKFeedback(prev_idx=prev,
                        valid=torch.zeros((num_layers, batch), dtype=torch.bool,
                                          device=device))


def update_feedback(fb: TopKFeedback, layer: Union[int, torch.Tensor],
                    new_idx: torch.Tensor) -> TopKFeedback:
    """Record `layer`'s Top-K (B, K) for the next decode step. Returns new
    tensors."""
    prev, valid = fb.prev_idx.clone(), fb.valid.clone()
    prev[layer] = new_idx.to(torch.int32)
    valid[layer] = True
    return TopKFeedback(prev_idx=prev, valid=valid)


def reset_slot_arrays(prev_idx: torch.Tensor, valid: torch.Tensor, slot,
                      seq_len_hint: Optional[int] = None):
    """Slot reset shared by the feedback pool and the model decode state.

    prev_idx: (L, B, K); valid: (L, B). The slot's prediction rows are
    re-seeded (even spacing over `seq_len_hint`) and marked invalid, so the
    first selection after admission is a cold row, and the next step's
    genuine feedback re-arms the GVR path. Returns new tensors.
    """
    seed = seed_slot_idx(prev_idx.shape[-1], seq_len_hint, prev_idx.device)
    prev_idx = prev_idx.clone()
    valid = valid.clone()
    prev_idx[:, slot] = seed
    valid[:, slot] = False
    return prev_idx, valid


def recycle_slot_arrays(prev_idx: torch.Tensor, valid: torch.Tensor, slot):
    """Slot recycle on eviction: poison the slot's predictions with -1 and
    drop validity. A later admission must call `reset_slot_arrays`."""
    prev_idx = prev_idx.clone()
    valid = valid.clone()
    prev_idx[:, slot] = -1
    valid[:, slot] = False
    return prev_idx, valid


def reset_slot(fb: TopKFeedback, slot,
               seq_len_hint: Optional[int] = None) -> TopKFeedback:
    """Slot admission: re-seed one slot of the feedback buffer (all layers)."""
    return TopKFeedback(*reset_slot_arrays(fb.prev_idx, fb.valid, slot,
                                           seq_len_hint))


def recycle_slot(fb: TopKFeedback, slot) -> TopKFeedback:
    """Slot eviction: poison one slot so stale predictions can never leak
    into the next request admitted there."""
    return TopKFeedback(*recycle_slot_arrays(fb.prev_idx, fb.valid, slot))


def hit_ratio(idx_t: torch.Tensor, idx_tm1: torch.Tensor, n: int) -> torch.Tensor:
    """Raw Top-K overlap between consecutive steps (paper Fig. 3):
    |P ∩ S*| / |P| through a membership bitmap per row, indices clipped to
    [0, n). idx_*: (..., K) int. Returns (...) float32."""
    lead = idx_t.shape[:-1]
    a = idx_t.reshape(-1, idx_t.shape[-1]).clamp(0, n - 1).long()
    b = idx_tm1.reshape(-1, idx_tm1.shape[-1]).clamp(0, n - 1).long()
    member = torch.zeros((b.shape[0], n), dtype=torch.bool, device=b.device)
    member.scatter_(1, b, True)
    return member.gather(1, a).float().mean(-1).reshape(lead)


def shifted_hit_ratio(idx_t: torch.Tensor, idx_tm1: torch.Tensor, n: int,
                      shift: int = 1) -> torch.Tensor:
    """Shifted overlap (paper §3.1): the previous indices advanced by
    `shift` before the comparison — the Toeplitz translation of the score
    landscape."""
    return hit_ratio(idx_t, idx_tm1 + shift, n)
