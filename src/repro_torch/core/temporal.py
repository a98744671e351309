"""Temporal-correlation feedback state (paper §3.1), PyTorch port.

Each DSA layer's Top-K output at step t is carried to step t+1 as the
prediction signal (the paper's `heuristic_prev_topk` buffer, L × B × K
int32). These are the array-level slot operations the decode state and
the serving engine's `FeedbackPool` share.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def seed_slot_idx(k: int, seq_len_hint: Optional[int] = None,
                  device=None) -> torch.Tensor:
    """Even-spacing warm-start seed: (K,) int32 inside [0, seq_len_hint)
    (paper Table 9 row b). Computed as `jnp.linspace(0, n-1, k)` in float32
    — start·(1-s) + stop·s with s = i/(k-1), the stop appended — then
    truncated, so the seed is the JAX package's to the bit."""
    n = seq_len_hint if seq_len_hint is not None else k
    stop = np.float32(max(n - 1, 0))
    if k == 1:
        vals = np.zeros((1,), np.float32)
    else:
        step = np.arange(k - 1, dtype=np.float32) / np.float32(k - 1)
        vals = np.concatenate([np.float32(0.0) * (np.float32(1.0) - step)
                               + stop * step, [stop]]).astype(np.float32)
    return torch.as_tensor(vals.astype(np.int32), device=device)


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
