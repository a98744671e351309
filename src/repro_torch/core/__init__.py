"""Core selection algorithms of the PyTorch port: GVR, radix and exact
Top-K, the RoPE score structure and the temporal feedback helpers —
every name of the JAX package's `repro.core` but the sequence-parallel
GVR's (ROADMAP Queue A item 4)."""

from .gvr import (GVRResult, GVRStats, extract_topk, global_passes, gvr_threshold,
                  gvr_topk, uniform_pre_idx, DEFAULT_K)
from .rope import (compute_static_pre_idx, g_delta, generate_indexer_scores,
                   yarn_inv_freq)
from .temporal import (TopKFeedback, hit_ratio, init_feedback, recycle_slot,
                       recycle_slot_arrays, reset_slot, reset_slot_arrays,
                       seed_slot_idx, shifted_hit_ratio, update_feedback)
from .topk_baselines import exact_topk, radix_select_topk, sort_topk

__all__ = [
    "GVRResult", "GVRStats", "extract_topk", "global_passes", "gvr_threshold",
    "gvr_topk", "uniform_pre_idx", "DEFAULT_K",
    "compute_static_pre_idx", "g_delta", "generate_indexer_scores", "yarn_inv_freq",
    "TopKFeedback", "hit_ratio", "init_feedback", "recycle_slot",
    "recycle_slot_arrays", "reset_slot", "reset_slot_arrays", "seed_slot_idx",
    "shifted_hit_ratio", "update_feedback",
    "exact_topk", "radix_select_topk", "sort_topk",
]
