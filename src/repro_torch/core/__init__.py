"""Core selection algorithms of the PyTorch port: GVR, its sequence-parallel
form SP-GVR, radix and exact Top-K, the RoPE score structure and the
temporal feedback helpers — every name of the JAX package's `repro.core`."""

from .gvr import (GVRResult, GVRStats, extract_topk, global_passes, gvr_threshold,
                  gvr_topk, uniform_pre_idx, DEFAULT_K)
from .rope import (compute_static_pre_idx, g_delta, generate_indexer_scores,
                   yarn_inv_freq)
from .temporal import (TopKFeedback, hit_ratio, init_feedback, recycle_slot,
                       recycle_slot_arrays, reset_slot, reset_slot_arrays,
                       seed_slot_idx, shifted_hit_ratio, update_feedback)
from .sp_gvr import SPGVRResult, sp_gvr_topk, sp_gvr_topk_local
from .topk_baselines import exact_topk, radix_select_topk, sort_topk

__all__ = [
    "GVRResult", "GVRStats", "extract_topk", "global_passes", "gvr_threshold",
    "gvr_topk", "uniform_pre_idx", "DEFAULT_K",
    "compute_static_pre_idx", "g_delta", "generate_indexer_scores", "yarn_inv_freq",
    "TopKFeedback", "hit_ratio", "init_feedback", "recycle_slot",
    "recycle_slot_arrays", "reset_slot", "reset_slot_arrays", "seed_slot_idx",
    "shifted_hit_ratio", "update_feedback",
    "SPGVRResult", "sp_gvr_topk", "sp_gvr_topk_local",
    "exact_topk", "radix_select_topk", "sort_topk",
]
