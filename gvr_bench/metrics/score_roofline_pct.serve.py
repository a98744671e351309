"""score_roofline_pct (%): B2's scoring launch (csrc/indexer_scores.cu)
against its bound (`counts/kernels.py`), over its device time in the traced
window (layer: kernels)."""

from gvr_bench.harness.readers import roofline_pct

KERNELS = ("indexer_scores_mma_kernel", "indexer_scores_fma_kernel")


def read(rec):
    return roofline_pct(rec, "b2_scoring", KERNELS)
