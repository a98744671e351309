"""topk_roofline_pct (%): B1, the GVR Top-K (csrc/gvr_topk.cu), against its
bound (`counts/kernels.py`), over its device time in the traced window
(layer: kernels)."""

from gvr_bench.harness.readers import roofline_pct

KERNELS = ("gvr_topk_kernel",)


def read(rec):
    return roofline_pct(rec, "b1", KERNELS)
