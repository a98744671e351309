"""step_mfu_pct.serve (%): the whole step's share of the chip's peak: the
least time the window's ticks need (each tick the larger of its operations
over 989 TFLOP/s and its bytes over 3.35 TB/s, `counts/step.py`) over the
window's time (layer: step)."""

from gvr_bench.harness.readers import step_mfu_pct


def read(rec):
    return step_mfu_pct(rec)
