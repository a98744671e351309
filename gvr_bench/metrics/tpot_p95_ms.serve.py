"""tpot_p95_ms.serve (ms): 95th percentile of every gap between a request's
consecutive output tokens in the window, from host timestamps taken after
each `engine.tick()` (layer: engine)."""

from gvr_bench.harness.readers import percentile


def read(rec):
    return percentile(rec.gaps_ms, 95.0)
