"""device_idle_pct (%): 1 - (union of the device's events / the traced
window), from torch.profiler (layer: device)."""

from gvr_bench.harness.readers import idle_pct


def read(rec):
    return idle_pct(rec)
