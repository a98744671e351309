"""Arithmetic the metric readers share (gvr_bench/metrics/*.py).

A reader that finds nothing to read returns None, and the run leaves that
metric out of its line; a share of a roofline or of a peak is never made
up as 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from gvr_bench.counts import h100, kernels, step
from . import trace as tr


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def idle_pct(rec) -> Optional[float]:
    if rec.trace is None or not rec.trace.device:
        return None
    return 100.0 * (1.0 - tr.busy_s(rec.trace) / rec.trace.window_s)


def _launch_bound_s(launch) -> float:
    if launch["kind"] == "b2_scoring":
        nb, fl = kernels.b2_scoring(
            launch["lengths"], heads=launch["heads"], dim=launch["dim"],
            page_size=launch["page_size"])
    elif launch["kind"] == "b1":
        nb, fl = kernels.b1(launch["lengths"], m=launch["m"], k=launch["k"])
    else:
        raise ValueError(f"unknown launch kind {launch['kind']!r}")
    return h100.bound_s(nb, fl)


def roofline_pct(rec, kind: str, patterns: Sequence[str]) -> Optional[float]:
    """A kernel's share of its roofline in the traced window: its mean
    bound a launch over its mean device time a launch (the kernels whose
    name holds one of `patterns`). The means keep the share right where
    the profiler lost a launch's event."""
    if rec.trace is None:
        return None
    launches = [x for x in rec.launches if x["kind"] == kind]
    secs, count = tr.kernel_seconds(rec.trace, patterns)
    if not launches or count == 0 or secs <= 0:
        return None
    bound = sum(_launch_bound_s(x) for x in launches) / len(launches)
    return 100.0 * bound / (secs / count)


def step_mfu_pct(rec) -> Optional[float]:
    """The window's least time (a tick: the larger of its operations over
    the bf16 peak and its bytes over the memory's rate) over its time."""
    if not rec.ticks or rec.window_s <= 0:
        return None
    least = step.window(rec.model, rec.ticks, dsa_on=rec.dsa_on,
                        bound=h100.bound_s)
    return 100.0 * least / rec.window_s
