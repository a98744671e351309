"""The traced window: `torch.profiler` over a stretch of the timed path,
reduced to device events, host spans and the window's bounds.

The harness marks its own work with `span(name)` (a `record_function`), so
an idle stretch of the device can be put down to what the harness was doing
then. The reduction reads the profiler's raw events
(`kineto_results.events()`), one Python object per event, and keeps:

* device events: (name, start_ns, end_ns) of every kernel, copy and set on
  the card (the profiler's own user-annotation ranges left out);
* host events: (name, start_ns, end_ns, is_harness_span) of the CPU side;
* the window: the bounds of the harness's "gvr_bench.window" span, which
  ends after a `torch.cuda.synchronize()`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "gvr_bench.window"


def span(name: str):
    """A harness span in the traced window (a no-op cost outside one)."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class TraceData:
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int, bool]]
    window: Tuple[int, int]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces of its own
    and parameter list: "void (anonymous namespace)::k<8>(float*)" is
    "k<8>"."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    return name.split("(")[0].strip()


@contextlib.contextmanager
def capture(sink: Dict[str, Optional[TraceData]], device):
    """Profile the block; `sink["trace"]` holds the reduced trace after it.
    On the CPU (the tests) the trace holds host events alone."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        with span(WINDOW):
            yield
            sync()
    finally:
        prof.__exit__(None, None, None)
    sink["trace"] = reduce(prof, need_device=cuda)


def reduce(prof, need_device: bool = True) -> TraceData:
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if ev.is_user_annotation():
                continue
            device.append((_short(name), start, end))
        else:
            if name == WINDOW:
                window = (start, end)
            host.append((name, start, end, bool(ev.is_user_annotation())))
    if window is None:
        raise RuntimeError("trace: the profiler kept no window span")
    if need_device and not device:
        raise RuntimeError("trace: the profiler saw no device event")
    device.sort(key=lambda e: e[1])
    return TraceData(device=device, host=host, window=window)


def busy_intervals(trace: TraceData) -> List[Tuple[int, int]]:
    """The union of the device events, clipped to the window."""
    lo, hi = trace.window
    out: List[Tuple[int, int]] = []
    for _, s, e in trace.device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def busy_s(trace: TraceData) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e9


def idle_gaps(trace: TraceData) -> List[Tuple[int, int]]:
    lo, hi = trace.window
    gaps, cur = [], lo
    for s, e in busy_intervals(trace):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    return gaps


class _HostIndex:
    """Host events bucketed by time, to find those covering an instant."""

    def __init__(self, trace: TraceData, bucket_ns: int = 200_000):
        self.bucket = bucket_ns
        self.base = trace.window[0]
        self.buckets: Dict[int, list] = {}
        for ev in trace.host:
            if ev[0] == WINDOW:
                continue
            for b in range((ev[1] - self.base) // bucket_ns,
                           (ev[2] - self.base) // bucket_ns + 1):
                self.buckets.setdefault(b, []).append(ev)

    def label(self, t: int) -> str:
        """What the host was doing at t: the innermost harness span and
        the innermost host operation (shortest event) covering t."""
        evs = self.buckets.get((t - self.base) // self.bucket, [])
        spans = [(e - s, n) for n, s, e, ann in evs if ann and s <= t < e]
        ops = [(e - s, n) for n, s, e, ann in evs if not ann and s <= t < e]
        label = min(spans)[1] if spans else "harness"
        return f"{label}/{min(ops)[1]}" if ops else f"{label}/python"


def breakdown(trace: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time, and the idle time of
    the device summed by what the host was doing then, the largest first,
    each as [name, seconds]."""
    by_name: Dict[str, int] = {}
    for name, s, e in trace.device:
        by_name[name] = by_name.get(name, 0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    index = _HostIndex(trace)
    idle: Dict[str, int] = {}
    for s, e in idle_gaps(trace):
        label = index.label((s + e) // 2)
        idle[label] = idle.get(label, 0) + (e - s)
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
            "idle_gaps": [[n, ns / 1e9] for n, ns in gaps]}


def kernel_seconds(trace: TraceData, patterns) -> Tuple[float, int]:
    """Summed device seconds and count of the kernels whose name holds any
    of `patterns`, inside the window."""
    lo, hi = trace.window
    total, count = 0, 0
    for name, s, e in trace.device:
        if s >= lo and e <= hi and any(p in name for p in patterns):
            total += e - s
            count += 1
    return total / 1e9, count
