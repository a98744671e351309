"""What a driver gets and what it gives back.

A driver (gvr_bench/drivers/<name>.py) defines `Driver(ctx)` with:

* `setup()` — weights, restored state and warm-up; nothing timed;
* `window(seconds)` — the timed path for `seconds`, filling `ctx.record`;
* `traced()` — more of the timed path under the profiler, after the
  window (runs with `--trace 1` only), and the layer counters;
* `release()` — drops the program's state once the peak memory is read;
* `check()` — the comparison with the reference: {name: value}, each held
  to the cell's `limits[name]`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from .trace import TraceData


@dataclasses.dataclass
class Record:
    """A run's readings, which the metric readers take values from."""
    cell: str
    model: Dict[str, Any]                    # the config file's model block
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    # served cells: the window's ticks, each the new lengths of every row
    # of every step it ran; the gaps between a request's output tokens
    ticks: List[List[int]] = dataclasses.field(default_factory=list)
    gaps_ms: List[float] = dataclasses.field(default_factory=list)
    dsa_on: bool = True
    # the traced window and the kernel launches it holds: one entry a
    # launch site and step, {"kind": "b2_scoring" | "b1", ...shape}
    trace: Optional[TraceData] = None
    launches: List[Dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Context:
    cell: str
    seed: int
    trace: bool
    device: Any
    cfg: Any                                 # the port's ModelConfig
    conf: Dict[str, Any]                     # gvr_bench/configs/<config>.json
    traffic: Dict[str, Any]                  # gvr_bench/traffic/<mix>.json
    workload: Dict[str, Any]                 # gvr_bench/workloads/<cell>.json
    record: Record = None
