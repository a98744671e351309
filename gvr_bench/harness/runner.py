"""One run of one cell: set-up, the timed window, the traced window, the
check against the reference, and the result line.

The result is the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end metrics
with `--trace 0`, its per-layer metrics with `--trace 1`), `device`,
`breakdown` (traced runs) and, last, `checks`: each number compared with
its limit. The same numbers end standard error.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

from . import spec

# top-level module names that must not be loaded: JAX, its libraries and
# the JAX package beside the port (compared whole: `repro_torch` is fine)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(RuntimeError):
    """The run cannot be made here (no card, no program, a bad spec)."""


def process_seconds() -> float:
    """Seconds since this process started, from /proc (clock ticks)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return float(f.read().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED
_IMPORTED = time.perf_counter()


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def _program_path() -> None:
    src = spec.ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))


def prepare(cell: str, *, chips_check: bool = True,
            parts: Optional[Dict[str, Dict]] = None) -> Dict[str, Any]:
    """The cell's entry, workload, configuration and traffic; `parts`
    (tests) gives them as dicts instead of files."""
    if parts is not None:
        return dict(parts)
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, cell)
    work = spec.workload(cell)
    if (work["config"], work["traffic"]) != (entry["config"], entry["traffic"]):
        raise spec.SpecError(f"{cell}: workload file and BENCHMARK.json "
                             f"name another config or traffic")
    if chips_check:
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: the benchmark runs on the card")
        if torch.cuda.device_count() < entry["chips"]:
            raise Refused(f"{cell} needs {entry['chips']} cards, "
                          f"{torch.cuda.device_count()} present")
    return {"bench": bench, "entry": entry, "workload": work,
            "config": spec.config(work["config"]),
            "traffic": spec.traffic(work["traffic"])}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """({name: {value, limit}} for each limit, correct): correct when
    there are limits and every number is within its own."""
    missing = set(limits) - set(numbers)
    if missing:
        raise spec.SpecError(f"no number for the limits {sorted(missing)}")
    checks = {name: {"value": float(numbers[name]),
                     "limit": float(limits[name])} for name in limits}
    return checks, bool(limits) and all(
        c["value"] <= c["limit"] for c in checks.values())


def run(cell: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", parts: Optional[Dict] = None,
        controls: Sequence[str] = (), options: Optional[Dict] = None
        ) -> Dict[str, Any]:
    """Run one cell; returns the result object (the JSON line).

    For the readings alone: `options` are attributes set on the driver
    before set-up, and each precision in `controls` ("fp8", the control;
    "bf16", a witness) is put in the program's place after the program's
    check and judged by the same limits, under `controls`; the program's
    numbers, every one of them, are then under `numbers`."""
    import torch
    from .context import Context, Record
    from .model import port_config
    from . import trace as tr
    p = prepare(cell, chips_check=device == "cuda", parts=parts)
    _program_path()
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        raise Refused(f"the program (repro_torch) is not importable: {exc}")
    conf, traf, work = p["config"], p["traffic"], p["workload"]
    cfg = port_config(conf)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.set_num_threads(1)     # one host thread: the load is Python's
    ctx = Context(cell=cell, seed=int(seed), trace=trace, device=dev, cfg=cfg,
                  conf=conf, traffic=traf, workload=work)
    ctx.record = Record(cell=cell, model=conf["model"])
    drv = spec.driver(traf["driver"]).Driver(ctx)
    for key, val in (options or {}).items():
        setattr(drv, key, val)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    drv.setup()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ctx.record.setup_s = process_seconds()
    drv.window(float(seconds))
    if trace:
        drv.traced()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    drv.release()
    checks = drv.check()
    limits = work["limits"]
    rec = ctx.record
    bench = p.get("bench")
    metrics: Dict[str, Any] = {}
    for m in (spec.metrics_for(bench, cell, trace) if bench else
              p.get("metrics", [])):
        value = spec.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info: Dict[str, Any] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": None, "attempted": rec.attempted,
                           "failed": rec.failed, "metrics": metrics,
                           "device": device_info}
    out["counters"] = dict(rec.counters, window_s=rec.window_s)
    if trace and rec.trace is not None:
        device_info["busy_s"] = tr.busy_s(rec.trace)
        device_info["window_s"] = rec.trace.window_s
        out["breakdown"] = tr.breakdown(rec.trace)
    if controls:
        out["numbers"] = checks
        out["controls"] = {}
        for low in controls:
            numbers = drv.check(low=low)
            out["controls"][low] = {"numbers": numbers,
                                    "correct": judge(numbers, limits)[1]}
    out["checks"], out["correct"] = judge(checks, limits)
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python3 -m gvr_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except (Refused, spec.SpecError) as exc:
        print(f"gvr_bench: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"gvr_bench: modules that must not load were loaded: "
              f"{', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
