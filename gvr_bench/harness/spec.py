"""Finding the benchmark's parts by name.

`BENCHMARK.json` at the checkout's root lists the cells and the metrics.
Everything that belongs to one cell, configuration, traffic mix, driver or
metric sits in a file of its own, found by the name the listing gives:

    gvr_bench/workloads/<cell>.json     the cell: its config, mix and limits
    gvr_bench/configs/<config>.json     a configuration and its reference
    gvr_bench/traffic/<mix>.json        a traffic mix; names its driver
    gvr_bench/drivers/<driver>.py       a driver: sets up and times a cell
    gvr_bench/metrics/<metric>.py       a metric: `read(record)` -> value

A new part is a new file; no file that is there needs an edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "gvr_bench"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


class SpecError(RuntimeError):
    """A part the benchmark needs is missing or malformed."""


def _check_name(name: str) -> str:
    if not isinstance(name, str) or not _NAME.match(name):
        raise SpecError(f"not a valid name: {name!r}")
    return name


def load_json(path: Path) -> Dict[str, Any]:
    try:
        return json.loads(Path(path).read_text())
    except FileNotFoundError:
        raise SpecError(f"missing file {path}") from None


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> Dict[str, Any]:
    return load_json(BENCH / "workloads" / f"{_check_name(name)}.json")


def config(name: str) -> Dict[str, Any]:
    return load_json(BENCH / "configs" / f"{_check_name(name)}.json")


def traffic(name: str) -> Dict[str, Any]:
    return load_json(BENCH / "traffic" / f"{_check_name(name)}.json")


def driver(name: str):
    return importlib.import_module(f"gvr_bench.drivers.{_check_name(name)}")


def metric_reader(name: str):
    """The `read` function of gvr_bench/metrics/<name>.py (a metric's name
    may hold dots, so the file is loaded by its path)."""
    path = BENCH / "metrics" / f"{_check_name(name)}.py"
    if not path.is_file():
        raise SpecError(f"no reader for metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"gvr_bench.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: Dict[str, Any], cell: str, trace: bool
                ) -> List[Dict[str, Any]]:
    """The metrics a run of `cell` reports: its end-to-end metrics with
    `trace` off, its per-layer metrics with it on. A metric without a
    `workloads` key belongs to every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def cell_entry(bench: Dict[str, Any], cell: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w
    raise SpecError(f"BENCHMARK.json names no workload {cell!r}")
