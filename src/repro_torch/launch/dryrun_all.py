"""Driver: run every (arch x shape x mesh) dry-run cell of the port.

Results land in results/dryrun_torch/<arch>__<shape>__<pod1|pod2>.json,
as the JAX package's sweep writes results/dryrun/. A cell of the port runs
one rank's step on the meta device (`launch.dryrun`): no device count is
locked, so `--jobs` is a pool of worker processes over the cells (3 by
default, as the reference's), and `--jobs 1` runs every cell in this
process. The whole sweep is CPU work of about a minute.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all \\
        [--mesh pod1|pod2|both] [--outdir DIR] [--jobs N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def cells():
    """(arch, shape, applicable) over every arch and the four shapes."""
    from repro_torch.configs.registry import all_archs, get_config
    from repro_torch.models.api import supported_shapes
    out = []
    for arch in all_archs():
        cfg = get_config(arch)
        for shape in SHAPES:
            out.append((arch, shape, shape in supported_shapes(cfg)))
    return out


def run_one(arch: str, shape: str, multi_pod: bool, outdir: str) -> dict:
    """One cell, its JSON written to `outdir`; a cell that raises is an
    "error" with its exception's text."""
    from repro_torch.launch.dryrun import error_result, run_cell
    try:
        d = run_cell(arch, shape, multi_pod)
    except Exception as e:  # noqa: BLE001 — record the failure for the table
        d = error_result(arch, shape, multi_pod, e)
    tag = f"{arch}__{shape}__{'pod2' if multi_pod else 'pod1'}"
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(d, f, indent=1)
    return d


def _timed(work):
    t0 = time.time()
    return run_one(*work), time.time() - t0


def sweep(mesh: str = "both", outdir: str = "results/dryrun_torch",
          jobs: int = 1, log=print) -> list:
    """Every cell on the meshes `mesh` names, over `jobs` processes;
    returns the cells' dicts in the order of `cells()`."""
    os.makedirs(outdir, exist_ok=True)
    work = [(arch, shape, mp, outdir)
            for arch, shape, _ in cells()
            for mp in ([False, True] if mesh == "both" else [mesh == "pod2"])]
    applicable = {(a, s): ok for a, s, ok in cells()}
    if jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            jobs, mp_context=multiprocessing.get_context("spawn"))
        done = pool.map(_timed, work)
    else:
        pool, done = None, map(_timed, work)
    results = []
    try:
        for (arch, shape, mp, _), (d, secs) in zip(work, done):
            tag = f"{arch}:{shape}:{'2pod' if mp else '1pod'}"
            if applicable[arch, shape] != (d.get("status") != "skipped"):
                d = {"arch": arch, "shape": shape, "multi_pod": mp,
                     "status": "error",
                     "error": f"status {d.get('status')!r} disagrees with "
                              f"supported_shapes"}
            results.append(d)
            log(f"[{d.get('status', '?'):7s}] {tag:45s} "
                f"{secs:6.2f}s {d.get('error', '')[:90]}")
    finally:
        if pool is not None:
            pool.shutdown(cancel_futures=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default="results/dryrun_torch")
    ap.add_argument("--mesh", choices=["pod1", "pod2", "both"], default="both")
    ap.add_argument("--jobs", type=int, default=3)
    args = ap.parse_args(argv)
    results = sweep(args.mesh, args.outdir, args.jobs,
                    log=lambda m: print(m, flush=True))
    ok = sum(1 for r in results if r.get("status") == "ok")
    sk = sum(1 for r in results if r.get("status") == "skipped")
    bad = [r for r in results if r.get("status") not in ("ok", "skipped")]
    print(f"\n== dry-run sweep: {ok} ok, {sk} skipped, {len(bad)} failed ==")
    for r in bad:
        print(f"  FAIL {r['arch']}:{r['shape']}:{r.get('multi_pod')}: "
              f"{r.get('status')} {r.get('error', '')[:120]}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
