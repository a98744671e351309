#!/usr/bin/env python3
"""Where kernel B1's (GVR Top-K) time goes, by phase, on one card.

    python3 tools/phase_gvr_topk.py [CHECKOUT ...]

For each checkout (default: this one), in a process of its own (two
checkouts share the package name `repro_torch`), builds the checkout's
`csrc/gvr_topk.cu` and launches its timing instance,
`gvr_topk_timed_launch`: the production body compiled with the template
parameter kTimed = true, in which thread 0 of rank 0 of each row's
cluster writes `%globaltimer` at the start and after each phase into a
(rows, 8) int64 buffer. Neither `ops.gvr_topk`, `chip_smoke.py` nor the
main path ever launches that instance. Phases:

    P0  row load and its extrema        P3  ordered compaction (none in
    P1  predicted values: bracket, t0       the cluster body: P4/P5 filter)
    P2  secant probes                   P4  exact K-th value (radix)
    ex  the exit count                  P5  ordered emit

It prints, per regime of `tools/gvr_regimes.py` and per row, the mean of
each phase over the calls (microseconds, from the stamps), then the
device time of one call alone (`chip_smoke.time_ms`: torch.profiler, L2
flushed before each call) of the production launch (`ops.gvr_topk`), of
the timing instance, and of a null kernel with the same grid, cluster and
dynamic shared memory (`gvr_null_launch`): the floor of a launch of that
shape. The timing instance's outputs must equal the production launch's
bit for bit. The last line is the card's name and power limit.

A checkout without `ops.gvr_schedule` is taken for the single-CTA body of
the parent (one 1024-thread CTA per row). Where its `gvr_topk.cu` lacks
the two entry points, `tools/gvr_topk_parent_timed.patch` adds them in
place (the parent's body with a timing instance and a null kernel, stamps
at the same phase boundaries); the patch applies only to that parent's
source, so give a throwaway copy of it:

    git archive <parent> | tar -x -C build/parent
    python3 tools/phase_gvr_topk.py build/parent .
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from gvr_regimes import CMAX, K, REGIMES, regime_inputs  # noqa: E402

PHASES = ("P0", "P1", "P2", "ex", "P3", "P4", "P5")
ITERS = 30
SOURCE = "src/repro_torch/kernels/csrc/gvr_topk.cu"
PARENT_TIMED = REPO / "tools" / "gvr_topk_parent_timed.patch"


def apply_patch(root: Path, patch: Path) -> None:
    """Apply a unified diff of one file to the checkout at `root`, in
    place, each hunk at its stated line; exits if a hunk's old lines are
    not there."""
    lines = [ln for ln in patch.read_text().splitlines(keepends=True)
             if not ln.startswith("\\")]
    target = root / lines[1][4:].strip().split("/", 1)[1]     # +++ b/<path>
    src = target.read_text().splitlines(keepends=True)
    out, pos, i = [], 0, 2
    while i < len(lines):
        start = int(lines[i].split()[1][1:].split(",")[0]) - 1
        old, new = [], []
        i += 1
        while i < len(lines) and not lines[i].startswith("@@"):
            if lines[i][0] in " -":
                old.append(lines[i][1:])
            if lines[i][0] in " +":
                new.append(lines[i][1:])
            i += 1
        if src[start:start + len(old)] != old:
            raise SystemExit(f"{patch.name}: the hunk at line {start + 1} does "
                             f"not apply to {target}")
        out += src[pos:start] + new
        pos = start + len(old)
    target.write_text("".join(out + src[pos:]))


def launch_args(ops, scores, prev, k, cmax):
    """The checkout's C arguments of one B1 launch up to the outputs, and
    the launch's shape (rows, CTAs per row, threads, dynamic smem bytes)."""
    b = scores.shape[0]
    if hasattr(ops, "gvr_schedule"):
        n, m, cmax, f_target, c_lo0, sch = ops._gvr_args(scores, prev, k, cmax,
                                                          "phase")
        return ([scores.data_ptr(), prev.data_ptr(), b, n, m, k, cmax, 12,
                 f_target, c_lo0, sch.ranks, sch.threads, sch.smem],
                (b, sch.ranks, sch.threads, sch.smem))
    n, m, cmax, f_target, c_lo0, row_in_smem = ops._gvr_args(scores, prev, k,
                                                              cmax, "phase")
    smem = ((n if row_in_smem else 0) + 2 * cmax) * 4
    return ([scores.data_ptr(), prev.data_ptr(), b, n, m, k, cmax, 12,
             f_target, c_lo0, row_in_smem], (b, 1, 1024, smem))


def child(root: Path) -> None:
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import time_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import LIBRARIES
    dev = torch.device("cuda")
    lib = LIBRARIES.get("gvr_topk")
    timed, null = lib.gvr_topk_timed_launch, lib.gvr_null_launch
    timed.restype = null.restype = ctypes.c_int
    null.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name in REGIMES:
        x, prev = regime_inputs(name, dev)
        b = x.shape[0]
        args, (rows, ranks, threads, smem) = launch_args(ops, x, prev, K, CMAX)
        head = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_float] + [ctypes.c_int] * (len(args) - 10)
        timed.argtypes = head + [ctypes.c_void_p] * 5
        vals = torch.empty((b, K), dtype=torch.float32, device=dev)
        idx = torch.empty((b, K), dtype=torch.int32, device=dev)
        st = torch.empty((b, 8), dtype=torch.float32, device=dev)
        stamps = torch.zeros((b, 8), dtype=torch.int64, device=dev)

        def run_timed():
            rc = timed(*args, vals.data_ptr(), idx.data_ptr(), st.data_ptr(),
                       stamps.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"gvr_topk_timed_launch failed: {rc}")

        def run_null():
            rc = null(rows, ranks, threads, smem, stream)
            if rc:
                raise RuntimeError(f"gvr_null_launch failed: {rc}")

        v0, i0, s0 = ops.gvr_topk(x, prev, K, max_candidates=CMAX)
        run_timed()
        torch.cuda.synchronize()
        if not (torch.equal(v0, vals) and torch.equal(i0, idx)
                and torch.equal(s0, st)):
            raise SystemExit(f"{name}: the timing instance's outputs differ "
                             f"from ops.gvr_topk's")
        per_row = [[[] for _ in PHASES] for _ in range(b)]
        for _ in range(ITERS):
            flush.zero_()
            run_timed()
            torch.cuda.synchronize()
            s = stamps.cpu().tolist()
            for r in range(b):
                for p in range(len(PHASES)):
                    per_row[r][p].append((s[r][p + 1] - s[r][p]) / 1e3)
        t_prod = time_ms(lambda: ops.gvr_topk(x, prev, K, max_candidates=CMAX),
                         flush, iters=ITERS)
        t_timed = time_ms(run_timed, flush, iters=ITERS)
        t_null = time_ms(run_null, flush, iters=ITERS)
        for r in range(b):
            means = [statistics.mean(v) for v in per_row[r]]
            print(f"PHASE {root.name} {name} row {r} (stats "
                  f"{[int(v) for v in s0[r, :4].tolist()]}): " + ", ".join(
                      f"{p} {m:.3f}" for p, m in zip(PHASES, means))
                  + f"; sum {sum(means):.3f} us", flush=True)
        print(f"PHASE {root.name} {name}: grid {rows} rows x {ranks} CTAs of "
              f"{threads} threads, {smem} B dynamic smem; device ms "
              f"production {t_prod['ms']:.5f} (wall {t_prod['wall_ms']:.5f}), "
              f"timing instance {t_timed['ms']:.5f}, null kernel "
              f"{t_null['ms']:.5f}", flush=True)


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        child(Path(argv[2]).resolve())
        return 0
    roots = [Path(p).resolve() for p in argv[1:]] or [REPO]
    for root in roots:
        if "gvr_topk_timed_launch" not in (root / SOURCE).read_text():
            apply_patch(root, PARENT_TIMED)
            print(f"PHASE {root.name}: applied tools/{PARENT_TIMED.name}",
                  flush=True)
        out = subprocess.run([sys.executable, __file__, "--child", str(root)],
                             capture_output=True, text=True, timeout=900)
        print(out.stdout, end="", flush=True)
        if out.returncode != 0:
            print(out.stderr, file=sys.stderr)
            return out.returncode
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
