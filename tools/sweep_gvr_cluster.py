#!/usr/bin/env python3
"""Time kernel B1 (GVR Top-K) and B9's chain on every cluster schedule,
R in {1, 2, 4, 8, 16} CTAs per row x {256, 512, 1024} threads per CTA, on
one card, and check that every schedule writes the default schedule's
values, indices and stats bit for bit.

    python3 tools/sweep_gvr_cluster.py

Inputs are `tools/gvr_regimes.py`'s: B1 on kernel-mix (the kernel phase's
B=4, N=8192 rows), warm, plateau (B=1, length 1000 < K) and warm-131072,
and the chain (B=4, Q=3). A schedule whose slice does not fit the
kernel's shared-memory budget is skipped; a cluster of 16 is
non-portable, and a launch the card refuses is reported. Each time is the
median device time of one call alone (`chip_smoke.time_ms`:
torch.profiler, L2 flushed before each call) over 20 calls. The default
schedule (`ops.gvr_schedule`) is timed first. Prints one line per
schedule, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from gvr_regimes import CMAX, K, chain_inputs, regime_inputs  # noqa: E402

CASES = ("kernel-mix", "warm", "plateau", "warm-131072")


def main() -> int:
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    from chip_smoke import time_ms
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("sweep_gvr_cluster: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    calls = {}
    for name in CASES:
        x, prev = regime_inputs(name, dev)
        calls[name] = (x.shape[-1], False,
                       lambda x=x, prev=prev: ops.gvr_topk(x, prev, K, max_candidates=CMAX))
    xq, pq = chain_inputs(dev)
    calls["chain"] = (xq.shape[-1], True,
                      lambda: ops.gvr_topk_chain(xq, pq, K, max_candidates=CMAX))
    want = {key: f() for key, (_, _, f) in calls.items()}
    default = ops.gvr_schedule
    for sched in [None] + [(r, t) for r in ops.GVR_RANKS for t in ops.GVR_THREADS]:
        if sched is not None:
            ops.gvr_schedule = (lambda n, k, chain=False, wide=True, sched=sched:
                                ops.gvr_layout(n, k, *sched, chain))
        try:
            cells, same = [], True
            for key, (n, chain, f) in calls.items():
                sch = ops.gvr_schedule(n, K, chain,
                                       ops.gvr_hosts_wide_cluster(dev, chain))
                if sch.smem > ops._SMEM_BUDGET:
                    cells.append(f"{key} skipped ({sch.smem} B)")
                    continue
                try:
                    same &= all(torch.equal(a, b) for a, b in zip(f(), want[key]))
                    cells.append(f"{key} {time_ms(f, flush, iters=20)['ms']:.5f} ms")
                except RuntimeError as err:
                    cells.append(f"{key} refused ({str(err)[:60]})")
        finally:
            ops.gvr_schedule = default
        label = "default" if sched is None else f"R={sched[0]} threads={sched[1]}"
        print(f"{label}: " + ", ".join(cells)
              + f"; outputs equal to the default schedule's: {same}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
