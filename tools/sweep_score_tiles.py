#!/usr/bin/env python3
"""Time the bf16 scoring body (the scoring launches of B2, B5 and B9)
with 1, 2, 3 and 4 position tiles per CTA on one card, and check that
every schedule writes the same score rows bit for bit.

    python3 tools/sweep_score_tiles.py

Shapes are those of `chip_smoke.py`'s kernel phase: B=4, N=8192, page 64,
lengths 8192, 5000, 1000, 3001 (pages past a slot's extent unmapped),
llama3.2-1b's indexer widths (64 heads of 128, bf16), w = 1/64; B9 scores
Q=3 query rows per slot at lengths L0+q+1 from L0 = 4999, 2299, 699,
7997. A CTA keeps all its tiles in flight (as many buffers as tiles).
Each time is the median device time of one call alone
(`chip_smoke.time_ms`: torch.profiler, L2 flushed before each call), over
30 calls. The default schedule (`ops.score_ctas_per_row`) is timed first.
Prints one line per schedule, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
B, N, PS, HI, DI = 4, 8192, 64, 64, 128
LENGTHS = (8192, 5000, 1000, 3001)
VERIFY_L0 = (4999, 2299, 699, 7997)


def main() -> int:
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    from chip_smoke import time_ms
    from repro_torch.kernels import ops
    if not torch.cuda.is_available():
        print("sweep_score_tiles: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    mp = N // PS
    perm = torch.randperm(B * mp, generator=g, device=dev).int().reshape(B, mp)
    need = torch.tensor([-(-L // PS) for L in LENGTHS], device=dev)
    table = torch.where(torch.arange(mp, device=dev)[None] < need[:, None],
                        perm, torch.full_like(perm, -1)).contiguous()
    pages = torch.randn((B * mp, PS, DI), generator=g, device=dev).bfloat16()
    qi = torch.randn((B, HI, DI), generator=g, device=dev).bfloat16()
    w = torch.full((HI,), 1.0 / HI, device=dev)
    ln = torch.tensor(LENGTHS, dtype=torch.int32, device=dev)
    kc = pages[table.clamp(min=0).long()].reshape(B, N, DI).contiguous()
    q9 = torch.randn((B, 3, HI, DI), generator=g, device=dev).bfloat16()
    l9 = (torch.tensor(VERIFY_L0, device=dev)[:, None]
          + torch.arange(1, 4, device=dev)).int().contiguous()
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    calls = {
        "B2s": lambda: ops.paged_indexer_scores(qi, pages, w, table, ln),
        "B5s": lambda: ops.indexer_scores(qi, kc, w, ln),
        "B9s": lambda: ops.paged_indexer_scores_mq(q9, pages, w, table, l9),
    }
    rows = {"B2s": B, "B5s": B, "B9s": 3 * B}
    default = ops.score_ctas_per_row
    want = {k: f() for k, f in calls.items()}
    for per in (None, 1, 2, 3, 4):
        tiles = -(-N // ops.SCORE_TILE)
        sched = default if per is None else (
            lambda r, n, per=per: (per, -(-tiles // per)))
        ops.score_ctas_per_row = sched
        try:
            same = all(torch.equal(f(), want[k]) for k, f in calls.items())
            ms = {k: time_ms(f, flush, iters=30)["ms"] for k, f in calls.items()}
        finally:
            ops.score_ctas_per_row = default
        print(f"tiles per CTA {per or 'default'}: " + ", ".join(
            f"{k} {v:.5f} ms ({rows[k] * sched(rows[k], N)[1]} CTAs)"
            for k, v in ms.items())
            + f"; rows equal to the default schedule's: {same}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
