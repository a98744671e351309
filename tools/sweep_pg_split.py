#!/usr/bin/env python3
"""Time kernel B10 (page-granular sparse decode attention) under other
splits over positions on one card, and check every schedule's outputs.

    python3 tools/sweep_pg_split.py

B10 splits a row of n positions into runs of R whole pages, R the least
multiple of the page size that is at least PG_MIN_ROWS and at least
n / PG_MAX_SPLITS (`ops.pg_rows_per_split`). This sweeps PG_MIN_ROWS over
128-2048 and PG_MAX_SPLITS over 8-128, the default (512, 16) first, in
the three shapes of `PG_SHAPES`, all B=4, K=2048, llama3.2-1b's attention
widths (32 query heads, 8 KV heads, head_dim 64, bf16 pools, page 64):

- kernel: `chip_smoke.py`'s kernel phase, N=8192, lengths 8192, 5000,
  1000, 3001 (slot 2 shorter than K: its first K positions selected);
- short: `[page]`-like rows, N=8192, lengths 208, 88, 48, 1, the first K
  positions selected (a row shorter than K);
- long: N=131072, lengths 131072, 130972, 98313, 40000.

Each row also holds -1 entries and duplicates; pages past a slot's
extent are unmapped. Every schedule must write outputs allclose to the
plain version (atol = rtol = 1e-4) and identical in two calls. Each time
is the median device time of one call alone (`chip_smoke.time_ms`:
torch.profiler, L2 flushed before each call) over 30 calls. Prints one
line per schedule, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
B, PS, K, H, KVH, HD = 4, 64, 2048, 32, 8, 64
PG_SHAPES = {          # "long" last: a checkout that refuses it stops there
    "kernel": (8192, (8192, 5000, 1000, 3001)),
    "short": (8192, (208, 88, 48, 1)),
    "long": (131072, (131072, 131072 - 100, 97536 + 777, 40000)),
}


def pg_inputs(shape: str, dev, seed: int = 1234):
    """(q, k_pages, v_pages, table, idx, lengths) of one of PG_SHAPES."""
    import torch
    n, lengths = PG_SHAPES[shape]
    g = torch.Generator(device=dev).manual_seed(seed)
    mp = n // PS
    perm = torch.randperm(B * mp, generator=g, device=dev).int().reshape(B, mp)
    need = torch.tensor([-(-L // PS) for L in lengths], device=dev)
    table = torch.where(torch.arange(mp, device=dev)[None] < need[:, None],
                        perm, torch.full_like(perm, -1)).contiguous()
    kp = torch.randn((B * mp, PS, KVH, HD), generator=g, device=dev).bfloat16()
    vp = torch.randn((B * mp, PS, KVH, HD), generator=g, device=dev).bfloat16()
    q = torch.randn((B, H, HD), generator=g, device=dev).bfloat16()
    idx = torch.stack([
        torch.randperm(L, generator=g, device=dev)[:K].sort().values
        if L >= K else torch.arange(K, device=dev) for L in lengths]).int()
    idx[1, :16] = -1
    idx[0, 16:32] = lengths[0] - 1
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, table, idx.contiguous(), ln


def main() -> int:
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    from chip_smoke import time_ms
    from repro_torch.kernels import ops, ref
    if not torch.cuda.is_available():
        print("sweep_pg_split: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    inputs = {s: pg_inputs(s, dev) for s in PG_SHAPES}
    plain = {s: ref.paged_sparse_attn_pg_ref(*a) for s, a in inputs.items()}
    default = (ops.PG_MIN_ROWS, ops.PG_MAX_SPLITS)
    schedules = [default] + [(r, c) for r in (128, 256, 512, 1024, 2048)
                             for c in (8, 16, 32, 64, 128) if (r, c) != default]
    ok = True
    for min_rows, cap in schedules:
        ops.PG_MIN_ROWS, ops.PG_MAX_SPLITS = min_rows, cap
        try:
            cells = []
            for s, a in inputs.items():
                out = ops.paged_sparse_decode_attn_pg(*a)
                same = torch.equal(out, ops.paged_sparse_decode_attn_pg(*a))
                close = torch.allclose(out, plain[s], atol=1e-4, rtol=1e-4)
                ok &= same and close
                ms = time_ms(lambda a=a: ops.paged_sparse_decode_attn_pg(*a),
                             flush, iters=30)["ms"]
                r, splits = ops.decode_attn_splits("paged_pages", K,
                                                   PG_SHAPES[s][0], PS)
                cells.append(f"{s} {ms:.5f} ms ({splits} x {r}; "
                             f"allclose {close}, two calls equal {same})")
        finally:
            ops.PG_MIN_ROWS, ops.PG_MAX_SPLITS = default
        print(f"PG_MIN_ROWS {min_rows}, PG_MAX_SPLITS {cap}: "
              + ", ".join(cells), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    print(f"sweep verdict: {'every schedule allclose and repeatable' if ok else 'FAILED'}",
          flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
