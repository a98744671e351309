#!/usr/bin/env python3
"""Split kernel B10's device time (page-granular sparse decode attention)
into its parts on one card, beside B3 over the same entries.

    python3 tools/phase_pg_attn.py

Builds three variants of `csrc/decode_attn.cu` into `build/phase_pg/`,
each changed in B10's instance alone by inserting one statement at a fixed
place of the source text (the checkout's file is not touched):

- null: every CTA returns at once, so the time is the launch of the same
  grid, workspace and all;
- prologue: the live CTAs end after the idx scan, the counts and the
  compaction (the time to find the rows, no row read);
- no-merge: the live CTAs write their partial straight to the output and
  end (no ticket, no merge; a wrong result, for timing only).

Each variant replaces the loaded `decode_attn` library for its calls, so
the wrapper (`ops.paged_sparse_decode_attn_pg`: schedule, workspace,
tickets) is the one the port runs. Shapes are `tools/sweep_pg_split.py`'s
(kernel, short, long). Each time is the median device time of one call
alone (`chip_smoke.time_ms`: torch.profiler, L2 flushed before each
call) over 30 calls. Prints one line per shape, then the card's name and
power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from sweep_pg_split import PG_SHAPES, pg_inputs  # noqa: E402

# (anchor in decode_attn.cu, statement inserted before it)
VARIANTS = {
    "null": ("  int live_pg = 0;\n",
             "  if constexpr (PG) return;\n"),
    "prologue": ("  // scoring: lane lc of each row group holds q's chunk lc for all G heads\n",
                 "  if constexpr (PG) { if (e1 < 0) out[0] = 0.f; return; }\n"),
    "no-merge": ("  const int ns = PG ? live_pg : (int)gridDim.x;",
                 "  if constexpr (PG) { if (t < hd) { for (int g = 0; g < G; ++g)"
                 " if (g < gv) ob[g * hd + d] = acc[g]; } return; }\n"),
}


def build_variants(out_dir: Path) -> dict:
    """Compile every variant (one nvcc each, all at once); returns their
    library paths."""
    from repro_torch.kernels.build import CSRC, FLAGS, find_nvcc
    src = (CSRC / "decode_attn.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (anchor, stmt) in VARIANTS.items():
        if src.count(anchor) != 1:
            raise RuntimeError(f"variant {name}: anchor not found once in "
                               f"decode_attn.cu: {anchor!r}")
        cu = out_dir / f"decode_attn_{name}.cu"
        cu.write_text(src.replace(anchor, stmt + anchor))
        lib = out_dir / f"libdecode_attn_{name}.so"
        procs[name] = (subprocess.Popen([find_nvcc()] + FLAGS + ["-o", str(lib), str(cu)],
                                        stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    from chip_smoke import time_ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.build import LIBRARIES, SIGNATURES
    if not torch.cuda.is_available():
        print("phase_pg_attn: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    full = LIBRARIES.get("decode_attn")
    variants = {}
    for name, path in build_variants(REPO / "build" / "phase_pg").items():
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES["decode_attn"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        variants[name] = lib
    for shape in PG_SHAPES:
        a = pg_inputs(shape, dev)
        n = PG_SHAPES[shape][0]
        r, splits = ops.decode_attn_splits("paged_pages", a[4].shape[1], n, 64)
        cells = [f"B3 {time_ms(lambda: ops.paged_sparse_decode_attn(*a), flush, iters=30)['ms']:.5f}",
                 f"full {time_ms(lambda: ops.paged_sparse_decode_attn_pg(*a), flush, iters=30)['ms']:.5f}"]
        for name, lib in variants.items():
            LIBRARIES.libs["decode_attn"] = lib
            try:
                ms = time_ms(lambda: ops.paged_sparse_decode_attn_pg(*a), flush,
                             iters=30)["ms"]
            finally:
                LIBRARIES.libs["decode_attn"] = full
            cells.append(f"{name} {ms:.5f}")
        print(f"B10 phases [{shape}] ({splits} splits of {r}), device ms: "
              + ", ".join(cells), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
