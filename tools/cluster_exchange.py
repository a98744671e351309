#!/usr/bin/env python3
"""Time one cluster-wide exchange on the card by the two mechanisms
csrc/gvr_topk.cu chose between (barrier.cluster, and st.async completing
on the receiver's mbarrier), at cluster sizes 1, 2, 4 and 8: the
measurement behind the kernel's exchange. See tools/cluster_exchange.cu.

    python3 tools/cluster_exchange.py

Builds tools/cluster_exchange.cu with nvcc for sm_90a into build/, runs
it, and prints its `XBENCH` lines, then the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))


def main() -> int:
    from repro_torch.kernels.build import ARCH_FLAGS, find_nvcc
    out = REPO / "build" / "cluster_exchange"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([find_nvcc()] + ARCH_FLAGS + ["-std=c++17", "-O3", "-o", str(out),
                    str(REPO / "tools" / "cluster_exchange.cu")], check=True)
    subprocess.run([str(out)], check=True, timeout=300)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
