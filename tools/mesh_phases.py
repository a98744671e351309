"""Run chip_smoke.py's mesh phases alone on the card: [tp], [ep] and
[hybrid-sp] (a ("data", "model") mesh of 4 gloo ranks sharing one GPU),
after building the kernels. For iterating on those phases without the
whole script; `python3 chip_smoke.py` runs them in its own order.

    python3 tools/mesh_phases.py [PHASE ...]     # default: all three
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("mesh_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    chip_smoke.phase_build()
    for phase in sys.argv[1:] or ("tp", "ep", "hybrid-sp"):
        t0 = time.perf_counter()
        chip_smoke.phase_mesh(phase)
        chip_smoke.log(f"[phase] {phase}: {time.perf_counter() - t0:.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
