#!/usr/bin/env python3
"""Time the training step of `chip_smoke.py`'s [train] phase (llama3.2-1b
at full width and depth, B = 4, S = 2048, 10 steps) with AdamW updating
each leaf on the card whole, as `optim/adamw.py` does, and in slices of
2^22 elements, as it does on the CPU.

    python3 tools/ab_adamw_slices.py

Runs whole, sliced, sliced, whole in one process on one card and prints,
after each run's own [train] lines, one line:

    AB <whole|sliced>: step <ms> ms (median of steps 3-10), <tokens/s>
        tokens/s, peak <GiB> GiB, device <ms> ms

then `AB verdict: sliced - whole = <ms> ms a step (<percent>%)` from the
means of the two runs of each. Both schedules give the same bits
(`tests/test_torch_train.py::test_adamw_cpu_slices_give_the_same_bits`),
so only the time is compared.
"""

import gc
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ab_adamw_slices: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke
    from repro_torch.optim import adamw
    whole = adamw._span
    spans = {"whole": whole, "sliced": lambda p: adamw._CPU_SLICE}
    walls = {"whole": [], "sliced": []}
    for name in ("whole", "sliced", "sliced", "whole"):
        adamw._span = spans[name]
        r = chip_smoke.phase_train()
        walls[name].append(r["wall_ms"])
        print(f"AB {name}: step {r['wall_ms']:.3f} ms (median of steps "
              f"3-10), {r['tokens_s']:.1f} tokens/s, peak {r['peak_gib']:.3f} "
              f"GiB, device {r['device_ms']:.3f} ms", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    adamw._span = whole
    w, s = (sum(walls[k]) / 2 for k in ("whole", "sliced"))
    print(f"AB verdict: sliced - whole = {s - w:.3f} ms a step "
          f"({100 * (s - w) / w:.2f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
