"""The readings the limits of `correct` are set from, on the card: for each
seed, one run of a cell through the harness's own run (set-up, a short
window at the cell's own load, the check) and, on the same prompts, tokens
and calls, the control: the reference computed in float8 put in the
program's place and judged by the cell's limits as the program is.

    python3 -m gvr_bench.tools.readings --workload <cell> --seconds <s> \
        --seeds 11 12 13 [--control 11 12 13] [--witness] [--scale-k]

One JSON line a seed: the program's numbers and `correct`, and for the
seeds under --control the control's numbers and `correct`, which has to
come out false. With --witness (served cells) also a bfloat16 reference's,
which computes as the served model stores; with --scale-k the restored K
rows carry the indexer keys' per-position scale, which the cells leave
out. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch


def one(cell: str, seed: int, seconds: float, control: bool,
        witness: bool = False, scale_k: bool = False) -> dict:
    from gvr_bench.harness import runner
    controls = (("fp8",) if control else ()) + (("bf16",) if witness else ())
    out = runner.run(cell, seed, seconds, False, controls=controls,
                     options={"scale_k": True} if scale_k else None)
    line = {"cell": cell, "seed": seed, "scale_k": scale_k,
            "correct": out["correct"], "program": out.get("numbers",
                                                          out["checks"]),
            "counters": out["counters"]}
    for low, res in out.get("controls", {}).items():
        line["control" if low == "fp8" else "bf16_witness"] = res
    gc.collect()
    torch.cuda.empty_cache()
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--witness", action="store_true",
                    help="also the gaps of a bfloat16 reference (served cells)")
    ap.add_argument("--scale-k", action="store_true",
                    help="K rows scaled as the indexer keys (served cells)")
    args = ap.parse_args(argv)
    control_false = True
    for seed in args.seeds:
        line = one(args.workload, seed, args.seconds, seed in args.control,
                   args.witness, args.scale_k)
        if "control" in line:
            control_false &= line["control"]["correct"] is False
        print(json.dumps(line), flush=True)
    print(json.dumps({"controls_all_incorrect": control_false}), flush=True)
    return 0 if control_false else 1


if __name__ == "__main__":
    sys.exit(main())
