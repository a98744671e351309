"""Quickstart of the PyTorch port: GVR exact Top-K on synthetic decode
scores, against radix select and torch.topk, then kernel B1 on the card.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] \
        [--n 65536] [--k 2048]

It runs on the GPU unless `--device cpu` is given (then B1's wrapper runs
its plain version), and raises without one.
"""
import argparse

import torch

from repro_torch.core import (exact_topk, generate_indexer_scores, gvr_topk,
                              radix_select_topk)
from repro_torch.kernels import ops
from repro_torch.models.api import resolve_device


def _same_values(a, b) -> bool:
    return torch.equal(torch.sort(a.reshape(-1)).values,
                       torch.sort(b.reshape(-1)).values)


def run(scores, pre_idx, k: int, device) -> dict:
    """GVR (`core.gvr_topk`), radix select and B1 (`kernels.ops.gvr_topk`)
    on one score row (N,) warm-started from pre_idx (M,), each held
    against `exact_topk`; returns their statistics and verdicts."""
    scores = scores.to(device).float().contiguous()
    pre_idx = pre_idx.to(device).int().contiguous()
    res = gvr_topk(scores, pre_idx, k)
    v_radix, _, rstats = radix_select_topk(scores[None], k)
    v_ref, _ = exact_topk(scores[None], k)
    v, _, st = ops.gvr_topk(scores[None], pre_idx[None], k)
    return {"secant_iters": int(res.stats.secant_iters),
            "hist_levels": int(res.stats.hist_levels),
            "snap_iters": int(res.stats.snap_iters),
            "cand_count": int(res.stats.cand_count),
            "radix_passes": int(rstats.passes[0]),
            "gvr_exact": _same_values(res.values, v_ref),
            "radix_exact": _same_values(v_radix, v_ref),
            "kernel_exact": _same_values(v, v_ref),
            "kernel_stats": [float(x) for x in st[0].cpu()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--k", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # synthetic DSA indexer scores (random Q/K + YaRN-RoPE) and the static
    # structural prior as the prediction signal (the paper's Appendix E)
    scores, pre_idx = generate_indexer_scores(
        torch.Generator(device=dev).manual_seed(0), args.n, args.k)
    r = run(scores, pre_idx, args.k, dev)
    print(f"GVR:   secant iters I={r['secant_iters']}, "
          f"hist levels={r['hist_levels']}, snap iters S={r['snap_iters']}, "
          f"candidates={r['cand_count']} (C={3 * args.k})")
    print(f"radix: passes R={r['radix_passes']} (x2 row scans each)")
    assert r["gvr_exact"] and r["radix_exact"], r
    print("both methods EXACT vs torch.topk  ✓")
    assert r["kernel_exact"], r
    where = "on the card" if dev.type == "cuda" else "plain version on the CPU"
    st = r["kernel_stats"]
    print(f"kernel B1 ({where}) EXACT ✓  (I={int(st[0])}, "
          f"refine={int(st[1])})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
