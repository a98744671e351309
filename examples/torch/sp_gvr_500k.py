"""SP-GVR in the PyTorch port: the exact Top-K of a sequence-sharded score
row over S ranks, the long-context decode primitive.

    PYTHONPATH=src python examples/torch/sp_gvr_500k.py [--device cpu] \
        [--shards 8] [--n 262144] [--k 2048]

The S ranks are processes (`torch.multiprocessing`) in one gloo group;
on the GPU they share the one card (`launch.make_seq_mesh`), on the CPU
with `--device cpu`. Without a GPU and without `--device cpu` it raises.
Each rank holds its contiguous slice of the row; the result is checked
exact against `exact_topk` on the whole row.
"""
import argparse
import json
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

from repro_torch.core import exact_topk, sp_gvr_topk
from repro_torch.launch import init_seq_group, make_seq_mesh
from repro_torch.models.api import resolve_device


def _inputs(n: int, k: int):
    """The row (1, N) and a drifted copy's Top-K as the prediction."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, n)).astype(np.float32)
    drift = x + 0.05 * rng.normal(size=(1, n))
    prev = np.argsort(-drift, -1)[:, :k].astype(np.int32)
    return torch.from_numpy(x), torch.from_numpy(prev)


def _rank(rank, world, init, device, n, k, out_dir):
    torch.set_num_threads(1)
    init_seq_group(rank, world, init_method=init, backend="gloo",
                   timeout_s=300)
    mesh = make_seq_mesh(world, backend="gloo",
                         device=None if device == "cuda" else device)
    x, prev = _inputs(n, k)
    x, prev = x.to(mesh.device), prev.to(mesh.device)
    idx, _, iters = sp_gvr_topk(x, prev, k, mesh)
    if rank == 0:
        got = torch.sort(x.gather(1, idx.long()), -1).values
        want = torch.sort(exact_topk(x, k)[0], -1).values
        with open(os.path.join(out_dir, "rank0.json"), "w") as f:
            json.dump({"exact": bool(torch.equal(got, want)),
                       "secant_iters": int(iters.max()),
                       "bill": mesh.bill(), "device": str(mesh.device)}, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--n", type=int, default=262144)
    ap.add_argument("--k", type=int, default=2048)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    tmp = tempfile.mkdtemp(prefix="sp_gvr_")
    try:
        mp.spawn(_rank, args=(args.shards, f"file://{tmp}/rdv", dev.type,
                              args.n, args.k, tmp),
                 nprocs=args.shards, join=True)
        with open(os.path.join(tmp, "rank0.json")) as f:
            res = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert res["exact"], res
    print(f"SP-GVR exact over {args.shards} sequence shards "
          f"({res['device']}) ✓")
    print(f"secant iterations (scalar psums): {res['secant_iters']}")
    print(f"collective bill of rank 0 (calls, bytes by tag): {res['bill']}")
    return res


if __name__ == "__main__":
    main()
