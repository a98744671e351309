"""Serve a DSA model through the port's continuous-batching engine: ragged
requests admit mid-stream, cold slots take radix for one tick, then the
temporal feedback warm-starts GVR (the paper's Fig. 3 signal, live, across
a churning pool); then the same kind of trace on the paged layout with a
shared prompt prefix.

    PYTHONPATH=src python examples/torch/serve_longcontext.py \
        [--device cpu] [--requests 10] [--max-new 24] [--paged-slots 8]

The model is llama3.2-1b's smoke config with random weights from seed 0. It
runs on the GPU unless `--device cpu` is given, and raises without one.
"""
import argparse

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.models.api import build_model
from repro_torch.serve import DecodeEngine, Request

LETTERS = {"gvr": "G", "radix": "R", "exact": "E", "dense": "D"}


def paths(engine, requests):
    """Each request's selector path, one letter a tick."""
    return {r.uid: "".join(LETTERS[m] for _, _, m in engine.method_log[r.uid])
            for r in requests}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--paged-slots", type=int, default=8)
    args = ap.parse_args(argv)

    cfg = get_config("llama3.2-1b", smoke=True)
    model = build_model(cfg, device=args.device)
    params = model.init_params(seed=0)
    rng = np.random.default_rng(0)

    engine = DecodeEngine(model, params, num_slots=4, max_len=256,
                          prefill_chunk=16, scheduler="fifo")
    # a small trace: staggered arrivals, ragged prompt lengths
    requests = [
        Request(uid=i,
                prompt=rng.integers(0, cfg.vocab, (int(rng.integers(8, 48)),)),
                max_new_tokens=args.max_new,
                arrival=int(rng.integers(0, 20)))
        for i in range(args.requests)]
    report = engine.run(requests)
    dense_paths = paths(engine, requests)
    print(f"ticks={report.ticks}  completed={report.completed}  "
          f"decoded={report.decoded_tokens}  prefill={report.prefill_tokens}")
    print(f"tokens/s={report.tokens_per_s:.1f}  "
          f"gvr_hit_rate={report.gvr_hit_rate:.2f}  "
          f"paths={report.method_counts}")
    for r in requests[:4]:
        print(f"req {r.uid}: prompt={len(r.prompt):3d} "
              f"admitted@{r.admitted_at:3d} done@{r.finished_at:3d}  "
              f"path={dense_paths[r.uid]}")
    assert report.completed == len(requests), report
    print("serve OK — cold admissions dispatch radix for one tick, then the "
          "temporal feedback drives the GVR warm start")

    # the paged layout: twice the slots over a pool sized for 4 dense
    # slots; every request shares one long prompt prefix, stored once
    prefix = rng.integers(0, cfg.vocab, (64,))
    paged = DecodeEngine(model, params, num_slots=args.paged_slots,
                         max_len=256, prefill_chunk=16, kv_layout="paged",
                         page_size=16, num_pages=4 * 256 // 16)
    shared = [Request(uid=100 + i,
                      prompt=np.concatenate(
                          [prefix, rng.integers(0, cfg.vocab, (1 + i,))]),
                      max_new_tokens=args.max_new, arrival=6 * i)
              for i in range(args.paged_slots)]
    rep = paged.run(shared)
    paged_paths = paths(paged, shared)
    print(f"paged: completed={rep.completed}  "
          f"tokens/s={rep.tokens_per_s:.1f}  "
          f"gvr_hit_rate={rep.gvr_hit_rate:.2f}  preempt={rep.preemptions}")
    print(f"paged: {rep.prefix_hit_tokens} prompt tokens served from the "
          f"prefix cache; peak page utilization "
          f"{rep.peak_page_utilization:.0%} of half the dense budget")
    for r in shared[:4]:
        print(f"req {r.uid}: path={paged_paths[r.uid]}")
    assert rep.completed == len(shared), rep
    print("paged serve OK")
    return {"dense": (report, dense_paths), "paged": (rep, paged_paths)}


if __name__ == "__main__":
    main()
