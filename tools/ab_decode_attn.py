#!/usr/bin/env python3
"""Time kernels B3 (paged sparse decode attention), B4 (paged dense
decode attention), B1 (GVR Top-K), the scoring launches of B2 (paged
indexer scoring) and B5 (contiguous indexer scoring), B1 in the regimes of
`tools/gvr_regimes.py` and B9's chain, B6, B8 and B10 (page-granular
sparse attention) in the shapes of `tools/sweep_pg_split.py`, and one B=4
DSA decode step, of two checkouts of the PyTorch port on one card, and
compare the two checkouts' outputs.

    python3 tools/ab_decode_attn.py CHECKOUT_A CHECKOUT_B

Runs A, B, B, A, each in a process of its own (the two packages share the
name `repro_torch`), and prints one line per run:

    AB <checkout>: B3 <ms> ms (wall <ms>), B4 ..., B1 ..., B2s ..., B5s ...,
        step <ms> ms (wall <ms>)
    AB <checkout> gvr: B1[kernel-mix] <ms> ms (wall <ms>), ..., chain ...
    AB <checkout> attn: B6 ..., B8 ..., B10[kernel] ..., B10[long] ...,
        B10[short] ...

(a B10 launch the checkout refuses is printed as its error), then, from
the first A and the first B run, one `AB bits` line per regime and for
the chain: whether values, indices and each of the 8 stats columns agree
bit for bit (where column 1, the refine's pass count, differs, both are
printed); one `AB bits attn` line: whether B3, B4, B6 and B8 wrote the
same outputs bit for bit, and B10's largest difference in each shape;
and an `AB bits verdict` line.

Each kernel is built from the checkout's own sources into its
`build/kernels/`. Shapes are those of `chip_smoke.py`'s kernel phase:
B=4, N=8192, page 64, K=2048, llama3.2-1b widths (32 query heads, 8 KV
heads, head_dim 64), bf16 pools through a shuffled block table. B3 attends
over K random distinct rows per slot at lengths 8192, 5000, 1000 and 3001;
B4 over every slot's whole extent (N rows). B1 selects K of N normal
scores per slot warm-started from the Top-K of a perturbed copy (C =
6144). B2s scores the 64 indexer heads of width 128 (bf16) over the
pages of an indexer pool through the same table at the same lengths as
B3; B5s the same keys copied into a contiguous (B, N, 128) cache. A time
is the median over 50 calls of the call's device time alone
(torch.profiler, `chip_smoke.time_ms` of this script's own checkout, so
both checkouts are timed by one method), with the L2 flushed before each
call; "wall" is the median CUDA-event window around each call. B6
attends over B3's rows copied into contiguous caches; B8 over Q=3 query
rows per slot (each slot's table shared, lengths L+1..L+3 capped at N,
each row its own K random rows). The step
is `serve_step_paged` of llama3.2-1b at full width (random weights, seed
0) from `chip_smoke.py`'s [step] state (lengths 5000, 2300, 700, 8000,
max_len 8192): its device time is the sum of a step's device events
(`chip_smoke._profile_step`, L2 flushed before each profiled step), its
wall the host time per step. Compare two checkouts only within one run
of this script: cards and machines differ.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np

# this script's checkout, for chip_smoke.time_ms and the B1 regimes
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
from gvr_regimes import CMAX, REGIMES, chain_inputs, regime_inputs  # noqa: E402

OUT = REPO / "build" / "ab"            # each run's B1 and chain outputs
B, N, PS, K, H, KVH, HD = 4, 8192, 64, 2048, 32, 8, 64
HI, DI = 64, 128                  # indexer heads and dim
SPARSE_LENGTHS = (8192, 5000, 1000, 3001)


def child(root: Path, out: Path) -> None:
    """Time B3, B4, B1, B2's and B5's scoring, B1's regimes, B9's chain
    and the step of the checkout at `root`, print the AB lines, and save
    the B1 and chain outputs to `out`."""
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(root / "src"))
    from chip_smoke import STEP_LENGTHS, _profile_step, _random_step_state, time_ms
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    mp = N // PS
    table = torch.randperm(B * mp, generator=g, device=dev).int().reshape(B, mp)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    k_pages, v_pages = rnd(B * mp, PS, KVH, HD), rnd(B * mp, PS, KVH, HD)
    q = rnd(B, H, HD)
    idx = torch.stack([torch.randperm(N, generator=g, device=dev)[:K].sort().values
                       for _ in range(B)]).int().contiguous()
    sparse_len = torch.tensor(SPARSE_LENGTHS, dtype=torch.int32, device=dev)
    full_len = torch.full((B,), N, dtype=torch.int32, device=dev)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device=dev)
    b3 = time_ms(lambda: ops.paged_sparse_decode_attn(
        q, k_pages, v_pages, table, idx, sparse_len), flush, iters=50)
    b4 = time_ms(lambda: ops.paged_dense_decode_attn(
        q, k_pages, v_pages, table, full_len), flush, iters=50)
    scores = torch.randn((B, N), generator=g, device=dev)
    noisy = scores + 0.01 * torch.randn((B, N), generator=g, device=dev)
    prev = torch.topk(noisy, K, dim=-1).indices.sort(-1).values.int().contiguous()
    b1 = time_ms(lambda: ops.gvr_topk(scores, prev, K, max_candidates=6144),
                 flush, iters=50)
    idx_pages = rnd(B * mp, PS, DI)
    qi = rnd(B, HI, DI)
    wi = torch.full((HI,), 1.0 / HI, device=dev)
    kci = idx_pages[table.long()].reshape(B, N, DI).contiguous()
    b2s = time_ms(lambda: ops.paged_indexer_scores(qi, idx_pages, wi, table,
                                                   sparse_len), flush, iters=50)
    b5s = time_ms(lambda: ops.indexer_scores(qi, kci, wi, sparse_len), flush,
                  iters=50)
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg)
    params = model.init_params(seed=0)
    st = _random_step_state(model, torch.Generator(device=dev).manual_seed(99),
                            dev, STEP_LENGTHS)
    tokens = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab, (B,)),
                          dtype=torch.int32, device=dev)
    step = _profile_step(params, st, tokens, cfg, flush)
    dev_ms = ("not measured" if step["device_ms"] is None
              else f"{step['device_ms']:.5f} ms")
    print(f"AB {root}: " + ", ".join(
        f"{key} {v['ms']:.5f} ms (wall {v['wall_ms']:.5f})"
        for key, v in (("B3", b3), ("B4", b4), ("B1", b1), ("B2s", b2s),
                       ("B5s", b5s)))
        + f", step {dev_ms} (wall {step['wall_ms']:.5f})", flush=True)
    outs, cells = {}, []
    for name in REGIMES:
        x, pr = regime_inputs(name, dev)
        outs[name] = [t.cpu() for t in ops.gvr_topk(x, pr, K, max_candidates=CMAX)]
        t = time_ms(lambda: ops.gvr_topk(x, pr, K, max_candidates=CMAX), flush,
                    iters=50)
        cells.append(f"B1[{name}] {t['ms']:.5f} ms (wall {t['wall_ms']:.5f})")
    xq, pq = chain_inputs(dev)
    outs["chain"] = [t.cpu() for t in ops.gvr_topk_chain(xq, pq, K, max_candidates=CMAX)]
    t = time_ms(lambda: ops.gvr_topk_chain(xq, pq, K, max_candidates=CMAX), flush,
                iters=50)
    cells.append(f"chain {t['ms']:.5f} ms (wall {t['wall_ms']:.5f})")
    print(f"AB {root} gvr: " + ", ".join(cells), flush=True)
    outs["attn"] = attn_cells(ops, time_ms, flush, dev, g, q, k_pages, v_pages,
                              table, idx, sparse_len, full_len, root)
    torch.save(outs, out)


def attn_cells(ops, time_ms, flush, dev, g, q, k_pages, v_pages, table, idx,
               sparse_len, full_len, root):
    """Time B6, B8 and B10 (three shapes), print the `AB ... attn` line and
    return the outputs of B3, B4, B6, B8 and B10 on the CPU."""
    import torch
    from sweep_pg_split import PG_SHAPES, pg_inputs
    kc = k_pages[table.long()].reshape(B, N, KVH, HD).contiguous()
    vc = v_pages[table.long()].reshape(B, N, KVH, HD).contiguous()
    q8 = torch.randn((B, 3, H, HD), generator=g, device=dev).bfloat16()
    l8 = torch.clamp(sparse_len[:, None] + torch.arange(1, 4, device=dev),
                     max=N).int().contiguous()
    idx8 = torch.stack([torch.stack([torch.randperm(N, generator=g, device=dev)[:K]
                                     for _ in range(3)]) for _ in range(B)]).int()
    calls = {
        "B3": lambda: ops.paged_sparse_decode_attn(q, k_pages, v_pages, table,
                                                   idx, sparse_len),
        "B4": lambda: ops.paged_dense_decode_attn(q, k_pages, v_pages, table,
                                                  full_len),
        "B6": lambda: ops.sparse_decode_attn(q, kc, vc, idx, sparse_len),
        "B8": lambda: ops.paged_sparse_decode_attn_mq(q8, k_pages, v_pages, table,
                                                      idx8.contiguous(), l8),
    }
    for shape in PG_SHAPES:
        a = pg_inputs(shape, dev)
        calls[f"B10[{shape}]"] = lambda a=a: ops.paged_sparse_decode_attn_pg(*a)
    outs, cells = {}, []
    for name, fn in calls.items():
        try:
            outs[name] = fn().cpu()
        except RuntimeError as e:          # the parent's B10 past ~97.5K positions
            outs[name] = None
            cells.append(f"{name} launch error ({e})")
            continue
        if name in ("B6", "B8") or name.startswith("B10"):
            t = time_ms(fn, flush, iters=50)
            cells.append(f"{name} {t['ms']:.5f} ms (wall {t['wall_ms']:.5f})")
    print(f"AB {root} attn: " + ", ".join(cells), flush=True)
    return outs


def compare_bits(a: Path, b: Path) -> bool:
    """Print whether two runs' B1 and chain outputs agree bit for bit."""
    import torch
    oa, ob = torch.load(a), torch.load(b)
    attn_a, attn_b = oa.pop("attn"), ob.pop("attn")
    cells = []
    ok = True
    for key, xa in attn_a.items():
        xb = attn_b[key]
        if key.startswith("B10"):
            cells.append(f"{key} max|diff| " + (
                "n/a (a launch error)" if xa is None or xb is None
                else f"{float((xa - xb).abs().max()):.3e}"))
        else:
            same = torch.equal(xa, xb)
            ok &= same
            cells.append(f"{key} equal {same}")
    print("AB bits attn: " + ", ".join(cells), flush=True)
    for key in oa:
        (va, ia, sa), (vb, ib, sb) = oa[key], ob[key]
        cols = [bool(torch.equal(sa[..., c], sb[..., c])) for c in range(8)]
        same = torch.equal(va, vb) and torch.equal(ia, ib)
        ok &= same and all(cols[:1] + cols[2:])
        extra = ("" if cols[1] else f" (column 1: {sa[..., 1].flatten().tolist()} "
                 f"vs {sb[..., 1].flatten().tolist()})")
        print(f"AB bits {key}: values and indices equal {same}; stats columns "
              f"equal {cols}{extra}", flush=True)
    print(f"AB bits verdict: {'equal' if ok else 'DIFFER'} (column 1 exempt)",
          flush=True)
    return ok


def main(argv) -> int:
    if len(argv) == 4 and argv[1] == "--child":
        child(Path(argv[2]).resolve(), Path(argv[3]))
        return 0
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    a, b = (Path(p).resolve() for p in argv[1:])
    OUT.mkdir(parents=True, exist_ok=True)
    saved = []
    for i, root in enumerate((a, b, b, a)):
        dest = OUT / f"run{i}.pt"
        out = subprocess.run([sys.executable, __file__, "--child", str(root),
                              str(dest)], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        print(out.stdout.strip(), flush=True)
        saved.append(dest)
    return 0 if compare_bits(saved[0], saved[1]) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
