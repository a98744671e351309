#!/usr/bin/env python3
"""On-card run of the PyTorch/CUDA port (src/repro_torch) on one H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is swallowed):
  1. build   — compile kernels B1–B4 from src/repro_torch/kernels/csrc with
               nvcc for sm_90a (one nvcc per source, all started together);
  2. kernels — hold each kernel against its plain PyTorch version on the
               card at the main path's shapes (B=4, N=8192, K=2048,
               llama3.2-1b widths), edge cases included, and time kernel,
               plain version and (B1) the library call with CUDA events;
  3. main    — serve requests through `DecodeEngine` (paged, fused, greedy)
               at the full width of llama3.2-1b, max_len=8192, 4 slots;
               the launch counts are zeroed just before and read just after;
  4. step    — one `serve_step_paged` from the same state on the card and
               through the plain path on the CPU: logits and per-layer Top-K;
  5. dense   — a second engine at max_len=4096 <= dsa.min_n, the dense
               pre-DSA fallback (kernel B4), counted the same way;
  6. summary — the `kernels` JSON line, the card's name and power limit,
               and the contract line `{"ok": true, "device": {...}}` last.

Weights are random (seeded), so nothing is downloaded. The script needs the
repository's `src/` beside it and a CUDA device; without either it exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------- timing ------

def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed before every call (the main path finds the pools
    cold: a step streams ~3 GB of weights between two layers' kernels)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for s, e in ev:
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: bytes over HBM rate vs bf16 flops
    over the tensor-core peak; returns (ms, which)."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ------------------------------------------------------------- phases ------

def phase_build():
    from repro_torch.kernels.build import LIBRARIES
    logs = LIBRARIES.build_all()
    (LIBRARIES.build_dir / "chip_smoke_build.log").write_text(
        "\n".join(f"--- {k} ---\n{v}" for k, v in logs.items()))
    for name, text in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {name}.cu: {len(regs)} instantiations, registers "
            f"{min(regs, default=0)}-{max(regs, default=0)}, spill stores "
            f"{spills} bytes in all (full report: build/kernels/chip_smoke_build.log)")
    log(f"[build] nvcc sm_90a, {len(logs)} sources built in "
        f"{LIBRARIES.build_seconds:.3f} s")


def _paged_inputs(g, dev, *, b, mp, ps, lengths, kvh, hd, h, di, hi):
    """Random bf16 pools and a shuffled block table; pages past each slot's
    extent stay unmapped (-1)."""
    import torch
    p = b * mp
    perm = torch.randperm(p, generator=g, device=dev).int().reshape(b, mp)
    need = torch.tensor([-(-int(L) // ps) for L in lengths], device=dev)
    table = torch.where(torch.arange(mp, device=dev)[None] < need[:, None],
                        perm, torch.full_like(perm, -1)).contiguous()
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    return dict(
        table=table,
        lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
        k_pages=rnd(p, ps, kvh, hd), v_pages=rnd(p, ps, kvh, hd),
        idx_pages=rnd(p, ps, di), q=rnd(b, h, hd), qi=rnd(b, hi, di),
        w=torch.full((hi,), 1.0 / hi, device=dev))


def phase_kernels(cfg, flush):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    b, n, k, ps = 4, 8192, cfg.dsa.k, 64
    mp = n // ps
    cmax = cfg.dsa.max_candidates
    # slot 2 is shorter than K (NEG ties: the full-row refine path)
    lengths = [8192, 5000, 1000, 3001]
    inp = _paged_inputs(g, dev, b=b, mp=mp, ps=ps, lengths=lengths,
                        kvh=cfg.n_kv_heads, hd=cfg.hd, h=cfg.n_heads,
                        di=cfg.dsa.indexer_dim, hi=cfg.dsa.indexer_heads)
    table, ln = inp["table"], inp["lengths"]
    results = {}

    # ---- B2 scoring stage: kernel vs plain score row --------------------
    s_ker = ops.paged_indexer_scores(inp["qi"], inp["idx_pages"], inp["w"],
                                     table, ln)
    s_ref = ref.paged_indexer_scores_ref(inp["qi"], inp["idx_pages"],
                                         inp["w"], table, ln)
    torch.cuda.synchronize()
    live = s_ref > -1e38
    if not torch.equal(live, s_ker > -1e38):
        fail("B2 scoring: NEG mask (length / unmapped pages) differs")
    # tolerance: bf16 products are exact in f32; the kernel sums 128 of them
    # per head and 64 heads in another order than the einsum, so the two
    # f32 rows differ by a few ulps of the partial sums (~1e-6 relative);
    # 1e-4 of the row's scale leaves a 100x margin
    s_err = float((s_ker - s_ref)[live].abs().max())
    s_scale = float(s_ref[live].abs().max())
    if s_err > 1e-4 * s_scale:
        fail(f"B2 scoring: max |err| {s_err} > 1e-4 * {s_scale}")

    # predictions: slot 0 warm (Top-K of a perturbed row), slot 1 random,
    # slot 2 a recycled slot (-1), slot 3 the even-spacing seed
    noisy = s_ref + 0.01 * s_scale * torch.randn(s_ref.shape, generator=g, device=dev)
    warm = ref.gvr_topk_ref(noisy, torch.zeros((b, k), dtype=torch.int32, device=dev), k)[1]
    prev = torch.stack([
        warm[0],
        torch.randint(0, n, (k,), generator=g, device=dev).int(),
        torch.full((k,), -1, dtype=torch.int32, device=dev),
        torch.linspace(0, lengths[3] - 1, k, device=dev).int()]).contiguous()

    # ---- B1: exact Top-K, identical indices and values ------------------
    def check_b1(scores, pr, tag):
        v1, i1, st1 = ops.gvr_topk(scores, pr, k, max_candidates=cmax)
        v0, i0, st0 = ref.gvr_topk_ref(scores, pr, k, max_candidates=cmax)
        torch.cuda.synchronize()
        if not (torch.equal(i1, i0) and torch.equal(v1, v0)):
            bad = (i1 != i0).any(-1).nonzero().flatten().tolist()
            fail(f"B1 {tag}: Top-K differs from the plain version (rows {bad})")
        if not torch.equal(st1[:, 4:], st0[:, 4:]):
            fail(f"B1 {tag}: threshold / n_gt / n_ge / emitted differ: "
                 f"{st1[:, 4:].tolist()} vs {st0[:, 4:].tolist()}")
        return st1

    st = check_b1(s_ref, prev, "main")
    log(f"[kernels] B1 exact; per-row [secant, refine, cand, full-row] = "
        f"{st[:, :4].int().tolist()}")
    # fewer predictions than K (row-extrema bracket), and predictions past N
    few = prev[:, :512].contiguous()
    oob = prev.clone()
    oob[1, :100] = n + 7
    check_b1(s_ref, few, "M<K")
    check_b1(s_ref, oob, "prev>=N")

    # ---- B2 whole (scoring + B1) vs the plain pipeline -------------------
    v2, i2, _ = ops.paged_indexer_topk(inp["qi"], inp["idx_pages"], inp["w"],
                                       table, prev, k, lengths=ln,
                                       max_candidates=cmax)
    v2r, i2r, _ = ref.gvr_topk_ref(s_ker, prev, k, max_candidates=cmax)
    torch.cuda.synchronize()
    if not (torch.equal(i2, i2r) and torch.equal(v2, v2r)):
        fail("B2: selection differs from the plain Top-K of its own score row")
    _, i_plain, _ = ref.gvr_topk_ref(s_ref, prev, k, max_candidates=cmax)
    agree = [len(set(a.tolist()) & set(c.tolist())) / k
             for a, c in zip(i2, i_plain)]
    log(f"[kernels] B2 scores max|err| {s_err:.3e} (scale {s_scale:.3e}); "
        f"selection exact on its row; Top-K agreement with the plain "
        f"pipeline per slot {agree}")

    # ---- B3: sparse attention over the selected rows --------------------
    idx = i2.clone()
    idx[1, :16] = -1                       # -1 padding entries
    idx[0, 16:32] = lengths[0] - 1         # duplicates are legal entries
    args3 = (inp["q"], inp["k_pages"], inp["v_pages"], table, idx, ln)
    o3 = ops.paged_sparse_decode_attn(*args3)
    o3r = ref.paged_sparse_attn_ref(*args3)
    torch.cuda.synchronize()
    # tolerance: bf16 inputs upcast exactly; f32 softmax and PV sums over
    # <= 2048 rows in another order (16 warp partials merged at the end)
    # and expf vs torch.exp: ~1e-6 relative; atol = rtol = 1e-4
    e3 = float((o3 - o3r).abs().max())
    if not torch.allclose(o3, o3r, atol=1e-4, rtol=1e-4):
        fail(f"B3: max |err| {e3} beyond atol=rtol=1e-4")
    valid3 = ((idx >= 0) & (idx < ln[:, None])).sum(-1)
    log(f"[kernels] B3 allclose, max|err| {e3:.3e}; valid rows per slot "
        f"{valid3.tolist()} (slot 2: idx >= length masked)")

    # ---- B4: dense attention over the causal extent ----------------------
    mp4 = 4096 // ps
    lengths4 = [4096, 2500, 1, 777]
    inp4 = _paged_inputs(g, dev, b=b, mp=mp4, ps=ps, lengths=lengths4,
                         kvh=cfg.n_kv_heads, hd=cfg.hd, h=cfg.n_heads,
                         di=cfg.dsa.indexer_dim, hi=cfg.dsa.indexer_heads)
    args4 = (inp4["q"], inp4["k_pages"], inp4["v_pages"], inp4["table"],
             inp4["lengths"])
    o4 = ops.paged_dense_decode_attn(*args4)
    o4r = ref.paged_dense_attn_ref(*args4)
    o4w = ops.paged_dense_decode_attn(*args4, window=300)
    o4wr = ref.paged_dense_attn_ref(*args4, window=300)
    torch.cuda.synchronize()
    e4 = max(float((o4 - o4r).abs().max()), float((o4w - o4wr).abs().max()))
    if not (torch.allclose(o4, o4r, atol=1e-4, rtol=1e-4)
            and torch.allclose(o4w, o4wr, atol=1e-4, rtol=1e-4)):
        fail(f"B4: max |err| {e4} beyond atol=rtol=1e-4 (same reasoning as B3)")
    log(f"[kernels] B4 allclose (window None and 300), max|err| {e4:.3e}")

    # ---- times ------------------------------------------------------------
    hi, di = cfg.dsa.indexer_heads, cfg.dsa.indexer_dim
    kvh, hd, h = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    t = {
        "B1": (time_ms(lambda: ops.gvr_topk(s_ref, prev, k, max_candidates=cmax), flush),
               time_ms(lambda: ref.gvr_topk_ref(s_ref, prev, k, max_candidates=cmax), flush, iters=5),
               time_ms(lambda: torch.topk(s_ref, k, dim=-1), flush)),
        "B2": (time_ms(lambda: ops.paged_indexer_topk(inp["qi"], inp["idx_pages"], inp["w"], table, prev, k, lengths=ln, max_candidates=cmax), flush),
               time_ms(lambda: ref.gvr_topk_ref(ref.paged_indexer_scores_ref(inp["qi"], inp["idx_pages"], inp["w"], table, ln), prev, k, max_candidates=cmax), flush, iters=5),
               None),
        "B3": (time_ms(lambda: ops.paged_sparse_decode_attn(*args3), flush),
               time_ms(lambda: ref.paged_sparse_attn_ref(*args3), flush), None),
        "B4": (time_ms(lambda: ops.paged_dense_decode_attn(*args4), flush),
               time_ms(lambda: ref.paged_dense_attn_ref(*args4), flush), None),
    }
    # bounds from this run's inputs: each input read once, each output once
    pages_read = sum(-(-L // ps) for L in lengths)
    b1_bytes = b * n * 4 + prev.numel() * 4 + b * k * 8 + b * 32
    b2_bytes = (inp["qi"].numel() * 2 + pages_read * ps * di * 2 + hi * 4
                + table.numel() * 4 + b * 4 + prev.numel() * 4 + b * k * 8 + b * 32)
    b2_flops = 2 * hi * di * sum(lengths)
    rows3 = int(valid3.sum())
    b3_bytes = (inp["q"].numel() * 2 + rows3 * kvh * hd * 2 * 2 + idx.numel() * 4
                + table.numel() * 4 + b * 4 + b * h * hd * 4)
    b4_rows = sum(lengths4)
    b4_bytes = (inp4["q"].numel() * 2 + b4_rows * kvh * hd * 2 * 2
                + inp4["table"].numel() * 4 + b * 4 + b * h * hd * 4)
    results["B1"] = dict(err=0.0, bound=bound_ms(b1_bytes, 0))
    results["B2"] = dict(err=s_err, bound=bound_ms(b2_bytes, b2_flops))
    results["B3"] = dict(err=e3, bound=bound_ms(b3_bytes, 4 * h * hd * rows3))
    results["B4"] = dict(err=e4, bound=bound_ms(b4_bytes, 4 * h * hd * b4_rows))
    for key, (ms, plain, lib) in t.items():
        results[key].update(ms=ms, plain_ms=plain, library_ms=lib)
        log(f"[kernels] {key}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"library {lib if lib is None else f'{lib:.4f} ms'}, bound "
            f"{results[key]['bound'][0]:.4f} ms ({results[key]['bound'][1]})")
    return results


def _engine_run(model, params, *, max_len, specs, page_size=64):
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import DecodeEngine, Request
    eng = DecodeEngine(model, params, num_slots=4, max_len=max_len,
                       page_size=page_size, prefill_chunk=64,
                       kv_layout="paged", paged_attn="fused")
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(specs)]
    ops.reset_launch_counts()
    rep = eng.run(reqs, max_ticks=5000)
    counts = ops.launch_counts()
    vocab = model.cfg.vocab
    if rep.completed != len(reqs):
        fail(f"engine completed {rep.completed} of {len(reqs)} requests")
    for r in reqs:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or toks.min() < 0 or toks.max() >= vocab:
            fail(f"request {r.uid}: generated {r.generated}")
    return eng, reqs, rep, counts


def _paths(eng, reqs):
    return {r.uid: "".join(m[0].upper() for _, _, m in eng.method_log[r.uid])
            for r in reqs}


def phase_main(model, params, rng):
    """The main path: paged, fused, greedy engine at full width."""
    vocab = model.cfg.vocab
    shared = rng.integers(0, vocab, (192,))
    specs = [
        (rng.integers(0, vocab, (2300,)), 16, 0),      # > K: GVR's buffer path
        (rng.integers(0, vocab, (40,)), 16, 0),
        (np.concatenate([shared, rng.integers(0, vocab, (20,))]), 16, 0),
        (rng.integers(0, vocab, (300,)), 16, 1),
        (np.concatenate([shared, rng.integers(0, vocab, (9,))]), 16, 12),  # prefix reuse
    ]
    eng, reqs, rep, counts = _engine_run(model, params, max_len=8192, specs=specs)
    paths = _paths(eng, reqs)
    log(f"[main] llama3.2-1b full width, max_len 8192, 4 slots, "
        f"{len(reqs)} requests: {rep.decoded_tokens} decoded + "
        f"{rep.prefill_tokens} prefill tokens in {rep.ticks} ticks, "
        f"{rep.wall_s:.3f} s wall, {rep.tokens_per_s:.2f} decoded tokens/s, "
        f"gvr_hit_rate {rep.gvr_hit_rate:.4f}, prefix_hit_tokens "
        f"{rep.prefix_hit_tokens}")
    steps = counts["gvr_topk"] // model.cfg.n_layers
    log(f"[main] {steps} model steps (batch-1 prefill + pool decode), "
        f"{rep.wall_s / max(steps, 1) * 1e3:.3f} ms host wall per step")
    log(f"[main] selector path per request (R radix/cold, G gvr): {paths}")
    log(f"[main] launches: {counts}")
    for name in ("gvr_topk", "paged_indexer_scores", "paged_sparse_decode_attn"):
        if counts[name] == 0:
            fail(f"main path never launched {name}")
    for r in reqs:
        p = paths[r.uid]
        if not (p[0] == "R" and set(p[1:]) <= {"G"} and "G" in p):
            fail(f"request {r.uid}: cold→warm dispatch not R then G: {p}")
    return counts


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _profile_step(params, st, tokens, cfg):
    """Host wall time of one B=4 DSA decode step and, from torch.profiler,
    the device time of its kernels: the device's busy and idle share. The
    step rewrites the same cache rows each call (its new state is
    dropped), so repeated calls see the same inputs."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    for _ in range(2):
        transformer.serve_step_paged(params, st, tokens, cfg)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        transformer.serve_step_paged(params, st, tokens, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            transformer.serve_step_paged(params, st, tokens, cfg)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies): the operator entries of
    # key_averages() carry their kernels' time too and would count it twice
    dev = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev[e.name] = dev.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    if not dev:
        log(f"[step] B=4 DSA decode step: {step_ms:.3f} ms host wall; device "
            f"time not measured (the profiler saw no CUDA kernels)")
        return
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    log(f"[step] B=4 DSA decode step: {step_ms:.3f} ms host wall, {busy:.3f} ms "
        f"device busy ({busy / step_ms:.3f} busy share); top device time "
        f"per step (ms): " + ", ".join(f"{k[:48]}={v:.4f}" for k, v in top))


def phase_step(model, params, rng):
    """One serve_step_paged on the card and through the plain path on the
    CPU, from the same state."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.models.layers import rms_norm
    from repro_torch.sparse import dsa
    cfg = model.cfg
    dev = torch.device("cuda")
    b, max_len, ps = 4, 8192, 64
    mp = max_len // ps
    g = torch.Generator(device=dev).manual_seed(99)
    lengths = [5000, 2300, 700, 8000]
    st = model.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        st[key].copy_(torch.randn(st[key].shape, generator=g, device=dev))
    perm = torch.randperm(b * mp, generator=g, device=dev).int().reshape(b, mp)
    st["page_table"] = perm.contiguous()
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kk = st["prev_topk"].shape[-1]
    st["prev_topk"] = torch.stack([
        torch.randint(0, L, (cfg.n_layers, kk), generator=g, device=dev)
        for L in lengths], dim=1).int()
    st["topk_valid"] = torch.tensor([True, True, False, True], device=dev
                                    ).expand(cfg.n_layers, b).contiguous()
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (b,)), dtype=torch.int32,
                          device=dev)
    cpu_state = {k: v.cpu().clone() for k, v in st.items()}
    cpu_params = _to_cpu(params)
    logits_gpu, new_gpu = transformer.serve_step_paged(params, st, tokens, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_cpu, new_cpu = transformer.serve_step_paged(cpu_params, cpu_state,
                                                       tokens.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    lg, lc = logits_gpu.cpu(), logits_cpu
    if not (torch.isfinite(lg).all() and lg.shape == (b, cfg.vocab)):
        fail("step: logits not finite or of the wrong shape")
    # tolerance: the two devices run the same bf16 model with different
    # matmul kernels (cuBLAS vs oneDNN, both f32-accumulating, rounding to
    # bf16 at every layer boundary): ~2^-8 relative per rounding, compounded
    # over 16 layers; relative L2 error of the logits <= 5e-2
    rel = float((lg - lc).norm() / lc.norm())
    argmax_agree = float((lg.argmax(-1) == lc.argmax(-1)).float().mean())
    if rel > 5e-2:
        fail(f"step: logits relative L2 error {rel} > 5e-2")
    agree = []
    flips = []
    for layer in range(cfg.n_layers):
        a = new_gpu["prev_topk"][layer].cpu()
        c = new_cpu["prev_topk"][layer]
        agree.append(round(sum(len(set(x.tolist()) & set(y.tolist()))
                               for x, y in zip(a, c)) / a.numel(), 5))
    # near-tie flips of layer 0 (its input, the embedding, is identical):
    # each entry in one Top-K but not the other, with its plain score minus
    # the plain K-th score
    lay0 = transformer.layer_params(cpu_params["layers"], 0)
    h0 = rms_norm(cpu_params["embed"][tokens.cpu().long()], lay0["ln1"])
    q0 = dsa.indexer_q(lay0["indexer"], h0, cpu_state["length"], heads=cfg.dsa.indexer_heads,
                       dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base,
                       dtype=cpu_state["idx_k_pages"].dtype)
    s0 = ref.paged_indexer_scores_ref(q0, cpu_state["idx_k_pages"][0],
                                      lay0["indexer"]["w"].float(),
                                      cpu_state["page_table"], cpu_state["length"] + 1)
    for row in range(b):
        a = set(new_gpu["prev_topk"][0, row].cpu().tolist())
        c = set(new_cpu["prev_topk"][0, row].tolist())
        for i in sorted(a ^ c)[:4]:
            kth = float(torch.topk(s0[row], kk).values[-1])
            flips.append((row, i, float(s0[row, i]) - kth))
    _profile_step(params, st, tokens, cfg)
    log(f"[step] logits rel L2 err {rel:.3e} (argmax agreement "
        f"{argmax_agree:.2f}); CPU plain step {cpu_s:.3f} s; per-layer "
        f"Top-K agreement {agree}")
    log(f"[step] layer-0 near-tie flips (slot, index, score - kth): {flips}")
    if agree[0] < 0.99:
        fail(f"step: layer-0 Top-K agreement {agree[0]} < 0.99")


def phase_dense(model, params, rng):
    vocab = model.cfg.vocab
    specs = [(rng.integers(0, vocab, (n,)), 12, 0) for n in (500, 64, 1200, 250)]
    eng, reqs, rep, counts = _engine_run(model, params, max_len=4096, specs=specs)
    log(f"[dense] max_len 4096 <= min_n: {rep.decoded_tokens} decoded tokens "
        f"in {rep.ticks} ticks, {rep.wall_s:.3f} s; paths "
        f"{set(_paths(eng, reqs).values())}; launches: {counts}")
    if counts["paged_dense_decode_attn"] == 0:
        fail("dense fallback never launched paged_dense_decode_attn")
    return counts


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found — run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()
    log(f"[env] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    phase_build()
    cfg = get_config("llama3.2-1b")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    kres = phase_kernels(cfg, flush)

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"[main] params {cfg.param_count() / 1e9:.3f} B (approx), bf16, "
        f"random init in {time.perf_counter() - t0:.3f} s")
    rng = np.random.default_rng(0)
    main_counts = phase_main(model, params, rng)
    phase_step(model, params, rng)
    dense_counts = phase_dense(model, params, rng)

    rows = [("B1 gvr_topk", "gvr_topk.cu", "src/repro/kernels/gvr_topk.py:334",
             main_counts["gvr_topk"]),
            ("B2 paged_indexer_topk", "paged_indexer.cu",
             "src/repro/kernels/indexer_topk.py:246",
             main_counts["paged_indexer_scores"]),
            ("B3 paged_sparse_decode_attn", "paged_attn.cu",
             "src/repro/kernels/sparse_attn.py:272",
             main_counts["paged_sparse_decode_attn"]),
            ("B4 paged_dense_decode_attn", "paged_attn.cu",
             "src/repro/kernels/sparse_attn.py:634",
             dense_counts["paged_dense_decode_attn"])]
    kernels = []
    for (name, src_file, replaces, launches), key in zip(rows, ("B1", "B2", "B3", "B4")):
        r = kres[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src_file}",
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
    log(f"[summary] total {time.perf_counter() - t_start:.3f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
