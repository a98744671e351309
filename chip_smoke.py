#!/usr/bin/env python3
"""On-card run of the PyTorch/CUDA port (src/repro_torch) on one H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no exception is swallowed):
  1. build        — compile kernels B1–B10 from
                    src/repro_torch/kernels/csrc with nvcc for sm_90a (one
                    nvcc per source, all started together);
  2. kernels      — hold each kernel against its plain PyTorch version on
                    the card at the main path's shapes (B=4, N=8192,
                    K=2048, llama3.2-1b widths; B8/B9 with Q=3 query rows
                    per slot), edge cases included (B1 also on slot 2's
                    NEG plateau alone and on N=131072 rows, with its
                    cluster schedule printed); B5 and B6 against B2
                    and B3 bit for bit on the same rows, B8 against B3 on
                    the folded rows, B9's scores against B2's and its chain
                    against sequential B1 launches; B3/B4's split over
                    rows, B10's split over positions (also on B=4 rows of
                    N=131072) and the B2/B5 scoring body's grid (CTAs >=
                    SMs, two calls and each slot alone bit-identical); time
                    kernel, its scoring half (B2/B5/B9, against its own
                    bound), plain version and (B1, B7)
                    the library call on the device alone (torch.profiler,
                    L2 flushed before each call), with the CUDA-event
                    window around each call beside it (wall_ms);
                    B3, B4 and B6 also at moonshot-v1-16b-a3b's widths
                    (G = 1, hd 128, KVH 16); B3, B4, B6, B8 and B10 at the
                    rest of the dense family's widths (G 16, 48 and 7 as
                    head chunks of 8; G 4 at hd 120), B6 == B3 and B8 ==
                    B3 bit for bit there; B2/B5/B9 scoring and B1 under
                    h2o-danube's window of 4096; B6 at whisper-medium's
                    width (G 1, hd 64, KVH 16); [b7-ab]: B7 against
                    `index_select` on one gather, in turns A B B A;
  3. main         — serve requests through `DecodeEngine` (paged, fused,
                    greedy) at the full width of llama3.2-1b and MAIN_DEPTH
                    of its 16 layers, max_len=8192, 4 slots; every path
                    below zeroes the launch counts just before it and reads
                    them just after;
  4. dense-layout — the same trace through `DecodeEngine(kv_layout="dense")`
                    (kernels B5, B1, B6): the same tokens as [main];
  5. step         — one `serve_step_paged` from one state on the card and
                    through the plain path on the CPU: logits, per-layer
                    Top-K (run after phase 13's child processes end, so
                    that the profile has the card to itself);
  6. layouts      — one B=4 DSA step from one state in four forms (paged
                    fused, paged gather, paged page-granular, dense): fused,
                    gather and dense bit-identical; the dense form also
                    against the CPU plain path;
  7. gather, page — the paged engine with `paged_attn="gather"` (B7) and
                    with `gather_granularity="page"` (B10) on a short trace,
                    against a fused run of it (phases 3 and 4 at
                    MAIN_DEPTH layers, 7, 8 and 10 at ENGINE_DEPTH);
  8. spec         — speculative decoding at depth 2 on the short trace,
                    against the fused run's tokens: scan verify with oracle
                    drafts (B2/B1/B3), mq verify (B9/B8) with oracle drafts,
                    with every second draft wrong (the pages checked after
                    every tick) and with the default n-gram drafter;
  9. verify-step  — one full-width verify tick of B=4 slots from one state
                    through scan and mq: tokens, acceptance and the
                    rolled-back state equal; logits and Top-K compared
                    (after the child processes, as phase 5);
 10. dense        — engines at max_len=4096 <= dsa.min_n, the pre-DSA
                    fallback: paged (kernel B4) and the dense layout (plain
                    PyTorch attention);
 11. moe          — moonshot-v1-16b-a3b (the MoE family: 64 experts top-6
                    through the one-device dense fallback) at full width
                    and MOE_DEPTH of its 48 layers, bf16, after llama's
                    model is freed: four
                    greedy requests through the paged fused engine
                    (B2/B1/B3), then the dense layout (B5/B1/B6), one after
                    the other; the same tokens bit for bit;
 12. moe-step     — one B=4 DSA step of that model under torch.profiler,
                    the fallback's share of its device time, then a 2-layer
                    cut of the same weights (full width) on the card
                    against the plain path on the CPU;
 13. dense-family — h2o-danube-3-4b (SWA window 4096, hd 120) at full
                    width and FAMILY_CHILD_DEPTH of its 24 layers (full
                    depth until the training phases joined the script;
                    [dense-family-step] keeps all 24): a prompt past the window and three
                    short ones through the paged fused engine (B2/B1/B3)
                    and the dense layout (B5/B1/B6), the same tokens, in
                    two child processes started after phase 2 that run
                    beside phases 3, 4, 6-8 and 10 (each engine is
                    host-bound) and are joined before phases 5 and 9;
                    [dense-family-step]: one profiled B=4 DSA step and a
                    2-layer cut against the CPU; then chatglm3-6b,
                    qwen2-vl-7b and granite-34b at full width and a depth
                    cut to FAMILY_CUT_DEPTH layers (granite-34b's 88
                    layers do not fit one card), each through both
                    layouts and its 2-layer cut against the CPU;
 14. audio        — whisper-medium (enc-dec: 24 encoder and 24 decoder
                    layers, d_model 1024) at full width and depth, bf16,
                    through `serve_step`, the only serve path the reference
                    gives the family: four requests, one per slot, fed
                    token by token, then 16 greedy tokens each, at
                    max_len 8192 (DSA every step: B5, B1, B6), the cross
                    K/V random; `encode` timed at 1500 frames;
                    [audio-step]: one profiled B=4 step and a 2-layer cut
                    against the CPU (logits, Top-K);
 15. ssm          — rwkv6-3b (the WKV6 recurrence, no kernel: the
                    reference has none) at full width and depth, bf16: the
                    same loop, a profiled step, and a 2-layer cut stepping
                    8 times against the CPU (logits, `s`, `x_att`);
 16. hybrid       — jamba-1.5-large-398b (Mamba + attention 1:7, MoE on
                    odd layers) at full width, one superblock (JAMBA_DEPTH
                    of its 72 layers) and JAMBA_EXPERTS of its 16 experts,
                    bf16, through `serve_step`: the same loop (DSA every
                    step: B5, B1, B6); [hybrid-step]: a profiled B=4 step;
                    [hybrid-cut]: its attention layer, one Mamba layer
                    stepping 8 times and one dense FFN against the CPU;
 17. temporal     — B1 on the paper's synthetic RoPE rows (n 8192 and
                    131072) from the static and the uniform prior, equal
                    to the exact Top-K; hit ratios and global passes;
 18. sp           — sequence-sharded serving on two ranks, two child
                    processes of a gloo group on the one card (NCCL runs
                    one rank per device), run after phase 9 while this
                    process runs the single-device references:
                    llama3.2-1b at full width and SP_DEPTH (2) of its 16
                    layers, B = 2, max_len
                    131072, 8 greedy ticks of `serve_step_sp_paged`
                    (SP-GVR, B2's scoring half per rank, the O(K) row
                    assembly, B6) bit-identical to the fused step in
                    logits, tokens, prev_topk and sel_gvr; the collective
                    bill a tick at N = 131072 and 16384 (bytes a call of
                    every site equal, O(1) in N); B2 scoring and B6 at
                    the sharded shapes against their plain versions; the
                    bit-pattern assembly alone, -0.0 kept;
                    [sp-engine]: `DecodeEngine(kv_layout="paged",
                    seq_shards=2)` at full width, SP_ENGINE_DEPTH layers,
                    max_len 8192, equal to the fused engine in tokens,
                    method log, hit rate and prefix hits, and at
                    spec_depth 3 (mq verify) giving the same tokens;
 18b. tp, ep, hybrid-sp — a ("data", "model") mesh of four ranks, child
                    processes of a gloo group on the one card, run after
                    llama is freed, each against the single-device step
                    run first here (every tick fed its greedy token;
                    logits within the phase's tolerance, tokens equal but
                    for near-ties, Top-K agreement, the bill by axis and
                    tag): [tp] llama3.2-1b at 8 layers on (2, 2)
                    (heads, d_ff, vocab over "model", rows over "data";
                    B5, B1, B6 on every rank, against their plain
                    versions at its shapes); [ep] moonshot-v1-16b-a3b at
                    4 layers, bf16, on (1, 4) (`moe_mlp_ep`; a router
                    flip passes only as a near-tie its margin shows; one
                    overflowing call whose drops equal the CPU's count);
                    [hybrid-sp] jamba at one superblock and 4 experts,
                    sequence-sharded on (2, 2) at max_len 524288 (SP-DSA
                    over "data", the rest over "model"), then a cell at
                    max_len 4096 = dsa.min_n (the dense attention over
                    the sequence shards). [tp] and [ep] then run the
                    paged forms (`serve_step_paged` /
                    `serve_step_spec_paged(mesh=, rules=)`) in the same
                    ranks over the same cache (page 64, a shuffled
                    table), fed the dense mesh ticks' inputs: fused/token,
                    gather and every live verify position (scan and mq on
                    [tp], mq on [ep]) equal the rank's own dense mesh
                    ticks bit for bit, mq == scan, page granularity (B10)
                    and the fallback at max_len 4096 (B4) within
                    [layouts]' rule; B2, B3, B4, B7, B8, B9 and B10 on a
                    rank's first inputs against their plain versions.
                    The same ranks then run: [train-mesh] ([tp]'s ranks) llama3.2-1b at 2 layers,
                    f32, (2, 2), B = 4, S = 512, 2 AdamW steps with
                    ZeRO-1 moments against the one-device steps (loss,
                    every gradient and parameter leaf; ZeRO-1 bit-equal
                    to replicated moments); [family-mesh] ([tp]'s)
                    whisper-medium and rwkv6-3b at 4 layers, bf16, 8
                    ticks (whisper's B5 / B1 / B6 at a rank's shapes
                    against their plain versions); [ep-train] ([ep]'s)
                    moonshot-v1-16b-a3b at 2 layers, f32, (1, 4), at a
                    token count that drops nothing, against the
                    one-device steps, and one call under autograd that
                    drops as `moe_ep_drops` says;
 19. train        — llama3.2-1b trained at full width and depth (16
                    layers, bf16 parameters, f32 moments), B = 4, S = 2048,
                    10 steps of `launch.train.make_train_step` over
                    `data.pipeline.synthetic_stream` (no kernel of the
                    port: autograd, cuBLAS and the plain f32 blockwise
                    attention, as the reference trains outside any Pallas
                    kernel): losses finite, the indexer's gradients exactly
                    zero and its update decay-only bit for bit; host wall a
                    step, tokens/s, peak memory, one profiled step's device
                    time and busy share, model FLOPs against the bf16 peak;
 20. train-cut    — one train step at full width and 2 layers (whisper
                    2 + 2), float32, B = 1, S = 128, on the card and on the
                    CPU for llama3.2-1b, moonshot-v1-16b-a3b, whisper-medium
                    and rwkv6-3b: loss and every gradient leaf within
                    the stated tolerances, AdamW from equal gradients
                    on both, and each leaf's step from each side's own;
 21. train-resume — in a child process under deterministic algorithms
                    (started after phase 19, beside phase 20): llama3.2-1b
                    at full width, 2 layers, B = 2, S = 512, 6 steps
                    straight against 3 + save + restore_latest + 3,
                    parameters and moments bit for bit; the train CLI on
                    the card resuming from its checkpoint at step 4;
 21b. dryrun      — `launch.dryrun_all`'s sweep of every production cell
                    on the meta device (a CPU child started before phase
                    19): every cell "ok" or "skipped", a line a cell (GiB
                    a rank by kind against 80, the bill by axis); then
                    llama3.2-1b decode_32k (full depth) and train_4k (2
                    layers) as rank 0 of 16 x 16 on the card under a
                    `ShadowMesh`: the argument blocks held against the dry
                    run's bytes and the allocator's rule, one step, the
                    peak over them, B5 / B1 / B6 against their plain
                    versions, the bill equal to the meta run's;
 21c. examples    — the four `examples/torch/` scripts at their defaults,
                    in child processes beside phase 21b: each exits 0 and
                    prints its check line;
 22. summary      — each kernel's device time lost against its bound
                    over its path at llama's 16 layers (launches x (ms -
                    bound_ms), the launches of phases 3, 4, 7, 8 and 10
                    scaled from the depth each ran; B2, B5 and B9 by their scoring
                    launch, so B1 counts once), the
                    `kernels` JSON line, the card's name and power limit,
                    and the contract line `{"ok": true, ...}` last.

Weights are random (seeded), so nothing is downloaded. The script needs the
repository's `src/` beside it and a CUDA device; without either it exits
non-zero before printing any result.
"""

from __future__ import annotations

import atexit
import dataclasses
import gc
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
STEP_LENGTHS = [5000, 2300, 700, 8000]   # the B=4 steps of [step], [layouts]
VERIFY_L0 = [4999, 2299, 699, 7997]      # the verify ticks of [kernels], [verify-step]
SPEC_DEPTH = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# ------------------------------------------------------------- timing ------

_FLUSH_NAMES: set = set()
_GAP_S = 0.05          # host sleep after each profiled call


def _profiled(run) -> list:
    """(name, start us, duration us) of every device event (kernels,
    copies, memsets) that `run()` issues, in start order, from
    torch.profiler (CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not getattr(e, "is_user_annotation", False)]
    ev.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in ev]


def _profiled_calls(fn, flush, reps: int) -> tuple:
    """The device events of the complete calls among `reps` calls of fn in
    one profiled window, the L2 flushed before each call, and the number
    of calls seen. Each call is followed by a synchronize and _GAP_S on
    the host, so a call is one cluster of device events on the device's
    timeline. CUPTI drops events now and then (a call's kernel, on some
    machines the first calls of a window): a call that shows fewer device
    events than the most any call shows lost some and is left out."""
    import torch
    if not _FLUSH_NAMES:                       # the flush's own device events
        def flushes():
            for _ in range(4):
                flush.zero_()
                torch.cuda.synchronize()
                time.sleep(_GAP_S)
        _FLUSH_NAMES.update(name for name, _, _ in _profiled(flushes))
        if not _FLUSH_NAMES:
            fail("device timing: the profiler saw no device event of the flush")

    def window():
        for _ in range(reps):
            flush.zero_()
            fn()
            torch.cuda.synchronize()
            time.sleep(_GAP_S)

    clusters, end = [], None
    for name, start, us in _profiled(window):
        if end is None or start - end > _GAP_S * 1e6 / 2:
            clusters.append([])
        end = max(end or start, start + us)
        if name not in _FLUSH_NAMES:
            clusters[-1].append((name, us))
    calls = [c for c in clusters if c]
    most = max((len(c) for c in calls), default=0)
    return [c for c in calls if len(c) == most], len(calls)


def time_ms(fn, flush, iters: int = 20, warmup: int = 3) -> dict:
    """Time of one call on the device alone, by torch.profiler: the 50 MB L2
    is flushed before every call (the main path finds the pools cold: a
    step streams ~3 GB of weights between two layers' kernels), and a
    call's device events are summed; `ms` is the median over the complete
    calls (`_profiled_calls`, at least half of `iters`; a window with
    fewer is profiled again, five tries), `lo`/`hi` the least and most.
    `wall_ms` is the median of CUDA events recorded around each call,
    which also counts any host time past the flush's: the host cost per
    call."""
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
    wall = statistics.median(s.elapsed_time(e) for s, e in ev)
    for attempt in range(5):
        calls, seen = _profiled_calls(fn, flush, iters)
        if len(calls) >= max(1, iters // 2):
            break
        log(f"[timing] profiled window {attempt + 1}: {len(calls)} complete "
            f"calls of {iters} ({seen} with device events); profiling it again")
    else:
        fail(f"device timing: no profiled window in five with {iters // 2} "
             f"complete calls of {iters}")
    if len(calls) < iters:
        log(f"[timing] {iters - len(calls)} of {iters} calls lost device "
            f"events to the profiler and are left out")
    us = [sum(u for _, u in c) for c in calls]
    return dict(ms=statistics.median(us) / 1e3, lo=min(us) / 1e3,
                hi=max(us) / 1e3, wall_ms=wall)


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


def _check_split(tag, fn, args, out, ctas, per_slot=(0, 3, 4, 5)):
    """The split over rows: at least one CTA per SM, a second call
    bit-identical, and each slot computed alone (B=1; the arguments at
    `per_slot` cut to its row) bit-identical to the same slot inside the
    batch."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if ctas < sms:
        fail(f"{tag}: {ctas} CTAs for {sms} SMs")
    again = fn(*args)
    torch.cuda.synchronize()
    if not torch.equal(again, out):
        fail(f"{tag}: two calls on the same inputs differ")
    for s in range(out.shape[0]):
        alone = fn(*(a[s:s + 1] if i in per_slot else a
                     for i, a in enumerate(args)))
        if not torch.equal(alone, out[s:s + 1]):
            fail(f"{tag}: slot {s} alone differs from slot {s} of the batch")
    return (f"{ctas} CTAs on {sms} SMs; two calls and each slot alone "
            f"bit-identical")


def phase_kernels(cfg, flush):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    from repro_torch.sparse import dsa
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
    sched = ops.score_schedule(inp["qi"].dtype, b, n, cfg.dsa.indexer_heads,
                               cfg.dsa.indexer_dim, ps)
    ctas2 = _check_split("B2 scoring", ops.paged_indexer_scores,
                         (inp["qi"], inp["idx_pages"], inp["w"], table, ln),
                         s_ker, sched["ctas_per_row"] * b, per_slot=(0, 3, 4))
    log(f"[kernels] B2 scoring on the {sched['route']} body ({sched['heads']} "
        f"heads, {sched['tile']}-position tiles, {sched['tiles_per_cta']} per "
        f"CTA): {ctas2}")

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
    wide = ops.gvr_hosts_wide_cluster(dev)
    sch1 = ops.gvr_schedule(n, k, wide=wide)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sch1.ranks < 2:
        fail(f"B1: N={n} scheduled on one CTA per row, not a cluster")
    log(f"[kernels] B1 exact on a cluster per row: R={sch1.ranks} CTAs of "
        f"{sch1.threads} threads, {b * sch1.ranks} CTAs on {sms} SMs, "
        f"{sch1.smem} B of shared memory each; per-row [secant, refine, "
        f"cand, full-row] = {st[:, :4].int().tolist()}")
    # fewer predictions than K (row-extrema bracket), and predictions past N
    few = prev[:, :512].contiguous()
    oob = prev.clone()
    oob[1, :100] = n + 7
    check_b1(s_ref, few, "M<K")
    check_b1(s_ref, oob, "prev>=N")
    # slot 2's NEG plateau alone (B = 1: length 1000 < K, predictions -1),
    # and warm rows of N = 131072, now in the cluster's shared memory
    st_p = check_b1(s_ref[2:3].contiguous(), prev[2:3].contiguous(), "plateau B=1")
    n_long = 131072
    g_long = torch.Generator(device=dev).manual_seed(n_long)   # g's stream untouched
    x_long = torch.randn((b, n_long), generator=g_long, device=dev)
    prev_long = torch.topk(x_long + 0.01 * torch.randn(x_long.shape, generator=g_long, device=dev),
                           k, dim=-1).indices.sort(-1).values.int().contiguous()
    st_long = check_b1(x_long, prev_long, "N=131072")
    sch_long = ops.gvr_schedule(n_long, k, wide=wide)
    log(f"[kernels] B1 exact (warm, random, -1, even, M<K, prev>=N); the B=1 "
        f"plateau row [secant, refine, cand, full-row] = "
        f"{st_p[0, :4].int().tolist()}; N={n_long} warm rows on R="
        f"{sch_long.ranks} CTAs of {sch_long.threads} threads "
        f"({sch_long.smem} B of shared memory each; the card runs a cluster "
        f"of 16: {wide}), per-row "
        f"{st_long[:, :4].int().tolist()}")

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
    # <= 2048 rows in another order (tiles of 32 rows, 16 split partials
    # merged at the end) and expf vs torch.exp: ~1e-6 relative;
    # atol = rtol = 1e-4
    e3 = float((o3 - o3r).abs().max())
    if not torch.allclose(o3, o3r, atol=1e-4, rtol=1e-4):
        fail(f"B3: max |err| {e3} beyond atol=rtol=1e-4")
    valid3 = ((idx >= 0) & (idx < ln[:, None])).sum(-1)
    _, splits3 = ops.decode_attn_splits("paged_sparse", k, n, ps)
    ctas3 = _check_split("B3", ops.paged_sparse_decode_attn, args3, o3,
                         splits3 * cfg.n_kv_heads * b)
    log(f"[kernels] B3 allclose, max|err| {e3:.3e}; valid rows per slot "
        f"{valid3.tolist()} (slot 2: idx >= length masked); {ctas3}")

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
    _, splits4 = ops.decode_attn_splits("paged_dense", 0, mp4 * ps, ps)
    ctas4 = _check_split("B4", ops.paged_dense_decode_attn, args4, o4,
                         splits4 * cfg.n_kv_heads * b, per_slot=(0, 3, 4))
    log(f"[kernels] B4 allclose (window None and 300), max|err| {e4:.3e}; "
        f"{ctas4}")

    # ---- B5: the same keys in a contiguous cache ---------------------------
    # pages past a slot's extent are unmapped; their rows lie beyond its
    # length, so what stands there in the contiguous cache is masked
    flat_table = table.clamp(min=0).long()
    kc5 = inp["idx_pages"][flat_table].reshape(b, n, -1).contiguous()
    s5 = ops.indexer_scores(inp["qi"], kc5, inp["w"], ln)
    s5r = ref.indexer_scores_ref(inp["qi"], kc5, inp["w"], ln)
    torch.cuda.synchronize()
    if not torch.equal(s5, s_ker):
        fail("B5: score row differs from B2's on the same keys")
    e5 = float((s5 - s5r)[live].abs().max())
    if not torch.equal(s5r > -1e38, live) or e5 > 1e-4 * s_scale:
        fail(f"B5 scoring: max |err| {e5} > 1e-4 * {s_scale} (B2's reasoning)")
    for pr, tag in ((prev, "main"), (few, "M<K"), (oob, "prev>=N")):
        v5, i5, _ = ops.indexer_topk(inp["qi"], kc5, inp["w"], pr, k,
                                     lengths=ln, max_candidates=cmax)
        v5r, i5r, _ = ref.gvr_topk_ref(s5, pr, k, max_candidates=cmax)
        torch.cuda.synchronize()
        if not (torch.equal(i5, i5r) and torch.equal(v5, v5r)):
            fail(f"B5 {tag}: selection differs from the plain Top-K of its row")
        if tag == "main" and not (torch.equal(i5, i2) and torch.equal(v5, v2)):
            fail("B5: selection differs from B2's on the same keys")
    ctas5 = _check_split("B5 scoring", ops.indexer_scores,
                         (inp["qi"], kc5, inp["w"], ln), s5,
                         sched["ctas_per_row"] * b, per_slot=(0, 1, 3))
    log(f"[kernels] B5 score row == B2's bit for bit, max|err| {e5:.3e} vs "
        f"plain; selection exact (warm, random, -1, even, M<K, prev>=N) and "
        f"== B2's; scoring {ctas5}")

    # ---- B6: B3's rows in contiguous caches ------------------------------
    kc6 = inp["k_pages"][flat_table].reshape(b, n, *inp["k_pages"].shape[2:]).contiguous()
    vc6 = inp["v_pages"][flat_table].reshape(b, n, *inp["v_pages"].shape[2:]).contiguous()
    args6 = (inp["q"], kc6, vc6, idx, ln)
    o6 = ops.sparse_decode_attn(*args6)
    o6r = ref.sparse_attn_ref(*args6)
    torch.cuda.synchronize()
    if not torch.equal(o6, o3):
        fail("B6: output differs from B3's on the same rows")
    e6 = float((o6 - o6r).abs().max())
    if not torch.allclose(o6, o6r, atol=1e-4, rtol=1e-4):
        fail(f"B6: max |err| {e6} beyond atol=rtol=1e-4 (B3's reasoning)")
    log(f"[kernels] B6 == B3 bit for bit; allclose, max|err| {e6:.3e}")

    # ---- B7: the logical views, unmapped pages zero ------------------------
    for name, pool in (("K", inp["k_pages"]), ("indexer-K", inp["idx_pages"])):
        g7 = ops.paged_gather(pool, table)
        g7r = ref.paged_gather_ref(pool, table)
        torch.cuda.synchronize()
        if not torch.equal(g7, g7r):
            fail(f"B7 {name} view differs from the plain gather")
    unmapped = int((table < 0).sum())
    log(f"[kernels] B7 exact (K and indexer-K views, {unmapped} unmapped "
        f"pages zero)")

    # ---- B10: B3's entries (-1 and duplicates) at page granularity -------
    o10 = ops.paged_sparse_decode_attn_pg(*args3)
    o10r = ref.paged_sparse_attn_pg_ref(*args3)
    torch.cuda.synchronize()
    # tolerance: as B3; the kernel also sums in page order, not Top-K order
    e10 = float((o10 - o10r).abs().max())
    if not torch.allclose(o10, o10r, atol=1e-4, rtol=1e-4):
        fail(f"B10: max |err| {e10} beyond atol=rtol=1e-4")
    valid10 = (idx >= 0) & (idx < ln[:, None])
    pages10 = [len(set((row[m] // ps).tolist())) for row, m in zip(idx, valid10)]
    stats10 = dsa.page_gather_stats(idx, page_size=ps, num_logical_pages=mp)
    rps10, splits10 = ops.decode_attn_splits("paged_pages", k, n, ps)
    ctas10 = _check_split("B10", ops.paged_sparse_decode_attn_pg, args3, o10,
                          splits10 * cfg.n_kv_heads * b)
    log(f"[kernels] B10 allclose, max|err| {e10:.3e}; distinct pages with a "
        f"valid entry per slot {pages10} of {mp} (page_gather_stats over all "
        f"entries {stats10.tolist()}), K={k}; {splits10} splits of {rps10} "
        f"positions: {ctas10}")

    # ---- B10 on long rows: 2048 pages of 64, past the 97,536 positions a
    # one-split kernel with a count per table position could hold ---------
    n_long = 131072
    lengths_long = [n_long, n_long - 100, 97536 + 777, 40000]
    gl = torch.Generator(device=dev).manual_seed(n_long)   # leaves g alone
    inp_l = _paged_inputs(gl, dev, b=b, mp=n_long // ps, ps=ps,
                          lengths=lengths_long, kvh=cfg.n_kv_heads, hd=cfg.hd,
                          h=cfg.n_heads, di=8, hi=1)
    idx_l = torch.stack([torch.randperm(L, generator=gl, device=dev)[:k]
                         for L in lengths_long]).int()
    idx_l[1, :16] = -1
    idx_l[0, 16:32] = lengths_long[0] - 1
    idx_l = idx_l.contiguous()
    args10l = (inp_l["q"], inp_l["k_pages"], inp_l["v_pages"], inp_l["table"],
               idx_l, inp_l["lengths"])
    o10l = ops.paged_sparse_decode_attn_pg(*args10l)
    o10lr = ref.paged_sparse_attn_pg_ref(*args10l)
    torch.cuda.synchronize()
    e10l = float((o10l - o10lr).abs().max())
    if not torch.allclose(o10l, o10lr, atol=1e-4, rtol=1e-4):
        fail(f"B10 at N={n_long}: max |err| {e10l} beyond atol=rtol=1e-4")
    rps10l, splits10l = ops.decode_attn_splits("paged_pages", k, n_long, ps)
    ctas10l = _check_split(f"B10 N={n_long}", ops.paged_sparse_decode_attn_pg,
                           args10l, o10l, splits10l * cfg.n_kv_heads * b)
    rows10l = int(((idx_l >= 0) & (idx_l < inp_l["lengths"][:, None])).sum())
    log(f"[kernels] B10 at B={b}, N={n_long}: allclose, max|err| "
        f"{e10l:.3e}; {splits10l} splits of {rps10l} positions: {ctas10l}")

    # ---- B8 / B9: the verify tick's Q = d+1 query rows per slot ----------
    hi, di = cfg.dsa.indexer_heads, cfg.dsa.indexer_dim
    kvh, hd, h = cfg.n_kv_heads, cfg.hd, cfg.n_heads
    qn = SPEC_DEPTH + 1
    lq = (torch.tensor(VERIFY_L0, device=dev)[:, None]
          + torch.arange(1, qn + 1, device=dev)).int().contiguous()   # L0+q+1
    inp9 = _paged_inputs(g, dev, b=b, mp=mp, ps=ps,
                         lengths=[L + qn for L in VERIFY_L0], kvh=kvh, hd=hd,
                         h=h, di=di, hi=hi)
    t9 = inp9["table"]
    qi9 = torch.randn((b, qn, hi, di), generator=g, device=dev).to(torch.bfloat16)
    q8 = torch.randn((b, qn, h, hd), generator=g, device=dev).to(torch.bfloat16)
    args9 = (inp9["idx_pages"], inp9["w"], t9)
    s9 = ops.paged_indexer_scores_mq(qi9, *args9, lq)
    s9r = ref.paged_indexer_scores_mq_ref(qi9, *args9, lq)
    torch.cuda.synchronize()
    for j in range(qn):
        s2j = ops.paged_indexer_scores(qi9[:, j].contiguous(), *args9,
                                       lq[:, j].contiguous())
        if not torch.equal(s9[:, j], s2j):
            fail(f"B9 scoring: query row {j} differs from B2's score row")
    live9 = s9r > -1e38
    if not torch.equal(live9, s9 > -1e38):
        fail("B9 scoring: NEG mask (per-row length / unmapped pages) differs")
    # tolerance: B2's (same body, same sums)
    e9 = float((s9 - s9r)[live9].abs().max())
    s9_scale = float(s9r[live9].abs().max())
    if e9 > 1e-4 * s9_scale:
        fail(f"B9 scoring: max |err| {e9} > 1e-4 * {s9_scale}")
    noisy9 = s9r[:, 0] + 0.01 * s9_scale * torch.randn(s9r[:, 0].shape, generator=g, device=dev)
    warm9 = ref.gvr_topk_ref(noisy9, torch.zeros((b, k), dtype=torch.int32, device=dev), k)[1]
    prev9 = torch.stack([
        warm9[0],
        torch.randint(0, n, (k,), generator=g, device=dev).int(),
        torch.full((k,), -1, dtype=torch.int32, device=dev),     # recycled slot
        torch.linspace(0, VERIFY_L0[3] - 1, k, device=dev).int()]).contiguous()
    oob9 = prev9.clone()
    oob9[1, :100] = n + 7
    for pr, tag in ((prev9, "main"), (oob9, "prev>=N")):
        v9, i9, st9 = ops.gvr_topk_chain(s9, pr, k, max_candidates=cmax)
        v9r, i9r, st9r = ref.gvr_topk_chain_ref(s9, pr, k, max_candidates=cmax)
        torch.cuda.synchronize()
        if not (torch.equal(i9, i9r) and torch.equal(v9, v9r)
                and torch.equal(st9[..., 4:], st9r[..., 4:])):
            fail(f"B9 chain {tag}: differs from the plain chain")
        pv = pr
        for j in range(qn):
            v1, i1, st1 = ops.gvr_topk(s9[:, j].contiguous(), pv, k,
                                       max_candidates=cmax)
            if not (torch.equal(v9[:, j], v1) and torch.equal(i9[:, j], i1)
                    and torch.equal(st9[:, j], st1)):
                fail(f"B9 chain {tag}: row {j} differs from sequential B1 "
                     f"(values, indices or stats)")
            pv = i1
        if tag == "main":
            i9_main, st9_main = i9, st9
    v9w, i9w, _ = ops.paged_indexer_topk_mq(qi9, *args9, prev9, k, lengths=lq,
                                            max_candidates=cmax)
    if not (torch.equal(i9w, i9_main) and torch.equal(v9w, ops.gvr_topk_chain(
            s9, prev9, k, max_candidates=cmax)[0])):
        fail("B9: scoring + chain through paged_indexer_topk_mq differs")
    log(f"[kernels] B9 score rows == B2's bit for bit, max|err| {e9:.3e} "
        f"(scale {s9_scale:.3e}); chain == {qn} sequential B1 launches bit for "
        f"bit (values, indices, 8 stats) and == the plain chain (stats 4-7) on "
        f"warm/random/-1/even and prev>=N predictions; per-row [secant, "
        f"refine, cand, full-row] = {st9_main[..., :4].int().tolist()}")

    idx8 = i9_main.clone()                 # each row's own Top-K, logical
    idx8[1, :, :16] = -1
    idx8[0, 1, 16:32] = VERIFY_L0[0]       # duplicates
    args8 = (q8, inp9["k_pages"], inp9["v_pages"], t9, idx8, lq)
    o8 = ops.paged_sparse_decode_attn_mq(*args8)
    o8r = ref.paged_sparse_attn_mq_ref(*args8)
    fold3 = ops.paged_sparse_decode_attn(
        q8.reshape(b * qn, h, hd), inp9["k_pages"], inp9["v_pages"],
        t9.repeat_interleave(qn, 0).contiguous(), idx8.reshape(b * qn, k),
        lq.reshape(b * qn))
    beyond = idx8 >= lq[..., None]
    o8m = ops.paged_sparse_decode_attn_mq(
        q8, inp9["k_pages"], inp9["v_pages"], t9,
        torch.where(beyond, -1, idx8).int().contiguous(), lq)
    torch.cuda.synchronize()
    if not torch.equal(o8.reshape(b * qn, h, hd), fold3):
        fail("B8: output differs from B3's on the folded rows")
    if not torch.equal(o8, o8m):
        fail("B8: entries >= the row's length are not masked")
    # tolerance: B3's
    e8 = float((o8 - o8r).abs().max())
    if not torch.allclose(o8, o8r, atol=1e-4, rtol=1e-4):
        fail(f"B8: max |err| {e8} beyond atol=rtol=1e-4")
    valid8 = (idx8 >= 0) & ~beyond
    log(f"[kernels] B8 == B3 on the folded rows bit for bit; allclose, "
        f"max|err| {e8:.3e}; entries >= length masked ({int(beyond.sum())} "
        f"in all, slot 2 at L0 {VERIFY_L0[2]} < K); valid entries per row "
        f"{valid8.sum(-1).tolist()}")

    # ---- times ------------------------------------------------------------
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
        "B5": (time_ms(lambda: ops.indexer_topk(inp["qi"], kc5, inp["w"], prev, k, lengths=ln, max_candidates=cmax), flush),
               time_ms(lambda: ref.gvr_topk_ref(ref.indexer_scores_ref(inp["qi"], kc5, inp["w"], ln), prev, k, max_candidates=cmax), flush, iters=5),
               None),
        "B6": (time_ms(lambda: ops.sparse_decode_attn(*args6), flush),
               time_ms(lambda: ref.sparse_attn_ref(*args6), flush), None),
        "B7": (time_ms(lambda: ops.paged_gather(inp["k_pages"], table), flush),
               time_ms(lambda: ref.paged_gather_ref(inp["k_pages"], table), flush),
               time_ms(lambda: inp["k_pages"].index_select(0, flat_table.flatten()), flush)),
        "B10": (time_ms(lambda: ops.paged_sparse_decode_attn_pg(*args3), flush),
                time_ms(lambda: ref.paged_sparse_attn_pg_ref(*args3), flush), None),
        "B10 N=131072": (time_ms(lambda: ops.paged_sparse_decode_attn_pg(*args10l), flush),
                         time_ms(lambda: ref.paged_sparse_attn_pg_ref(*args10l), flush, iters=5),
                         None),
        "B8": (time_ms(lambda: ops.paged_sparse_decode_attn_mq(*args8), flush),
               time_ms(lambda: ref.paged_sparse_attn_mq_ref(*args8), flush), None),
        "B9": (time_ms(lambda: ops.paged_indexer_topk_mq(qi9, *args9, prev9, k, lengths=lq, max_candidates=cmax), flush),
               time_ms(lambda: ref.gvr_topk_chain_ref(ref.paged_indexer_scores_mq_ref(qi9, *args9, lq), prev9, k, max_candidates=cmax), flush, iters=3),
               None),
    }
    # the scoring halves of B2, B5 and B9 (their second launch is B1 or
    # the chain), and B9's chain, for the per-row cost of the mq forms
    halves = {
        "B2 scoring": time_ms(lambda: ops.paged_indexer_scores(inp["qi"], inp["idx_pages"], inp["w"], table, ln), flush),
        "B5 scoring": time_ms(lambda: ops.indexer_scores(inp["qi"], kc5, inp["w"], ln), flush),
        "B9 scoring": time_ms(lambda: ops.paged_indexer_scores_mq(qi9, *args9, lq), flush),
        "B9 chain": time_ms(lambda: ops.gvr_topk_chain(s9, prev9, k, max_candidates=cmax), flush),
    }
    log("[kernels] halves (device ms, wall ms): " + ", ".join(
        f"{key} {v['ms']:.5f} / {v['wall_ms']:.5f}" for key, v in halves.items()))
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
    # B5 reads each slot's keys up to its length, as B2 does
    b5_bytes = b2_bytes - pages_read * ps * di * 2 + sum(lengths) * di * 2
    results["B5"] = dict(err=e5, bound=bound_ms(b5_bytes, b2_flops))
    results["B6"] = dict(err=e6, bound=bound_ms(b3_bytes - table.numel() * 4,
                                                4 * h * hd * rows3))
    page_bytes = ps * kvh * hd * 2
    b7_bytes = (int((table >= 0).sum()) * page_bytes + table.numel() * 4
                + b * mp * page_bytes)
    results["B7"] = dict(err=0.0, bound=bound_ms(b7_bytes, 0))
    # B10 computes B3's function (attention over the K selected rows), so
    # its bound is B3's; reading whole touched pages is this design's cost
    results["B10"] = dict(err=e10, bound=bound_ms(b3_bytes, 4 * h * hd * rows3))
    b10l_bytes = (inp_l["q"].numel() * 2 + rows10l * kvh * hd * 2 * 2
                  + idx_l.numel() * 4 + inp_l["table"].numel() * 4 + b * 4
                  + b * h * hd * 4)
    results["B10 N=131072"] = dict(err=e10l, bound=bound_ms(
        b10l_bytes, 4 * h * hd * rows10l))
    # B8: each distinct selected (slot, row) pair read once across its Q
    # query rows; the design reads every valid entry of every row
    rows8 = int(valid8.sum())
    pairs8 = sum(len(set(idx8[i][valid8[i]].tolist())) for i in range(b))
    row_bytes = kvh * hd * 2 * 2
    b8_bytes = (q8.numel() * 2 + pairs8 * row_bytes + idx8.numel() * 4
                + t9.numel() * 4 + lq.numel() * 4 + b * qn * h * hd * 4)
    results["B8"] = dict(err=e8, bound=bound_ms(b8_bytes, 4 * h * hd * rows8))
    log(f"[kernels] B8 bound reads {pairs8} distinct (slot, row) pairs "
        f"({pairs8 * row_bytes / 1e6:.3f} MB of K/V); the design reads "
        f"{rows8} rows ({rows8 * row_bytes / 1e6:.3f} MB)")
    # B9: each slot's keys up to its longest row read once; the design
    # reads them once per query row
    keys9 = sum(-(-int(lq[i].max()) // ps) for i in range(b)) * ps * di * 2
    keys9_read = sum(-(-int(L) // ps) for L in lq.flatten().tolist()) * ps * di * 2
    b9_bytes = (qi9.numel() * 2 + keys9 + hi * 4 + t9.numel() * 4
                + lq.numel() * 4 + prev9.numel() * 4 + b * qn * (k * 8 + 32))
    results["B9"] = dict(err=e9, bound=bound_ms(
        b9_bytes, 2 * hi * di * int(lq.sum())))
    log(f"[kernels] B9 bound reads {keys9 / 1e6:.3f} MB of keys; the design "
        f"reads {keys9_read / 1e6:.3f} MB (once per query row)")
    # the scoring halves alone: keys up to each length, q, w, table,
    # lengths and the f32 score row written once
    half_bounds = {
        "B2": bound_ms(inp["qi"].numel() * 2 + pages_read * ps * di * 2 + hi * 4
                       + table.numel() * 4 + b * 4 + b * n * 4, b2_flops),
        "B5": bound_ms(inp["qi"].numel() * 2 + sum(lengths) * di * 2 + hi * 4
                       + b * 4 + b * n * 4, b2_flops),
        "B9": bound_ms(qi9.numel() * 2 + keys9 + hi * 4 + t9.numel() * 4
                       + lq.numel() * 4 + b * qn * n * 4,
                       2 * hi * di * int(lq.sum())),
    }
    for key, bnd in half_bounds.items():
        half = halves[f"{key} scoring"]
        results[key]["half"] = (half["ms"], bnd)
        log(f"[kernels] {key} scoring: device {half['ms']:.5f} ms, bound "
            f"{bnd[0]:.5f} ms ({bnd[1]}), {half['ms'] / bnd[0]:.1f}x")
    # B10 reads each distinct selected row once, weighted by its count; the
    # rows of its touched pages are the page-granular reference's figure
    sel10 = sum(len(set(row[m].tolist())) for row, m in zip(idx, valid10))
    rows10 = sum(pages10) * ps
    log(f"[kernels] B10 design reads the {sel10} distinct selected rows "
        f"({sel10 * kvh * hd * 2 * 2 / 1e6:.3f} MB of K/V) of the {rows3} "
        f"valid entries ({rows3 * kvh * hd * 2 * 2 / 1e6:.3f} MB); the "
        f"page-granular reference reads every row of the touched pages: "
        f"{rows10} rows ({rows10 * kvh * hd * 2 * 2 / 1e6:.3f} MB)")
    # device ms [least-most over the calls] / wall ms, for kernel, plain
    # version and library call alike
    def fmt(x):
        return ("none" if x is None else f"{x['ms']:.5f} [{x['lo']:.5f}-"
                f"{x['hi']:.5f}] / {x['wall_ms']:.5f} ms")

    for key, (ker, plain, lib) in t.items():
        results[key].update(ms=ker["ms"], wall_ms=ker["wall_ms"],
                            plain_ms=plain["ms"],
                            library_ms=None if lib is None else lib["ms"])
        log(f"[kernels] {key}: device [least-most] / wall: kernel {fmt(ker)}, "
            f"plain {fmt(plain)}, library {fmt(lib)}, bound "
            f"{results[key]['bound'][0]:.5f} ms ({results[key]['bound'][1]})")
    return results


def phase_kernels_moe_width(mcfg, flush):
    """B3, B4 and B6 at moonshot-v1-16b-a3b's widths (G = 1, hd 128, KVH
    16, bf16) at the kernel phase's lengths, each against its plain
    version, timed and bounded as in `phase_kernels`. The entries are a
    Top-K-like selection per slot (K distinct positions below the length;
    a slot shorter than K takes [0, K), as B1's NEG ties give), with B3's
    -1 padding and duplicates."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1408)
    b, n, k, ps = 4, 8192, mcfg.dsa.k, 64
    kvh, h, hd = mcfg.n_kv_heads, mcfg.n_heads, mcfg.hd
    mp = n // ps
    lengths = [8192, 5000, 1000, 3001]
    inp = _paged_inputs(g, dev, b=b, mp=mp, ps=ps, lengths=lengths, kvh=kvh,
                        hd=hd, h=h, di=8, hi=1)
    table, ln = inp["table"], inp["lengths"]
    idx = torch.stack([
        torch.randperm(L, generator=g, device=dev)[:k].sort().values
        if L >= k else torch.arange(k, device=dev) for L in lengths]).int()
    idx[1, :16] = -1
    idx[0, 16:32] = lengths[0] - 1
    idx = idx.contiguous()
    out = {}

    args3 = (inp["q"], inp["k_pages"], inp["v_pages"], table, idx, ln)
    o3 = ops.paged_sparse_decode_attn(*args3)
    o3r = ref.paged_sparse_attn_ref(*args3)
    torch.cuda.synchronize()
    # tolerance: B3's at llama's widths (f32 softmax and PV sums in another
    # order; hd 128 adds no sum over more rows)
    e3 = float((o3 - o3r).abs().max())
    if not torch.allclose(o3, o3r, atol=1e-4, rtol=1e-4):
        fail(f"B3 at moe width: max |err| {e3} beyond atol=rtol=1e-4")
    _, splits3 = ops.decode_attn_splits("paged_sparse", k, n, ps)
    ctas3 = _check_split("B3 moe width", ops.paged_sparse_decode_attn, args3,
                         o3, splits3 * kvh * b)

    flat_table = table.clamp(min=0).long()
    kc6 = inp["k_pages"][flat_table].reshape(b, n, kvh, hd).contiguous()
    vc6 = inp["v_pages"][flat_table].reshape(b, n, kvh, hd).contiguous()
    args6 = (inp["q"], kc6, vc6, idx, ln)
    o6 = ops.sparse_decode_attn(*args6)
    o6r = ref.sparse_attn_ref(*args6)
    torch.cuda.synchronize()
    if not torch.equal(o6, o3):
        fail("B6 at moe width: output differs from B3's on the same rows")
    e6 = float((o6 - o6r).abs().max())
    if not torch.allclose(o6, o6r, atol=1e-4, rtol=1e-4):
        fail(f"B6 at moe width: max |err| {e6} beyond atol=rtol=1e-4")

    mp4, lengths4 = 4096 // ps, [4096, 2500, 1, 777]
    inp4 = _paged_inputs(g, dev, b=b, mp=mp4, ps=ps, lengths=lengths4,
                         kvh=kvh, hd=hd, h=h, di=8, hi=1)
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
        fail(f"B4 at moe width: max |err| {e4} beyond atol=rtol=1e-4")
    _, splits4 = ops.decode_attn_splits("paged_dense", 0, mp4 * ps, ps)
    ctas4 = _check_split("B4 moe width", ops.paged_dense_decode_attn, args4,
                         o4, splits4 * kvh * b, per_slot=(0, 3, 4))
    log(f"[kernels] moe width (G {h // kvh}, hd {hd}, KVH {kvh}, bf16): B3 "
        f"allclose, max|err| {e3:.3e}, {ctas3}; B6 == B3 bit for bit, "
        f"max|err| {e6:.3e}; B4 allclose (window None and 300), max|err| "
        f"{e4:.3e}, {ctas4}")

    rows3 = int(((idx >= 0) & (idx < ln[:, None])).sum())
    b3_bytes = (inp["q"].numel() * 2 + rows3 * kvh * hd * 2 * 2 + idx.numel() * 4
                + table.numel() * 4 + b * 4 + b * h * hd * 4)
    b4_rows = sum(lengths4)
    b4_bytes = (inp4["q"].numel() * 2 + b4_rows * kvh * hd * 2 * 2
                + inp4["table"].numel() * 4 + b * 4 + b * h * hd * 4)
    for key, err, fn, plain, bnd in (
            ("B3", e3, lambda: ops.paged_sparse_decode_attn(*args3),
             lambda: ref.paged_sparse_attn_ref(*args3),
             bound_ms(b3_bytes, 4 * h * hd * rows3)),
            ("B4", e4, lambda: ops.paged_dense_decode_attn(*args4),
             lambda: ref.paged_dense_attn_ref(*args4),
             bound_ms(b4_bytes, 4 * h * hd * b4_rows)),
            ("B6", e6, lambda: ops.sparse_decode_attn(*args6),
             lambda: ref.sparse_attn_ref(*args6),
             bound_ms(b3_bytes - table.numel() * 4, 4 * h * hd * rows3))):
        ker, pl = time_ms(fn, flush), time_ms(plain, flush)
        out[key] = dict(err=err, ms=ker["ms"], wall_ms=ker["wall_ms"],
                        plain_ms=pl["ms"], bound=bnd)
        log(f"[kernels] {key} at moe width: device [least-most] / wall: "
            f"kernel {ker['ms']:.5f} [{ker['lo']:.5f}-{ker['hi']:.5f}] / "
            f"{ker['wall_ms']:.5f} ms, plain {pl['ms']:.5f} / "
            f"{pl['wall_ms']:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
            f"{ker['ms'] / bnd[0]:.2f}x")
    return out


# the rest of the dense family's attention widths at full width: (label,
# arch, KVH, H, hd) — head groups 16, 48 and 7 run as head chunks of 8,
# head dim 120 on the 128-lane instance
FAMILY_WIDTHS = [("chatglm3", "chatglm3-6b", 2, 32, 128),
                 ("granite34", "granite-34b", 1, 48, 128),
                 ("qwen2vl", "qwen2-vl-7b", 4, 28, 128),
                 ("danube", "h2o-danube-3-4b", 8, 32, 120)]


def phase_kernels_family_widths(flush):
    """B3, B4, B6, B8 and B10 at the rest of the dense family's widths
    (FAMILY_WIDTHS, bf16, B=4, N=8192, K=2048, the kernel phase's lengths),
    each against its plain version, B6 == B3 and B8 == B3 on the folded
    rows bit for bit, B3/B4/B10 two calls and each slot alone
    bit-identical, B4 also under h2o-danube's window of 4096 (slot 1 at
    length 5000: the window begins at 904, inside the split [896, 1024));
    timed and bounded as in `phase_kernels`."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    b, n, k, ps = 4, 8192, 2048, 64
    mp = n // ps
    lengths = [8192, 5000, 1000, 3001]
    out = {}
    for label, arch, kvh, h, hd in FAMILY_WIDTHS:
        g = torch.Generator(device=dev).manual_seed(2000 + h + hd)
        inp = _paged_inputs(g, dev, b=b, mp=mp, ps=ps, lengths=lengths,
                            kvh=kvh, hd=hd, h=h, di=8, hi=1)
        table, ln = inp["table"], inp["lengths"]
        idx = torch.stack([
            torch.randperm(L, generator=g, device=dev)[:k].sort().values
            if L >= k else torch.arange(k, device=dev) for L in lengths]).int()
        idx[1, :16] = -1
        idx[0, 16:32] = lengths[0] - 1
        idx = idx.contiguous()
        gc, chunks = ops.attn_head_chunk(h // kvh)
        tag = f"{arch} width (G {h // kvh} as {chunks} x {gc}, KVH {kvh}, hd {hd})"
        res = {}

        def close(name, a, c):
            err = float((a - c).abs().max())
            # tolerance: B3's at llama's widths (f32 softmax and PV sums in
            # another order; more heads or chunks add no longer sum)
            if not torch.allclose(a, c, atol=1e-4, rtol=1e-4):
                fail(f"{name} at {tag}: max |err| {err} beyond atol=rtol=1e-4")
            return err

        args3 = (inp["q"], inp["k_pages"], inp["v_pages"], table, idx, ln)
        o3 = ops.paged_sparse_decode_attn(*args3)
        e3 = close("B3", o3, ref.paged_sparse_attn_ref(*args3))
        _, splits3 = ops.decode_attn_splits("paged_sparse", k, n, ps)
        ctas3 = _check_split(f"B3 {tag}", ops.paged_sparse_decode_attn, args3,
                             o3, splits3 * kvh * chunks * b)
        flat = table.clamp(min=0).long()
        kc6 = inp["k_pages"][flat].reshape(b, n, kvh, hd).contiguous()
        vc6 = inp["v_pages"][flat].reshape(b, n, kvh, hd).contiguous()
        args6 = (inp["q"], kc6, vc6, idx, ln)
        o6 = ops.sparse_decode_attn(*args6)
        if not torch.equal(o6, o3):
            fail(f"B6 at {tag}: output differs from B3's on the same rows")
        e6 = close("B6", o6, ref.sparse_attn_ref(*args6))
        # B8: slots (0, 1) and (2, 3) as two slots of Q = 2 verify rows on
        # table rows 0 and 2; B3 over the folded rows with the table repeated
        t8 = table[0::2].contiguous()
        args8 = (inp["q"].reshape(2, 2, h, hd), inp["k_pages"], inp["v_pages"],
                 t8, idx.reshape(2, 2, k), ln.reshape(2, 2))
        o8 = ops.paged_sparse_decode_attn_mq(*args8)
        fold = ops.paged_sparse_decode_attn(
            inp["q"], inp["k_pages"], inp["v_pages"],
            t8.repeat_interleave(2, 0).contiguous(), idx, ln)
        if not torch.equal(o8.reshape(b, h, hd), fold):
            fail(f"B8 at {tag}: output differs from B3's on the folded rows")
        e8 = close("B8", o8, ref.paged_sparse_attn_mq_ref(*args8))
        args4 = (inp["q"], inp["k_pages"], inp["v_pages"], table, ln)
        o4 = ops.paged_dense_decode_attn(*args4)
        o4w = ops.paged_dense_decode_attn(*args4, window=4096)
        e4 = max(close("B4", o4, ref.paged_dense_attn_ref(*args4)),
                 close("B4 window 4096", o4w,
                       ref.paged_dense_attn_ref(*args4, window=4096)))
        _, splits4 = ops.decode_attn_splits("paged_dense", 0, n, ps)
        ctas4 = _check_split(f"B4 {tag}", ops.paged_dense_decode_attn, args4,
                             o4, splits4 * kvh * chunks * b, per_slot=(0, 3, 4))
        o10 = ops.paged_sparse_decode_attn_pg(*args3)
        e10 = close("B10", o10, ref.paged_sparse_attn_pg_ref(*args3))
        _, splits10 = ops.decode_attn_splits("paged_pages", k, n, ps)
        ctas10 = _check_split(f"B10 {tag}", ops.paged_sparse_decode_attn_pg,
                              args3, o10, splits10 * kvh * chunks * b)
        log(f"[kernels] {tag}, bf16: B3 allclose, max|err| {e3:.3e}, {ctas3}; "
            f"B6 == B3 and B8 == B3 (folded rows) bit for bit, max|err| "
            f"{e6:.3e} / {e8:.3e}; B4 allclose (window None and 4096), max|err| "
            f"{e4:.3e}, {ctas4}; B10 allclose, max|err| {e10:.3e}, {ctas10}")
        rows3 = int(((idx >= 0) & (idx < ln[:, None])).sum())
        row_bytes = kvh * hd * 2 * 2
        b3_bytes = (inp["q"].numel() * 2 + rows3 * row_bytes + idx.numel() * 4
                    + table.numel() * 4 + b * 4 + b * h * hd * 4)
        b4_bytes = (inp["q"].numel() * 2 + sum(lengths) * row_bytes
                    + table.numel() * 4 + b * 4 + b * h * hd * 4)
        # B8's valid entries: in the row's length and on a page its slot's
        # table row maps; each distinct (slot, row) pair read once
        t8f = t8.repeat_interleave(2, 0)
        valid8 = ((idx >= 0) & (idx < ln[:, None])
                  & (t8f.gather(1, (idx.clamp(min=0) // ps).long()) >= 0))
        rows8 = int(valid8.sum())
        pairs8 = sum(len(set(idx[2 * s:2 * s + 2][valid8[2 * s:2 * s + 2]].tolist()))
                     for s in range(2))
        b8_bytes = (inp["q"].numel() * 2 + pairs8 * row_bytes + idx.numel() * 4
                    + t8.numel() * 4 + b * 4 + b * h * hd * 4)
        for key, err, fn, plain, bnd in (
                ("B3", e3, lambda: ops.paged_sparse_decode_attn(*args3),
                 lambda: ref.paged_sparse_attn_ref(*args3),
                 bound_ms(b3_bytes, 4 * h * hd * rows3)),
                ("B4", e4, lambda: ops.paged_dense_decode_attn(*args4),
                 lambda: ref.paged_dense_attn_ref(*args4),
                 bound_ms(b4_bytes, 4 * h * hd * sum(lengths))),
                ("B6", e6, lambda: ops.sparse_decode_attn(*args6),
                 lambda: ref.sparse_attn_ref(*args6),
                 bound_ms(b3_bytes - table.numel() * 4, 4 * h * hd * rows3)),
                ("B8", e8, lambda: ops.paged_sparse_decode_attn_mq(*args8),
                 lambda: ref.paged_sparse_attn_mq_ref(*args8),
                 bound_ms(b8_bytes, 4 * h * hd * rows8)),
                ("B10", e10, lambda: ops.paged_sparse_decode_attn_pg(*args3),
                 lambda: ref.paged_sparse_attn_pg_ref(*args3),
                 bound_ms(b3_bytes, 4 * h * hd * rows3))):
            ker, pl = time_ms(fn, flush), time_ms(plain, flush, iters=10)
            res[key] = dict(err=err, ms=ker["ms"], wall_ms=ker["wall_ms"],
                            plain_ms=pl["ms"], bound=bnd)
            log(f"[kernels] {key} at {label} width: device [least-most] / wall: "
                f"kernel {ker['ms']:.5f} [{ker['lo']:.5f}-{ker['hi']:.5f}] / "
                f"{ker['wall_ms']:.5f} ms, plain {pl['ms']:.5f} / "
                f"{pl['wall_ms']:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
                f"{ker['ms'] / bnd[0]:.2f}x")
        out[label] = res
        del inp, kc6, vc6
        torch.cuda.empty_cache()
    return out


def phase_kernels_window(dcfg, flush):
    """The scoring body under h2o-danube's sliding window (4096) at the
    kernel phase's shapes (B=4, N=8192, H_i=64, d_i=128, bf16, lengths
    8192/5000/1000/3001; B9 at Q=3): B2, B5 and B9 allclose to their plain
    versions, every position below length - window (and at or past the
    length) exactly NEG, B5 == B2 and B9's rows == B2's at their own
    lengths bit for bit, two calls and each slot alone bit-identical; B1
    exact on the windowed rows (a NEG prefix, the short slots a NEG
    suffix too) from warm, random, -1 and even predictions. Times each
    scoring launch with and without the window, and B1 on the windowed
    rows."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4096)
    win = dcfg.swa_window
    b, n, k, ps = 4, 8192, dcfg.dsa.k, 64
    hi, di, cmax = dcfg.dsa.indexer_heads, dcfg.dsa.indexer_dim, dcfg.dsa.max_candidates
    mp = n // ps
    lengths = [8192, 5000, 1000, 3001]
    inp = _paged_inputs(g, dev, b=b, mp=mp, ps=ps, lengths=lengths, kvh=1,
                        hd=32, h=1, di=di, hi=hi)
    table, ln, qi, pages, w = (inp["table"], inp["lengths"], inp["qi"],
                               inp["idx_pages"], inp["w"])
    s2 = ops.paged_indexer_scores(qi, pages, w, table, ln, win)
    s0 = ref.paged_indexer_scores_ref(qi, pages, w, table, ln, win)
    torch.cuda.synchronize()
    pos = torch.arange(n, device=dev)[None]
    inside = (pos < ln[:, None]) & (pos >= ln[:, None] - win)
    if not torch.equal(s2 > -1e38, s0 > -1e38) or not bool((s2[~inside] == ref.NEG).all()):
        fail("windowed B2 scoring: a position outside [length - window, "
             "length) does not score NEG")
    live = s0 > -1e38
    err = float((s2 - s0)[live].abs().max())
    scale = float(s0[live].abs().max())
    # tolerance: B2's (the window masks positions, it changes no sum)
    if err > 1e-4 * scale:
        fail(f"windowed B2 scoring: max |err| {err} > 1e-4 * {scale}")
    sched = ops.score_schedule(qi.dtype, b, n, hi, di, ps)
    ctas = _check_split("windowed B2 scoring",
                        lambda *a: ops.paged_indexer_scores(*a, win),
                        (qi, pages, w, table, ln), s2,
                        sched["ctas_per_row"] * b, per_slot=(0, 3, 4))
    kc5 = pages[table.clamp(min=0).long()].reshape(b, n, di).contiguous()
    s5 = ops.indexer_scores(qi, kc5, w, ln, win)
    if not torch.equal(s5, s2):
        fail("windowed B5 scoring: score row differs from B2's")
    e5 = float((s5 - ref.indexer_scores_ref(qi, kc5, w, ln, win))[live].abs().max())
    qn = SPEC_DEPTH + 1
    lq = (ln[:, None] - qn + 1 + torch.arange(qn, device=dev)).int().contiguous()
    qi9 = torch.randn((b, qn, hi, di), generator=g, device=dev).to(torch.bfloat16)
    s9 = ops.paged_indexer_scores_mq(qi9, pages, w, table, lq, win)
    s9r = ref.paged_indexer_scores_mq_ref(qi9, pages, w, table, lq, win)
    for j in range(qn):
        if not torch.equal(s9[:, j], ops.paged_indexer_scores(
                qi9[:, j].contiguous(), pages, w, table, lq[:, j].contiguous(), win)):
            fail(f"windowed B9 scoring: row {j} differs from B2's at its length")
    live9 = s9r > -1e38
    if not torch.equal(live9, s9 > -1e38):
        fail("windowed B9 scoring: NEG mask differs from the plain version's")
    e9 = float((s9 - s9r)[live9].abs().max())
    if max(e5, e9) > 1e-4 * scale:
        fail(f"windowed B5/B9 scoring: max |err| {max(e5, e9)} > 1e-4 * {scale}")
    noisy = s0 + 0.01 * scale * torch.randn(s0.shape, generator=g, device=dev)
    noisy = torch.where(s0 > -1e38, noisy, s0)
    warm = ref.gvr_topk_ref(noisy, torch.zeros((b, k), dtype=torch.int32, device=dev), k)[1]
    prev = torch.stack([
        warm[0], torch.randint(0, n, (k,), generator=g, device=dev).int(),
        torch.full((k,), -1, dtype=torch.int32, device=dev),
        torch.linspace(0, lengths[3] - 1, k, device=dev).int()]).contiguous()
    for pr, name in ((prev, "warm/random/-1/even"), (warm, "warm")):
        v1, i1, st1 = ops.gvr_topk(s2, pr, k, max_candidates=cmax)
        v0, i0, st0 = ref.gvr_topk_ref(s2, pr, k, max_candidates=cmax)
        torch.cuda.synchronize()
        if not (torch.equal(i1, i0) and torch.equal(v1, v0)
                and torch.equal(st1[:, 4:], st0[:, 4:])):
            fail(f"B1 on windowed rows ({name}): differs from the plain version")
    lo = (ln - win).clamp(min=0)
    if not bool((i1 >= lo[:, None]).all()):
        fail("B1 on windowed rows selected a position below length - window")
    log(f"[kernels] window {win} (h2o-danube): B2 scoring NEG outside "
        f"[length - window, length), max|err| {err:.3e} (scale {scale:.3e}); "
        f"{ctas}; B5 == B2 and B9 rows == B2 at their own lengths bit for "
        f"bit (max|err| {e5:.3e} / {e9:.3e}); B1 exact on the windowed rows "
        f"(warm, random, -1, even); per-row [secant, refine, cand, full-row] "
        f"= {st1[:, :4].int().tolist()}")
    # times: the scoring launches with and without the window; B1 on the
    # windowed rows. Bound: the keys of [lo, length) once, q, w, table,
    # lengths, the f32 row written
    in_keys = sum(-(-int(L) // ps) - int(lo_) // ps for L, lo_ in zip(lengths, lo.tolist()))
    flops = 2 * hi * di * int(inside.sum())
    out = {}
    for key, fn, fn_free, plain, bnd in (
            ("B2", lambda: ops.paged_indexer_scores(qi, pages, w, table, ln, win),
             lambda: ops.paged_indexer_scores(qi, pages, w, table, ln),
             lambda: ref.paged_indexer_scores_ref(qi, pages, w, table, ln, win),
             bound_ms(qi.numel() * 2 + in_keys * ps * di * 2 + hi * 4
                      + table.numel() * 4 + b * 4 + b * n * 4, flops)),
            ("B5", lambda: ops.indexer_scores(qi, kc5, w, ln, win),
             lambda: ops.indexer_scores(qi, kc5, w, ln),
             lambda: ref.indexer_scores_ref(qi, kc5, w, ln, win),
             bound_ms(qi.numel() * 2 + int(inside.sum()) * di * 2 + hi * 4
                      + b * 4 + b * n * 4, flops))):
        tw, tf = time_ms(fn, flush), time_ms(fn_free, flush)
        tp = time_ms(plain, flush, iters=5)
        out[key] = dict(ms=tw["ms"], free_ms=tf["ms"], plain_ms=tp["ms"],
                        bound=bnd)
        log(f"[kernels] {key} scoring under the window: device {tw['ms']:.5f} "
            f"ms (without it {tf['ms']:.5f}), plain {tp['ms']:.5f} ms, bound "
            f"{bnd[0]:.5f} ms ({bnd[1]}), {tw['ms'] / bnd[0]:.1f}x")
    t1 = time_ms(lambda: ops.gvr_topk(s2, prev, k, max_candidates=cmax), flush)
    p1 = time_ms(lambda: ref.gvr_topk_ref(s2, prev, k, max_candidates=cmax),
                 flush, iters=5)
    out["B1"] = dict(ms=t1["ms"], plain_ms=p1["ms"],
                     bound=bound_ms(b * n * 4 + prev.numel() * 4 + b * k * 8
                                    + b * 32, 0))
    log(f"[kernels] B1 on the windowed rows: device {t1['ms']:.5f} ms, wall "
        f"{t1['wall_ms']:.5f} ms, plain {p1['ms']:.5f} ms")
    return out


def phase_kernels_whisper_width(flush):
    """B6 at whisper-medium's decoder width (G 1, hd 64, KVH 16, bf16) at
    the kernel phase's shapes (B=4, N=8192, K=2048, lengths
    8192/5000/1000/3001; entries as `phase_kernels_moe_width` draws them):
    allclose to its plain version, == B3 over pages holding the same rows
    bit for bit, two calls and each slot alone bit-identical; timed and
    bounded as in `phase_kernels`. Returns {"B6": ...}."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1024)
    b, n, k, ps, kvh, h, hd = 4, 8192, 2048, 64, 16, 16, 64
    lengths = [8192, 5000, 1000, 3001]
    inp = _paged_inputs(g, dev, b=b, mp=n // ps, ps=ps, lengths=lengths,
                        kvh=kvh, hd=hd, h=h, di=8, hi=1)
    table, ln = inp["table"], inp["lengths"]
    idx = torch.stack([
        torch.randperm(L, generator=g, device=dev)[:k].sort().values
        if L >= k else torch.arange(k, device=dev) for L in lengths]).int()
    idx[1, :16] = -1
    idx[0, 16:32] = lengths[0] - 1
    idx = idx.contiguous()
    flat = table.clamp(min=0).long()
    kc = inp["k_pages"][flat].reshape(b, n, kvh, hd).contiguous()
    vc = inp["v_pages"][flat].reshape(b, n, kvh, hd).contiguous()
    args6 = (inp["q"], kc, vc, idx, ln)
    o6 = ops.sparse_decode_attn(*args6)
    o3 = ops.paged_sparse_decode_attn(inp["q"], inp["k_pages"], inp["v_pages"],
                                      table, idx, ln)
    o6r = ref.sparse_attn_ref(*args6)
    torch.cuda.synchronize()
    if not torch.equal(o6, o3):
        fail("B6 at whisper width: output differs from B3's on the same rows")
    # tolerance: B3's at llama's widths (f32 softmax and PV sums over the
    # same rows in another order)
    e6 = float((o6 - o6r).abs().max())
    if not torch.allclose(o6, o6r, atol=1e-4, rtol=1e-4):
        fail(f"B6 at whisper width: max |err| {e6} beyond atol=rtol=1e-4")
    _, splits = ops.decode_attn_splits("paged_sparse", k, n, ps)
    ctas = _check_split("B6 whisper width", ops.sparse_decode_attn, args6, o6,
                        splits * kvh * b, per_slot=(0, 1, 2, 3, 4))
    rows = int(((idx >= 0) & (idx < ln[:, None])).sum())
    bnd = bound_ms(inp["q"].numel() * 2 + rows * kvh * hd * 2 * 2
                   + idx.numel() * 4 + b * 4 + b * h * hd * 4,
                   4 * h * hd * rows)
    ker = time_ms(lambda: ops.sparse_decode_attn(*args6), flush)
    pl = time_ms(lambda: ref.sparse_attn_ref(*args6), flush, iters=6)
    log(f"[kernels] whisper-medium width (G {h // kvh}, hd {hd}, KVH {kvh}, "
        f"bf16): B6 allclose, max|err| {e6:.3e}, == B3 bit for bit, {ctas}; "
        f"device [least-most] / wall: kernel {ker['ms']:.5f} [{ker['lo']:.5f}-"
        f"{ker['hi']:.5f}] / {ker['wall_ms']:.5f} ms, plain {pl['ms']:.5f} / "
        f"{pl['wall_ms']:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}; {rows} "
        f"valid rows), {ker['ms'] / bnd[0]:.2f}x")
    return {"B6": dict(err=e6, ms=ker["ms"], wall_ms=ker["wall_ms"],
                       plain_ms=pl["ms"], bound=bnd)}


B7_AB_ROUNDS = 3


def phase_b7_ab(cfg, flush):
    """B7 against `torch.index_select` on one logical-view gather at
    llama's widths (B=4, N=8192, pages of 64, KVH 8, hd 64, bf16) through
    a fully mapped shuffled table, where the two compute the same
    function (checked bit for bit), timed in turns A B B A, B7_AB_ROUNDS
    times, in this one call (`time_ms`, L2 flushed). Returns (median,
    least, most) device ms of each."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(77)
    b, n, ps = 4, 8192, 64
    inp = _paged_inputs(g, dev, b=b, mp=n // ps, ps=ps, lengths=[n] * b,
                        kvh=cfg.n_kv_heads, hd=cfg.hd, h=cfg.n_heads, di=8, hi=1)
    pool, table = inp["k_pages"], inp["table"]
    flat = table.long().flatten()
    view = ops.paged_gather(pool, table)
    if not torch.equal(view.reshape(-1), pool.index_select(0, flat).reshape(-1)):
        fail("[b7-ab] B7 and index_select differ on a fully mapped table")
    fns = {"B7": lambda: ops.paged_gather(pool, table),
           "index_select": lambda: pool.index_select(0, flat)}
    ms = {key: [] for key in fns}
    for _ in range(B7_AB_ROUNDS):
        for key in ("B7", "index_select", "index_select", "B7"):
            ms[key].append(time_ms(fns[key], flush, iters=10)["ms"])
    out = {key: (statistics.median(v), min(v), max(v)) for key, v in ms.items()}
    (a, a_lo, a_hi), (c, c_lo, c_hi) = out["B7"], out["index_select"]
    spread = max(a_hi - a_lo, c_hi - c_lo)
    verdict = ("B7 loses by more than the spread" if a - c > spread else
               "B7 does not lose by more than the spread")
    log(f"[b7-ab] B7 == index_select bit for bit on a fully mapped table; "
        f"{B7_AB_ROUNDS} rounds A B B A, device ms median [least-most]: B7 "
        f"{a:.5f} [{a_lo:.5f}-{a_hi:.5f}], index_select {c:.5f} [{c_lo:.5f}-"
        f"{c_hi:.5f}]; B7 - index_select {a - c:+.5f} ms, spread {spread:.5f} "
        f"ms: {verdict}; every run B7 {ms['B7']}, index_select "
        f"{ms['index_select']}")
    return out


def _engine_run(model, params, *, max_len, specs, hook=None, **layout):
    """Serve `specs` [(prompt, max_new, arrival)] through a fresh 4-slot
    engine of the given layout, with the launch counts zeroed just before
    and read just after. `hook(engine)` runs before the requests."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.serve import DecodeEngine, Request
    layout = layout or dict(kv_layout="paged", paged_attn="fused")
    if layout["kv_layout"] == "paged":
        layout.setdefault("page_size", 64)
    eng = DecodeEngine(model, params, num_slots=4, max_len=max_len,
                       prefill_chunk=64, **layout)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=m, arrival=a)
            for i, (p, m, a) in enumerate(specs)]
    if hook is not None:
        hook(eng)
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


def main_specs(rng, vocab):
    """The main trace: five requests, the last sharing a 192-token prefix
    with the third."""
    shared = rng.integers(0, vocab, (192,))
    return [
        (rng.integers(0, vocab, (2300,)), 16, 0),      # > K: GVR's buffer path
        (rng.integers(0, vocab, (40,)), 16, 0),
        (np.concatenate([shared, rng.integers(0, vocab, (20,))]), 16, 0),
        (rng.integers(0, vocab, (300,)), 16, 1),
        (np.concatenate([shared, rng.integers(0, vocab, (9,))]), 16, 12),  # prefix reuse
    ]


def _check_paths(tag, eng, reqs):
    """Every request's selector path must be R (cold) then G only."""
    paths = _paths(eng, reqs)
    for r in reqs:
        p = paths[r.uid]
        if not (p[0] == "R" and set(p[1:]) <= {"G"} and "G" in p):
            fail(f"{tag} request {r.uid}: cold→warm dispatch not R then G: {p}")
    return paths


def _need(tag, counts, names):
    for name in names:
        if counts[name] == 0:
            fail(f"{tag} never launched {name}")


def _tally_b1_rows(ops):
    """Install a wrapper of `ops.paged_indexer_topk` (B2 + B1, the fused
    paged path's selection) that keeps, per call, the mask of rows shorter
    than K (from the lengths the caller passes) and stats column 1 (0 where
    P4 was settled by the row-minimum test). Only device tensors are kept,
    so the run gains no host synchronisation; returns the list and a
    function that puts the original back."""
    orig, seen = ops.paged_indexer_topk, []

    def tally(q, k_pages, w, table, prev_idx, k, **kw):
        out = orig(q, k_pages, w, table, prev_idx, k, **kw)
        seen.append((kw["lengths"] < k, out[2][:, 1]))
        return out

    ops.paged_indexer_topk = tally
    return seen, lambda: setattr(ops, "paged_indexer_topk", orig)


def _b1_row_shares(seen):
    """(launches, launches with a row shorter than K, rows, rows shorter
    than K, rows whose stats column 1 reads 0) over a tally's calls."""
    import torch
    if not seen:
        return 0, 0, 0, 0, 0
    short = [s for s, _ in seen]
    any_short = int(torch.stack([s.any() for s in short]).sum())
    flat = torch.cat(short)
    minimum = int((torch.cat([c for _, c in seen]) == 0).sum())
    return len(seen), any_short, flat.numel(), int(flat.sum()), minimum


def phase_main(model, params, specs):
    """The main path: paged, fused, greedy engine at full width."""
    from repro_torch.kernels import ops
    seen, restore = _tally_b1_rows(ops)
    try:
        eng, reqs, rep, counts = _engine_run(model, params, max_len=8192,
                                             specs=specs)
    finally:
        restore()
    paths = _paths(eng, reqs)
    log(f"[main] llama3.2-1b full width, {model.cfg.n_layers} layers, "
        f"max_len 8192, 4 slots, beside h2o-danube's two engine processes, "
        f"{len(reqs)} requests: {rep.decoded_tokens} decoded + "
        f"{rep.prefill_tokens} prefill tokens in {rep.ticks} ticks, "
        f"{rep.wall_s:.3f} s wall, {rep.tokens_per_s:.2f} decoded tokens/s, "
        f"gvr_hit_rate {rep.gvr_hit_rate:.4f}, prefix_hit_tokens "
        f"{rep.prefix_hit_tokens}")
    steps = counts["gvr_topk"] // model.cfg.n_layers
    log(f"[main] {steps} model steps (batch-1 prefill + pool decode), "
        f"{rep.wall_s / max(steps, 1) * 1e3:.3f} ms host wall per step")
    log(f"[main] selector path per request (R radix/cold, G gvr): {paths}")
    log(f"[main] tokens: {[list(r.generated) for r in reqs]}")
    log(f"[main] launches: {counts}")
    calls, short_calls, rows, short_rows, minimum = _b1_row_shares(seen)
    log(f"[main] B1 rows shorter than K={model.cfg.dsa.k}: {short_calls} of "
        f"{calls} launches through paged_indexer_topk "
        f"({short_calls / max(calls, 1):.4f}; gvr_topk launches "
        f"{counts['gvr_topk']}) hold one, {short_rows} of {rows} rows "
        f"({short_rows / max(rows, 1):.4f}); P4 settled by the row-minimum "
        f"test (stats column 1 == 0) on {minimum} rows")
    _need("main path", counts, ("gvr_topk", "paged_indexer_scores",
                                "paged_sparse_decode_attn"))
    _check_paths("[main]", eng, reqs)
    return counts, [list(r.generated) for r in reqs]


def phase_dense_layout(model, params, specs, main_tokens):
    """The main trace through the dense KV layout: B5 + B1 select, B6
    attends. The tokens must be [main]'s; the dense layout has no prefix
    cache, so request 4 prefills its shared prefix (the method logs may
    differ there, the reference pins only tokens)."""
    eng, reqs, rep, counts = _engine_run(model, params, max_len=8192,
                                         specs=specs, kv_layout="dense")
    steps = counts["gvr_topk"] // model.cfg.n_layers
    paths = _check_paths("[dense-layout]", eng, reqs)
    log(f"[dense-layout] llama3.2-1b full width, {model.cfg.n_layers} "
        f"layers, max_len 8192, 4 slots: "
        f"{rep.decoded_tokens} decoded + {rep.prefill_tokens} prefill tokens "
        f"in {rep.ticks} ticks, {rep.wall_s:.3f} s wall, "
        f"{rep.tokens_per_s:.2f} decoded tokens/s, {steps} model steps, "
        f"{rep.wall_s / max(steps, 1) * 1e3:.3f} ms host wall per step, "
        f"prefix_hit_tokens {rep.prefix_hit_tokens}")
    log(f"[dense-layout] paths {paths}; launches: {counts}")
    _need("dense layout", counts, ("indexer_scores", "gvr_topk",
                                   "sparse_decode_attn"))
    got = [list(r.generated) for r in reqs]
    if got != main_tokens:
        bad = [i for i, (a, c) in enumerate(zip(got, main_tokens)) if a != c]
        fail(f"[dense-layout] tokens differ from [main]'s for requests {bad}")
    log("[dense-layout] tokens == [main]'s for every request")
    return counts


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def _profile_step(params, st, tokens, cfg, flush, tag="[step]", step=None):
    """Host wall time of one B=4 decode step and, from torch.profiler,
    the device time of its kernels (the L2 flushed before each profiled
    step): the device's busy and idle share. `step(params, state,
    tokens, cfg)` is the family's step, `transformer.serve_step_paged` by
    default. The step rewrites the same cache rows each call (its new
    state is dropped), so repeated calls see the same inputs. Returns
    {"wall_ms", "device_ms"}, device_ms None when no profiled step was
    complete; `tools/ab_decode_attn.py` calls it on two checkouts."""
    import torch
    from repro_torch.models import transformer
    step = step or transformer.serve_step_paged
    for _ in range(2):
        step(params, st, tokens, cfg)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step(params, st, tokens, cfg)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    # device-side events only (kernels, copies): the operator entries of
    # key_averages() carry their kernels' time too and would count it twice
    calls, seen = _profiled_calls(lambda: step(params, st, tokens, cfg),
                                  flush, reps)
    what = f"{tag} B={tokens.shape[0]} decode step"
    if not calls:
        log(f"{what}: {step_ms:.3f} ms host wall; device time not measured "
            f"(the profiler saw no complete step)")
        return dict(wall_ms=step_ms, device_ms=None)
    dev = {}
    for call in calls:
        for name, us in call:
            dev[name] = dev.get(name, 0.0) + us / len(calls) / 1e3
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    log(f"{what}: {step_ms:.3f} ms host wall, {busy:.3f} ms device busy "
        f"({busy / step_ms:.3f} busy share; {len(calls)} of {reps} profiled "
        f"steps complete); top device time per step (ms): "
        + ", ".join(f"{k[:48]}={v:.4f}" for k, v in top))
    return dict(wall_ms=step_ms, device_ms=busy)


def _random_step_state(model, g, dev, lengths, b=4, max_len=8192, ps=64,
                       per_layer=False):
    """A paged DSA state with random pools, a shuffled full block table,
    the given lengths and random (partly cold) feedback. `per_layer` draws
    the pools one layer at a time (another stream of numbers): a whole f32
    draw of moonshot-v1-16b-a3b's K pool would be a 13 GB temporary."""
    import torch
    cfg = model.cfg
    mp = max_len // ps
    st = model.init_paged_decode_state(b, max_len, num_pages=b * mp, page_size=ps)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        for pool in (st[key] if per_layer else [st[key]]):
            pool.copy_(torch.randn(pool.shape, generator=g, device=dev))
    perm = torch.randperm(b * mp, generator=g, device=dev).int().reshape(b, mp)
    st["page_table"] = perm.contiguous()
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kk = st["prev_topk"].shape[-1]
    st["prev_topk"] = torch.stack([
        torch.randint(0, L, (cfg.n_layers, kk), generator=g, device=dev)
        for L in lengths], dim=1).int()
    st["topk_valid"] = torch.tensor([True, True, False, True], device=dev
                                    ).expand(cfg.n_layers, b).contiguous()
    return st


def phase_step(model, params, cpu_params, rng, flush, tag="[step]",
               profile=True):
    """One serve_step_paged on the card and through the plain path on the
    CPU, from the same state; `profile` also times it on the card
    (`_profile_step`)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.models import transformer
    from repro_torch.models.layers import rms_norm
    from repro_torch.sparse import dsa
    cfg = model.cfg
    dev = torch.device("cuda")
    b = 4
    g = torch.Generator(device=dev).manual_seed(99)
    st = _random_step_state(model, g, dev, STEP_LENGTHS)
    kk = st["prev_topk"].shape[-1]
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (b,)), dtype=torch.int32,
                          device=dev)
    cpu_state = {k: v.cpu().clone() for k, v in st.items()}
    logits_gpu, new_gpu = transformer.serve_step_paged(params, st, tokens, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_cpu, new_cpu = transformer.serve_step_paged(cpu_params, cpu_state,
                                                       tokens.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    lg, lc = logits_gpu.cpu(), logits_cpu
    if not (torch.isfinite(lg).all() and lg.shape == (b, cfg.vocab)):
        fail("step: logits not finite or of the wrong shape")
    rel, argmax_agree = _logits_vs(tag, lg, lc)
    agree = _topk_agreement(new_gpu["prev_topk"], new_cpu["prev_topk"])
    flips = []
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
                                      cpu_state["page_table"], cpu_state["length"] + 1,
                                      cfg.swa_window)
    for row in range(b):
        a = set(new_gpu["prev_topk"][0, row].cpu().tolist())
        c = set(new_cpu["prev_topk"][0, row].tolist())
        for i in sorted(a ^ c)[:4]:
            kth = float(torch.topk(s0[row], kk).values[-1])
            flips.append((row, i, float(s0[row, i]) - kth))
    if profile:
        _profile_step(params, st, tokens, cfg, flush, tag)
    log(f"{tag} logits rel L2 err {rel:.3e} (argmax agreement "
        f"{argmax_agree:.2f}); CPU plain step {cpu_s:.3f} s; per-layer "
        f"Top-K agreement {agree}")
    log(f"{tag} layer-0 near-tie flips (slot, index, score - kth): {flips}")
    if agree[0] < 0.99:
        fail(f"{tag} layer-0 Top-K agreement {agree[0]} < 0.99")


def _logits_vs(tag, lg, lc):
    """Relative L2 error and argmax agreement of two logits tensors.
    Tolerance: the same bf16 model run two ways that round differently
    (other matmul kernels or another order of the attention sums, rounding
    to bf16 at every layer boundary): ~2^-8 relative per rounding,
    compounded over 16 layers; relative L2 error of the logits <= 5e-2."""
    import torch
    if not (torch.isfinite(lg).all() and lg.shape == lc.shape):
        fail(f"{tag}: logits not finite or of the wrong shape")
    rel = float((lg.float() - lc.float()).norm() / lc.float().norm())
    if rel > 5e-2:
        fail(f"{tag}: logits relative L2 error {rel} > 5e-2")
    return rel, float((lg.argmax(-1) == lc.argmax(-1)).float().mean())


def _topk_agreement(a, c):
    """Per-layer share of Top-K entries two (L, B, K) selections share."""
    a, c = a.cpu(), c.cpu()
    return [round(sum(len(set(x.tolist()) & set(y.tolist()))
                      for x, y in zip(a[i], c[i])) / a[i].numel(), 5)
            for i in range(a.shape[0])]


def _rel(a, b) -> float:
    """Relative L2 error of a (the card's) against b (the CPU's)."""
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm())


def phase_layouts(model, params, cpu_params, rng):
    """One B=4 DSA step from one state in four forms: paged fused, paged
    gather (B7 views, then B5/B1/B6), paged page-granular (B10) and the
    dense layout holding the same rows. Fused, gather and dense must agree
    bit for bit in logits and every layer's Top-K."""
    import torch
    from repro_torch.models import transformer
    cfg = model.cfg
    dev = torch.device("cuda")
    b, max_len = 4, 8192
    g = torch.Generator(device=dev).manual_seed(7)
    st = _random_step_state(model, g, dev, STEP_LENGTHS)
    table = st["page_table"].long()
    dense = model.init_decode_state(b, max_len)
    for src, dst in (("k_pages", "k"), ("v_pages", "v"), ("idx_k_pages", "idx_k")):
        for i in range(cfg.n_layers):
            dense[dst][i].copy_(st[src][i][table].reshape(dense[dst][i].shape))
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        dense[key] = st[key].clone()
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (b,)), dtype=torch.int32,
                          device=dev)
    cpu_dense = {k: v.cpu().clone() for k, v in dense.items()}

    def clone(x):
        return {k: v.clone() for k, v in x.items()}

    out = {}
    for form, kw in (("fused", dict(paged_attn="fused")),
                     ("gather", dict(paged_attn="gather")),
                     ("page", dict(gather_granularity="page"))):
        out[form] = transformer.serve_step_paged(params, clone(st), tokens, cfg, **kw)
    out["dense"] = transformer.serve_step(params, dense, tokens, cfg)
    torch.cuda.synchronize()
    lf, sf = out["fused"]
    for form in ("gather", "dense"):
        lg, sg = out[form]
        if not torch.equal(lg, lf):
            fail(f"[layouts] {form} logits differ from fused (max |diff| "
                 f"{float((lg - lf).abs().max())})")
        bad = [i for i in range(cfg.n_layers)
               if not torch.equal(sg["prev_topk"][i], sf["prev_topk"][i])]
        if bad:
            fail(f"[layouts] {form} Top-K differs from fused at layers {bad}")
    lp, sp = out["page"]
    rel_p, arg_p = _logits_vs("[layouts] page vs token", lp, lf)
    agree_p = _topk_agreement(sp["prev_topk"], sf["prev_topk"])
    if agree_p[0] != 1.0 or min(agree_p) < 0.99:
        fail(f"[layouts] page-granular Top-K agreement {agree_p}")
    log(f"[layouts] B=4 DSA step, lengths {STEP_LENGTHS}: fused == gather == "
        f"dense bit for bit (logits and all {cfg.n_layers} layers' Top-K); "
        f"page vs token logits rel L2 {rel_p:.3e}, argmax agreement {arg_p:.2f}, "
        f"per-layer Top-K agreement {agree_p}")
    t0 = time.perf_counter()
    lc, sc = transformer.serve_step(cpu_params, cpu_dense, tokens.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    rel, arg = _logits_vs("[layouts] dense card vs CPU", out["dense"][0].cpu(), lc)
    agree = _topk_agreement(out["dense"][1]["prev_topk"], sc["prev_topk"])
    if agree[0] < 0.99:
        fail(f"[layouts] dense layer-0 Top-K agreement card vs CPU {agree[0]} < 0.99")
    log(f"[layouts] dense card vs CPU plain path: logits rel L2 {rel:.3e} "
        f"(argmax agreement {arg:.2f}); CPU plain step {cpu_s:.3f} s; "
        f"per-layer Top-K agreement {agree}")


def phase_gather_page(model, params, rng):
    """The paged engine with the gather oracle (B7) and with page-granular
    attention (B10) on a short trace, against a fused run of it."""
    vocab = model.cfg.vocab
    specs = short_specs(rng, vocab)
    runs = {}
    for form, kw in (("fused", dict(paged_attn="fused")),
                     ("gather", dict(paged_attn="gather")),
                     ("page", dict(gather_granularity="page"))):
        timer = DecodeTimer()
        eng, reqs, rep, counts = _engine_run(model, params, max_len=8192,
                                             specs=specs, hook=timer.install,
                                             kv_layout="paged", **kw)
        _check_paths(f"[{form}]", eng, reqs)
        runs[form] = ([list(r.generated) for r in reqs], counts)
        log(f"[{form}] short trace (prompts 200/80/40, 8 new each): "
            f"{rep.decoded_tokens} decoded tokens in {rep.ticks} ticks, "
            f"{rep.wall_s:.3f} s wall; {timer.summary(rep, len(reqs))}; "
            f"launches: {counts}")
        if form == "fused":
            fused = (specs, runs[form][0], timer.rate(rep, len(reqs)))
    _need("gather oracle", runs["gather"][1], ("paged_gather", "indexer_scores",
                                              "sparse_decode_attn"))
    _need("page-granular path", runs["page"][1], ("paged_sparse_decode_attn_pg",))
    if runs["gather"][0] != runs["fused"][0]:
        fail("[gather] tokens differ from the fused run of the same trace")
    same = sum(a == c for ra, rc in zip(runs["page"][0], runs["fused"][0])
               for a, c in zip(ra, rc))
    total = sum(len(r) for r in runs["fused"][0])
    log(f"[gather] tokens == fused; [page] token agreement with fused "
        f"{same}/{total}")
    return runs["gather"][1], runs["page"][1], fused


def short_specs(rng, vocab):
    """The short trace of [gather], [page] and [spec]: prompts of 200, 80
    and 40 tokens, 8 new tokens each."""
    return [(rng.integers(0, vocab, (n,)), 8, a)
            for n, a in ((200, 0), (80, 0), (40, 2))]


class DecodeTimer:
    """Host wall of each engine decode tick that served a DECODE slot (the
    verify tick under speculation), the device synchronised at its end."""

    def __init__(self):
        self.seconds = []

    def install(self, eng):
        import torch
        from repro_torch.serve import DECODE
        inner = eng._decode_tick

        def timed():
            busy = any(r is not None and r.phase == DECODE for r in eng.slots)
            t0 = time.perf_counter()
            inner()
            torch.cuda.synchronize()
            if busy:
                self.seconds.append(time.perf_counter() - t0)

        eng._decode_tick = timed

    def rate(self, rep, n_requests):
        """Tokens the decode ticks emitted (each request's first token
        comes from its last prefill step) per second of decode tick."""
        return (rep.decoded_tokens - n_requests) / sum(self.seconds)

    def summary(self, rep, n_requests):
        return (f"{len(self.seconds)} decode ticks, "
                f"{statistics.mean(self.seconds) * 1e3:.3f} ms host wall per "
                f"tick, {self.rate(rep, n_requests):.2f} decode-tick tokens/s")


def _assert_nonspec_page_shape(eng):
    """After a tick every DECODE slot's mapped logical pages cover exactly
    [0, length), as non-speculative decode keeps them."""
    from repro_torch.serve import DECODE
    lengths = eng.state["length"].cpu().tolist()
    for s, req in enumerate(eng.slots):
        if req is None or req.phase != DECODE:
            continue
        want = list(range((lengths[s] - 1) // eng.kv.page_size + 1))
        got = [lp for lp in range(eng.kv.pages_per_slot)
               if eng.kv.tables[s].get(lp) >= 0]
        if got != want:
            fail(f"[spec] slot {s} at length {lengths[s]} maps logical pages "
                 f"{got}, not {want}")
    eng.kv.pool.assert_consistent()


_MQ_KERNELS = ("paged_indexer_scores_mq", "gvr_topk_chain",
               "paged_sparse_decode_attn_mq")


def phase_spec(model, params, fused):
    """Speculative decoding at depth 2 on the short trace, each run against
    the fused run's tokens: (a) scan + oracle drafts, (b) mq + oracle
    drafts, (c) mq + every second draft wrong, pages checked after every
    tick, (d) mq + the default n-gram drafter."""
    from repro_torch.serve import ReplayDrafter, ScriptedDrafter
    specs, fused_tokens, fused_rate = fused
    vocab = model.cfg.vocab
    cont = {i: t for i, t in enumerate(fused_tokens)}

    def second_wrong(req, d):
        draft = list(cont[req.uid][len(req.generated):len(req.generated) + d])
        if len(draft) >= 2:
            draft[1] = (draft[1] + 1) % vocab
        return draft

    runs = {}
    for tag, vk, drafter, check in (
            ("a", "scan", ReplayDrafter(cont), False),
            ("b", "mq", ReplayDrafter(cont), False),
            ("c", "mq", ScriptedDrafter(second_wrong), True),
            ("d", "mq", None, False)):
        timer = DecodeTimer()

        def hook(eng, timer=timer, check=check):
            timer.install(eng)
            if check:
                inner = eng.tick

                def checked():
                    inner()
                    _assert_nonspec_page_shape(eng)

                eng.tick = checked

        eng, reqs, rep, counts = _engine_run(
            model, params, max_len=8192, specs=specs, hook=hook,
            kv_layout="paged", spec_depth=SPEC_DEPTH, verify_kernel=vk,
            drafter=drafter)
        name = f"[spec] ({tag}) {vk}, {type(eng.drafter).__name__}"
        paths = _check_paths(name, eng, reqs)
        got = [list(r.generated) for r in reqs]
        if got != fused_tokens:
            fail(f"{name}: tokens differ from the fused run's: {got} vs "
                 f"{fused_tokens}")
        if vk == "scan":
            _need(name, counts, ("paged_indexer_scores", "gvr_topk",
                                 "paged_sparse_decode_attn"))
            if any(counts[kk] for kk in _MQ_KERNELS):
                fail(f"{name} launched an mq kernel: {counts}")
        else:
            _need(name, counts, _MQ_KERNELS)
        rate = timer.rate(rep, len(reqs))
        log(f"{name}: tokens == fused; paths {paths}; spec_ticks "
            f"{rep.spec_ticks}, drafted {rep.spec_drafted}, accepted "
            f"{rep.spec_accepted}, acceptance {rep.spec_acceptance_rate:.4f}, "
            f"gvr_hit_rate_by_draft_pos {rep.gvr_hit_rate_by_draft_pos}; "
            f"{rep.wall_s:.3f} s wall, {timer.summary(rep, len(reqs))} "
            f"({rate / fused_rate:.3f}x the fused run's); launches: {counts}")
        runs[tag] = counts
    return runs["b"]


def phase_verify_step(model, params, rng):
    """One verify tick of B=4 slots at lengths VERIFY_L0 from one state,
    draft lengths (2, 1, 0, 2), through scan and mq. Slot 0 accepts both
    drafts, slot 1 rejects its one, slot 3 accepts one of two."""
    import torch
    from repro_torch.models import transformer
    cfg = model.cfg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(31)
    st = _random_step_state(model, g, dev, VERIFY_L0)
    b, d1 = len(VERIFY_L0), SPEC_DEPTH + 1
    dl = torch.tensor([2, 1, 0, 2], dtype=torch.int32, device=dev)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (b, d1)),
                          dtype=torch.int32, device=dev)

    def verify(vk):
        clone = {key: v.clone() for key, v in st.items()}
        return transformer.serve_step_spec_paged(
            params, clone, tokens, cfg, draft_len=dl, max_accept=dl,
            verify_kernel=vk)

    for j, wrong in ((1, 1), (2, 3)):            # draft j from position j-1
        tokens[:, j] = verify("scan")[0][:, j - 1]
        tokens[wrong, j] = (tokens[wrong, j] + 1) % cfg.vocab
    t0 = time.perf_counter()
    scan = verify("scan")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mq = verify("mq")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    acc = scan[1].tolist()
    if acc != [2, 0, 0, 1]:
        fail(f"[verify-step] accept lengths {acc}, expected [2, 0, 0, 1]")
    for name, a, c in (("out_tokens", scan[0], mq[0]), ("accept_len", scan[1], mq[1]),
                       ("sel_gvr_pos", scan[3], mq[3])):
        if not torch.equal(a, c):
            fail(f"[verify-step] {name} differs between scan and mq: "
                 f"{a.tolist()} vs {c.tolist()}")
    for key in ("length", "topk_valid", "sel_gvr"):
        if not torch.equal(scan[4][key], mq[4][key]):
            fail(f"[verify-step] rolled-back {key} differs between scan and mq")
    live = [(s, j) for s in range(b) for j in range(int(dl[s]) + 1)]
    logits_equal = all(torch.equal(scan[2][s, j], mq[2][s, j]) for s, j in live)
    topk_equal = [bool(torch.equal(scan[4]["prev_topk"][i], mq[4]["prev_topk"][i]))
                  for i in range(cfg.n_layers)]
    rel = max(float((scan[2][s, j] - mq[2][s, j]).norm() / scan[2][s, j].norm())
              for s, j in live)
    agree = _topk_agreement(mq[4]["prev_topk"], scan[4]["prev_topk"])
    log(f"[verify-step] B=4 at L0 {VERIFY_L0}, draft_len {dl.tolist()}: "
        f"accept {acc}; out_tokens, accept_len, sel_gvr_pos and rolled-back "
        f"length/topk_valid/sel_gvr equal in scan and mq; live-position "
        f"logits bit-equal: {logits_equal} (max rel L2 {rel:.3e}); rolled-back "
        f"Top-K bit-equal per layer: {topk_equal} (agreement {agree}); scan "
        f"{(t1 - t0) * 1e3:.3f} ms, mq {(t2 - t1) * 1e3:.3f} ms host wall")
    if logits_equal and not all(topk_equal):
        fail("[verify-step] equal logits but a differing rolled-back Top-K")
    if agree[0] < 0.99:
        fail(f"[verify-step] layer-0 Top-K agreement {agree[0]} < 0.99")


def phase_dense(model, params, rng):
    """The pre-DSA fallback (max_len 4096 <= min_n): the paged engine
    (kernel B4), then a short run of the dense layout (plain attention)."""
    vocab = model.cfg.vocab
    specs = [(rng.integers(0, vocab, (n,)), 12, 0) for n in (500, 64, 1200, 250)]
    eng, reqs, rep, counts = _engine_run(model, params, max_len=4096, specs=specs)
    log(f"[dense] max_len 4096 <= min_n: {rep.decoded_tokens} decoded tokens "
        f"in {rep.ticks} ticks, {rep.wall_s:.3f} s; paths "
        f"{set(_paths(eng, reqs).values())}; launches: {counts}")
    _need("dense fallback", counts, ("paged_dense_decode_attn",))
    eng2, reqs2, rep2, counts2 = _engine_run(model, params, max_len=4096,
                                             specs=specs[1::2], kv_layout="dense")
    same = sum(a == c for r2, r in zip(reqs2, reqs[1::2])
               for a, c in zip(r2.generated, r.generated))
    log(f"[dense] dense layout, max_len 4096, the 64- and 250-token requests: "
        f"{rep2.decoded_tokens} decoded tokens in {rep2.ticks} ticks, "
        f"{rep2.wall_s:.3f} s; paths {set(_paths(eng2, reqs2).values())}; "
        f"token agreement with the paged run {same}/"
        f"{sum(len(r.generated) for r in reqs2)}; launches: {counts2}")
    if any(set(p) != {"D"} for p in _paths(eng2, reqs2).values()):
        fail("[dense] dense layout at max_len 4096 did not take the fallback")
    return counts


def moe_specs(rng, vocab):
    """The [moe] trace: prompts of 192, 64, 40 and 24 tokens, 8 new tokens
    each; the 64-token prompt is the first one's first page, and arrives
    once that page is in the prefix cache (tick 4: the first prompt's
    prefill ends at tick 2)."""
    first = rng.integers(0, vocab, (192,))
    return [(first, 8, 0), (first[:64].copy(), 8, 4),
            (rng.integers(0, vocab, (40,)), 8, 0),
            (rng.integers(0, vocab, (24,)), 8, 1)]


_LAYOUT_NEED = {"paged": ("paged_indexer_scores", "gvr_topk",
                          "paged_sparse_decode_attn"),
                "dense": ("indexer_scores", "gvr_topk", "sparse_decode_attn")}
_LAYOUT_KW = {"paged": {}, "dense": dict(kv_layout="dense")}


def _layout_run(model, params, specs, layout, tag):
    """One engine run of a trace at max_len 8192 and 4 slots in one
    layout ("paged": fused, B2/B1/B3; "dense": B5/B1/B6): paths R then all
    G and the layout's kernels launched, else it fails. Returns what
    `_log_layout_run` prints, JSON-serialisable."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, rep, counts = _engine_run(model, params, max_len=8192,
                                         specs=specs, **_LAYOUT_KW[layout])
    paths = _check_paths(f"{tag} {layout}", eng, reqs)
    _need(f"{tag} {layout}", counts, _LAYOUT_NEED[layout])
    out = dict(layout=layout, tokens=[list(map(int, r.generated)) for r in reqs],
               counts=counts, paths={u: len(p) for u, p in paths.items()},
               decoded=rep.decoded_tokens, prefill=rep.prefill_tokens,
               ticks=rep.ticks, wall_s=rep.wall_s, tokens_per_s=rep.tokens_per_s,
               gvr_hit_rate=rep.gvr_hit_rate, prefix_hit=rep.prefix_hit_tokens,
               steps=counts["gvr_topk"] // model.cfg.n_layers,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _log_layout_run(tag, cfg, specs, res, note=""):
    log(f"{tag} {cfg.name}, {res['layout']}, {cfg.n_layers} layers, max_len "
        f"8192, 4 slots, prompts {[len(p) for p, _, _ in specs]}{note}: "
        f"{res['decoded']} decoded + {res['prefill']} prefill tokens in "
        f"{res['ticks']} ticks, {res['wall_s']:.3f} s wall, "
        f"{res['tokens_per_s']:.3f} decoded tokens/s, {res['steps']} model "
        f"steps, {res['wall_s'] / max(res['steps'], 1) * 1e3:.3f} ms host wall "
        f"per step, gvr_hit_rate {res['gvr_hit_rate']:.4f}, prefix_hit_tokens "
        f"{res['prefix_hit']}, peak device memory {res['peak_gib']:.3f} GiB")
    log(f"{tag} {res['layout']} selector path per request: R then all G "
        f"({ {u: n for u, n in res['paths'].items()} } ticks); launches: "
        f"{res['counts']}")


def _same_tokens(tag, paged, dense):
    if paged["tokens"] != dense["tokens"]:
        bad = [i for i, (a, c) in enumerate(zip(paged["tokens"], dense["tokens"]))
               if a != c]
        fail(f"{tag} dense-layout tokens differ from the paged run's for "
             f"requests {bad}")
    log(f"{tag} dense-layout tokens == paged fused tokens for every request: "
        f"{paged['tokens']}")


def phase_two_layouts(model, params, specs, tag):
    """A model family's main path: a trace through the paged fused engine
    (B2/B1/B3), then through the dense layout (B5/B1/B6), one engine at a
    time (`_layout_run`); the two layouts' tokens must be equal. [moe]
    and the cut-depth [dense-family] runs. Returns the two runs' launch
    counts."""
    runs = {}
    for layout in ("paged", "dense"):
        runs[layout] = _layout_run(model, params, specs, layout, tag)
        _log_layout_run(tag, model.cfg, specs, runs[layout])
    _same_tokens(tag, runs["paged"], runs["dense"])
    return runs["paged"]["counts"], runs["dense"]["counts"]


def _first_layers(tree, n):
    """The first n layers' views of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _first_layers(v, n) for k, v in tree.items()}
    return tree[:n]


def _cut(model, params, key):
    """The first 2 layers of a model's stacked `key` tree (views, full
    width) and a model of that depth."""
    from repro_torch.models.api import build_model
    cut = build_model(dataclasses.replace(model.cfg, n_layers=2),
                      device=model.device)
    return cut, {**params, key: _first_layers(params[key], 2)}


def _cut_vs_cpu(model, params, rng, flush, tag):
    """The first 2 layers of a model's weights (views, full width) through
    one step on the card and through the plain path on the CPU
    (`phase_step`, unprofiled); the whole model has no CPU copy."""
    cut, cut_params = _cut(model, params, "layers")
    phase_step(cut, cut_params, _to_cpu(cut_params), rng, flush,
               tag=f"{tag} 2-layer cut", profile=False)


def phase_moe_step(model, params, rng, flush):
    """One B=4 DSA step of the MoE model at STEP_LENGTHS under the
    profiler, with the dense fallback timed alone (one layer's call at the
    step's shape, times the layers: its share of the step's device time);
    then a 2-layer cut of the same weights at full width, on the card and
    through the plain path on the CPU (`phase_step`; the full model has no
    CPU copy)."""
    import torch
    from repro_torch.models.layers import moe_mlp_dense_fallback
    from repro_torch.models.transformer import layer_params
    cfg = model.cfg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    st = _random_step_state(model, g, dev, STEP_LENGTHS, per_layer=True)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (4,)), dtype=torch.int32,
                          device=dev)
    prof = _profile_step(params, st, tokens, cfg, flush, "[moe-step]")
    del st
    torch.cuda.empty_cache()
    lay = layer_params(params["layers"], 0)
    e, f, d = cfg.moe.num_experts, cfg.moe.expert_d_ff, cfg.d_model
    h = torch.randn((4, 1, d), generator=g, device=dev).to(lay["w_gate"].dtype)
    moe = time_ms(lambda: moe_mlp_dense_fallback(
        h, lay["router"], lay["w_gate"], lay["w_up"], lay["w_down"],
        top_k=cfg.moe.top_k), flush)
    # every expert's three matrices, the f32 router, x in and out once
    bnd = bound_ms(3 * e * d * f * 2 + d * e * 4 + 2 * h.numel() * 2,
                   2 * h.shape[0] * 3 * e * d * f)
    per_step = moe["ms"] * cfg.n_layers
    share = ("not measured" if prof["device_ms"] is None
             else f"{per_step / prof['device_ms']:.3f}")
    log(f"[moe-step] dense fallback, one layer at B=4 (all {e} experts): "
        f"device {moe['ms']:.5f} ms [{moe['lo']:.5f}-{moe['hi']:.5f}], wall "
        f"{moe['wall_ms']:.5f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}), "
        f"{moe['ms'] / bnd[0]:.2f}x; x {cfg.n_layers} layers = "
        f"{per_step:.3f} ms, {share} of the step's device time")
    _cut_vs_cpu(model, params, rng, flush, "[moe-step]")
    return dict(wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                moe_ms=moe["ms"])


# the [dense-family] trace: one prompt longer than h2o-danube's window of
# 4096, so that the last rows of its prefill and every decode row are cut
FAMILY_LONG_PROMPT = 4200


def family_specs(rng, vocab):
    """The [dense-family] trace: prompts of FAMILY_LONG_PROMPT, 300, 64
    and 40 tokens, 8 new tokens each; the 64-token prompt is the 300-token
    one's first page and arrives once that page is in the prefix cache."""
    mid = rng.integers(0, vocab, (300,))
    return [(rng.integers(0, vocab, (FAMILY_LONG_PROMPT,)), 8, 0), (mid, 8, 0),
            (mid[:64].copy(), 8, 8), (rng.integers(0, vocab, (40,)), 8, 1)]


def short_family_specs(rng, vocab):
    """The trace of the cut-depth family runs: prompts of 300, 64 (the
    first one's first page, arriving once it is cached) and 40 tokens, 8
    new tokens each."""
    first = rng.integers(0, vocab, (300,))
    return [(first, 8, 0), (first[:64].copy(), 8, 8),
            (rng.integers(0, vocab, (40,)), 8, 1)]


# h2o-danube-3-4b's two layouts run in two child processes beside the
# llama engine phases (`python3 chip_smoke.py --family-engine
# paged|dense`). This is what fits the 1200 s limit: the prompt past the
# window prefills one token a model step, ~4,600 steps of 24 layers a
# layout at ~85 ms each (host-bound, the card idle ~85% of a step), so
# ~400 s a layout and ~800 s for both in this process, where the rest of
# the script, the build included, takes ~730 s on the H100. Side by side
# the two layouts and the llama engine phases end together (~430 s); the
# llama engines' host walls read higher while they run (PERF.md), and
# the profiled llama steps wait for the children. Since the training
# phases joined the script the children run FAMILY_CHILD_DEPTH of its 24
# layers (full width; the trace still crosses the window), so that they
# end halfway through the llama phases, which then run alone and faster.
FAMILY_ARCH = "h2o-danube-3-4b"
FAMILY_CHILD_DEPTH = 8
FAMILY_CHILD_TIMEOUT_S = 900


def family_engine_child(layout: str) -> int:
    """A child's work: h2o-danube-3-4b at full width and FAMILY_CHILD_DEPTH
    layers, seed 0, the [dense-family] trace in one layout; prints the
    run as JSON last."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    cfg = dataclasses.replace(get_config(FAMILY_ARCH),
                              n_layers=FAMILY_CHILD_DEPTH)
    model = build_model(cfg)
    params = model.init_params(seed=0)
    res = _layout_run(model, params, family_specs(np.random.default_rng(20),
                                                  cfg.vocab),
                      layout, "[dense-family]")
    torch.cuda.synchronize()
    print(json.dumps(res), flush=True)
    return 0


def start_family_children(log_dir: Path):
    """Start one child per layout; their output goes to log files."""
    log_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for layout in ("paged", "dense"):
        f = open(log_dir / f"family_{layout}.log", "w")
        procs[layout] = (subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--family-engine",
             layout], stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT)), f)
    return procs


def stop_family_children(procs) -> None:
    for proc, f in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()


def join_family_children(procs, log_dir: Path, specs, cfg):
    """Wait for both children, print their runs, hold the tokens equal.
    Returns (paged counts, dense counts)."""
    runs = {}
    for layout, (proc, f) in procs.items():
        try:
            rc = proc.wait(timeout=FAMILY_CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"[dense-family] the {layout} child ran past "
                 f"{FAMILY_CHILD_TIMEOUT_S} s")
        f.close()
        text = (log_dir / f"family_{layout}.log").read_text().strip()
        if rc != 0:
            fail(f"[dense-family] the {layout} child exited {rc}: "
                 f"{text[-3000:]}")
        runs[layout] = json.loads(text.splitlines()[-1])
        _log_layout_run("[dense-family]", cfg, specs, runs[layout],
                        " (a child process, beside the llama phases)")
    _same_tokens("[dense-family]", runs["paged"], runs["dense"])
    return runs["paged"]["counts"], runs["dense"]["counts"]


FAMILY_STEP_LENGTHS = [8000, 5000, 1000, 3001]   # [dense-family-step]
FAMILY_CUT_DEPTH = 4     # layers of chatglm3-6b, qwen2-vl-7b and granite-34b
# moonshot-v1-16b-a3b's layers in [moe] and [moe-step] (of 48): cut so
# that h2o-danube-3-4b's engines fit the time limit
MOE_DEPTH = 12
# llama3.2-1b's layers (of 16) in [main] and [dense-layout], which run
# beside h2o-danube's child processes and take most of their host wall
# from that contention: 4 since the mesh phases joined the script, for its
# time limit; [gather]/[page], [spec] and [dense] run ENGINE_DEPTH (8
# until the dry run and the examples joined the script, which then ran
# past 1200 s on a slow host)
MAIN_DEPTH = 4
ENGINE_DEPTH = 4


def phase_family_step(model, params, rng, flush, tag):
    """One B=4 DSA step at FAMILY_STEP_LENGTHS under the profiler (slots 0
    and 1 past h2o-danube's window), then a 2-layer cut of the same
    weights at full width on the card against the plain path on the CPU
    (`phase_step`)."""
    import torch
    cfg = model.cfg
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(99)
    st = _random_step_state(model, g, dev, FAMILY_STEP_LENGTHS, per_layer=True)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, (4,)), dtype=torch.int32,
                          device=dev)
    prof = _profile_step(params, st, tokens, cfg, flush, tag)
    del st
    torch.cuda.empty_cache()
    _cut_vs_cpu(model, params, rng, flush, tag)
    return prof


def phase_family_cut(arch, depth, rng, flush):
    """One more config of the dense family at full width and `depth`
    layers: built and initialised on the card, the short trace through
    both layouts (`phase_two_layouts`), then its first 2 layers against
    the CPU plain path (`phase_step`). The model is freed before it
    returns."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    full = get_config(arch)
    cfg = dataclasses.replace(full, n_layers=depth)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    tag = f"[dense-family] {arch}"
    log(f"{tag}: full width, depth cut to {depth} of {full.n_layers} "
        f"layers ({cfg.param_count() / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on the card; at "
        f"full depth {full.param_count() / 1e9:.3f} B, "
        f"{full.param_count() * 2 / 2 ** 30:.1f} GiB in bf16), random init in "
        f"{time.perf_counter() - t0:.3f} s; H/KVH {cfg.n_heads}/"
        f"{cfg.n_kv_heads}, hd {cfg.hd}, rope {cfg.rope_kind} over "
        f"{cfg.rope_fraction} of the dims")
    counts = phase_two_layouts(model, params,
                                  short_family_specs(rng, cfg.vocab), tag)
    _cut_vs_cpu(model, params, rng, flush, tag)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# the [audio] and [ssm] loops: four requests, one per slot from step 0,
# each fed its prompt token by token and then its own greedy tokens. The
# longest prompt sets the loop's length: 100 tokens, not 300, since a
# run with 300 took 1106 s of the 1200 s limit on a slow host (PERF.md)
STEP_PROMPTS = [100, 64, 40, 24]
STEP_NEW_TOKENS = 16
AUDIO_STEP_LENGTHS = [8000, 5000, 1000, 3001]     # [audio-step]
SSM_CUT_STEPS = 8


def _greedy_loop(model, params, state, prompts, tag):
    """Answer len(prompts) requests through `model.serve_step`, one per
    slot from step 0: each slot is fed its prompt a token a step, then its
    own greedy tokens, STEP_NEW_TOKENS each (a slot done early goes on
    stepping until the last is done; its extra tokens are dropped). The
    tokens are chosen on the card, so the loop never waits for the host;
    the launch counts are zeroed just before and read just after. Returns
    (tokens per request, steps, host ms a step, counts, state)."""
    import torch
    from repro_torch.kernels import ops
    dev = model.device
    b, vocab = len(prompts), model.cfg.vocab
    plen = [len(pr) for pr in prompts]
    steps = max(plen) + STEP_NEW_TOKENS - 1
    feed = torch.zeros((b, steps + 1), dtype=torch.int32)
    for i, pr in enumerate(prompts):
        feed[i, :len(pr)] = torch.as_tensor(pr)
    feed = feed.to(dev)
    plen_d = torch.tensor(plen, device=dev)
    out = torch.empty((steps, b), dtype=torch.int32, device=dev)
    tok = feed[:, 0]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(steps):
        logits, state = model.serve_step(params, state, tok)
        out[t] = logits.argmax(-1).int()
        tok = torch.where(plen_d > t + 1, feed[:, t + 1], out[t])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    counts = ops.launch_counts()
    if not bool(torch.isfinite(logits).all()):
        fail(f"{tag} the last step's logits are not finite")
    gen = [out[p - 1:p - 1 + STEP_NEW_TOKENS, i].tolist()
           for i, p in enumerate(plen)]
    if any(min(g) < 0 or max(g) >= vocab for g in gen):
        fail(f"{tag} a token outside the vocabulary: {gen}")
    return gen, steps, step_ms, counts, state


def _loop_report(model, params, state, tag, flush):
    """`_greedy_loop` over STEP_PROMPTS (random prompts from seed 21) with
    the peak device memory, then the device time of one more B=4 step
    (`_profile_step`) as the loop's busy share. Returns the loop's
    launch counts."""
    import torch
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, model.cfg.vocab, (n,)) for n in STEP_PROMPTS]
    torch.cuda.reset_peak_memory_stats()
    gen, steps, step_ms, counts, state = _greedy_loop(model, params, state,
                                                      prompts, tag)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"{tag} {model.cfg.name}, {model.cfg.n_layers} layers, B={len(prompts)}, "
        f"prompts {STEP_PROMPTS}, {STEP_NEW_TOKENS} new tokens each: {steps} "
        f"serve_steps, {step_ms:.3f} ms host wall a step, {steps * step_ms / 1e3:.3f} "
        f"s, peak device memory {peak:.3f} GiB")
    log(f"{tag} tokens: {gen}")
    log(f"{tag} launches: {counts}")
    tokens = torch.tensor([g[-1] for g in gen], dtype=torch.int32,
                          device=model.device)
    prof = _profile_step(params, state, tokens, model.cfg, flush,
                         f"{tag} after the loop,", model.mod.serve_step)
    if prof["device_ms"] is not None:
        log(f"{tag} device busy share of the loop's step: "
            f"{prof['device_ms'] / step_ms:.3f} ({prof['device_ms']:.3f} ms "
            f"device of {step_ms:.3f} ms host wall)")
    return counts


def _random_family_state(model, g, lengths, keys, max_len=8192):
    """A family's dense decode state with the leaves `keys` random (drawn
    one layer, or superblock, at a time), the given lengths and random
    Top-K predictions below each length."""
    import torch
    st = model.init_decode_state(len(lengths), max_len)
    for key in keys:
        for layer in st[key]:
            layer.copy_(torch.randn(layer.shape, generator=g, device=g.device))
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=g.device)
    kk = st["prev_topk"].shape[-1]
    st["prev_topk"] = torch.stack([
        torch.randint(0, L, (st["prev_topk"].shape[0], kk), generator=g,
                      device=g.device)
        for L in lengths], dim=1).int()
    return st


_ENCDEC_RANDOM = ("k", "v", "idx_k", "ck", "cv")
_HYBRID_RANDOM = ("k", "v", "idx_k", "h", "conv")


def _build_family(arch, tag):
    """A model at full width and depth with bf16 random weights from seed
    0, its parameter count and its bytes on the card logged."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    cfg = get_config(arch)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"{tag} {cfg.name}: full width and depth, {cfg.param_count() / 1e9:.3f} "
        f"B params (approx), {cfg.dtype}, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on the card, random "
        f"init in {time.perf_counter() - t0:.3f} s")
    return model, params


def phase_audio(flush):
    """[audio]: whisper-medium at full width and depth (24 + 24 layers):
    the greedy loop at max_len 8192 (> dsa.min_n: DSA every step, B5, B1
    and B6 launched), cross K/V random (the reference never fills them
    from `encode`); `encode` timed alone at 1500 frames (B=1 and 4).
    [audio-step]: one profiled B=4 step at AUDIO_STEP_LENGTHS, then a
    2-layer cut of the same weights on the card against the CPU plain
    path: logits and Top-K. Returns the loop's launch counts."""
    import torch
    from repro_torch.models import encdec
    model, params = _build_family("whisper-medium", "[audio]")
    cfg, dev = model.cfg, model.device
    g = torch.Generator(device=dev).manual_seed(1500)
    st = model.init_decode_state(len(STEP_PROMPTS), 8192)
    for key in ("ck", "cv"):
        st[key].copy_(torch.randn(st[key].shape, generator=g, device=dev))
    log(f"[audio] decode state (B={len(STEP_PROMPTS)}, max_len 8192, "
        f"{cfg.encoder_frames} cross rows): "
        f"{sum(v.numel() * v.element_size() for v in st.values()) / 2 ** 30:.3f} GiB")
    counts = _loop_report(model, params, st, "[audio]", flush)
    _need("[audio]", counts, ("indexer_scores", "gvr_topk", "sparse_decode_attn"))
    del st
    torch.cuda.empty_cache()
    for b in (1, 4):
        frames = torch.randn((b, cfg.encoder_frames, cfg.d_model), generator=g,
                             device=dev).to(torch.bfloat16)
        enc = encdec.encode(params, frames, cfg)
        if not (enc.shape == frames.shape and bool(torch.isfinite(enc).all())):
            fail(f"[audio] encode at B={b}: not finite or of the wrong shape")
        t = time_ms(lambda: encdec.encode(params, frames, cfg), flush, iters=6,
                    warmup=1)
        log(f"[audio] encode, {cfg.encoder_layers} layers over "
            f"{cfg.encoder_frames} frames, B={b}: device {t['ms']:.3f} ms "
            f"[{t['lo']:.3f}-{t['hi']:.3f}], wall {t['wall_ms']:.3f} ms")
    # [audio-step]
    st = _random_family_state(model, g, AUDIO_STEP_LENGTHS, _ENCDEC_RANDOM)
    tokens = torch.randint(0, cfg.vocab, (4,), generator=g, device=dev).int()
    _profile_step(params, st, tokens, cfg, flush, "[audio-step]",
                  encdec.serve_step)
    del st
    torch.cuda.empty_cache()
    cut, cut_params = _cut(model, params, "decoder")
    st = _random_family_state(cut, g, AUDIO_STEP_LENGTHS, _ENCDEC_RANDOM)
    cpu_st = {k: v.cpu().clone() for k, v in st.items()}
    lg, new = encdec.serve_step(cut_params, st, tokens, cut.cfg)
    t0 = time.perf_counter()
    lc, new_c = encdec.serve_step(_to_cpu(cut_params), cpu_st, tokens.cpu(), cut.cfg)
    cpu_s = time.perf_counter() - t0
    rel, arg = _logits_vs("[audio-step] 2-layer cut", lg.cpu(), lc)
    agree = _topk_agreement(new["prev_topk"], new_c["prev_topk"])
    log(f"[audio-step] 2-layer cut (full width) card vs CPU plain path, lengths "
        f"{AUDIO_STEP_LENGTHS}: logits rel L2 {rel:.3e} (argmax agreement "
        f"{arg:.2f}), per-layer Top-K agreement {agree}; the CPU copy and "
        f"step {cpu_s:.3f} s")
    if agree[0] < 0.99:
        fail(f"[audio-step] layer-0 Top-K agreement {agree[0]} < 0.99")
    del model, params, cut_params, st, cpu_st
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_ssm(flush):
    """[ssm]: rwkv6-3b at full width and depth (32 layers, bf16): the
    greedy loop (the state is O(1) in context: f32 WKV state and token
    shifts), a profiled B=4 step, then a 2-layer cut of the same weights
    stepping SSM_CUT_STEPS times on the card and through the CPU plain
    path from one random state: logits, `s` and `x_att`."""
    import torch
    from repro_torch.models import ssm
    model, params = _build_family("rwkv6-3b", "[ssm]")
    dev = model.device
    st = model.init_decode_state(len(STEP_PROMPTS), 8192)
    _loop_report(model, params, st, "[ssm]", flush)
    cut, cut_params = _cut(model, params, "layers")
    cpu_params = _to_cpu(cut_params)
    g = torch.Generator(device=dev).manual_seed(2560)
    st = cut.init_decode_state(4, 8192)
    for key in ("s", "x_att", "x_ffn"):
        st[key].copy_(torch.randn(st[key].shape, generator=g, device=dev))
    cpu_st = {k: v.cpu().clone() for k, v in st.items()}
    rels = []
    t0 = time.perf_counter()
    for _ in range(SSM_CUT_STEPS):
        tokens = torch.randint(0, cut.cfg.vocab, (4,), generator=g, device=dev).int()
        lg, st = ssm.serve_step(cut_params, st, tokens, cut.cfg)
        lc, cpu_st = ssm.serve_step(cpu_params, cpu_st, tokens.cpu(), cut.cfg)
        rels.append(_logits_vs("[ssm] 2-layer cut", lg.cpu(), lc)[0])
    state_rel = {key: _rel(st[key], cpu_st[key]) for key in ("s", "x_att", "x_ffn")}
    # tolerance: _logits_vs's (the same bf16 model run two ways)
    if max(state_rel.values()) > 5e-2:
        fail(f"[ssm] 2-layer cut: state relative L2 error {state_rel} > 5e-2")
    log(f"[ssm] 2-layer cut (full width) card vs CPU plain path, "
        f"{SSM_CUT_STEPS} steps in {time.perf_counter() - t0:.3f} s: logits "
        f"rel L2 per step "
        f"{[f'{r:.2e}' for r in rels]}; after the last, rel L2 "
        + ", ".join(f"{k} {v:.3e}" for k, v in state_rel.items()))
    del model, params, cut_params, st
    gc.collect()
    torch.cuda.empty_cache()


# jamba-1.5-large-398b on one card: one superblock (8 of 72 layers) and 8
# of the 16 experts at every width (26.45 B parameters, 49.3 GiB in bf16;
# 1 x 16 would be 85.3 GiB)
JAMBA_DEPTH = 8
JAMBA_EXPERTS = 8
HYBRID_CUT_STEPS = 8


def phase_hybrid(flush):
    """[hybrid]: jamba-1.5-large-398b at full width, JAMBA_DEPTH layers
    (one superblock: attention with DSA, 7 Mamba layers, MoE on odd
    layers and SwiGLU on even ones) and JAMBA_EXPERTS of its experts,
    bf16: the greedy loop at max_len 8192 (> dsa.min_n: B5, B1 and B6 on
    every step). [hybrid-step]: one profiled B=4 step from a random state
    at AUDIO_STEP_LENGTHS. [hybrid-cut]: one layer of each kind but the
    MoE, card against the CPU plain path (a superblock is indivisible and
    one does not fit the CPU path): the attention layer from that state
    (output, Top-K agreement per row), one Mamba layer stepping
    HYBRID_CUT_STEPS times (output, `h`, `conv`) and one dense FFN.
    Returns the loop's launch counts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import hybrid
    from repro_torch.models.api import build_model
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import layer_params
    full = get_config("jamba-1.5-large-398b")
    cfg = dataclasses.replace(full, n_layers=JAMBA_DEPTH, moe=dataclasses.replace(
        full.moe, num_experts=JAMBA_EXPERTS))
    model = build_model(cfg)
    dev = model.device
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"[hybrid] {full.name}: full width, {JAMBA_DEPTH} of {full.n_layers} layers "
        f"(one superblock), {JAMBA_EXPERTS} of {full.moe.num_experts} experts "
        f"(top-{cfg.moe.top_k}); params {cfg.param_count() / 1e9:.3f} B (approx; "
        f"{full.param_count() / 1e9:.3f} B published), "
        f"{cfg.active_param_count() / 1e9:.3f} B active per token, bf16, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on the card, random "
        f"init in {time.perf_counter() - t0:.3f} s")
    st = model.init_decode_state(len(STEP_PROMPTS), 8192)
    counts = _loop_report(model, params, st, "[hybrid]", flush)
    steps = max(STEP_PROMPTS) + STEP_NEW_TOKENS - 1
    names = ("indexer_scores", "gvr_topk", "sparse_decode_attn")
    if any(counts[name] != steps * (JAMBA_DEPTH // hybrid.SB) for name in names):
        fail(f"[hybrid] B5/B1/B6 not launched once a step and superblock: "
             f"{counts} over {steps} steps")
    del st
    torch.cuda.empty_cache()
    # [hybrid-step]
    g = torch.Generator(device=dev).manual_seed(8192)
    st = _random_family_state(model, g, AUDIO_STEP_LENGTHS, _HYBRID_RANDOM)
    tokens = torch.randint(0, cfg.vocab, (4,), generator=g, device=dev).int()
    _profile_step(params, st, tokens, cfg, flush, "[hybrid-step]", hybrid.serve_step)
    # [hybrid-cut]: the attention layer of superblock 0 from that state
    blocks = layer_params(params["blocks"], 0)
    wdt = params["embed"].dtype
    x = torch.randn((4, cfg.d_model), generator=g, device=dev).to(wdt)
    cpu_st = {k: v.cpu().clone() for k, v in st.items()}
    att, topk = hybrid.attention_layer(blocks["attn"], x, st, 0, cfg)
    t0 = time.perf_counter()
    att_c, topk_c = hybrid.attention_layer(_to_cpu(blocks["attn"]), x.cpu(), cpu_st,
                                           0, cfg)
    cpu_s = time.perf_counter() - t0
    rel_att = _rel(att, att_c)
    agree = _topk_agreement(topk[:, None], topk_c[:, None])     # per row
    if rel_att > 1e-2 or min(agree) < 0.99:
        fail(f"[hybrid-cut] attention layer: rel L2 {rel_att} > 1e-2 or Top-K "
             f"agreement per row {agree} < 0.99")
    log(f"[hybrid-cut] attention layer (full width, lengths {AUDIO_STEP_LENGTHS}) "
        f"card vs CPU plain path: output rel L2 {rel_att:.3e}, Top-K agreement "
        f"per row {agree}; CPU {cpu_s:.3f} s")
    del st, cpu_st
    torch.cuda.empty_cache()
    # one Mamba layer (superblock 0's first), stepping HYBRID_CUT_STEPS times
    pm = layer_params(blocks["mamba"], 0)
    pm_c = _to_cpu(pm)
    di = cfg.d_model * cfg.mamba_expand
    h = torch.randn((4, di, cfg.mamba_d_state), generator=g, device=dev)
    conv = torch.randn((4, cfg.mamba_d_conv - 1, di), generator=g,
                       device=dev).to(wdt)
    h_c, conv_c = h.cpu(), conv.cpu()
    rels = []
    t0 = time.perf_counter()
    for _ in range(HYBRID_CUT_STEPS):
        xm = torch.randn((4, cfg.d_model), generator=g, device=dev).to(wdt)
        y, h, conv = hybrid._mamba_step(pm, rms_norm(xm, pm["ln"]), h, conv, cfg)
        y_c, h_c, conv_c = hybrid._mamba_step(pm_c, rms_norm(xm.cpu(), pm_c["ln"]),
                                              h_c, conv_c, cfg)
        rels.append(_rel(y, y_c))
    state_rel = {"h": _rel(h, h_c), "conv": _rel(conv, conv_c)}
    # tolerances: the outputs as the 2-layer cuts' (bf16 GEMMs that round
    # differently), the f32 state as [ssm]'s
    if max(rels) > 1e-2 or max(state_rel.values()) > 5e-2:
        fail(f"[hybrid-cut] Mamba layer: output rel L2 {rels} > 1e-2 or state "
             f"{state_rel} > 5e-2")
    # one dense FFN (superblock 0's layer 0)
    pd = layer_params(blocks["dense"], 0)
    pd_c = _to_cpu(pd)
    f_out = hybrid._ffn(pd, rms_norm(x, pd["ln"]), cfg, False)
    rel_ffn = _rel(f_out, hybrid._ffn(pd_c, rms_norm(x.cpu(), pd_c["ln"]), cfg, False))
    if rel_ffn > 1e-2:
        fail(f"[hybrid-cut] dense FFN: rel L2 {rel_ffn} > 1e-2")
    log(f"[hybrid-cut] Mamba layer (d_inner {di}, d_state {cfg.mamba_d_state}) "
        f"card vs CPU, {HYBRID_CUT_STEPS} steps in {time.perf_counter() - t0:.3f} "
        f"s: output rel L2 per step {[f'{r:.2e}' for r in rels]}; after the "
        f"last, h {state_rel['h']:.3e}, conv {state_rel['conv']:.3e}; dense "
        f"FFN (d_ff {cfg.d_ff}) rel L2 {rel_ffn:.3e}; the MoE layer is left "
        f"out ({cfg.moe.num_experts * 3 * cfg.d_model * cfg.moe.expert_d_ff / 1e9:.3f} "
        f"B parameters; the fallback is held card against CPU at moonshot's "
        f"widths by tests/test_torch_cuda.py)")
    del model, params, blocks, pm, pm_c, pd, pd_c, h, conv
    gc.collect()
    torch.cuda.empty_cache()
    return counts


TEMPORAL_ROWS = [8192, 131072]


def phase_temporal(flush):
    """[temporal]: B1 on the paper's synthetic indexer rows (random Q/K +
    YaRN-RoPE, `core.rope.generate_indexer_scores`; B=4, K=2048, n =
    TEMPORAL_ROWS), warm-started from the static RoPE prior and from the
    uniform one: each run equal to the plain exact Top-K bit for bit
    (values, indices and B1's own plain version), with the prior's hit
    ratio against the true Top-K, the mean global passes (B1's and the
    plain GVR's) and B1's device time."""
    import torch
    from repro_torch.core import (exact_topk, global_passes, gvr_topk, hit_ratio,
                                  uniform_pre_idx)
    from repro_torch.core.rope import generate_indexer_scores
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    b, k = 4, 2048
    g = torch.Generator(device=dev).manual_seed(2048)
    for n in TEMPORAL_ROWS:
        rows = [generate_indexer_scores(g, n, k) for _ in range(b)]
        scores = torch.stack([r[0] for r in rows]).contiguous()
        priors = {"static": rows[0][1][None].expand(b, k).contiguous(),
                  "uniform": uniform_pre_idx(n, k, batch=b, device=dev)}
        ev, ei = exact_topk(scores, k)
        ei, order = ei.sort(-1)
        ev = ev.gather(-1, order)
        parts = []
        for name, prior in priors.items():
            v1, i1, st1 = ops.gvr_topk(scores, prior, k)
            v0, i0, st0 = ref.gvr_topk_ref(scores, prior, k)
            if not (torch.equal(i1, ei) and torch.equal(v1, ev)
                    and torch.equal(i1, i0) and torch.equal(v1, v0)
                    and torch.equal(st1[:, 4:], st0[:, 4:])):
                fail(f"[temporal] B1 from the {name} prior at n={n} differs from "
                     f"the exact Top-K")
            hit = float(hit_ratio(prior, ei, n).mean())
            plain = float(global_passes(gvr_topk(scores, prior, k).stats).float().mean())
            t = time_ms(lambda: ops.gvr_topk(scores, prior, k), flush)
            parts.append(f"{name} prior: hit ratio {hit:.4f}, global passes "
                         f"{float(st1[:, 0].mean()) + 1:.2f} (B1) / {plain:.2f} "
                         f"(plain GVR), B1 device {t['ms']:.5f} ms "
                         f"[{t['lo']:.5f}-{t['hi']:.5f}]")
        log(f"[temporal] n={n}, B={b}, K={k}: B1 == exact Top-K bit for bit from "
            f"both priors; " + "; ".join(parts))


# ------------------------------------------------------ sequence sharding ---
# [sp] and [sp-engine] run the sequence-sharded path (SP-GVR, the O(K) row
# assembly, `DecodeEngine(seq_shards=2)`) in two child processes, the two
# ranks of a gloo group (`python3 chip_smoke.py --sp-rank R ...`), both on
# the one card: NCCL runs one rank per device, so two ranks sharing an
# H100 take gloo, which stages each collective through host memory. This
# is a functional run of the sharded path's bits and collective schedule,
# not a measure of its speed. The parent runs the single-device fused
# references meanwhile and holds the ranks' outputs against them.
SP_SHARDS = 2
SP_N = 131072                       # [sp]: max_len, B = 2, 8 greedy ticks
SP_LENGTHS = [SP_N - 9, SP_N // 2 - 6]   # slot 1's writes cross the boundary
SP_BILL_N = 16384                   # the collective bill again at this N
SP_TICKS = 8
SP_PAGE = 64
SP_ENGINE_LEN = 8192                # [sp-engine]: above dsa.min_n = 4096
SP_CHILD_TIMEOUT_S = 600
SP_SEED = 23
# collective tags inside SP-GVR's data-dependent loops: their calls per
# tick follow the iteration counts; every other tag is called a fixed
# number of times per layer
SP_LOOP_TAGS = ("secant", "hist", "snap", "fallback")
SP_ENGINE_DEPTH = 2                 # [sp-engine]'s layers (full width)
# [sp]'s layers (full width): 16 until the training phases joined the
# script, 8 until the mesh training cells did (the whole script ran
# 905.5 s with 8, past its 900 s aim), 4 until the dry run and the
# examples did; the ranks and the fused reference init this depth from
# seed 0
SP_DEPTH = 2
SP_BILL_TICKS = 3


def sp_engine_specs(rng, vocab):
    """[sp-engine]'s trace: prompts of 72, 70 and 20 tokens, the first two
    sharing a 66-token prefix (one full 64-token page reused), 8 new
    tokens each; the second arrives once the first has committed."""
    shared = rng.integers(0, vocab, (66,))
    return [(np.concatenate([shared, rng.integers(0, vocab, (6,))]), 8, 0),
            (np.concatenate([shared, rng.integers(0, vocab, (4,))]), 8, 3),
            (rng.integers(0, vocab, (20,)), 8, 1)]


def sp_state(model, *, n, lengths, seed, rank=None, shards=SP_SHARDS,
             ps=SP_PAGE):
    """One seeded logical cache (K, V and indexer-K rows of every layer,
    slot and position) in the single-device paged layout (rank None: one
    pool, a shuffled table) or in rank `rank`'s part of the sharded layout
    (its span's pages in its own pool, a table of shard-local ids shuffled
    per shard). The rows are drawn on the card layer by layer from the
    same seeds in both, so both layouts hold the same content."""
    import torch
    cfg, dev = model.cfg, model.device
    b, mp = len(lengths), n // ps
    span = mp // shards
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(seed))
    local = torch.cat([torch.randperm(b * span, generator=torch.Generator(
        ).manual_seed(seed + 1 + s)).reshape(b, span) for s in range(shards)], 1)
    if rank is None:
        st = model.init_paged_decode_state(b, n, num_pages=b * mp, page_size=ps)
        table = perm.reshape(b, mp)
        dest, cols = perm, slice(None)
    else:
        st = model.init_sp_paged_decode_state(
            b, n, num_pages_per_shard=b * span, page_size=ps, seq_shards=shards)
        table = local
        cols = slice(rank * span, (rank + 1) * span)
        dest = local[:, cols].reshape(-1)
    dest = dest.to(dev)
    for i in range(cfg.n_layers):
        for j, key in enumerate(("k_pages", "v_pages", "idx_k_pages")):
            pool = st[key][i] if rank is None else st[key][i, 0]
            feat = tuple(pool.shape[2:])
            g = torch.Generator(device=dev).manual_seed(seed * 1000 + 3 * i + j)
            rows = torch.randn((b, mp, ps) + feat, generator=g, device=dev)
            pool[dest] = rows[:, cols].reshape((-1, ps) + feat).to(pool.dtype)
            del rows
    st["page_table"] = table.int().contiguous().to(dev)
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return st


def _sp_ticks(model, params, st, step, ticks, mesh=None):
    """`ticks` greedy steps from [1, 2]; per tick the logits, feedback,
    host wall and (sharded) the collective bill, on the CPU."""
    import torch
    tok = torch.tensor([1, 2], dtype=torch.int32, device=model.device)
    out = []
    for _ in range(ticks):
        if mesh is not None:
            mesh.reset_bill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, st = step(st, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        rec = {"logits": logits.cpu(), "wall_ms": wall,
               **{k: st[k].cpu() for k in ("prev_topk", "sel_gvr",
                                           "topk_valid", "length")}}
        if mesh is not None:
            rec["bill"] = mesh.bill()
        out.append(rec)
        tok = logits.argmax(-1).int()
    return out, st


def _capture(ops, names):
    """Wrap kernel wrappers so that their first call's inputs are kept
    (cloned). A wrapper counts its launches on the module's name, here the
    stand-in, so `restore()` puts the originals back and adds the
    stand-ins' counts to theirs."""
    import torch
    seen, originals = {}, {n: getattr(ops, n) for n in names}

    def wrap(name, fn):
        def inner(*args, **kw):
            if name not in seen:
                seen[name] = ([a.clone() if torch.is_tensor(a) else a
                               for a in args], dict(kw))
            return fn(*args, **kw)
        inner.launches = 0
        return inner

    stand_ins = {n: wrap(n, fn) for n, fn in originals.items()}
    for n, fn in stand_ins.items():
        setattr(ops, n, fn)

    def restore():
        for n, fn in originals.items():
            fn.launches += stand_ins[n].launches
            setattr(ops, n, fn)

    return seen, restore


def _sp_kernels_vs_plain(seen):
    """B2's scoring half and B6 on the inputs the sharded step gave them,
    each against its plain version (the [kernels] tolerances)."""
    import torch
    from repro_torch.kernels import ops, ref
    args, kw = seen["paged_indexer_scores"]
    b2_shape = [args[3].shape[0], args[3].shape[1] * args[1].shape[1]]
    s_ker = ops.paged_indexer_scores(*args, **kw)
    s_ref = ref.paged_indexer_scores_ref(*args, **kw)
    live = s_ref > -1e38
    if not torch.equal(live, s_ker > -1e38):
        fail("[sp] B2 scoring at the sharded shapes: NEG mask differs")
    s_err = float((s_ker - s_ref)[live].abs().max()) if live.any() else 0.0
    s_scale = float(s_ref[live].abs().max()) if live.any() else 0.0
    if s_err > 1e-4 * s_scale:
        fail(f"[sp] B2 scoring at the sharded shapes: max |err| {s_err} > "
             f"1e-4 * {s_scale}")
    args, kw = seen["sparse_decode_attn"]
    o = ops.sparse_decode_attn(*args, **kw)
    o_ref = ref.sparse_attn_ref(*args, **kw)
    e6 = float((o - o_ref).abs().max())
    if not torch.allclose(o, o_ref, atol=1e-4, rtol=1e-4):
        fail(f"[sp] B6 on the assembled rows: max |err| {e6} beyond 1e-4")
    return {"B2 scoring": {"err": s_err, "shape": b2_shape},
            "B6": {"err": e6, "shape": list(args[1].shape)}}


def _assembly_check(mesh):
    """The step-4 assembly alone: bf16 rows with -0.0 entries, each row
    owned by one rank (zeros on the other), summed as int32 bit patterns,
    equal to the whole buffer bit for bit."""
    import torch
    from repro_torch.sparse.sp_dsa import _assemble
    g = torch.Generator(device=mesh.device).manual_seed(5)
    full = torch.randn((2, 2, 2048, 8, 64), generator=g,
                       device=mesh.device).to(torch.bfloat16)
    full[..., ::7] = -0.0
    owner = torch.arange(2048, device=mesh.device) % mesh.size == mesh.rank
    part = torch.where(owner[None, None, :, None, None], full, 0)
    got, owners = _assemble(part, owner[None].expand(2, -1), mesh)
    if not bool((owners == 1).all()):
        fail(f"[sp] the assembly's owner flags sum to {owners.unique()}, not 1")
    same = torch.equal(got.view(torch.int16), full.view(torch.int16))
    negz = int((got.view(torch.int16) == -32768).sum())
    return {"bit_equal": bool(same), "neg_zeros": negz}


def _gloo_cuda_probe(mesh):
    """Which collectives gloo takes on CUDA tensors directly (the port
    stages them through the host either way)."""
    import torch
    import torch.distributed as dist
    res = {}
    for name, call in (
            ("all_reduce_sum", lambda t: dist.all_reduce(t)),
            ("all_reduce_max", lambda t: dist.all_reduce(t, dist.ReduceOp.MAX)),
            ("all_gather", lambda t: dist.all_gather(
                [torch.empty_like(t) for _ in range(mesh.size)], t)),
            ("all_to_all", lambda t: dist.all_to_all(
                list(torch.empty_like(t).chunk(mesh.size)),
                list(t.chunk(mesh.size))))):
        t = torch.ones(4 * mesh.size, device=mesh.device)
        try:
            call(t)
            torch.cuda.synchronize()
            res[name] = "yes"
        except RuntimeError as exc:          # the answer, not a failure
            res[name] = f"no ({str(exc).splitlines()[0][:80]})"
    return res


def sp_child(argv) -> int:
    """One rank of [sp] / [sp-engine]: RANK WORLD INIT OUT DEPTH N TICKS
    BILL_N ENGINE. Runs the sharded step at llama3.2-1b's full width and
    DEPTH layers over N positions, then (BILL_N > 0) again at BILL_N for
    the collective bill, the assembly check and (ENGINE 1) the sharded
    engine at SP_ENGINE_DEPTH layers, without and with speculation; saves its
    results to OUT/rank{RANK}.pt."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import init_seq_group, make_seq_mesh
    from repro_torch.models.api import build_model
    from repro_torch.serve import ScriptedDrafter
    rank, world, init, out_dir, depth, n, ticks, bill_n, engine = argv
    rank, world, depth, n, ticks, bill_n, engine = (
        int(rank), int(world), int(depth), int(n), int(ticks), int(bill_n),
        int(engine))
    init_seq_group(rank, world, init_method=init, backend="gloo",
                   timeout_s=300)
    mesh = make_seq_mesh(world, backend="gloo")
    cfg = dataclasses.replace(get_config("llama3.2-1b"), n_layers=depth)
    model = build_model(cfg, device=mesh.device)
    params = model.init_params(seed=0)
    res = {"device": str(mesh.device), "backend": mesh.backend,
           "probe": _gloo_cuda_probe(mesh)}

    def step(st, tok):
        return model.serve_step_sp_paged(params, st, tok, mesh=mesh)

    lengths = [n - 9, n // 2 - 6]
    st = sp_state(model, n=n, lengths=lengths, seed=SP_SEED, rank=rank,
                  shards=world)
    seen, restore = _capture(ops, ("paged_indexer_scores", "sparse_decode_attn"))
    ops.reset_launch_counts()
    res["ticks"], st = _sp_ticks(model, params, st, step, ticks, mesh)
    restore()
    res["counts"] = ops.launch_counts()
    res["kernels"] = _sp_kernels_vs_plain(seen)
    res["pool_gib"] = sum(st[k].numel() * st[k].element_size() for k in
                          ("k_pages", "v_pages", "idx_k_pages")) / 2 ** 30
    del st
    torch.cuda.empty_cache()
    if bill_n:
        st = sp_state(model, n=bill_n, lengths=[bill_n - 9, bill_n // 2 - 6],
                      seed=SP_SEED + 1, rank=rank, shards=world)
        res["bill_ticks"], st = _sp_ticks(model, params, st, step,
                                          min(ticks, SP_BILL_TICKS), mesh)
        del st
        torch.cuda.empty_cache()
    res["assembly"] = _assembly_check(mesh)
    if engine:
        cut = build_model(dataclasses.replace(cfg, n_layers=SP_ENGINE_DEPTH),
                          device=model.device)
        cut_params = {**params, "layers": _first_layers(params["layers"],
                                                        SP_ENGINE_DEPTH)}
        specs = sp_engine_specs(np.random.default_rng(SP_SEED), cfg.vocab)
        eng, reqs, rep, counts = _engine_run(
            cut, cut_params, max_len=SP_ENGINE_LEN, specs=specs,
            kv_layout="paged", seq_shards=world, mesh=mesh)
        res["engine"] = _engine_summary(eng, reqs, rep, counts)
        cont = {i: t for i, t in enumerate(res["engine"]["tokens"])}

        def wrong_third(req, d):
            draft = list(cont[req.uid][len(req.generated):len(req.generated) + d])
            if len(draft) >= 3:
                draft[2] = (draft[2] + 1) % cfg.vocab
            return draft

        eng, reqs, rep, counts = _engine_run(
            cut, cut_params, max_len=SP_ENGINE_LEN, specs=specs,
            kv_layout="paged", seq_shards=world, mesh=mesh, spec_depth=3,
            verify_kernel="mq", drafter=ScriptedDrafter(wrong_third))
        res["spec"] = _engine_summary(eng, reqs, rep, counts)
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    mesh.barrier()
    import torch.distributed as dist
    dist.destroy_process_group()
    return 0


def _paths_of(summary):
    return {u: "".join(m[0].upper() for _, _, m in log)
            for u, log in summary["log"].items()}


def _engine_summary(eng, reqs, rep, counts):
    return {"tokens": [[int(t) for t in r.generated] for r in reqs],
            "log": {u: [tuple(e) for e in v] for u, v in eng.method_log.items()},
            "hit": rep.gvr_hit_rate, "prefix": rep.prefix_hit_tokens,
            "accept": rep.spec_acceptance_rate, "wall_s": rep.wall_s,
            "ticks": rep.ticks, "counts": counts}


def start_sp_children(out_dir: Path, *, depth, n, ticks, bill_n, engine):
    """The two ranks of a fresh gloo group (a file rendezvous in out_dir);
    their output goes to out_dir/rank{r}.log."""
    out_dir.mkdir(parents=True, exist_ok=True)
    rdv = out_dir / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    procs = []
    for r in range(SP_SHARDS):
        f = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sp-rank",
             str(r), str(SP_SHARDS), f"file://{rdv}", str(out_dir),
             str(depth), str(n), str(ticks), str(bill_n), str(engine)],
            stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT)), f))
    return procs


def join_sp_children(procs, out_dir: Path, tag: str):
    """Wait for both ranks (SP_CHILD_TIMEOUT_S); a rank that fails or
    hangs fails the phase. Returns the ranks' results."""
    import torch
    try:
        for r, (proc, f) in enumerate(procs):
            try:
                rc = proc.wait(timeout=SP_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"{tag} rank {r} ran past {SP_CHILD_TIMEOUT_S} s")
            f.close()
            if rc != 0:
                text = (out_dir / f"rank{r}.log").read_text()
                fail(f"{tag} rank {r} exited {rc}: {text[-3000:]}")
    finally:
        stop_family_children({r: p for r, p in enumerate(procs)})
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(SP_SHARDS)]


def _bill_split(bill):
    """(calls, bytes) of a tick's bill in all, and the bytes of its fixed
    part (the tags outside SP-GVR's loops)."""
    calls = sum(v["calls"] for v in bill.values())
    nbytes = sum(v["bytes"] for v in bill.values())
    fixed = sum(v["bytes"] for k, v in bill.items() if k not in SP_LOOP_TAGS)
    return calls, nbytes, fixed


def _per_call(bills):
    """Bytes per call of each tag over a run's ticks."""
    tot = {}
    for bill in bills:
        for k, v in bill.items():
            c, b = tot.get(k, (0, 0))
            tot[k] = (c + v["calls"], b + v["bytes"])
    return {k: b / c for k, (c, b) in tot.items()}


def _same_ticks(tag, got, want, who):
    import torch
    for i, (a, b) in enumerate(zip(got, want)):
        for key in ("logits", "prev_topk", "sel_gvr", "topk_valid", "length"):
            if not torch.equal(a[key], b[key]):
                fail(f"{tag} {who}: tick {i} {key} differs from the fused "
                     f"step's")


def phase_sp(model, params):
    """[sp] and [sp-engine]: start the two ranks, run the single-device
    references here meanwhile, join and compare. Returns the ranks' launch
    counts ([sp], [sp-engine] and its spec run, summed over the ranks)."""
    import torch
    from repro_torch.kernels import ops
    out_dir = ROOT / "build" / "chip_smoke" / "sp"
    t0 = time.perf_counter()
    procs = start_sp_children(out_dir, depth=model.cfg.n_layers, n=SP_N,
                              ticks=SP_TICKS, bill_n=SP_BILL_N, engine=1)
    try:
        # the fused single-device step over the same logical cache
        st = sp_state(model, n=SP_N, lengths=SP_LENGTHS, seed=SP_SEED)
        gib = sum(st[k].numel() * st[k].element_size() for k in
                  ("k_pages", "v_pages", "idx_k_pages")) / 2 ** 30
        fused, st = _sp_ticks(model, params, st, lambda s, t: model.serve_step_paged(
            params, s, t), SP_TICKS)
        del st
        torch.cuda.empty_cache()
        cut_cfg = dataclasses.replace(model.cfg, n_layers=SP_ENGINE_DEPTH)
        from repro_torch.models.api import build_model
        cut = build_model(cut_cfg, device=model.device)
        cut_params = {**params, "layers": _first_layers(params["layers"],
                                                        SP_ENGINE_DEPTH)}
        specs = sp_engine_specs(np.random.default_rng(SP_SEED), model.cfg.vocab)
        eng, reqs, rep, fcounts = _engine_run(
            cut, cut_params, max_len=SP_ENGINE_LEN, specs=specs,
            kv_layout="paged")
        fused_engine = _engine_summary(eng, reqs, rep, fcounts)
    finally:
        ranks = join_sp_children(procs, out_dir, "[sp]")
    r0 = ranks[0]
    log(f"[sp] backend {r0['backend']}: {SP_SHARDS} ranks (processes) on one "
        f"card, {ranks[0]['device']} and {ranks[1]['device']}; NCCL runs one "
        f"rank per device, so the ranks share the H100 over gloo, which "
        f"stages every collective through host memory; gloo on CUDA tensors "
        f"directly: {r0['probe']}")
    # bit-identity with the fused step, every rank, every tick
    for r, res in enumerate(ranks):
        _same_ticks("[sp]", res["ticks"], fused, f"rank {r}")
    counts = [res["counts"] for res in ranks]
    for r, c in enumerate(counts):
        _need(f"[sp] rank {r}", c, ("paged_indexer_scores", "sparse_decode_attn"))
        if c["gvr_topk"] or c["paged_sparse_decode_attn"]:
            fail(f"[sp] rank {r} launched B1 or B3 on the sharded path: {c}")
    gvr_rows = [int(t["sel_gvr"][0].sum()) for t in fused]
    log(f"[sp] llama3.2-1b full width, {model.cfg.n_layers} layers, B = 2, "
        f"max_len {SP_N}, lengths {SP_LENGTHS} (slot 1's writes cross the "
        f"shard boundary at {SP_N // 2}), {SP_TICKS} greedy ticks: logits, "
        f"tokens, prev_topk, topk_valid, sel_gvr and length bit-identical to "
        f"serve_step_paged(paged_attn='fused') on every tick and rank; "
        f"tokens {[t['logits'].argmax(-1).tolist() for t in fused]}; layer-0 "
        f"GVR rows per tick {gvr_rows}; pools {gib:.3f} GiB single-device, "
        f"{r0['pool_gib']:.3f} GiB a rank; launches a rank: "
        f"{ {k: v for k, v in counts[0].items() if v} }")
    for name, chk in r0["kernels"].items():
        log(f"[sp] {name} at the sharded shapes {chk['shape']} vs its plain "
            f"version: max|err| {chk['err']:.3e}")
    # the collective bill: O(1) in the context length
    for who, res in enumerate(ranks):
        a = res["assembly"]
        if not a["bit_equal"]:
            fail(f"[sp] rank {who}: the bit-pattern assembly differs from the "
                 f"single-device buffer")
    log(f"[sp] assembly (int32 bit patterns, one owner a row): bit-equal to "
        f"the single-device buffer, {r0['assembly']['neg_zeros']} -0.0 "
        f"entries kept")
    hi = [_bill_split(t["bill"]) for t in r0["ticks"]]
    lo = [_bill_split(t["bill"]) for t in r0["bill_ticks"]]
    log(f"[sp] collective bill a tick and rank at N = {SP_N} (calls, bytes): "
        f"{[(c, b) for c, b, _ in hi]}; at N = {SP_BILL_N}: "
        f"{[(c, b) for c, b, _ in lo]}")
    if len({f for _, _, f in hi + lo}) != 1:
        fail(f"[sp] the fixed part of the bill differs across ticks or N: "
             f"{[f for _, _, f in hi]} vs {[f for _, _, f in lo]}")
    pc_hi = _per_call([t["bill"] for t in r0["ticks"]])
    pc_lo = _per_call([t["bill"] for t in r0["bill_ticks"]])
    for k in set(pc_hi) & set(pc_lo):
        if pc_hi[k] != pc_lo[k]:
            fail(f"[sp] {k}: {pc_hi[k]} bytes a call at N = {SP_N}, "
                 f"{pc_lo[k]} at N = {SP_BILL_N}")
    log(f"[sp] bytes per call by site, equal at N = {SP_N} and {SP_BILL_N}: "
        f"{ {k: pc_hi[k] for k in sorted(pc_hi)} }; the fixed part "
        f"{hi[0][2]} bytes a tick at both N; the loop sites' calls follow "
        f"SP-GVR's iteration counts (data-aware), their bytes a call do not "
        f"grow with N")
    sp_wall = [t["wall_ms"] for t in r0["ticks"]]
    fu_wall = [t["wall_ms"] for t in fused]
    log(f"[sp] host wall a tick (a functional run: two ranks share one card "
        f"and gloo stages through the host): sharded median "
        f"{statistics.median(sp_wall):.3f} ms {sp_wall}, single-device fused "
        f"median {statistics.median(fu_wall):.3f} ms")
    # [sp-engine]
    for r, res in enumerate(ranks):
        got = res["engine"]
        for key in ("tokens", "log", "hit", "prefix"):
            if got[key] != fused_engine[key]:
                fail(f"[sp-engine] rank {r}: {key} differs from the fused "
                     f"engine's: {got[key]} vs {fused_engine[key]}")
        if res["spec"]["tokens"] != got["tokens"]:
            fail(f"[sp-engine] rank {r}: spec_depth 3 tokens differ from "
                 f"non-spec: {res['spec']['tokens']} vs {got['tokens']}")
        _need(f"[sp-engine] rank {r}", got["counts"],
              ("paged_indexer_scores", "sparse_decode_attn"))
    e0, s0 = r0["engine"], r0["spec"]
    log(f"[sp-engine] DecodeEngine(kv_layout='paged', seq_shards=2) at full "
        f"width, {SP_ENGINE_DEPTH} of 16 layers, max_len {SP_ENGINE_LEN}, "
        f"prompts 72/70/20 (66-token shared prefix): tokens, method log, "
        f"paths {_paths_of(e0)}, GVR hit rate "
        f"{e0['hit']:.4f} and prefix hits {e0['prefix']} == the fused "
        f"single-device engine's on both ranks; {e0['ticks']} ticks, "
        f"{e0['wall_s']:.3f} s wall (fused {fused_engine['wall_s']:.3f} s); "
        f"spec_depth 3 (mq verify, every third draft wrong): tokens == "
        f"non-spec, acceptance {s0['accept']:.4f}, {s0['ticks']} ticks; "
        f"launches a rank {e0['counts']} / spec {s0['counts']}")
    log(f"[sp] phase wall {time.perf_counter() - t0:.3f} s")
    total = {}
    for res in ranks:
        for part in (res["counts"], res["engine"]["counts"], res["spec"]["counts"]):
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    return total, r0["kernels"]


# ------------------------------------------------------------- training ----

TRAIN_ARCH = "llama3.2-1b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2048, 10     # [train]: full width and depth
TRAIN_CUT_ARCHS = ("llama3.2-1b", "moonshot-v1-16b-a3b", "whisper-medium",
                   "rwkv6-3b")
TRAIN_CUT_B, TRAIN_CUT_S = 1, 128               # [train-cut]: 2 layers, f32
TRAIN_CUT_LOSS_RTOL = 1e-5
TRAIN_CUT_GRAD_RTOL = 1e-4
TRAIN_CUT_UPDATE_RTOL = 1e-6                    # AdamW from equal gradients
TRAIN_CUT_OWN_RTOL = 1e-2                       # ... from each side's own
RESUME_DEPTH, RESUME_B, RESUME_S = 2, 2, 512    # [train-resume], full width
RESUME_STEPS = 6                                # 6 straight vs 3 + resume + 3
RESUME_CHILD_TIMEOUT_S = 600
F32_FLOPS = 67e12                  # H100 SXM f32 CUDA-core peak (no TF32)


def _indexer_leaves(tree):
    from repro_torch.tree import flatten_with_paths
    return [(p, t) for p, t in flatten_with_paths(tree) if "['indexer']" in p]


def phase_train():
    """llama3.2-1b at full width and depth (bf16 parameters, f32 moments)
    through TRAIN_STEPS steps of `make_train_step` over `synthetic_stream`
    with the CLI's AdamWConfig: losses and grad norms finite; the indexer
    leaves (no part in the loss) keep zero moments, which holds only if
    every gradient they got was exactly zero, and take the decay-only
    update (p - lr (wd p)).to(bf16) bit for bit each step. Host wall a
    step (CUDA-synchronised, the median of steps 3-10), tokens/s, peak
    memory, one profiled step's device time, busy share and top kernels,
    and the model FLOPs as a share of the bf16 peak."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import synthetic_stream
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(seed=0)
    opt = adamw.init(params)
    n_all = sum(t.numel() for t in leaves(params))
    n_idx = sum(t.numel() for _, t in _indexer_leaves(params))
    ocfg = adamw.AdamWConfig(total_steps=max(TRAIN_STEPS, 10))
    step = make_train_step(model, ocfg)
    stream = synthetic_stream(vocab=cfg.vocab, batch=TRAIN_B, seq=TRAIN_S,
                              seed=0, family=cfg.family, cfg=cfg)
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, full width, "
        f"{n_all / 1e9:.4f} B parameters ({n_idx / 1e6:.1f} M indexer) in "
        f"bf16, f32 moments; B={TRAIN_B}, S={TRAIN_S}, {TRAIN_STEPS} steps "
        f"of make_train_step (remat on, AdamWConfig(total_steps="
        f"{ocfg.total_steps}))")
    walls, moved = [], 0
    for i in range(TRAIN_STEPS):
        batch = next(stream)
        before = [t.clone() for _, t in _indexer_leaves(params)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        loss, gn, lr = (float(met[k]) for k in ("loss", "grad_norm", "lr"))
        if not (np.isfinite(loss) and np.isfinite(gn)):
            fail(f"[train] step {i}: loss {loss}, grad norm {gn}")
        for (path, p), p0 in zip(_indexer_leaves(params), before):
            want = (p0.float() - met["lr"] * (ocfg.weight_decay * p0.float())
                    ).to(p0.dtype)
            if not torch.equal(p, want):
                fail(f"[train] step {i}: indexer {path} is not the "
                     f"decay-only update")
            moved += int((p != p0).sum())
        del before
        log(f"[train] step {i}: loss {loss:.6f} grad norm {gn:.6f} lr "
            f"{lr:.6e} host wall {walls[-1] * 1e3:.3f} ms")
    for tree, name in ((opt.m, "m"), (opt.v, "v")):
        for path, t in _indexer_leaves(tree):
            if t.any():
                fail(f"[train] indexer moment {name}{path} is not zero: its "
                     f"gradient was not")
    wall = statistics.median(walls[2:])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    from repro_torch.launch.dryrun import train_flops
    flops, attn = train_flops(cfg, TRAIN_B, TRAIN_S)
    log(f"[train] indexer gradients exactly zero (moments 0 after "
        f"{TRAIN_STEPS} steps), every update decay-only bit for bit "
        f"({moved} of {n_idx} indexer elements x {TRAIN_STEPS} steps moved "
        f"in bf16); host wall a step {wall * 1e3:.3f} ms (median of steps "
        f"3-{TRAIN_STEPS}), {TRAIN_B * TRAIN_S / wall:.1f} tokens/s, peak "
        f"{peak:.3f} GiB allocated")
    batch = next(stream)
    t0 = time.perf_counter()
    events = _profiled(lambda: step(params, opt, batch))
    prof_wall = (time.perf_counter() - t0) * 1e3
    dev = {}
    for name, _, us in events:
        dev[name] = dev.get(name, 0.0) + us / 1e3
    busy = sum(dev.values())
    top = sorted(dev.items(), key=lambda kv: -kv[1])[:8]
    log(f"[train] profiled step: {busy:.3f} ms device busy, "
        f"{busy / (wall * 1e3):.3f} busy share of the {wall * 1e3:.3f} ms "
        f"step ({prof_wall:.3f} ms host wall under the profiler, "
        f"{len(events)} device events); top device time (ms): "
        + ", ".join(f"{k[:48]}={v:.3f}" for k, v in top))
    log(f"[train] model FLOPs a step {flops / 1e12:.3f} T (attention "
        f"{attn / 1e12:.3f} T, in f32 einsums as the reference computes "
        f"them): {flops / wall / 1e12:.1f} TFLOP/s, "
        f"{flops / wall / BF16_FLOPS:.3f} of the bf16 peak (a printed "
        f"figure, not a claim); the f32 attention alone needs "
        f"{attn / F32_FLOPS * 1e3:.1f} ms at the f32 peak")
    return dict(wall_ms=wall * 1e3, tokens_s=TRAIN_B * TRAIN_S / wall,
                peak_gib=peak, device_ms=busy)


def _worst(got, want, skip=(), equal=False):
    """(rel L2, path) of the worst leaf of `got` (on the card) against
    `want` (moved to the card for the comparison), leaves whose path
    holds a `skip` word left out; with `equal`, also whether every leaf
    is bit-equal."""
    import torch
    from repro_torch.tree import flatten_with_paths
    worst, same = (0.0, ""), True
    for (path, a), (_, c) in zip(flatten_with_paths(got),
                                 flatten_with_paths(want)):
        if not any(w in path for w in skip):
            c = c.to(a.device)
            rel = float((a - c).norm() / c.norm().clamp_min(1e-30))
            worst = max(worst, (rel, path))
            same = same and (not equal or torch.equal(a, c))
    return (worst, same) if equal else worst


def phase_train_cut():
    """Training's counterpart of the 2-layer serving cuts, and the only
    value check of the card's training at full width: one train step at
    full width and 2 layers (whisper 2 + 2), float32 with TF32 off,
    B = 1, S = 128, on the card and through the plain path on the CPU
    from the same parameters and batch, in `make_train_step`'s two
    halves: `loss_and_grads` (loss within TRAIN_CUT_LOSS_RTOL, every
    gradient leaf within TRAIN_CUT_GRAD_RTOL relative L2, the indexer's
    exactly zero on both), then `adamw.update` on each side from the
    same (the CPU's) gradients (every updated parameter within
    TRAIN_CUT_UPDATE_RTOL), and from each side's own gradients: there
    the step each leaf takes (new - old) within TRAIN_CUT_OWN_RTOL
    relative L2 of the CPU's. Adam's first step is lr g / (|g| + eps),
    near +-lr for every element whatever its size, so the two differ by
    up to 2 lr only where an element's gradient is ~eps, while a fault in
    the gradients or the update moves a whole leaf's step (relative L2
    ~1). The step, not the parameter: at the first step's lr (3e-6) a
    whole step is ~1.5e-4 of a parameter of scale 0.02. The worst leaf
    of each."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import batch_to, loss_and_grads
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import tree_map
    ocfg = adamw.AdamWConfig()
    for arch in TRAIN_CUT_ARCHS:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=2, dtype="float32",
                                  encoder_layers=2 if full.encoder_layers else 0)
        gm, cm = build_model(cfg), build_model(cfg, device="cpu")
        params = gm.init_params(seed=0)
        cparams = _to_cpu(params)
        batch = batch_for_step(0, vocab=cfg.vocab, batch=TRAIN_CUT_B,
                               seq=TRAIN_CUT_S, family=cfg.family, cfg=cfg)
        t1 = time.perf_counter()
        lg, g_card = loss_and_grads(gm, params, batch_to(batch, gm.device))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lc, g_cpu = loss_and_grads(cm, cparams, batch_to(batch, "cpu"))
        t3 = time.perf_counter()
        pc, _, mc = adamw.update(g_cpu, adamw.init(cparams), cparams, ocfg)
        t4 = time.perf_counter()
        lg, lc = float(lg), float(lc)
        g_cpu = tree_map(lambda t: t.to(gm.device), g_cpu)
        for path, t in _indexer_leaves(g_card) + _indexer_leaves(g_cpu):
            if t.any():
                fail(f"[train-cut] {arch}: indexer gradient {path} not zero")
        worst_g = _worst(g_card, g_cpu, skip=("['indexer']",))
        p0 = tree_map(torch.clone, params)
        own = tree_map(torch.clone, params)      # the card's own step
        adamw.update(g_card, adamw.init(own), own, ocfg)
        del g_card
        pg, _, mg = adamw.update(g_cpu, adamw.init(params), params, ocfg)
        worst_u, same = _worst(pg, pc, equal=True)
        worst_own = _worst(tree_map(torch.sub, own, p0),
                           tree_map(torch.sub, pg, p0))
        worst_own_p = _worst(own, pg)
        log(f"[train-cut] {arch}: full width, 2 layers"
            f"{' (+ 2 encoder layers)' if full.encoder_layers else ''}, f32, "
            f"B={TRAIN_CUT_B}, S={TRAIN_CUT_S}: loss {lg:.7f} card / {lc:.7f} "
            f"CPU (rel {abs(lg - lc) / abs(lc):.3e}, tol {TRAIN_CUT_LOSS_RTOL}); "
            f"worst gradient leaf {worst_g[1]} rel L2 {worst_g[0]:.3e} (tol "
            f"{TRAIN_CUT_GRAD_RTOL}); grad norm {float(mg['grad_norm']):.6f} / "
            f"{float(mc['grad_norm']):.6f}; AdamW from the same gradients: "
            f"worst parameter {worst_u[1]} rel L2 {worst_u[0]:.3e} (tol "
            f"{TRAIN_CUT_UPDATE_RTOL}; bit-equal: {same}); from each side's "
            f"own gradients: worst step {worst_own[1]} rel L2 "
            f"{worst_own[0]:.3e} (tol {TRAIN_CUT_OWN_RTOL}), worst parameter "
            f"{worst_own_p[1]} rel L2 {worst_own_p[0]:.3e}; card gradients "
            f"{t2 - t1:.3f} s, CPU gradients {t3 - t2:.3f} s, CPU update "
            f"{t4 - t3:.3f} s, in all "
            f"{time.perf_counter() - t0:.3f} s")
        if not (abs(lg - lc) <= TRAIN_CUT_LOSS_RTOL * abs(lc)
                and worst_g[0] <= TRAIN_CUT_GRAD_RTOL
                and worst_u[0] <= TRAIN_CUT_UPDATE_RTOL
                and worst_own[0] <= TRAIN_CUT_OWN_RTOL):
            fail(f"[train-cut] {arch}: the card's train step is not the CPU's "
                 f"within the stated tolerances")
        del gm, cm, params, cparams, g_cpu, own, pg, pc, p0
        gc.collect()
        torch.cuda.empty_cache()


def train_resume_child(argv) -> int:
    """[train-resume]'s child, under torch.use_deterministic_algorithms
    (the embedding gather's backward accumulates with atomics otherwise)
    with CUBLAS_WORKSPACE_CONFIG set by the parent before CUDA starts:
    ARCH at DEPTH layers (SMOKE 1: its smoke config), B x S, bf16; 6
    steps of make_train_step straight against 3 + `save` +
    `restore_latest` + 3, parameters and moments bit for bit; beside
    them, the train CLI on the card, 4 steps with a checkpoint every 2,
    then `--steps 6 --resume`. Writes OUT/train_resume.json."""
    import os
    import shutil
    import tempfile
    import threading
    out_dir, arch, smoke, depth, b, s = argv
    out_dir, depth, b, s = Path(out_dir), int(depth), int(b), int(s)
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        fail("[train-resume] CUBLAS_WORKSPACE_CONFIG is not :4096:8")
    import torch
    torch.use_deterministic_algorithms(True)
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import batch_for_step
    from repro_torch.launch.train import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths
    cfg = dataclasses.replace(get_config(arch, smoke=smoke == "1"),
                              n_layers=depth)
    model = build_model(cfg)
    step = make_train_step(model, adamw.AdamWConfig(total_steps=10))

    def fresh():
        params = model.init_params(seed=0)
        return params, adamw.init(params)

    def run(params, opt, start, n):
        for i in range(start, start + n):
            params, opt, _ = step(params, opt, batch_for_step(
                i, vocab=cfg.vocab, batch=b, seq=s, family=cfg.family, cfg=cfg))
        return params, opt

    # the train CLI on the card, 4 steps then a resume to 6, in a thread
    # beside the deterministic runs (each CLI process pays its start-up)
    cli_dir = tempfile.mkdtemp(prefix="train_cli_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "llama3.2-1b", "--smoke", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", cli_dir, "--checkpoint-every", "2"]
    cli = []

    def run_cli():
        for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
            p = subprocess.run(base + extra, capture_output=True, text=True,
                               timeout=300, env=env, cwd=str(ROOT))
            cli.append(dict(rc=p.returncode, stdout=p.stdout,
                            stderr=p.stderr[-3000:]))

    cli_thread = threading.Thread(target=run_cli)
    cli_thread.start()
    half = RESUME_STEPS // 2
    t0 = time.perf_counter()
    pa, oa = run(*fresh(), 0, RESUME_STEPS)
    pb, ob = run(*fresh(), 0, half)
    ck = tempfile.mkdtemp(prefix="train_resume_")
    try:
        t1 = time.perf_counter()
        ckpt.save(ck, (pb, ob), half)
        save_s = time.perf_counter() - t1
        nbytes = sum(f.stat().st_size for f in Path(ck).rglob("*") if f.is_file())
        del pb, ob
        t1 = time.perf_counter()
        (pb, ob), at = ckpt.restore_latest(ck, fresh())
        restore_s = time.perf_counter() - t1
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    pb, ob = run(pb, ob, half, RESUME_STEPS - half)
    leaves_a = flatten_with_paths((pa, oa))
    differ = [p for (p, x), (_, y) in zip(leaves_a, flatten_with_paths((pb, ob)))
              if not torch.equal(x, y)]
    train_s = time.perf_counter() - t0
    cli_thread.join()
    shutil.rmtree(cli_dir, ignore_errors=True)
    res = dict(restored_step=at, leaves=len(leaves_a), differ=differ,
               checkpoint_bytes=nbytes, save_s=save_s, restore_s=restore_s,
               train_s=train_s, cli=cli, name=cfg.name, depth=depth, b=b, s=s)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train_resume.json").write_text(json.dumps(res))
    print(json.dumps(res), flush=True)
    return 0


def start_train_resume_child(out_dir: Path, arch=TRAIN_ARCH, smoke=False,
                             depth=RESUME_DEPTH, b=RESUME_B, s=RESUME_S):
    """[train-resume]'s child process (its log in out_dir), with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 in its environment from the start."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    f = open(out_dir / "train_resume.log", "w")
    # one CPU thread for it and the CLI processes it starts: its work is
    # on the card, and [train-cut]'s CPU half runs beside it
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--train-resume",
         str(out_dir), arch, "1" if smoke else "0", str(depth), str(b), str(s)],
        stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env)
    return proc, f


def join_train_resume_child(child, out_dir: Path) -> dict:
    """Wait for the child, check its run and log it: the resumed
    parameters and moments equal the straight run's bit for bit, and the
    CLI resumed from step 4 and printed `done` on the card. Returns the
    child's result."""
    proc, f = child
    try:
        rc = proc.wait(timeout=RESUME_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"[train-resume] the child ran past {RESUME_CHILD_TIMEOUT_S} s")
    finally:
        f.close()
    text = (out_dir / "train_resume.log").read_text()
    if rc != 0:
        fail(f"[train-resume] the child exited {rc} (an op without a "
             f"deterministic form names itself here): {text[-3000:]}")
    res = json.loads((out_dir / "train_resume.json").read_text())
    if res["differ"] or res["restored_step"] != RESUME_STEPS // 2:
        fail(f"[train-resume] resumed run differs from the straight run in "
             f"{res['differ'][:8]} (restored step {res['restored_step']})")
    if len(res["cli"]) != 2:
        fail(f"[train-resume] the train CLI did not run twice: {res['cli']}")
    first, second = res["cli"]
    lines = second["stdout"].splitlines()
    if (first["rc"] or second["rc"] or not lines or lines[0] != "resumed from step 4"
            or lines[-1] != "done" or first["stdout"].splitlines()[-1:] != ["done"]):
        fail(f"[train-resume] the train CLI on the card: {res['cli']}")
    log(f"[train-resume] {res['name']} at full width, {res['depth']} layers, "
        f"B={res['b']}, S={res['s']}, deterministic algorithms: "
        f"{RESUME_STEPS} steps straight == {RESUME_STEPS // 2} + save + "
        f"restore_latest (step {res['restored_step']}) + "
        f"{RESUME_STEPS - RESUME_STEPS // 2}, all {res['leaves']} leaves "
        f"(parameters and moments) bit for bit; checkpoint "
        f"{res['checkpoint_bytes'] / 1e9:.3f} GB, save {res['save_s']:.3f} s, "
        f"restore {res['restore_s']:.3f} s, the two runs {res['train_s']:.3f} s")
    log(f"[train-resume] train CLI on the card: --steps 4 --checkpoint-every "
        f"2, then --steps 6 --resume: " + " | ".join(lines))
    return res


# ------------------------------------------------------------ the dry run --
# [dryrun]: the sweep of `launch.dryrun_all` (every arch x shape x mesh
# cell, one rank's step on the meta device), run in a child process beside
# the card phases; then two cells' rank 0 on the card at its real blocks

DRYRUN_JOBS = 2
DRYRUN_TIMEOUT_S = 600
DRYRUN_CELLS = 64                  # ok cells: 8 archs x 3 shapes + 2 x 4, x 2
DRYRUN_SKIPPED = 16                # long_500k outside the ssm and hybrid
DRYRUN_TRAIN_DEPTH = 2             # train_4k on the card: 2 of 16 layers
ALLOC_BLOCK = 512                  # the caching allocator's rounding
H100_GIB = 80


def start_dryrun_sweep(out_dir: Path):
    """The sweep as a child process on the CPU alone (it runs on the meta
    device and is kept off the card)."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    f = open(out_dir / "sweep.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun_all", "--mesh",
         "both", "--jobs", str(DRYRUN_JOBS), "--outdir", str(out_dir)],
        stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT),
        start_new_session=True)
    atexit.register(stop_dryrun_sweep, proc)
    return proc, f, time.perf_counter()


def stop_dryrun_sweep(proc) -> None:
    """The sweep and its worker processes (one process group), if alive."""
    import os
    import signal
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _gib(n: float) -> str:
    return f"{n / 2 ** 30:.3f}"


def join_dryrun_sweep(child, out_dir: Path) -> dict:
    """Wait for the sweep; every cell must be "ok" or "skipped". One line
    a cell: GiB a rank of each argument kind, the arguments against the
    card's 80 GiB, and the bill's bytes by axis."""
    proc, f, t0 = child
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"[dryrun] the sweep ran past {DRYRUN_TIMEOUT_S} s")
    finally:
        f.close()
    wall = time.perf_counter() - t0
    text = (out_dir / "sweep.log").read_text()
    cells = {}
    for path in sorted(out_dir.glob("*__*__pod*.json")):
        cells[path.stem] = json.loads(path.read_text())
    status = [c["status"] for c in cells.values()]
    if (rc != 0 or status.count("ok") != DRYRUN_CELLS
            or status.count("skipped") != DRYRUN_SKIPPED):
        fail(f"[dryrun] sweep exit {rc}, {status.count('ok')} ok, "
             f"{status.count('skipped')} skipped: {text[-3000:]}")
    for name, c in cells.items():
        if c["status"] != "ok":
            continue
        pr, mem = c["per_rank"], c["memory"]["argument_size_in_bytes"]
        bill = ", ".join(f"{a} {sum(t['bytes'] for t in tags.values()) / 2 ** 20:.3f}"
                         for a, tags in sorted(c["bill"].items()))
        log(f"[dryrun] {name}: GiB a rank params {_gib(pr['params'])} / "
            f"moments {_gib(pr['moments'])} / state {_gib(pr['state'])} / "
            f"inputs {_gib(pr['inputs'])}; arguments {_gib(mem)} of "
            f"{H100_GIB} GiB; bill MiB by axis: {bill or 'none'} "
            f"({c['lower_s']} s on meta)")
    log(f"[dryrun] sweep: {DRYRUN_CELLS} ok, {DRYRUN_SKIPPED} skipped, "
        f"{DRYRUN_JOBS} worker processes, {wall:.3f} s from its start")
    return cells


def _alloc_bytes(nbytes: int) -> int:
    """A tensor of `nbytes` rounded as the caching allocator rounds a
    request: a multiple of 512 bytes, at least 512, none when empty."""
    if nbytes == 0:
        return 0
    return max(ALLOC_BLOCK, -(-nbytes // ALLOC_BLOCK) * ALLOC_BLOCK)


ALLOC_SPLIT = 1 << 20     # a large-pool block keeps a remainder up to this


def _hold_allocation(tag, tensors, alloc):
    """The allocator's rule, held block by block: each tensor's block was
    requested for exactly its bytes and holds them rounded up to 512 B,
    but a block of the large pool (requests over 1 MiB) also keeps the
    rest of its segment when that rest is 1 MiB or less (the allocator
    splits off only larger remainders); the blocks' sizes sum to what
    `memory_allocated` grew by. Returns (sum of 512-rounded sizes,
    remainders kept, large blocks that kept one)."""
    import torch
    want = {t.data_ptr(): t.numel() * t.element_size() for t in tensors
            if t.numel()}
    got = {}
    for seg in torch.cuda.memory_snapshot():
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated" and addr in want:
                got[addr] = (blk["size"], blk.get("requested_size"))
            addr += blk["size"]
    if set(got) != set(want):
        fail(f"{tag}: {len(want) - len(got)} argument tensors share or lack "
             f"an allocator block")
    rounded = kept = n_kept = 0
    for ptr, nbytes in want.items():
        size, req = got[ptr]
        r = _alloc_bytes(nbytes)
        if req is not None and req != nbytes:
            fail(f"{tag}: a block requested {req} bytes for {nbytes}")
        if size != r and not (nbytes > ALLOC_SPLIT
                              and 0 < size - r <= ALLOC_SPLIT):
            fail(f"{tag}: a block of {size} bytes for {nbytes}")
        rounded, kept, n_kept = rounded + r, kept + size - r, n_kept + (size != r)
    if rounded + kept != alloc:
        fail(f"{tag}: {alloc} bytes allocated for the arguments, their "
             f"blocks hold {rounded + kept}")
    return rounded, kept, n_kept


def _fill_state(state, n, g):
    """Values for a rank's decode-state blocks (llama's leaves): caches
    N(0, 1), lengths in the cache's second half, the feedback an even
    spread below the shortest length, every row warm."""
    import torch
    for name, t in state.items():
        if name in ("k", "v", "idx_k"):
            for layer in t:
                layer.normal_(generator=g)
        elif name == "length":
            t.copy_(torch.randint(n // 2, n - 1, t.shape, generator=g,
                                  device=t.device))
        elif name == "prev_topk":
            kk = t.shape[-1]
            t.copy_(torch.arange(kk, device=t.device) * ((n // 2) // kk))
        else:
            t.fill_(name == "topk_valid")


def dryrun_card_cell(arch, shape, depth=None):
    """Rank 0 of `shape` on the 16 x 16 mesh on the card, under a
    `ShadowMesh`: its argument blocks allocated from an empty cache and
    held against the dry run's bytes under the allocator's rule, then one
    step (the decode step, or the train step with its AdamW update); the
    peak over the arguments is the step's temporaries. Values under a
    ShadowMesh are not the mesh's: shapes, bytes, the bill and the
    kernels are checked, not the outputs' values."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, make_production_mesh
    from repro_torch.models.api import SHAPES, build_model
    from repro_torch.parallel.sharding import ShadowMesh, make_rules, overrides_for
    from repro_torch.tree import leaves, tree_map
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    kind = SHAPES[shape]["kind"]
    mesh = make_production_mesh()
    rules = make_rules(mesh, overrides=overrides_for(cfg, kind))
    meta_model = build_model(cfg, device="meta")
    want = dryrun.cell_bytes(meta_model, shape, mesh, rules)
    meta_run = dryrun.shadow_step(meta_model, shape, mesh, rules)
    dims = [mesh.shape[a] for a in mesh.axis_names]
    meta_args = dryrun.shadow_args(
        meta_model, shape, ShadowMesh(dims, mesh.axis_names), rules)
    tag = f"[dryrun] {cfg.name} {shape} rank 0 of 16 x 16"

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    args = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cuda"), meta_args)
    alloc = torch.cuda.memory_allocated() - base
    rounded, kept, n_kept = _hold_allocation(tag, leaves(args), alloc)
    exact = {k: sum(t.numel() * t.element_size() for t in leaves(v))
             for k, v in args.items()}
    pr = want["per_rank"]
    held = {"params": exact["params"] == pr["params"],
            "moments": exact.get("opt_state", 0) == pr["moments"],
            "state": exact.get("state", 0) == pr["state"]}
    if not all(held.values()):
        fail(f"{tag}: argument bytes {exact} against the dry run's {pr}")
    inputs = exact.get("tokens", exact.get("batch"))

    # values: the parameters' seed-0 blocks, zero moments, a filled state
    shadow = ShadowMesh(dims, mesh.axis_names, device="cuda")
    model = build_model(cfg)
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for dst, src in zip(leaves(args["params"]),
                            leaves(model.init_params(seed=0, mesh=shadow,
                                                     rules=rules))):
            dst.copy_(src)
        if "opt_state" in args:
            for t in leaves(args["opt_state"]):
                t.zero_()
        if "state" in args:
            _fill_state(args["state"], SHAPES[shape]["seq_len"], g)
        for t in leaves(args.get("batch", {})) + [args.get("tokens")]:
            if t is not None:
                t.copy_(torch.randint(0, cfg.vocab, t.shape, generator=g,
                                      device="cuda"))
    torch.cuda.synchronize()
    gc.collect()
    # what the process holds beside the arguments when the step starts
    # (a library's workspace kept after the values were written)
    other = torch.cuda.memory_allocated() - base - alloc
    torch.cuda.reset_peak_memory_stats()
    names = ("indexer_scores", "gvr_topk", "sparse_decode_attn")
    ops.reset_launch_counts()
    shadow.reset_bill()
    t0 = time.perf_counter()
    out = dryrun.run_shadow(model, shape, shadow, rules, args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base - other
    counts = ops.launch_counts()
    if shadow.bill() != meta_run["bill"]:
        fail(f"{tag}: the card's bill differs from the meta run's")
    res = {"arguments": alloc, "rounded": rounded, "kept": kept,
           "other": other, "exact": exact, "peak": peak,
           "temp_measured_bytes": peak - alloc, "wall_s": wall,
           "launches": {k: counts[k] for k in names},
           "dry_run": want["memory"]}
    if kind == "decode":
        logits = out[0]
        if tuple(logits.shape) != (SHAPES[shape]["global_batch"] // 16,
                                   cfg.vocab):
            fail(f"{tag}: logits {tuple(logits.shape)}")
        if any(counts[k] != cfg.n_layers for k in names):
            fail(f"{tag}: launches {counts}, want {cfg.n_layers} of each")
        # a second step with the kernels' first inputs kept (their copies
        # would count in the peak above), each against its plain version
        del out, logits
        seen, restore = _capture(ops, names)
        try:
            dryrun.run_shadow(model, shape, shadow, rules, args)
            torch.cuda.synchronize()
        finally:
            restore()
        res["kernels"] = _mesh_kernels_vs_plain(seen, tag)
        del seen
    elif not bool(torch.isfinite(out[2]["loss"])):
        fail(f"{tag}: loss {float(out[2]['loss'])}")
    log(f"{tag}{'' if depth is None else f' ({depth} layers)'}: arguments "
        f"{alloc} bytes allocated == {rounded} (each block's request "
        f"rounded to 512 B) + {kept} (segment remainders of 1 MiB or less "
        f"kept by {n_kept} large blocks), block by block; params {exact['params']}, moments "
        f"{exact.get('opt_state', 0)}, state {exact.get('state', 0)} bytes "
        f"== the dry run's; the step takes the global inputs ({inputs} "
        f"bytes) where the dry run counts the rank's block "
        f"({pr['inputs']}); dry-run argument_size_in_bytes "
        f"{want['memory']['argument_size_in_bytes']}")
    log(f"{tag}: one step in {wall:.3f} s host wall; peak {peak} bytes "
        f"({_gib(peak)} GiB) allocated over the arguments and what was "
        f"held before them ({other} bytes held beside them at the step's "
        f"start, left out), temp_measured_bytes "
        f"{peak - alloc} ({_gib(peak - alloc)} GiB); launches "
        f"{res['launches']}; bill == the meta run's "
        + (f"; B5/B1/B6 vs plain {res['kernels']}" if kind == "decode"
           else ""))
    del args, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_dryrun(child, out_dir: Path) -> dict:
    cells = join_dryrun_sweep(child, out_dir)
    decode = dryrun_card_cell("llama3.2-1b", "decode_32k")
    train = dryrun_card_cell("llama3.2-1b", "train_4k",
                             depth=DRYRUN_TRAIN_DEPTH)
    return {"cells": len(cells), "decode": decode, "train": train}


# ------------------------------------------------------------- examples ----

EXAMPLES = (("quickstart.py", "kernel B1 (on the card) EXACT"),
            ("serve_longcontext.py", "paged serve OK"),
            ("sp_gvr_500k.py", "SP-GVR exact over 8 sequence shards"),
            ("train_dsa.py", "done"))
EXAMPLE_TIMEOUT_S = 600


def start_examples(out_dir: Path) -> dict:
    """The port's four examples at their defaults, as four processes at
    once on the card (train_dsa's checkpoints under `out_dir`)."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    for name, _ in EXAMPLES:
        f = open(out_dir / f"{name}.log", "w")
        extra = (["--checkpoint-dir", str(out_dir / "ckpt")]
                 if name == "train_dsa.py" else [])
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / "torch" / name), *extra],
            stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT)), f,
            time.perf_counter())
    return procs


def join_examples(procs, out_dir: Path) -> dict:
    """Each example must exit 0 and print its check line."""
    res = {}
    for name, check in EXAMPLES:
        proc, f, t0 = procs[name]
        try:
            rc = proc.wait(timeout=EXAMPLE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            fail(f"[examples] {name} ran past {EXAMPLE_TIMEOUT_S} s")
        f.close()
        text = (out_dir / f"{name}.log").read_text()
        if rc != 0 or check not in text:
            fail(f"[examples] {name}: exit {rc}, no {check!r}: "
                 f"{text[-3000:]}")
        line = next(ln for ln in text.splitlines() if check in ln)
        res[name] = time.perf_counter() - t0
        log(f"[examples] {name}: exit 0 in {res[name]:.3f} s (from its "
            f"start): {line}")
    return res


def stop_examples(procs) -> None:
    for proc, f, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        f.close()


def run_llama_phases(model, params, cpu_params, rng, specs, timed):
    """The llama3.2-1b engine phases, [main] through [dense], which run
    beside h2o-danube's child processes (their host walls with them);
    returns their launch counts (main, dense-layout, gather, page, spec,
    dense). [main] and [dense-layout] run the first MAIN_DEPTH layers,
    [gather]/[page], [spec] and [dense] the first ENGINE_DEPTH (views of
    the same weights, full width); [layouts] runs all 16, and so do the
    profiled steps, [step] and [verify-step], after the children."""
    from repro_torch.models.api import build_model

    def cut(depth):
        return (build_model(dataclasses.replace(model.cfg, n_layers=depth),
                            device=model.device),
                {**params, "layers": _first_layers(params["layers"], depth)})

    main, engine = cut(MAIN_DEPTH), cut(ENGINE_DEPTH)
    main_counts, main_tokens = timed("main", phase_main, *main, specs)
    dl_counts = timed("dense-layout", phase_dense_layout, *main, specs,
                      main_tokens)
    timed("layouts", phase_layouts, model, params, cpu_params, rng)
    gather_counts, page_counts, fused = timed("gather+page", phase_gather_page,
                                              *engine, rng)
    spec_counts = timed("spec", phase_spec, *engine, fused)
    dense_counts = timed("dense", phase_dense, *engine, rng)
    return (main_counts, dl_counts, gather_counts, page_counts, spec_counts,
            dense_counts)


# ------------------------------------------------------- the 2-D mesh ------
# [tp], [ep] and [hybrid-sp] serve on a ("data", "model") mesh of 4 ranks,
# child processes of a gloo group sharing the one H100 as [sp]'s do
# (`python3 chip_smoke.py --mesh-rank PHASE R 4 file://... OUT`): each rank
# holds the blocks its specs give it (`Model.init_params(mesh=, rules=)`,
# `bridge.shard_tree`), and the ranks initialise one after another so the
# card never holds two ranks' draws at once. The parent first runs the
# single-device step over the same seeded cache, keeps its result on the
# CPU, frees the card, then starts the ranks and holds their ticks against
# it. A functional check (every collective is a gloo host round trip),
# not a speed.
MESH_WORLD = 4
MESH_CHILD_TIMEOUT_S = 600
MESH_SEED = 25
MESH_PHASES = {
    # llama3.2-1b, 8 of 16 layers, B = 4, heads, d_ff and vocab over
    # "model", the batch over "data"
    "tp": dict(arch="llama3.2-1b", depth=8, experts=None,
               shape=(2, 2), lengths=[4200, 5301, 6402, 7999], n=8192,
               ticks=8, seq=False, tol=5e-2),
    # moonshot-v1-16b-a3b, 4 of 48 layers, 16 of 64 experts a rank, bf16;
    # a row whose router choice flips is held to the flip's margin
    # (`_router_flips`) and left out of the later ticks' comparisons
    "ep": dict(arch="moonshot-v1-16b-a3b", depth=4, experts=None,
               shape=(1, 4), lengths=[4200, 5301, 6402, 7999],
               n=8192, ticks=8, seq=False, tol=5e-2),
    # jamba-1.5-large-398b, one superblock, 4 of 16 experts (top-2), the
    # sequence over "data" (long_500k's max_len); the write crosses the
    # shards' boundary at 262144 on the second tick
    "hybrid-sp": dict(arch="jamba-1.5-large-398b", depth=8, experts=4,
                      shape=(2, 2), lengths=[262143], n=524288, ticks=3,
                      seq=True, tol=5e-2),
}
# [ep]'s overflowing moe_mlp_ep call: 4 x 256 tokens at moonshot's width
EP_OVERFLOW_TOKENS = (4, 256)


# a flipped expert choice passes only where the router logits' measured
# difference from the single-device step's is at most this share of their
# spread (a rounding-sized difference: [tp]'s logits differ by ~1e-2)
ROUTER_ROUNDING = 0.05


def _mesh_cfg(spec):
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(spec["arch"]), n_layers=spec["depth"])
    if spec["experts"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=spec["experts"]))
    return cfg


def mesh_state(model, n, lengths, seed):
    """The decode state over a seeded cache: every K, V and indexer-K row
    of every layer drawn on the card, layer by layer, from per-layer
    seeds (the same content in every process), lengths `lengths`."""
    import torch
    st = model.init_decode_state(len(lengths), n)
    for j, key in enumerate(("k", "v", "idx_k")):
        for i in range(st[key].shape[0]):
            g = torch.Generator(device=model.device).manual_seed(
                seed * 1000 + 3 * i + j)
            st[key][i].copy_(torch.randn(st[key][i].shape, generator=g,
                                         device=model.device))
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=model.device)
    return st


def _mesh_ticks(model, params, st, ticks, *, feed=None, mesh=None,
                rules=None, seq=False, step=None):
    """`ticks` steps from tokens 1..B: greedy, or fed `feed[t]` at tick t
    > 0 (the single-device step's greedy tokens, so that a rank's logits
    are held against the reference's on the same inputs every tick). Per
    tick the step's host wall, its rows' logits and feedback (CPU), its
    argmax over all rows, the f32 router logits of every `moe_route` call
    in call order (the dense fallback's rows, or this EP rank's token
    slice) and (on a mesh) the collective bill by axis and tag. `step`
    (state, tokens) -> (logits, state) replaces `model.serve_step`."""
    import torch
    from repro_torch.models import layers
    b = st["length"].shape[0]
    tok = torch.arange(1, b + 1, dtype=torch.int32, device=model.device)
    entry = None if mesh is None else rules.spec("batch", sizes=(b,))[0]
    out, routed, route = [], [], layers.moe_route

    def recording(x, router_w, top_k):
        routed.append((x.float() @ router_w).reshape(-1, router_w.shape[-1]).cpu())
        return route(x, router_w, top_k)

    layers.moe_route = recording
    try:
        for t in range(ticks):
            out.append(_mesh_tick(model, params, st, tok, t, feed, mesh, rules,
                                  seq, entry, step))
            st, tok = out[-1].pop("state"), out[-1].pop("next")
            out[-1]["router"] = list(routed)
            routed.clear()
    finally:
        layers.moe_route = route
    return out, st


def _mesh_tick(model, params, st, tok, t, feed, mesh, rules, seq, entry,
               step=None):
    """One tick of `_mesh_ticks`; the record also holds the new state and
    the next token ("state", "next")."""
    import torch
    if feed is not None and t > 0:
        tok = feed[t].to(model.device)
    if mesh is not None:
        mesh.reset_bill()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if step is not None:
        logits, st = step(st, tok)
    elif mesh is None:
        logits, st = model.serve_step(params, st, tok)
    else:
        logits, st = model.serve_step(params, st, tok, mesh=mesh,
                                      rules=rules, seq_sharded=seq)
    torch.cuda.synchronize()
    rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
           "logits": logits.float().cpu(),
           "prev_topk": st["prev_topk"].cpu() if "prev_topk" in st else None}
    if mesh is not None:
        rec["bill"] = mesh.bill()
    tok = logits.argmax(-1).int()
    if entry is not None:
        tok = mesh.axis(entry).all_gather(tok, dim=0, tiled=True)
    rec["tokens"] = tok.cpu()
    rec["state"], rec["next"] = st, tok
    return rec


def _router_flips(cfg, ref, ranks, tag):
    """The first (tick, MoE call) at which a rank routes a row to other
    top-k experts than the single-device step does, by row. A flip passes
    only as a near-tie that this run's rounding explains: the reference's
    margin between its k-th and (k+1)-th expert is at most twice the
    rank's measured max |router logit difference| on that token, and
    that difference is at most ROUTER_ROUNDING of the token's logit
    spread. The row's later ticks then diverge (another expert's output)
    and are left out; the other rows stay independent of it (no token
    drops at these batches). Logs each flip with its numbers."""
    import torch
    k = cfg.moe.top_k
    if not k:
        return {}

    def top(v):
        return set(torch.sort(v, descending=True, stable=True).indices[:k].tolist())

    flips = {}
    for t, want in enumerate(ref):
        for r, res in enumerate(ranks):
            rows, me = res["rows"], res["coords"]["model"]
            for call, got in enumerate(res["ticks"][t]["router"]):
                tm = got.shape[0]
                for i in range(tm):
                    row = rows.start + me * tm + i
                    if row >= rows.stop or row in flips:
                        continue
                    o = want["router"][call][row]
                    if top(got[i]) == top(o):
                        continue
                    srt = torch.sort(o, descending=True, stable=True).values
                    f = {"tick": t, "moe_call": call, "rank": r,
                         "margin": float(srt[k - 1] - srt[k]),
                         "diff": float((got[i] - o).abs().max()),
                         "spread": float(o.std())}
                    if (f["margin"] > 2 * f["diff"]
                            or f["diff"] > ROUTER_ROUNDING * f["spread"]):
                        fail(f"{tag} row {row}: a router flip that rounding "
                             f"does not explain: {f}")
                    flips[row] = f
    n_calls = len(ref[0]["router"]) if ref else 0
    log(f"{tag} router choices against the single-device step's over "
        f"{len(ref)} ticks x {n_calls} MoE calls: "
        + (f"first flips by row (the reference's k-th - (k+1)-th logit "
           f"margin, the rank's max |logit difference|, the logits' std): "
           f"{flips}" if flips else "no flip"))
    return flips


def _mesh_kernels_vs_plain(seen, tag="[mesh]"):
    """B5's scoring, B1 and B6 on the first inputs a rank gave them (its
    rows, its heads), each against its plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    res = {}
    args, kw = seen["indexer_scores"]
    s_ker, s_ref = ops.indexer_scores(*args, **kw), ref.indexer_scores_ref(*args, **kw)
    live = s_ref > -1e38
    if not torch.equal(live, s_ker > -1e38):
        fail(f"{tag} B5 scoring at a rank's shapes: NEG mask differs")
    err = float((s_ker - s_ref)[live].abs().max())
    if err > 1e-4 * float(s_ref[live].abs().max()):
        fail(f"{tag} B5 scoring at a rank's shapes: max |err| {err}")
    res["B5 scoring"] = {"err": err, "shape": list(args[1].shape)}
    args, kw = seen["gvr_topk"]
    got, want = ops.gvr_topk(*args, **kw), ref.gvr_topk_ref(*args, **kw)
    if not torch.equal(got[1], want[1]):
        fail(f"{tag} B1 at a rank's shapes: indices differ from the plain "
             "version")
    res["B1"] = {"err": 0.0, "shape": list(args[0].shape)}
    args, kw = seen["sparse_decode_attn"]
    o, o_ref = ops.sparse_decode_attn(*args, **kw), ref.sparse_attn_ref(*args, **kw)
    err = float((o - o_ref).abs().max())
    if not torch.allclose(o, o_ref, atol=1e-4, rtol=1e-4):
        fail(f"{tag} B6 at a rank's heads: max |err| {err} beyond 1e-4")
    res["B6"] = {"err": err, "shape": list(args[0].shape)}
    return res


def _ep_overflow(model, params, mesh, rules, g):
    """One `moe_mlp_ep` call of layer 0 at EP_OVERFLOW_TOKENS tokens, with
    inputs whose routing is exact on any device (entries in {-1, 0, 1}
    against a router of multiples of 1/256): its drop count, against the
    CPU's count from the same inputs in the parent."""
    import torch
    from repro_torch.models import layers
    cfg = model.cfg
    x = torch.randint(-1, 2, EP_OVERFLOW_TOKENS + (cfg.d_model,), generator=g,
                      device=model.device).to(params["embed"].dtype)
    router = torch.randint(-127, 128, (cfg.d_model, cfg.moe.num_experts),
                           generator=g, device=model.device).float() / 256
    p = params["layers"]
    y = layers.moe_mlp_ep(x, router, p["w_gate"][0], p["w_up"][0],
                          p["w_down"][0], top_k=cfg.moe.top_k,
                          capacity_factor=cfg.moe.capacity_factor, mesh=mesh)
    drops = layers.moe_ep_drops(x, router, top_k=cfg.moe.top_k,
                                num_experts=cfg.moe.num_experts,
                                capacity_factor=cfg.moe.capacity_factor,
                                ep=mesh.shape["model"])
    return {"x": x.cpu(), "router": router.cpu(), "drops": drops,
            "finite": bool(torch.isfinite(y).all()), "shape": list(y.shape)}


# ---------------------- the paged forms on the mesh -----------------------
# [tp] and [ep] go on in the same ranks with the same parameters: a paged
# state over the dense ticks' start cache (the same seeded rows in pages of
# PAGED_MESH_PAGE positions, one per (slot, logical page), their ids a
# seeded permutation), placed by `paged_state_specs`. Each form is fed the
# inputs of the rank's own dense mesh ticks (tokens 1..B, then the single-
# device step's greedy tokens), and the rank holds it against those ticks:
# fused/token, gather and every live verify position bit for bit (on the
# card B2 == B5, B3 == B6 and B8 == B3 on the folded rows), page
# granularity as [layouts] holds it (B10 sums in page order). The fallback
# runs at max_len = dsa.min_n against the dense mesh step there.
PAGED_MESH_PAGE = 64
PAGED_MESH_SEED = 28
PAGED_MESH = {"tp": dict(token=8, page=2, gather=2, fallback=2,
                         verify=("scan", "mq")),
              "ep": dict(token=2, page=0, gather=0, fallback=0,
                         verify=("mq",))}
PAGED_MESH_VERIFY = dict(ticks=2, depth=2)
PAGED_MESH_FALLBACK = dict(n=4096, lengths=[1000, 2100, 3200, 4000])
PAGED_MESH_KERNELS = {"B2": "paged_indexer_scores",
                      "B3": "paged_sparse_decode_attn",
                      "B4": "paged_dense_decode_attn", "B7": "paged_gather",
                      "B8": "paged_sparse_decode_attn_mq",
                      "B9": "paged_indexer_scores_mq",
                      "B10": "paged_sparse_decode_attn_pg"}


def paged_from_dense(model, dense, seed):
    """The paged state over `dense`'s cache rows (a `mesh_state`): slot
    b's logical page j at id perm[b, j] of a seeded permutation, page
    PAGED_MESH_PAGE; lengths and feedback leaves copied."""
    import torch
    b, n = dense["k"].shape[1], dense["k"].shape[2]
    mp = n // PAGED_MESH_PAGE
    st = model.init_paged_decode_state(b, n, num_pages=b * mp,
                                       page_size=PAGED_MESH_PAGE)
    perm = torch.randperm(b * mp, generator=torch.Generator().manual_seed(
        seed)).to(model.device)
    st["page_table"] = perm.reshape(b, mp).int()
    for src, dst in (("k", "k_pages"), ("v", "v_pages"), ("idx_k", "idx_k_pages")):
        for i in range(dense[src].shape[0]):
            st[dst][i][perm] = dense[src][i].reshape(
                (b * mp, PAGED_MESH_PAGE) + dense[src].shape[3:])
    for key in ("length", "prev_topk", "topk_valid", "sel_gvr"):
        st[key] = dense[key].clone()
    return st


def _shard_paged(model, full, mesh, rules):
    from repro_torch import bridge
    b, n = full["length"].shape[0], full["page_table"].shape[1] * PAGED_MESH_PAGE
    return bridge.shard_tree(full, model.paged_state_specs(
        rules, batch=b, max_len=n, num_pages=full["k_pages"].shape[1] - 1,
        page_size=PAGED_MESH_PAGE), mesh)


def _verify_ticks(model, params, st, vk, seq, mesh, rules, entry):
    """PAGED_MESH_VERIFY's ticks of `vk`, every row drafting `depth`
    tokens: position j of row r is fed seq[s_r + j, r] (the dense ticks'
    inputs, s_r the steps the row has emitted), so each live position
    stands for dense tick s_r + j. Per tick: s, the rank's rows' logits,
    accept lengths and out tokens, the rolled-back Top-K, host wall, bill."""
    import torch
    b = seq.shape[1]
    depth = PAGED_MESH_VERIFY["depth"]
    dl = torch.full((b,), depth, dtype=torch.int32, device=model.device)
    s = torch.zeros(b, dtype=torch.long)
    recs = []
    for _ in range(PAGED_MESH_VERIFY["ticks"]):
        idx = s[:, None] + torch.arange(depth + 1)
        inputs = seq.gather(0, idx.T).T.contiguous().to(model.device)
        mesh.reset_bill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, a, logits, _, st = model.serve_step_spec_paged(
            params, st, inputs, draft_len=dl, max_accept=dl,
            verify_kernel=vk, mesh=mesh, rules=rules)
        torch.cuda.synchronize()
        rec = {"wall_ms": (time.perf_counter() - t0) * 1e3, "s": s.clone(),
               "bill": mesh.bill(), "logits": logits.float().cpu(),
               "accept": a.cpu(), "out": out.cpu(),
               "prev_topk": st["prev_topk"].cpu()}
        if entry is not None:
            a = mesh.axis(entry).all_gather(a, dim=0, tiled=True)
        s = s + a.cpu().long() + 1
        recs.append(rec)
    return recs


def _verify_vs_dense(recs, dense, rows):
    """(bit-equal, max |logit difference|): every live position's logits
    against the dense tick it stands for, and the rolled-back Top-K
    against the dense tick at the accepted step, row by row."""
    import torch
    same, worst = True, 0.0
    for rec in recs:
        for i, row in enumerate(range(rows.start, rows.stop)):
            s = int(rec["s"][row])
            for j in range(rec["logits"].shape[1]):
                want = dense[s + j]["logits"][i]
                worst = max(worst, float((rec["logits"][i, j] - want).abs().max()))
                same &= torch.equal(rec["logits"][i, j], want)
            a = int(rec["accept"][i])
            same &= torch.equal(rec["prev_topk"][:, i],
                                dense[s + a]["prev_topk"][:, i])
    return same, worst


def _ticks_vs_dense(got, want):
    """(bit-equal, max |logit difference|) of ticks against dense ticks:
    logits, Top-K and next tokens."""
    import torch
    same, worst = True, 0.0
    for g, w in zip(got, want):
        worst = max(worst, float((g["logits"] - w["logits"]).abs().max()))
        same &= (torch.equal(g["logits"], w["logits"])
                 and torch.equal(g["prev_topk"], w["prev_topk"])
                 and torch.equal(g["tokens"], w["tokens"]))
    return same, worst


def _paged_kernels_vs_plain(seen):
    """Each paged kernel on the first inputs the rank gave it, against its
    plain version: scoring rows (B2, B9) with equal NEG masks within 1e-4
    of their scale, attention (B3, B4, B8, B10) allclose at atol = rtol =
    1e-4 as in [kernels], B7 exact."""
    import torch
    from repro_torch.kernels import ops, ref
    plain = {"B2": ref.paged_indexer_scores_ref,
             "B3": ref.paged_sparse_attn_ref, "B4": ref.paged_dense_attn_ref,
             "B7": ref.paged_gather_ref, "B8": ref.paged_sparse_attn_mq_ref,
             "B9": ref.paged_indexer_scores_mq_ref,
             "B10": ref.paged_sparse_attn_pg_ref}
    res = {}
    for short, name in PAGED_MESH_KERNELS.items():
        if name not in seen:
            continue
        args, kw = seen[name]
        if "scale" in kw and kw["scale"] is None:
            kw = dict(kw, scale=args[0].shape[-1] ** -0.5)
        got, want = getattr(ops, name)(*args, **kw), plain[short](*args, **kw)
        if short in ("B2", "B9"):
            live = want > -1e38
            err = float((got - want)[live].abs().max()) if live.any() else 0.0
            ok = (torch.equal(live, got > -1e38) and err <= 1e-4 * float(
                want[live].abs().max() if live.any() else 0.0))
            short += " scoring"
        elif short == "B7":
            err, ok = 0.0 if torch.equal(got, want) else float("inf"), torch.equal(got, want)
        else:
            err = float((got - want).abs().max())
            ok = torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        res[short] = {"err": err, "ok": bool(ok), "shape": list(args[0].shape)}
    return res


def paged_mesh_cells(model, params, mesh, rules, phase, feed, dense):
    """The paged forms of `phase` on this rank (see above). `dense` are
    the rank's dense mesh ticks, `feed` their inputs after tick 0.
    Returns per form the equality with the dense ticks (or [layouts]'
    numbers), host walls, the token form's bill, the launches of all the
    forms and each paged kernel on its first inputs against its plain
    version."""
    import torch
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.models.tensor_parallel import Placement
    spec, cells = MESH_PHASES[phase], PAGED_MESH[phase]
    b = len(spec["lengths"])
    rows = Placement(mesh, rules, b).rows
    entry = rules.spec("batch", sizes=(b,))[0]
    t0 = time.perf_counter()
    full = paged_from_dense(model, mesh_state(model, spec["n"], spec["lengths"],
                                              MESH_SEED), PAGED_MESH_SEED)
    start = _shard_paged(model, full, mesh, rules)
    del full
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0}

    def fresh():
        return {k: v.clone() for k, v in start.items()}

    def step(**kw):
        return lambda st, tok: model.serve_step_paged(
            params, st, tok, mesh=mesh, rules=rules, **kw)

    ops.reset_launch_counts()
    seen, restore = _capture(ops, list(PAGED_MESH_KERNELS.values()))
    t1 = time.perf_counter()
    try:
        ticks, _ = _mesh_ticks(model, params, fresh(), cells["token"],
                               feed=feed, mesh=mesh, rules=rules, step=step())
        same, diff = _ticks_vs_dense(ticks, dense)
        out["token"] = {"equal": same, "diff": diff, "bill": ticks[-1]["bill"],
                        "wall_ms": [t["wall_ms"] for t in ticks]}
        if cells["gather"]:
            ticks, _ = _mesh_ticks(model, params, fresh(), cells["gather"],
                                   feed=feed, mesh=mesh, rules=rules,
                                   step=step(paged_attn="gather"))
            same, diff = _ticks_vs_dense(ticks, dense)
            out["gather"] = {"equal": same, "diff": diff}
        if cells["page"]:
            ticks, _ = _mesh_ticks(model, params, fresh(), cells["page"],
                                   feed=feed, mesh=mesh, rules=rules,
                                   step=step(gather_granularity="page"))
            out["page"] = {
                "rel": [_rel(g["logits"], w["logits"]) for g, w in zip(ticks, dense)],
                "argmax": [float((g["logits"].argmax(-1) == w["logits"].argmax(-1))
                                 .float().mean()) for g, w in zip(ticks, dense)],
                "agree": [_topk_agreement(g["prev_topk"], w["prev_topk"])
                          for g, w in zip(ticks, dense)]}
        seq = torch.stack([torch.arange(1, b + 1, dtype=torch.int32)]
                          + [f.cpu() for f in feed[1:]])
        for vk in cells["verify"]:
            recs = _verify_ticks(model, params, fresh(), vk, seq, mesh, rules,
                                 entry)
            same, diff = _verify_vs_dense(recs, dense, rows)
            out[vk] = {"equal": same, "diff": diff, "recs": recs}
        del start
        if cells["fallback"]:
            fb = PAGED_MESH_FALLBACK
            full = mesh_state(model, fb["n"], fb["lengths"], MESH_SEED + 3)
            paged = _shard_paged(model, paged_from_dense(model, full,
                                                         PAGED_MESH_SEED + 1),
                                 mesh, rules)
            st = bridge.shard_tree(full, model.state_specs(
                rules, batch=b, max_len=fb["n"]), mesh)
            del full
            want, _ = _mesh_ticks(model, params, st, cells["fallback"],
                                  mesh=mesh, rules=rules)
            got, _ = _mesh_ticks(model, params, paged, cells["fallback"],
                                 feed=[None] + [w["tokens"] for w in want],
                                 mesh=mesh, rules=rules, step=step())
            out["fallback"] = {
                "rel": [_rel(g["logits"], w["logits"]) for g, w in zip(got, want)],
                "argmax": [float((g["logits"].argmax(-1) == w["logits"].argmax(-1))
                                 .float().mean()) for g, w in zip(got, want)]}
            del st, paged
    finally:
        restore()
    torch.cuda.synchronize()
    out["cells_s"] = time.perf_counter() - t1
    out["counts"] = ops.launch_counts()
    out["kernels"] = _paged_kernels_vs_plain(seen)
    return out


# ---------------------- training and the other families on the mesh ------
# [train-mesh] and [family-mesh] run in [tp]'s four ranks after its ticks,
# [ep-train] in [ep]'s, and [hybrid-sp]'s ranks take one more cell, a
# cache of dsa.min_n positions. The parent runs each one-device reference
# before it starts the ranks: a family's greedy ticks (the ranks are fed
# its tokens), or training's loss, first gradients and parameters after
# the last step, which it leaves f32 on the host in the phase's folder
# (`train_ref.pt`) for the ranks to read their blocks of (mmap).
TRAIN_MESH = dict(arch="llama3.2-1b", depth=2, b=4, s=512, steps=2,
                  deterministic=True, zero1_ab=True)
# 16 tokens on 4 EP ranks: 4 a rank, each choosing distinct experts, so no
# expert gets more than 4 of a rank's assignments: below the least
# capacity (4), nothing drops, and EP is the dense fallback's function
EP_TRAIN = dict(arch="moonshot-v1-16b-a3b", depth=2, b=1, s=16, steps=2,
                deterministic=False, zero1_ab=False)
TRAIN_MESH_LOSS_RTOL = 1e-5
TRAIN_MESH_TOL = 1e-4        # a leaf's max |error| over its max |reference|
FAMILY_MESH = {"whisper": "whisper-medium", "rwkv6": "rwkv6-3b"}
FAMILY_MESH_DEPTH, FAMILY_MESH_N, FAMILY_MESH_TICKS = 4, 8192, 8
FAMILY_MESH_LENGTHS = [4200, 5301, 6402, 7999]   # past dsa.min_n = 4096
FAMILY_MESH_TOL = 5e-2
# [hybrid-sp]'s short cell: max_len = dsa.min_n, the write crossing the
# two sequence shards' boundary (2048) on the second tick
HYBRID_SHORT = dict(n=4096, lengths=[2047], ticks=2)


def _train_cfg(spec):
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(spec["arch"]),
                               n_layers=spec["depth"], dtype="float32")


def _family_mesh_cfg(arch):
    from repro_torch.configs.registry import get_config
    cfg = get_config(arch)
    kw = {"n_layers": FAMILY_MESH_DEPTH}
    if cfg.encoder_layers:
        kw["encoder_layers"] = FAMILY_MESH_DEPTH
    return dataclasses.replace(cfg, **kw)


def family_mesh_state(model, n, lengths, seed):
    """`mesh_state` for any family: every floating leaf of the decode
    state (whisper's caches and cross K/V, rwkv6's recurrent state) drawn
    on the card layer by layer from per-layer seeds, lengths `lengths`."""
    import torch
    st = model.init_decode_state(len(lengths), n)
    for j, key in enumerate(sorted(st)):
        if not st[key].is_floating_point():
            continue
        for i in range(st[key].shape[0]):
            g = torch.Generator(device=model.device).manual_seed(
                seed * 1000 + 7 * i + j)
            st[key][i].copy_(torch.randn(st[key][i].shape, generator=g,
                                         device=model.device))
    st["length"] = torch.tensor(lengths, dtype=torch.int32, device=model.device)
    return st


def _counting_moe(stats, ep=None):
    """Patch the transformer's `moe_mlp_ep` so that each call adds to
    stats["drops"]: the dispatch's own count under a mesh, or, on one
    device, what `layers.moe_ep_drops` says `ep` ranks would drop. Returns
    the undo."""
    import torch
    from repro_torch.models import layers, transformer
    orig = transformer.moe_mlp_ep

    def counted(x, router_w, *w, mesh=None, **kw):
        if mesh is not None:
            return orig(x, router_w, *w, mesh=mesh, stats=stats, **kw)
        with torch.no_grad():
            stats["drops"] = stats.get("drops", 0) + layers.moe_ep_drops(
                x, router_w, top_k=kw["top_k"], num_experts=w[0].shape[0],
                capacity_factor=kw["capacity_factor"], ep=ep)
        return orig(x, router_w, *w, mesh=mesh, **kw)

    transformer.moe_mlp_ep = counted
    return lambda: setattr(transformer, "moe_mlp_ep", orig)


def _train_steps(model, params, opt, batches, mesh=None, rules=None,
                 specs=None, twin=None):
    """The spec's steps: the first in `make_train_step`'s two halves
    (`loss_and_grads`, kept, then `adamw.update`), the rest through
    `make_train_step` itself. With `twin` = (params, opt) every step runs
    in the two halves and each step's gradients also update the twin
    (moments placed otherwise), whose parameters must then equal these
    bit for bit. Returns (params, opt, losses, grad norms, the first
    gradients, each step's host wall in ms, whether the twin's parameters
    equalled these after every step, or None)."""
    import torch
    from repro_torch.launch.train import batch_to, loss_and_grads, make_train_step
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves
    ocfg = adamw.AdamWConfig()
    step = make_train_step(model, ocfg, mesh, rules)
    dev = model.device
    losses, norms, walls, grads0 = [], [], [], None
    equal = None if twin is None else True
    for i, b in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0 or twin is not None:
            loss, grads = loss_and_grads(model, params, batch_to(b, dev),
                                         mesh=mesh, rules=rules)
            params, opt, met = adamw.update(grads, opt, params, ocfg,
                                            mesh=mesh, specs=specs)
            met["loss"] = loss
            grads0 = grads if i == 0 else grads0
        else:
            params, opt, met = step(params, opt, b)
            grads = None
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if twin is not None:
            twin = adamw.update(grads, twin[1], twin[0], ocfg, mesh=mesh,
                                specs=specs)[:2]
            equal = equal and all(torch.equal(a, c) for a, c in zip(
                leaves(params), leaves(twin[0])))
        del grads
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return params, opt, losses, norms, grads0, walls, equal


def _train_batches(cfg, spec):
    from repro_torch.data.pipeline import batch_for_step
    return [batch_for_step(i, vocab=cfg.vocab, batch=spec["b"], seq=spec["s"],
                           seed=0, family=cfg.family, cfg=cfg)
            for i in range(spec["steps"])]


def train_reference(spec, out_dir: Path, tag):
    """The one-device train steps of `spec` (f32, TF32 off), saved for the
    ranks: losses, grad norms, the first gradients and the parameters
    after the last step (f32 on the host), each leaf's max |value|; and,
    where the model has experts, what 4 EP ranks would drop."""
    import torch
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import flatten_with_paths
    cfg = _train_cfg(spec)
    model = build_model(cfg)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = model.init_params(seed=0)
    opt = adamw.init(params)
    stats, undo = {}, None
    if cfg.moe.num_experts:
        undo = _counting_moe(stats, ep=MESH_WORLD)
    try:
        params, opt, losses, norms, grads0, walls, _ = _train_steps(
            model, params, opt, _train_batches(cfg, spec))
    finally:
        if undo:
            undo()
    ref = {"loss": losses, "grad_norm": norms, "ms": walls,
           "drops": stats.get("drops"), "peak_gib":
           torch.cuda.max_memory_allocated() / 2 ** 30}
    for name, tree in (("grads", grads0), ("params", params)):
        ref[name] = _to_cpu(tree)
        ref[name + "_scale"] = {p: float(t.abs().max())
                                for p, t in flatten_with_paths(tree)}
    torch.save(ref, out_dir / "train_ref.pt")
    log(f"{tag} the one-device reference: {cfg.name} at full width, "
        f"{cfg.n_layers} layers, float32 (TF32 off), B = {spec['b']}, S = "
        f"{spec['s']}, {spec['steps']} AdamW steps: losses {losses}, grad "
        f"norms {norms}, {np.median(walls):.3f} ms a step"
        + (f", {stats['drops']} assignments 4 EP ranks would drop"
           if undo else "")
        + f"; {time.perf_counter() - t0:.3f} s with the init and the save")
    if undo and stats["drops"]:
        fail(f"{tag} {spec['b']} x {spec['s']} tokens: moe_ep_drops reads "
             f"{stats['drops']}, not 0")
    del model, params, opt, grads0
    gc.collect()
    torch.cuda.empty_cache()
    return ref


def _block_errors(local, ref_tree, specs, mesh):
    """{path: max |local - the reference's block|} over the rank's
    blocks (the reference read through mmap)."""
    from repro_torch.parallel.sharding import block_slices
    from repro_torch.tree import flatten_with_paths, spec_leaves
    out = {}
    for (path, a), (_, r), spec in zip(flatten_with_paths(local),
                                       flatten_with_paths(ref_tree),
                                       spec_leaves(specs)):
        blk = r[block_slices(spec, r.shape, mesh, mesh.coords)]
        out[path] = float((a.float() - blk.to(a.device)).abs().max())
    return out


def train_mesh_child(spec, mesh, rules, out_dir: Path):
    """This rank's train steps of `spec` on `mesh` with ZeRO-1 moments
    (`shardings_for`), from the blocks of the one-device reference's
    parameters; its errors against that reference, its ms a step, bill,
    peak memory and moment bytes; with zero1_ab the same steps again with
    moments placed as their parameters (bit-equal parameters)."""
    import torch
    from repro_torch import bridge
    from repro_torch.launch.train import shardings_for
    from repro_torch.models.api import build_model
    from repro_torch.optim import adamw
    from repro_torch.tree import leaves, spec_map, tree_map
    cfg = _train_cfg(spec)
    model = build_model(cfg, device=mesh.device)
    if spec["deterministic"]:
        torch.use_deterministic_algorithms(True)
    try:
        params = model.init_params(seed=0, mesh=mesh, rules=rules)
        pspecs = model.param_specs(rules)
        sizes = spec_map(lambda sp, t: bridge.global_shape(sp, t.shape, mesh),
                         pspecs, params)
        pspecs, ospecs = shardings_for(model, mesh, rules, sizes)
        opt = adamw.init(params, mesh=mesh, specs=pspecs, moment_specs=ospecs.m)
        moment_bytes = sum(t.numel() * 4 for t in leaves((opt.m, opt.v)))
        twin, twin_bytes = None, None
        if spec["zero1_ab"]:
            tp = tree_map(torch.clone, params)
            twin = (tp, adamw.init(tp, mesh=mesh, specs=pspecs))
            twin_bytes = sum(t.numel() * 4 for t in leaves((twin[1].m,
                                                            twin[1].v)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mesh.reset_bill()
        stats, undo = {}, None
        if cfg.moe.num_experts:
            undo = _counting_moe(stats)
        try:
            params, opt, losses, norms, grads0, walls, equal = _train_steps(
                model, params, opt, _train_batches(cfg, spec), mesh, rules,
                pspecs, twin)
        finally:
            if undo:
                undo()
        res = {"loss": losses, "grad_norm": norms, "ms": walls,
               "bill": mesh.bill(), "drops": stats.get("drops"),
               "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
               "moment_bytes": moment_bytes, "zero1_equal": equal,
               "replicated_moment_bytes": twin_bytes}
        del twin
        ref = torch.load(out_dir / "train_ref.pt", mmap=True,
                         weights_only=True)
        res["grad_err"] = _block_errors(grads0, ref["grads"], pspecs, mesh)
        res["param_err"] = _block_errors(params, ref["params"], pspecs, mesh)
    finally:
        torch.use_deterministic_algorithms(False)
    return res


def _ep_train_overflow(model, params, mesh, g):
    """One `moe_mlp_ep` call of layer 0 under autograd at
    EP_OVERFLOW_TOKENS tokens (inputs whose routing is exact on any
    device, as `_ep_overflow`'s), and its backward: this rank's dropped
    assignments as the dispatch counts them, and whether every gradient
    is finite."""
    import torch
    from repro_torch.models import layers
    cfg = model.cfg
    x = torch.randint(-1, 2, EP_OVERFLOW_TOKENS + (cfg.d_model,), generator=g,
                      device=model.device).float().requires_grad_()
    router = (torch.randint(-127, 128, (cfg.d_model, cfg.moe.num_experts),
                            generator=g, device=model.device).float()
              / 256).requires_grad_()
    p = params["layers"]
    stats = {}
    y = layers.moe_mlp_ep(x, router, p["w_gate"][0], p["w_up"][0],
                          p["w_down"][0], top_k=cfg.moe.top_k,
                          capacity_factor=cfg.moe.capacity_factor, mesh=mesh,
                          stats=stats)
    y.square().sum().backward()
    return {"x": x.detach().cpu(), "router": router.detach().cpu(),
            "drops": stats["drops"],
            "finite": bool(torch.isfinite(x.grad).all()
                           and torch.isfinite(router.grad).all())}


def family_reference(out_dir: Path, flush=None):
    """[family-mesh]'s one-device greedy ticks of each family, their tokens
    left for the ranks (feed_{key}.pt). Returns {key: ticks}."""
    import torch
    from repro_torch.models.api import build_model
    refs = {}
    for key, arch in FAMILY_MESH.items():
        cfg = _family_mesh_cfg(arch)
        model = build_model(cfg)
        params = model.init_params(seed=0)
        st = family_mesh_state(model, FAMILY_MESH_N, FAMILY_MESH_LENGTHS,
                               MESH_SEED)
        refs[key], _ = _mesh_ticks(model, params, st, FAMILY_MESH_TICKS)
        torch.save([None] + [r["tokens"] for r in refs[key][:-1]],
                   out_dir / f"feed_{key}.pt")
        log(f"[family-mesh] {cfg.name} at full width, {cfg.n_layers} layers, "
            f"{cfg.dtype}, B = {len(FAMILY_MESH_LENGTHS)}, max_len "
            f"{FAMILY_MESH_N}, lengths {FAMILY_MESH_LENGTHS}: the one-device "
            f"step first, {np.median([r['wall_ms'] for r in refs[key][1:]]):.3f}"
            f" ms a step")
        del model, params, st
        gc.collect()
        torch.cuda.empty_cache()
    return refs


def family_mesh_child(mesh, rules, out_dir: Path):
    """This rank's [family-mesh] ticks of each family, fed the one-device
    tokens; whisper's B5 / B1 / B6 inputs held against the plain versions
    and its launches counted."""
    import torch
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.models.tensor_parallel import Placement
    from repro_torch.tree import leaves
    res = {}
    b = len(FAMILY_MESH_LENGTHS)
    for key, arch in FAMILY_MESH.items():
        model = build_model(_family_mesh_cfg(arch), device=mesh.device)
        params = model.init_params(seed=0, mesh=mesh, rules=rules)
        full = family_mesh_state(model, FAMILY_MESH_N, FAMILY_MESH_LENGTHS,
                                 MESH_SEED)
        st = bridge.shard_tree(full, model.state_specs(
            rules, batch=b, max_len=FAMILY_MESH_N), mesh)
        del full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seen, restore = _capture(ops, ("indexer_scores", "gvr_topk",
                                       "sparse_decode_attn"))
        ops.reset_launch_counts()
        ticks, _ = _mesh_ticks(model, params, st, FAMILY_MESH_TICKS,
                               feed=torch.load(out_dir / f"feed_{key}.pt"),
                               mesh=mesh, rules=rules)
        restore()
        r = {"ticks": ticks, "rows": Placement(mesh, rules, b).rows,
             "counts": ops.launch_counts(),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "param_gib": sum(x.numel() * x.element_size()
                              for x in leaves(params)) / 2 ** 30}
        if seen:
            r["kernels"] = _mesh_kernels_vs_plain(seen)
        res[key] = r
        del model, params, st
        gc.collect()
        torch.cuda.empty_cache()
    return res


def mesh_child(argv) -> int:
    """One rank of a mesh phase: PHASE RANK WORLD INIT OUT. Saves its ticks,
    launch counts, kernel checks and memory to OUT/rank{RANK}.pt."""
    import torch
    import torch.distributed as dist
    from repro_torch import bridge
    from repro_torch.kernels import ops
    from repro_torch.launch import init_mesh_group, make_mesh
    from repro_torch.models.api import build_model
    from repro_torch.models.tensor_parallel import Placement
    from repro_torch.parallel.sharding import make_rules
    from repro_torch.tree import leaves
    phase, rank, world, init, out_dir = argv
    rank, world = int(rank), int(world)
    spec = MESH_PHASES[phase]
    init_mesh_group(rank, world, init_method=init, backend="gloo",
                    timeout_s=300)
    mesh = make_mesh(spec["shape"], ("data", "model"), backend="gloo")
    rules = make_rules(mesh)
    model = build_model(_mesh_cfg(spec), device=mesh.device)
    b, n = len(spec["lengths"]), spec["n"]
    t0 = time.perf_counter()
    for r in range(world):           # one rank's draws on the card at a time
        if r == rank:
            free, total = torch.cuda.mem_get_info(mesh.device)
            print(f"rank {rank}: {free / 2 ** 30:.3f} of {total / 2 ** 30:.3f} "
                  f"GiB free on the card before its init", flush=True)
            params = model.init_params(seed=0, mesh=mesh, rules=rules)
            full = mesh_state(model, n, spec["lengths"], MESH_SEED)
            st = bridge.shard_tree(full, model.state_specs(
                rules, batch=b, max_len=n, seq_sharded=spec["seq"]), mesh)
            del full
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        mesh.barrier()
    res = {"device": str(mesh.device), "backend": mesh.backend,
           "coords": mesh.coords, "init_s": time.perf_counter() - t0,
           "rows": Placement(mesh, rules, b).rows,
           "probe": _gloo_cuda_probe(mesh),
           "param_gib": sum(x.numel() * x.element_size() for x in
                            leaves(params)) / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    seen, restore = _capture(ops, ("indexer_scores", "gvr_topk",
                                   "sparse_decode_attn"))
    ops.reset_launch_counts()
    feed = torch.load(Path(out_dir) / "feed.pt")
    res["ticks"], st = _mesh_ticks(model, params, st, spec["ticks"], feed=feed,
                                   mesh=mesh, rules=rules, seq=spec["seq"])
    restore()
    res["counts"] = ops.launch_counts()
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if seen:
        res["kernels"] = _mesh_kernels_vs_plain(seen)
    if phase == "ep":
        res["overflow"] = _ep_overflow(model, params, mesh, rules, torch.Generator(
            device=mesh.device).manual_seed(MESH_SEED))
    if phase in PAGED_MESH:
        del st
        torch.cuda.empty_cache()
        res["paged"] = paged_mesh_cells(model, params, mesh, rules, phase,
                                        feed, res["ticks"])
        st = None
    extra = time.perf_counter()
    if phase == "hybrid-sp":
        del st
        torch.cuda.empty_cache()
        full = mesh_state(model, HYBRID_SHORT["n"], HYBRID_SHORT["lengths"],
                          MESH_SEED + 1)
        st = bridge.shard_tree(full, model.state_specs(
            rules, batch=len(HYBRID_SHORT["lengths"]), max_len=HYBRID_SHORT["n"],
            seq_sharded=True), mesh)
        del full
        res["short"], _ = _mesh_ticks(
            model, params, st, HYBRID_SHORT["ticks"], mesh=mesh, rules=rules,
            seq=True, feed=torch.load(Path(out_dir) / "feed_short.pt"))
    del model, params, st
    gc.collect()
    torch.cuda.empty_cache()
    if phase == "tp":
        res["train"] = train_mesh_child(TRAIN_MESH, mesh, rules, Path(out_dir))
        res["family"] = family_mesh_child(mesh, rules, Path(out_dir))
    if phase == "ep":
        res["train"] = train_mesh_child(EP_TRAIN, mesh, rules, Path(out_dir))
        model = build_model(_train_cfg(EP_TRAIN), device=mesh.device)
        params = model.init_params(seed=0, mesh=mesh, rules=rules)
        res["train_overflow"] = _ep_train_overflow(
            model, params, mesh, torch.Generator(
                device=mesh.device).manual_seed(MESH_SEED + 2))
        del model, params
    res["extra_s"] = time.perf_counter() - extra
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    mesh.barrier()
    dist.destroy_process_group()
    return 0


def start_mesh_children(phase, out_dir: Path):
    """The ranks of a fresh gloo group (a file rendezvous in out_dir);
    their output goes to out_dir/rank{r}.log."""
    import os
    out_dir.mkdir(parents=True, exist_ok=True)
    rdv = out_dir / "rendezvous"
    if rdv.exists():
        rdv.unlink()
    # four ranks' caches share the card: segments that grow and shrink
    # keep each rank's freed draws from pinning memory the next one needs
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CUBLAS_WORKSPACE_CONFIG=":4096:8")   # [train-mesh]'s determinism
    procs = []
    for r in range(MESH_WORLD):
        f = open(out_dir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--mesh-rank",
             phase, str(r), str(MESH_WORLD), f"file://{rdv}", str(out_dir)],
            stdout=f, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env), f))
    return procs


def join_mesh_children(procs, out_dir: Path, tag: str):
    """Wait for every rank (MESH_CHILD_TIMEOUT_S); a rank that fails or
    hangs fails the phase, with the end of every failed rank's log (a
    rank that fails first takes its peers down with it)."""
    import torch
    failed = []
    try:
        for r, (proc, f) in enumerate(procs):
            try:
                rc = proc.wait(timeout=MESH_CHILD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                fail(f"{tag} rank {r} ran past {MESH_CHILD_TIMEOUT_S} s")
            f.close()
            if rc != 0:
                failed.append((r, rc))
    finally:
        stop_family_children({r: p for r, p in enumerate(procs)})
    if failed:
        fail(f"{tag} ranks exited nonzero: " + "\n".join(
            f"rank {r} exited {rc}: "
            + (out_dir / f"rank{r}.log").read_text()[-2000:] for r, rc in failed))
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(MESH_WORLD)]


def _hold_ticks(tag, ranks, ref, tol, flips=None):
    """Each rank's ticks (rows, ticks) against the single-device step's
    `ref`, row by row: logits within `tol` relative L2, tokens equal or a
    near-tie the reference's own logits show (its gap between the two
    tokens at most twice the rank's max |logit difference|), a row left
    out from its router flip on (`flips`); Top-K agreement by layer on
    rank 0 where there is a Top-K."""
    flips = flips or {}
    worst, agree, same, ties, held = 0.0, [], 0, [], 0
    for r, (rows, ticks) in enumerate(ranks):
        for t, (got, want) in enumerate(zip(ticks, ref)):
            for i, row in enumerate(range(rows.start, rows.stop)):
                if row in flips and t >= flips[row]["tick"]:
                    continue
                held += 1
                rel = _rel(got["logits"][i], want["logits"][row])
                worst = max(worst, rel)
                if rel > tol:
                    fail(f"{tag} rank {r} tick {t} row {row}: logits rel L2 "
                         f"{rel} > {tol}")
                a, w = int(got["tokens"][row]), int(want["tokens"][row])
                if a == w:
                    same += 1
                    continue
                ref_row = want["logits"][row]
                gap = float(ref_row[w] - ref_row[a])
                diff = float((got["logits"][i] - ref_row).abs().max())
                if gap > 2 * diff:
                    fail(f"{tag} rank {r} tick {t} row {row}: token {a} against "
                         f"the single-device step's {w}, whose logits part them "
                         f"by {gap}, beyond twice this rank's difference {diff}")
                ties.append((r, t, row, round(gap, 5), round(diff, 5)))
            if r == 0 and got["prev_topk"] is not None:
                agree.append(_topk_agreement(got["prev_topk"],
                                             want["prev_topk"][:, rows]))
    if not held:
        fail(f"{tag} every row's router choice flipped before any tick could "
             f"be held against the single-device step: {flips}")
    log(f"{tag} every tick fed the single-device step's greedy tokens: "
        f"{held} (rank, tick, row)s held to it (rows after a router flip "
        f"left out); the ranks' own argmax equals them on {same} of them, "
        f"the rest near-ties (rank, tick, row, the reference's logit gap, "
        f"the rank's max |logit difference|): {ties}; logits rel L2 at most "
        f"{worst:.3e} (tolerance {tol})"
        + (f"; Top-K agreement per layer, rank 0, by tick: {agree}"
           if agree else ""))


def _bill_line(bill) -> str:
    return "; ".join(f"{ax}: " + ", ".join(f"{k} {v['calls']}/{v['bytes']}"
                                           for k, v in tags.items())
                     for ax, tags in bill.items())


def _check_train(tag, spec, ref, ranks):
    """A mesh train run's ranks against the one-device reference: losses
    within TRAIN_MESH_LOSS_RTOL, every gradient leaf after the first step
    and every parameter after the last within TRAIN_MESH_TOL of the
    leaf's max |value| (the worst block over the ranks), no drop under
    experts, ZeRO-1 bit-equal to replicated moments where run; logs ms a
    step, the bill, peak memory and moment bytes a rank."""
    for r, res in enumerate(ranks):
        for i, (a, w) in enumerate(zip(res["loss"], ref["loss"])):
            if abs(a - w) > TRAIN_MESH_LOSS_RTOL * abs(w):
                fail(f"{tag} rank {r} step {i}: loss {a} against the one-"
                     f"device {w}")
    worst = {}
    for what in ("grad", "param"):
        scale = ref[what + "s_scale"]
        err = {p: max(res[what + "_err"][p] for res in ranks) / max(scale[p], 1e-30)
               for p in scale}
        path = max(err, key=err.get)
        worst[what] = (err[path], path)
        if err[path] > TRAIN_MESH_TOL:
            fail(f"{tag} {what} leaf {path}: max |err| / max |ref| "
                 f"{err[path]:.3e} > {TRAIN_MESH_TOL}")
    if ref["drops"] is not None:
        drops = sum(res["drops"] for res in ranks)
        if drops:
            fail(f"{tag} the mesh step dropped {drops} assignments")
    r0 = ranks[0]
    log(f"{tag} losses {r0['loss']} (one device {ref['loss']}), grad norms "
        f"{r0['grad_norm']} (one device {ref['grad_norm']}); worst leaf "
        f"max |err| / max |ref|: gradients {worst['grad'][0]:.3e} "
        f"({worst['grad'][1]}), parameters after {spec['steps']} steps "
        f"{worst['param'][0]:.3e} ({worst['param'][1]}) (tolerance "
        f"{TRAIN_MESH_TOL})" + (f"; drops {ref['drops']} one device, "
                                f"{sum(res['drops'] for res in ranks)} on "
                                f"the mesh" if ref["drops"] is not None else ""))
    log(f"{tag} rank 0: {r0['ms']} ms a step (one device {ref['ms']}); peak "
        f"GiB by rank {[round(res['peak_gib'], 3) for res in ranks]} (one "
        f"device {ref['peak_gib']:.3f}); moment bytes a rank "
        f"{[res['moment_bytes'] for res in ranks]}"
        + (f" against {r0['replicated_moment_bytes']} replicated "
           f"({r0['replicated_moment_bytes'] / r0['moment_bytes']:.3f}x)"
           if r0["replicated_moment_bytes"] else "")
        + f"; the steps' collectives on rank 0 (calls/bytes): "
        + _bill_line(r0["bill"]))
    if spec["zero1_ab"]:
        if not all(res["zero1_equal"] for res in ranks):
            fail(f"{tag} ZeRO-1 moments did not give the parameters of "
                 f"replicated moments bit for bit")
        log(f"{tag} ZeRO-1 moments and moments placed as their parameters, "
            f"each step from the same gradients: the same parameters after "
            f"every one of {spec['steps']} steps, bit for bit, on every rank "
            f"(deterministic algorithms)")


def _check_paged_mesh(tag, phase, ranks):
    """The paged cells' verdicts on every rank (`paged_mesh_cells`): fail
    unless fused/token, gather and every live verify position equal the
    rank's dense mesh ticks bit for bit, mq == scan where both ran, page
    granularity and the fallback within [layouts]' rule, every paged
    kernel of the phase's forms launched on every rank and each equal to
    its plain version. Logs them; returns the launches over the ranks."""
    import torch
    cells = PAGED_MESH[phase]
    need = ["B2", "B3", "B8", "B9"] + (["B10"] if cells["page"] else []) + (
        ["B7"] if cells["gather"] else []) + (["B4"] if cells["fallback"] else [])
    for r, res in enumerate(ranks):
        p = res["paged"]
        for form in ("token", "gather") + tuple(cells["verify"]):
            if form in p and not p[form]["equal"]:
                fail(f"{tag} rank {r}: the paged {form} ticks differ from the "
                     f"rank's dense mesh ticks (max |logit difference| "
                     f"{p[form]['diff']})")
        if "scan" in p and "mq" in p:
            for a, c in zip(p["scan"]["recs"], p["mq"]["recs"]):
                if not all(torch.equal(a[k], c[k]) for k in (
                        "logits", "accept", "out", "prev_topk")):
                    fail(f"{tag} rank {r}: mq differs from scan")
        for form in ("page", "fallback"):
            if form not in p:
                continue
            if max(p[form]["rel"]) > 5e-2:
                fail(f"{tag} rank {r}: paged {form} logits rel L2 "
                     f"{p[form]['rel']} > 5e-2 against the dense mesh ticks")
            if form == "page" and any(a[0] != 1.0 or min(a) < 0.99
                                      for a in p[form]["agree"]):
                fail(f"{tag} rank {r}: page-granular Top-K agreement "
                     f"{p[form]['agree']}")
        bad = {k: v for k, v in p["kernels"].items() if not v["ok"]}
        if bad:
            fail(f"{tag} rank {r}: paged kernels against their plain versions: {bad}")
        zero = [k for k in need if not p["counts"][PAGED_MESH_KERNELS[k]]]
        if zero:
            fail(f"{tag} rank {r}: no launch of {zero} on the paged forms")
    p0 = ranks[0]["paged"]
    verify = {vk: [rec["accept"].tolist() for rec in p0[vk]["recs"]]
              for vk in cells["verify"]}
    log(f"{tag} paged (page {PAGED_MESH_PAGE}, a shuffled table, the dense "
        f"ticks' start cache; every rank): fused/token {cells['token']} ticks"
        + (f", gather {cells['gather']}" if cells["gather"] else "")
        + f" and {PAGED_MESH_VERIFY['ticks']} verify ticks of depth "
        f"{PAGED_MESH_VERIFY['depth']} by {' and '.join(cells['verify'])} "
        f"(every live position) equal the rank's own dense mesh ticks bit "
        f"for bit (logits, Top-K, tokens)"
        + (", mq == scan bit for bit" if len(cells["verify"]) == 2 else "")
        + f"; rank 0's accept lengths by tick {verify}")
    if cells["page"]:
        log(f"{tag} paged page granularity (B10), {cells['page']} ticks, "
            f"against the dense mesh ticks on rank 0: logits rel L2 "
            f"{[f'{x:.3e}' for x in p0['page']['rel']]}, argmax agreement "
            f"{p0['page']['argmax']}, per-layer Top-K agreement "
            f"{p0['page']['agree']}; worst over the ranks "
            f"{max(max(res['paged']['page']['rel']) for res in ranks):.3e}")
    if cells["fallback"]:
        fb = PAGED_MESH_FALLBACK
        log(f"{tag} paged fallback (B4) at max_len {fb['n']} = dsa.min_n, "
            f"lengths {fb['lengths']}, {cells['fallback']} ticks, against the "
            f"dense mesh step there: logits rel L2 "
            f"{[f'{x:.3e}' for x in p0['fallback']['rel']]} on rank 0 (worst "
            f"{max(max(res['paged']['fallback']['rel']) for res in ranks):.3e}), "
            f"argmax agreement {p0['fallback']['argmax']}")
    counts = {k: sum(res["paged"]["counts"][k] for res in ranks)
              for k in p0["counts"]}
    per_rank = [{k: res["paged"]["counts"][PAGED_MESH_KERNELS[k]] for k in need}
                for res in ranks]
    walls = p0["token"]["wall_ms"][1:] or p0["token"]["wall_ms"]
    log(f"{tag} paged launches per rank: {per_rank}; rank 0's first inputs "
        f"against the plain versions: {p0['kernels']}; one fused/token tick's "
        f"collectives on rank 0 (calls/bytes): {_bill_line(p0['token']['bill'])}"
        f"; host wall a fused/token tick {np.median(walls):.3f} ms (dense "
        f"mesh tick {np.median([t['wall_ms'] for t in ranks[0]['ticks'][1:]]):.3f}"
        f"); a verify tick {[round(rec['wall_ms'], 3) for vk in cells['verify'] for rec in p0[vk]['recs']]} ms; "
        f"setup {max(res['paged']['setup_s'] for res in ranks):.3f} s, cells "
        f"{max(res['paged']['cells_s'] for res in ranks):.3f} s")
    return counts


def phase_mesh(phase):
    """[tp] / [ep] / [hybrid-sp]: the single-device step here, then the
    ranks; tokens equal every tick (or a near-tie), logits within the
    phase's tolerance (relative L2 of each row: bf16, and the sharded sums
    round in another order), router flips held to their margin
    (`_router_flips`), Top-K agreement per layer reported, the bill by
    axis and tag, each rank's launches. Returns the launches summed over
    the ranks."""
    import torch
    from repro_torch.models.api import build_model
    spec = MESH_PHASES[phase]
    tag = f"[{phase}]"
    cfg = _mesh_cfg(spec)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    st = mesh_state(model, spec["n"], spec["lengths"], MESH_SEED)
    torch.cuda.synchronize()
    one_gib = torch.cuda.memory_allocated() / 2 ** 30
    ref, st = _mesh_ticks(model, params, st, spec["ticks"])
    log(f"{tag} {cfg.name} at full width, {cfg.n_layers} layers, {cfg.dtype}"
        + (f", {cfg.moe.num_experts} experts (top-{cfg.moe.top_k})"
           if cfg.moe.num_experts else "")
        + f"; B = {len(spec['lengths'])}, max_len {spec['n']}, lengths "
        f"{spec['lengths']}: the single-device step first ({one_gib:.3f} GiB "
        f"on the card, {time.perf_counter() - t0:.3f} s with the init), "
        f"{np.median([r['wall_ms'] for r in ref[1:]]):.3f} ms a step")
    out_dir = ROOT / "build" / "chip_smoke" / "mesh" / phase
    out_dir.mkdir(parents=True, exist_ok=True)
    if phase == "hybrid-sp":
        # the short cell: max_len = dsa.min_n, the dense attention over
        # the sharded sequence on the ranks
        short = mesh_state(model, HYBRID_SHORT["n"], HYBRID_SHORT["lengths"],
                           MESH_SEED + 1)
        short_ref, _ = _mesh_ticks(model, params, short, HYBRID_SHORT["ticks"])
        torch.save([None] + [r["tokens"] for r in short_ref[:-1]],
                   out_dir / "feed_short.pt")
        del short
    del model, params, st
    gc.collect()
    torch.cuda.empty_cache()
    # every tick's input is the single-device step's greedy token
    torch.save([None] + [r["tokens"] for r in ref[:-1]], out_dir / "feed.pt")
    t_extra = time.perf_counter()
    if phase == "tp":
        train_ref = train_reference(TRAIN_MESH, out_dir, "[train-mesh]")
        family_ref = family_reference(out_dir)
    if phase == "ep":
        train_ref = train_reference(EP_TRAIN, out_dir, "[ep-train]")
    ref_s = time.perf_counter() - t_extra
    ranks = join_mesh_children(start_mesh_children(phase, out_dir), out_dir, tag)
    r0 = ranks[0]
    log(f"{tag} mesh {dict(zip(('data', 'model'), spec['shape']))} over "
        f"{MESH_WORLD} gloo ranks on one card ({r0['device']}); gloo on CUDA "
        f"tensors directly: {r0['probe']}; per rank "
        + ", ".join(f"{res['param_gib']:.3f} GiB of parameters, peak "
                    f"{res['peak_gib']:.3f} GiB" for res in ranks[:1])
        + f"; the ranks' init one at a time {max(res['init_s'] for res in ranks):.3f} s")
    flips = _router_flips(cfg, ref, ranks, tag)
    _hold_ticks(tag, [(res["rows"], res["ticks"]) for res in ranks], ref,
                spec["tol"], flips)
    bill = r0["ticks"][-1]["bill"]
    log(f"{tag} the last tick's collectives on rank 0, by axis and tag "
        f"(calls, bytes): " + _bill_line(bill)
        + f"; host wall a tick {np.median([t['wall_ms'] for t in r0['ticks'][1:]]):.3f} ms")
    counts = {k: sum(res["counts"][k] for res in ranks) for k in r0["counts"]}
    per_rank = [{k: res["counts"][k] for k in ("indexer_scores", "gvr_topk",
                                               "sparse_decode_attn")}
                for res in ranks]
    log(f"{tag} launches per rank (B5 scoring, B1, B6): {per_rank}")
    if phase in ("tp", "ep") and any(min(c.values()) == 0 for c in per_rank):
        fail(f"{tag} a rank launched no B5, B1 or B6: {per_rank}")
    if "kernels" in r0:
        log(f"{tag} rank 0's first B5 scoring / B1 / B6 inputs against the "
            f"plain versions: {r0['kernels']}")
    checks = dict(r0.get("kernels", {}))
    if phase in PAGED_MESH:
        paged = _check_paged_mesh(tag, phase, ranks)
        counts = {k: counts[k] + paged[k] for k in counts}
        checks.update(r0["paged"]["kernels"])
    if phase == "ep":
        from repro_torch.models import layers
        o = r0["overflow"]
        want = layers.moe_ep_drops(o["x"], o["router"], top_k=cfg.moe.top_k,
                                   num_experts=cfg.moe.num_experts,
                                   capacity_factor=cfg.moe.capacity_factor,
                                   ep=spec["shape"][1])
        if o["drops"] != want or want == 0 or not o["finite"]:
            fail(f"{tag} moe_mlp_ep at {EP_OVERFLOW_TOKENS} tokens: {o['drops']} "
                 f"drops on the card, {want} on the CPU, finite {o['finite']}")
        log(f"{tag} moe_mlp_ep at {EP_OVERFLOW_TOKENS} tokens: {o['drops']} "
            f"assignments dropped past capacity, the CPU's count from the "
            f"same inputs; output {o['shape']} finite")
    extra_s = ref_s + max(res["extra_s"] for res in ranks)
    if phase == "hybrid-sp":
        _hold_ticks("[hybrid-sp short]", [(res["rows"], res["short"])
                                          for res in ranks], short_ref,
                    spec["tol"])
        log(f"[hybrid-sp short] max_len {HYBRID_SHORT['n']} = dsa.min_n, "
            f"lengths {HYBRID_SHORT['lengths']}, {HYBRID_SHORT['ticks']} ticks: "
            f"the dense attention over the sequence shards; rank 0's "
            f"collectives (calls/bytes): {_bill_line(r0['short'][-1]['bill'])}"
            f"; host wall a tick {r0['short'][-1]['wall_ms']:.3f} ms")
    if phase in ("tp", "ep"):
        train_tag = "[train-mesh]" if phase == "tp" else "[ep-train]"
        _check_train(train_tag, TRAIN_MESH if phase == "tp" else EP_TRAIN,
                     train_ref, [res["train"] for res in ranks])
    if phase == "ep":
        from repro_torch.models import layers
        o = [res["train_overflow"] for res in ranks]
        want = layers.moe_ep_drops(o[0]["x"], o[0]["router"],
                                   top_k=cfg.moe.top_k,
                                   num_experts=cfg.moe.num_experts,
                                   capacity_factor=cfg.moe.capacity_factor,
                                   ep=spec["shape"][1])
        got = sum(x["drops"] for x in o)
        if got != want or not want or not all(x["finite"] for x in o):
            fail(f"[ep-train] moe_mlp_ep under autograd at "
                 f"{EP_OVERFLOW_TOKENS} tokens: the dispatch dropped {got}, "
                 f"moe_ep_drops on the CPU {want}; gradients finite "
                 f"{[x['finite'] for x in o]}")
        log(f"[ep-train] moe_mlp_ep under autograd at {EP_OVERFLOW_TOKENS} "
            f"tokens: the ranks' dispatch dropped {got} assignments (by "
            f"rank {[x['drops'] for x in o]}), the one-device "
            f"moe_ep_drops' count; the backward's gradients finite")
    family_counts = {}
    if phase == "tp":
        for key in FAMILY_MESH:
            fr = [res["family"][key] for res in ranks]
            ftag = f"[family-mesh] {key}"
            _hold_ticks(ftag, [(x["rows"], x["ticks"]) for x in fr],
                        family_ref[key], FAMILY_MESH_TOL)
            log(f"{ftag}: per rank {fr[0]['param_gib']:.3f} GiB of "
                f"parameters, peak {fr[0]['peak_gib']:.3f} GiB; rank 0's "
                f"last tick (calls/bytes): "
                f"{_bill_line(fr[0]['ticks'][-1]['bill'])}; host wall a "
                f"tick {np.median([t['wall_ms'] for t in fr[0]['ticks'][1:]]):.3f}"
                f" ms; launches per rank (B5 scoring, B1, B6) "
                + str([{k: x["counts"][k] for k in ("indexer_scores", "gvr_topk",
                                                     "sparse_decode_attn")}
                       for x in fr])
                + (f"; rank 0's first B5 / B1 / B6 inputs against the plain "
                   f"versions: {fr[0]['kernels']}" if "kernels" in fr[0] else ""))
            if key == "whisper":
                if any(min(x["counts"][k] for k in ("indexer_scores", "gvr_topk",
                                                    "sparse_decode_attn")) == 0
                       for x in fr) or "kernels" not in fr[0]:
                    fail(f"{ftag} a rank launched no B5, B1 or B6")
                family_counts = {k: sum(x["counts"][k] for x in fr)
                                 for k in fr[0]["counts"]}
                family_counts["kernels"] = fr[0]["kernels"]
    if phase in ("tp", "ep", "hybrid-sp"):
        log(f"[phase] {phase} new cells: {extra_s:.3f} s (the one-device "
            f"references {ref_s:.3f} s, the ranks' own at most "
            f"{max(res['extra_s'] for res in ranks):.3f} s)")
    return counts, checks, family_counts


def main() -> int:
    child = sys.argv[1:3] if sys.argv[1:2] == ["--family-engine"] else None
    sp_rank = sys.argv[2:] if sys.argv[1:2] == ["--sp-rank"] else None
    resume = sys.argv[2:] if sys.argv[1:2] == ["--train-resume"] else None
    mesh_rank = sys.argv[2:] if sys.argv[1:2] == ["--mesh-rank"] else None
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
    if child is not None:
        return family_engine_child(child[1])
    if sp_rank is not None:
        return sp_child(sp_rank)
    if resume is not None:
        return train_resume_child(resume)
    if mesh_rank is not None:
        return mesh_child(mesh_rank)
    t_start = time.perf_counter()
    log(f"[env] {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    from repro_torch.configs.registry import get_config
    from repro_torch.models.api import build_model
    phase_build()
    cfg = get_config("llama3.2-1b")
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    kres = phase_kernels(cfg, flush)
    mcfg = get_config("moonshot-v1-16b-a3b")
    kres_moe = phase_kernels_moe_width(mcfg, flush)
    kres_family = phase_kernels_family_widths(flush)
    dcfg = get_config("h2o-danube-3-4b")
    kres_window = phase_kernels_window(dcfg, flush)
    kres_family["whisper"] = phase_kernels_whisper_width(flush)
    b7_ab = phase_b7_ab(cfg, flush)

    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"[main] params {cfg.param_count() / 1e9:.3f} B (approx), bf16, "
        f"random init in {time.perf_counter() - t0:.3f} s")
    cpu_params = _to_cpu(params)
    rng = np.random.default_rng(0)
    specs = main_specs(rng, cfg.vocab)

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t:.3f} s")
        return out

    # h2o-danube-3-4b's [dense-family] engines start now, in two child
    # processes, and are joined after the llama phases
    family_dir = ROOT / "build" / "chip_smoke"
    fspecs = family_specs(np.random.default_rng(20), dcfg.vocab)
    children = start_family_children(family_dir)
    try:
        llama = run_llama_phases(model, params, cpu_params, rng, specs, timed)
        fam_paged, fam_dense = timed(
            "dense-family (join)", join_family_children, children,
            family_dir, fspecs,
            dataclasses.replace(dcfg, n_layers=FAMILY_CHILD_DEPTH))
    finally:
        stop_family_children(children)
    # llama's profiled steps, with the card to this process alone
    timed("step", phase_step, model, params, cpu_params, rng, flush)
    timed("verify-step", phase_verify_step, model, params, rng)
    # the sequence-sharded path: two gloo ranks on the card beside the
    # single-device references in this process
    sp_model = build_model(dataclasses.replace(cfg, n_layers=SP_DEPTH))
    sp_counts, sp_kernels = timed("sp", phase_sp, sp_model,
                                  sp_model.init_params(seed=0))
    del sp_model
    (main_counts, dl_counts, gather_counts, page_counts, spec_counts,
     dense_counts) = llama

    # the MoE family at full width and MOE_DEPTH layers: llama's model and
    # its CPU copy go first, and no CPU copy of this one is made
    del model, params, cpu_params
    gc.collect()
    torch.cuda.empty_cache()
    # the ("data", "model") mesh: 4 gloo ranks on the card, each phase after
    # its single-device step has run here and been freed
    mesh_counts = {phase: timed(phase, phase_mesh, phase)
                   for phase in ("tp", "ep", "hybrid-sp")}
    mmodel = build_model(dataclasses.replace(mcfg, n_layers=MOE_DEPTH))
    t0 = time.perf_counter()
    mparams = mmodel.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"[moe] {mcfg.name}: full width, depth cut to {MOE_DEPTH} of "
        f"{mcfg.n_layers} layers (the script's time limit); params "
        f"{mmodel.cfg.param_count() / 1e9:.3f} B (approx; {mcfg.param_count() / 1e9:.3f} B "
        f"at full depth), {mmodel.cfg.active_param_count() / 1e9:.3f} B active "
        f"per token, bf16, {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
        f"on the card, random init in {time.perf_counter() - t0:.3f} s")
    moe_paged, moe_dense = timed(
        "moe", phase_two_layouts, mmodel, mparams,
        moe_specs(np.random.default_rng(19), mcfg.vocab), "[moe]")
    timed("moe-step", phase_moe_step, mmodel, mparams, rng, flush)
    del mmodel, mparams
    gc.collect()
    torch.cuda.empty_cache()

    # the rest of the dense family: h2o-danube-3-4b's step at full width
    # and depth (its engines ran above), then chatglm3-6b, qwen2-vl-7b and
    # granite-34b at full width and a cut depth, one model at a time
    dmodel = build_model(dcfg)
    t0 = time.perf_counter()
    dparams = dmodel.init_params(seed=0)
    torch.cuda.synchronize()
    log(f"[dense-family] {dcfg.name}: params {dcfg.param_count() / 1e9:.3f} B "
        f"(approx), bf16, {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB on "
        f"the card, random init in {time.perf_counter() - t0:.3f} s; window "
        f"{dcfg.swa_window}, H/KVH {dcfg.n_heads}/{dcfg.n_kv_heads}, hd "
        f"{dcfg.hd}, depth not cut")
    timed("dense-family-step", phase_family_step, dmodel, dparams, rng, flush,
          "[dense-family-step]")
    del dmodel, dparams
    gc.collect()
    torch.cuda.empty_cache()
    for arch in ("chatglm3-6b", "qwen2-vl-7b", "granite-34b"):
        timed(f"dense-family {arch}", phase_family_cut, arch, FAMILY_CUT_DEPTH,
              rng, flush)
    # the enc-dec and ssm families at full width and depth, step by step
    audio_counts = timed("audio", phase_audio, flush)
    timed("ssm", phase_ssm, flush)
    # the hybrid family at full width, one superblock, step by step; then
    # B1 on the paper's RoPE rows
    hybrid_counts = timed("hybrid", phase_hybrid, flush)
    timed("temporal", phase_temporal, flush)
    # training: llama3.2-1b at full width and depth with the card to this
    # process alone, then the 2-layer cuts against the CPU while the
    # deterministic resume check runs in a child process; the dry-run
    # sweep (CPU work, kept off the card) runs from here to [dryrun],
    # beside the device-bound [train]
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_dir = ROOT / "build" / "chip_smoke" / "dryrun"
    dryrun_child = start_dryrun_sweep(dryrun_dir)
    timed("train", phase_train)
    gc.collect()
    torch.cuda.empty_cache()
    resume_dir = ROOT / "build" / "chip_smoke" / "train"
    resume_child = start_train_resume_child(resume_dir)
    try:
        timed("train-cut", phase_train_cut)
        timed("train-resume (join)", join_train_resume_child, resume_child,
              resume_dir)
    finally:
        stop_family_children({"train-resume": resume_child})
    # the port's four examples in child processes, while this process
    # reads the sweep's cells and runs two production cells' rank 0
    examples_dir = ROOT / "build" / "chip_smoke" / "examples"
    examples = start_examples(examples_dir)
    try:
        timed("dryrun", phase_dryrun, dryrun_child, dryrun_dir)
        timed("examples (join)", join_examples, examples, examples_dir)
    finally:
        stop_examples(examples)

    rows = [("B1 gvr_topk", "gvr_topk.cu", "src/repro/kernels/gvr_topk.py:334",
             main_counts["gvr_topk"]),
            ("B2 paged_indexer_topk", "indexer_scores.cu",
             "src/repro/kernels/indexer_topk.py:246",
             main_counts["paged_indexer_scores"]),
            ("B3 paged_sparse_decode_attn", "decode_attn.cu",
             "src/repro/kernels/sparse_attn.py:272",
             main_counts["paged_sparse_decode_attn"]),
            ("B4 paged_dense_decode_attn", "decode_attn.cu",
             "src/repro/kernels/sparse_attn.py:634",
             dense_counts["paged_dense_decode_attn"]),
            ("B5 indexer_topk", "indexer_scores.cu",
             "src/repro/kernels/indexer_topk.py:111",
             dl_counts["indexer_scores"]),
            ("B6 sparse_decode_attn", "decode_attn.cu",
             "src/repro/kernels/sparse_attn.py:159",
             dl_counts["sparse_decode_attn"]),
            ("B7 paged_gather", "paged_gather.cu",
             "src/repro/kernels/paged_gather.py:68",
             gather_counts["paged_gather"]),
            ("B8 paged_sparse_decode_attn_mq", "decode_attn.cu",
             "src/repro/kernels/sparse_attn.py:386",
             spec_counts["paged_sparse_decode_attn_mq"]),
            ("B9 paged_indexer_topk_mq", "indexer_scores.cu + gvr_topk.cu",
             "src/repro/kernels/indexer_topk.py:373",
             spec_counts["paged_indexer_scores_mq"]),
            ("B10 paged_sparse_decode_attn_pg", "decode_attn.cu",
             "src/repro/kernels/sparse_attn.py:522",
             page_counts["paged_sparse_decode_attn_pg"])]
    kernels = []
    for name, src_file, replaces, launches in rows:
        r = kres[name.split()[0]]
        kernels.append({
            "name": name, "route": "cuda",
            "source": " + ".join(f"src/repro_torch/kernels/csrc/{f}"
                                 for f in src_file.split(" + ")),
            "replaces": replaces, "launches": int(launches),
            "max_abs_err": r["err"], "ms": r["ms"], "wall_ms": r["wall_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": r["library_ms"]})
        if "half" in r:
            kernels[-1].update(scoring_ms=r["half"][0],
                               scoring_bound_ms=r["half"][1][0])
    # launches on the [moe] paths (B1, B2, B3 paged; B5, B6 dense layout),
    # and B3, B4 and B6 also at moonshot-v1-16b-a3b's widths
    for r, counts, key in ((kernels[0], moe_paged, "gvr_topk"),
                           (kernels[1], moe_paged, "paged_indexer_scores"),
                           (kernels[2], moe_paged, "paged_sparse_decode_attn"),
                           (kernels[4], moe_dense, "indexer_scores"),
                           (kernels[5], moe_dense, "sparse_decode_attn")):
        r["moe_launches"] = int(counts[key])
    for r in kernels:
        m = kres_moe.get(r["name"].split()[0])
        if m is not None:
            r.update(moe_width_ms=m["ms"], moe_width_wall_ms=m["wall_ms"],
                     moe_width_bound_ms=m["bound"][0],
                     moe_width_plain_ms=m["plain_ms"],
                     moe_width_max_abs_err=m["err"])
    # launches on the [dense-family] paths of h2o-danube-3-4b (B1, B2, B3
    # paged; B5, B6 dense layout); B3/B4/B6/B8/B10 at the rest of the
    # family's widths; B1, B2 and B5 scoring under the window
    for r, counts, key in ((kernels[0], fam_paged, "gvr_topk"),
                           (kernels[1], fam_paged, "paged_indexer_scores"),
                           (kernels[2], fam_paged, "paged_sparse_decode_attn"),
                           (kernels[4], fam_dense, "indexer_scores"),
                           (kernels[5], fam_dense, "sparse_decode_attn")):
        r["dense_family_launches"] = int(counts[key])
    for r in kernels:
        short = r["name"].split()[0]
        for label, res in kres_family.items():
            m = res.get(short)
            if m is not None:
                r.update({f"{label}_width_ms": m["ms"],
                          f"{label}_width_wall_ms": m["wall_ms"],
                          f"{label}_width_bound_ms": m["bound"][0],
                          f"{label}_width_plain_ms": m["plain_ms"],
                          f"{label}_width_max_abs_err": m["err"]})
        m = kres_window.get(short)
        if m is not None and short == "B1":
            r.update(window_ms=m["ms"], window_plain_ms=m["plain_ms"],
                     window_bound_ms=m["bound"][0])
        elif m is not None:
            r.update(window_scoring_ms=m["ms"],
                     window_scoring_free_ms=m["free_ms"],
                     window_scoring_plain_ms=m["plain_ms"],
                     window_scoring_bound_ms=m["bound"][0])
    # launches on the [audio] and [hybrid] loops (whisper-medium,
    # jamba-1.5-large-398b: B5, B1, B6); B7
    # against index_select in turns (median, least, most)
    for r, key in ((kernels[0], "gvr_topk"), (kernels[4], "indexer_scores"),
                   (kernels[5], "sparse_decode_attn")):
        r["audio_launches"] = int(audio_counts[key])
        r["hybrid_launches"] = int(hybrid_counts[key])
    # launches on the sequence-sharded paths ([sp] and [sp-engine], both
    # ranks): B2's scoring half over each rank's pool, B6 over the
    # assembled rows; and each against its plain version at those shapes
    for r, key, short in ((kernels[1], "paged_indexer_scores", "B2 scoring"),
                          (kernels[5], "sparse_decode_attn", "B6")):
        r["sp_launches"] = int(sp_counts[key])
        r["sp_max_abs_err"] = sp_kernels[short]["err"]
    # launches on the mesh paths ([tp], [ep]: every rank, B5 -> B1 -> B6 in
    # the dense ticks, the paged forms' B2/B3/B4/B7/B8/B9/B10 at its rows and
    # heads), and each against its plain version there
    mesh_keys = dict(PAGED_MESH_KERNELS, B1="gvr_topk", B5="indexer_scores",
                     B6="sparse_decode_attn")
    for r in kernels:
        short = r["name"].split()[0]
        for phase in ("tp", "ep"):
            counts, checks, _ = mesh_counts[phase]
            r[f"{phase}_launches"] = int(counts[mesh_keys[short]])
            chk = checks.get(short, checks.get(short + " scoring"))
            if chk is not None:
                r[f"{phase}_max_abs_err"] = chk["err"]
    # [family-mesh]: whisper's step on (2, 2), every rank
    for r, key, short in ((kernels[0], "gvr_topk", "B1"),
                          (kernels[4], "indexer_scores", "B5 scoring"),
                          (kernels[5], "sparse_decode_attn", "B6")):
        fam = mesh_counts["tp"][2]
        r["family_mesh_launches"] = int(fam[key])
        r["family_mesh_max_abs_err"] = fam["kernels"][short]["err"]
    (a, a_lo, a_hi), (c, c_lo, c_hi) = b7_ab["B7"], b7_ab["index_select"]
    kernels[6].update(ab_ms=a, ab_lo_ms=a_lo, ab_hi_ms=a_hi, ab_library_ms=c,
                      ab_library_lo_ms=c_lo, ab_library_hi_ms=c_hi)
    # B10 also on rows of 131,072 positions (B = 4, K = 2048)
    long10 = kres["B10 N=131072"]
    next(r for r in kernels if r["name"].startswith("B10 ")).update(long_row_ms=long10["ms"], long_row_plain_ms=long10["plain_ms"],
                       long_row_bound_ms=long10["bound"][0],
                       long_row_max_abs_err=long10["err"])
    # the redesign order: device time lost against the bound over each
    # kernel's path in this run, at llama's full depth: every launch was
    # counted in the engine phases, which ran MAIN_DEPTH layers ([main],
    # [dense-layout]: B1/B2/B3/B5/B6) or ENGINE_DEPTH (B4, B7, B8, B9,
    # B10), so they count n_layers / depth times; B2, B5 and B9 by their
    # scoring launch alone, so that B1 (their second launch) is counted once
    engine_rows = ("B4", "B7", "B8", "B9", "B10")

    def at_depth(k):
        ran = ENGINE_DEPTH if k["name"].split()[0] in engine_rows else MAIN_DEPTH
        return k["launches"] * cfg.n_layers / ran

    lost = sorted(((at_depth(k) * (k.get("scoring_ms", k["ms"])
                                   - k.get("scoring_bound_ms", k["bound_ms"])) / 1e3,
                    k["name"].split()[0] + (" scoring" if "scoring_ms" in k else ""))
                   for k in kernels), reverse=True)
    log(f"[summary] launches at {cfg.n_layers} layers x (ms - bound_ms): "
        + ", ".join(f"{name} {sec:.4f} s" for sec, name in lost))
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
