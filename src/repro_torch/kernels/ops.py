"""Wrappers of the port's kernels: dispatch by device, validate, count.

Every wrapper takes the plain version in `ref.py` for tensors that lie on
the CPU, and only then. For CUDA tensors it launches the hand-written
Hopper kernel (built from `csrc/` on first use, see `build.py`) on
PyTorch's current stream, raises if the launch is refused, and adds one to
its launch count; there is no fallback. Outputs and scratch are allocated
here, never in a kernel.

| kernel | wrapper                    | replaces (src/repro/kernels/)              |
|--------|----------------------------|--------------------------------------------|
| B1     | `gvr_topk`                 | gvr_topk.py:gvr_topk_pallas                |
| B2     | `paged_indexer_scores` (+ B1 = `paged_indexer_topk`) | indexer_topk.py:paged_indexer_topk_pallas |
| B3     | `paged_sparse_decode_attn` | sparse_attn.py:paged_sparse_decode_attn_pallas |
| B4     | `paged_dense_decode_attn`  | sparse_attn.py:paged_dense_decode_attn_pallas  |
| B5     | `indexer_scores` (+ B1 = `indexer_topk`) | indexer_topk.py:indexer_topk_pallas |
| B6     | `sparse_decode_attn`       | sparse_attn.py:sparse_decode_attn_pallas   |
| B7     | `paged_gather`             | paged_gather.py:paged_gather_pallas        |
| B8     | `paged_sparse_decode_attn_mq` | sparse_attn.py:paged_sparse_decode_attn_mq_pallas |
| B9     | `paged_indexer_scores_mq` (+ `gvr_topk_chain` = `paged_indexer_topk_mq`) | indexer_topk.py:paged_indexer_topk_mq_pallas |
| B10    | `paged_sparse_decode_attn_pg` | sparse_attn.py:paged_sparse_decode_attn_pg_pallas |

Each wrapper's `launches` attribute is a plain integer; `launch_counts()`
reads them all and `reset_launch_counts()` zeroes them.

The dry run (`launch.dryrun`) runs a step on the meta device. When every
input of `gvr_topk`, `indexer_scores` (and so `indexer_topk`) or
`sparse_decode_attn` lies on meta, the wrapper checks the shapes and
returns empty outputs of the kernel's shapes and dtypes, as a
`pallas_call`'s `out_shape` gives them: nothing is launched or counted.
Inputs on meta and on another device raise, as any mix does.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from . import ref
from .build import LIBRARIES

# dynamic shared memory a CTA may use on Hopper, less room for the static part
_SMEM_BUDGET = 200 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError("kernel inputs lie on different CUDA devices")
        return False
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(devs)}")


def _on_meta(*tensors: torch.Tensor) -> bool:
    """Every input on the meta device: the shapes-only result."""
    return all(t.device.type == "meta" for t in tensors)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _contig(t: torch.Tensor, dtype, name: str) -> torch.Tensor:
    _check(t.dtype == dtype, f"{name}: expected {dtype}, got {t.dtype}")
    _check(t.is_contiguous(), f"{name}: must be contiguous")
    return t


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------- B1 ------

class GvrSchedule(NamedTuple):
    """How B1 and B9's chain lay one score row on a thread-block cluster:
    rank r of `ranks` CTAs owns positions [r * span, (r + 1) * span) in
    its own shared memory, each of its `threads` threads a contiguous run
    of ceil(span / threads); `smem` is the dynamic shared memory per CTA
    in bytes (the rank's slice, the radix histograms the ranks send it,
    and the chain's k-entry value buffers and index buffer)."""
    ranks: int
    threads: int
    span: int
    smem: int


GVR_RANKS = (1, 2, 4, 8, 16)      # cluster sizes the kernel takes (16 non-portable)
GVR_THREADS = (256, 512, 1024)    # threads per CTA the kernel is built for
_GVR_SPAN = 1024                  # positions per rank the schedule aims at
_GVR_WIDE = 8 * 8192              # rows longer than this take a cluster of 16
_GVR_RUN = 16                     # positions per thread it aims at


def gvr_layout(n: int, k: int, ranks: int, threads: int,
               chain: bool = False) -> GvrSchedule:
    """The schedule of a row of n positions on `ranks` CTAs of `threads`
    threads (shared memory for the chain's buffers too when `chain`)."""
    span = -(-n // ranks)
    per = -(-span // threads)
    # the slice, R received 256-bin histograms of two parities, and for the
    # chain the received and staged values (k rounded up to 4) and indices
    chain_bytes = 8 * (-(-k // 4) * 4) + 4 * k if chain else 0
    return GvrSchedule(ranks, threads, span,
                       4 * per * threads + 2048 * ranks + chain_bytes)


def gvr_schedule(n: int, k: int, chain: bool = False,
                 wide: bool = True) -> GvrSchedule:
    """B1's cluster schedule, by shape and by what the device hosts: R, the
    least cluster size that gives each rank at most 1024 positions, up to
    8 (the portable limit); 16 (non-portable) for rows of more than 65536
    positions or whose slice does not fit shared memory at 8, when `wide`
    says the device runs a cluster of 16 (`gvr_hosts_wide_cluster`), else
    8; then the fewest threads per CTA (256, 512 or 1024) that give each
    thread at most 16 positions. Rows of up to 1024 positions run on one
    CTA (R = 1), a choice of shape, not a fallback. On the H100 this
    schedule was the fastest or within 3% of it in every regime
    `tools/sweep_gvr_cluster.py` times (PERF.md). Raises when the row does
    not fit the shared memory of the largest cluster allowed (n beyond
    ~680K at 16, ~377K at 8). The candidate capacity C does not enter: the
    kernel keeps no candidate buffer (P4 and P5 filter the row in
    place)."""
    ranks = 1
    while ranks < 8 and -(-n // ranks) > _GVR_SPAN:
        ranks *= 2
    if wide and (n > _GVR_WIDE or gvr_layout(
            n, k, ranks, GVR_THREADS[-1], chain).smem > _SMEM_BUDGET):
        ranks = 16
    span = -(-n // ranks)
    threads = next((t for t in GVR_THREADS if -(-span // t) <= _GVR_RUN),
                   GVR_THREADS[-1])
    sch = gvr_layout(n, k, ranks, threads, chain)
    _check(sch.smem <= _SMEM_BUDGET,
           f"GVR Top-K: a row of n={n} needs {sch.smem} B of shared memory "
           f"per CTA on a {ranks}-CTA cluster, more than the kernel's "
           f"{_SMEM_BUDGET} B")
    return sch


_WIDE_CLUSTER: Dict[Tuple[int, bool], bool] = {}


def gvr_hosts_wide_cluster(device: torch.device, chain: bool = False) -> bool:
    """Whether `device` runs B1's (or, with `chain`, B9's chain's) cluster of
    16 CTAs at the largest launch the schedule gives one (1024 threads and
    the whole shared-memory budget per CTA, so every smaller one fits too):
    cudaOccupancyMaxActiveClusters, asked once per device and kernel. A
    card or partition whose GPCs cannot hold 16 such CTAs answers no, and
    `gvr_schedule` keeps its rows on clusters of 8."""
    key = (torch.device(device).index or 0, chain)
    if key not in _WIDE_CLUSTER:
        with torch.cuda.device(key[0]):
            got = LIBRARIES.get("gvr_topk").gvr_cluster_capacity(
                16, GVR_THREADS[-1], _SMEM_BUDGET, int(chain))
        _raise_on(-min(got, 0), "gvr_cluster_capacity")
        _WIDE_CLUSTER[key] = got >= 1
    return _WIDE_CLUSTER[key]


def _gvr_args(scores: torch.Tensor, prev_idx: torch.Tensor, k: int,
              max_candidates: Optional[int], name: str, chain: bool = False):
    """Validate a GVR launch over score rows (..., N) with predictions
    (B, M); returns (n, m, cmax, f_target, c_lo0, schedule)."""
    _contig(scores, torch.float32, f"{name} scores")
    _contig(prev_idx, torch.int32, f"{name} prev_idx")
    n = scores.shape[-1]
    m = prev_idx.shape[1]
    _check(prev_idx.shape[0] == scores.shape[0] and m >= 1,
           f"{name}: prev_idx (B, M>=1)")
    _check(1 <= k <= n, f"{name}: need 1 <= k={k} <= n={n}")
    _check(n < 2 ** 30, f"{name}: n={n} beyond the kernel's int32 indexing")
    _check(scores.shape[0] <= 65535, f"{name}: at most 65535 slots per launch")
    cmax = ref.resolve_cmax(k, n, max_candidates)
    return (n, m, cmax, float((k + cmax) // 2), _c_lo0(n, m, k),
            gvr_schedule(n, k, chain, gvr_hosts_wide_cluster(scores.device,
                                                             chain)))


def _c_lo0(n: int, m: int, k: int) -> float:
    """The secant bracket's initial count for M predictions."""
    return float(min(n, max(1.25 * m, k)))


def gvr_topk(scores: torch.Tensor, prev_idx: torch.Tensor, k: int, *,
             max_candidates: Optional[int] = None,
             max_secant_iters: int = 12):
    """B1 — exact Top-K of (B, N) f32 rows warm-started from (B, M) int32
    predictions. Returns (values (B,K) f32, indices (B,K) int32 in
    ascending order, stats (B,8) f32; see `ref.gvr_topk_ref`). On the card
    a row lies in one cluster's shared memory (`gvr_schedule`): up to
    ~680K positions where the device runs a cluster of 16, ~377K where it
    does not; a longer row raises ValueError."""
    if _on_meta(scores, prev_idx):
        _check(scores.dim() == 2 and prev_idx.dim() == 2
               and prev_idx.shape[0] == scores.shape[0]
               and 1 <= k <= scores.shape[1],
               f"gvr_topk: scores (B, N), prev_idx (B, M), 1 <= k <= N; got "
               f"{tuple(scores.shape)}, {tuple(prev_idx.shape)}, k={k}")
        b = scores.shape[0]
        return (scores.new_empty((b, k)), prev_idx.new_empty((b, k),
                                                             dtype=torch.int32),
                scores.new_empty((b, 8), dtype=torch.float32))
    if _on_cpu(scores, prev_idx):
        return ref.gvr_topk_ref(scores, prev_idx, k,
                                max_candidates=max_candidates,
                                max_secant_iters=max_secant_iters)
    _check(scores.dim() == 2 and prev_idx.dim() == 2, "gvr_topk: 2-D inputs")
    n, m, cmax, f_target, c_lo0, sch = _gvr_args(
        scores, prev_idx, k, max_candidates, "gvr_topk")
    b = scores.shape[0]
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    stats = torch.empty((b, 8), dtype=torch.float32, device=scores.device)
    rc = LIBRARIES.get("gvr_topk").gvr_topk_launch(
        scores.data_ptr(), prev_idx.data_ptr(), b, n, m, k, cmax,
        max_secant_iters, f_target, c_lo0, sch.ranks, sch.threads, sch.smem,
        vals.data_ptr(), idx.data_ptr(), stats.data_ptr(), _stream(scores))
    _raise_on(rc, "gvr_topk")
    gvr_topk.launches += 1
    return vals, idx, stats


def _check_chain_prev(prev_idx: torch.Tensor, k: int, name: str) -> None:
    _check(prev_idx.dim() == 2 and prev_idx.shape[1] == k,
           f"{name}: each row's K={k} outputs warm-start the next row, so "
           f"prev_idx must be (B, K) with exactly K entries, got "
           f"{tuple(prev_idx.shape)}")


def gvr_topk_chain(scores: torch.Tensor, prev_idx: torch.Tensor, k: int, *,
                   max_candidates: Optional[int] = None,
                   max_secant_iters: int = 12):
    """B9's selection — Q chained exact Top-Ks per slot: row 0 of scores
    (B, Q, N) f32 warm-starts from prev_idx (B, K) int32 (exactly K
    entries), row q > 0 from row q-1's Top-K, which stays on chip. Equals
    Q sequential `gvr_topk` calls bit for bit. Returns (values (B,Q,K),
    indices (B,Q,K) int32, stats (B,Q,8))."""
    _check(scores.dim() == 3, "gvr_topk_chain: scores (B, Q, N)")
    _check_chain_prev(prev_idx, k, "gvr_topk_chain")
    if _on_cpu(scores, prev_idx):
        return ref.gvr_topk_chain_ref(scores, prev_idx, k,
                                      max_candidates=max_candidates,
                                      max_secant_iters=max_secant_iters)
    n, m, cmax, f_target, c_lo0, sch = _gvr_args(
        scores, prev_idx, k, max_candidates, "gvr_topk_chain", chain=True)
    b, qn = scores.shape[:2]
    vals = torch.empty((b, qn, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, qn, k), dtype=torch.int32, device=scores.device)
    stats = torch.empty((b, qn, 8), dtype=torch.float32, device=scores.device)
    rc = LIBRARIES.get("gvr_topk").gvr_topk_chain_launch(
        scores.data_ptr(), prev_idx.data_ptr(), b, qn, n, m, k, cmax,
        max_secant_iters, f_target, c_lo0, _c_lo0(n, k, k), sch.ranks,
        sch.threads, sch.smem, vals.data_ptr(), idx.data_ptr(),
        stats.data_ptr(), _stream(scores))
    _raise_on(rc, "gvr_topk_chain")
    gvr_topk_chain.launches += 1
    return vals, idx, stats


# ----------------------------------------------------------- B2 / B5 ------

# the scoring body by cache dtype alone: bf16 runs on the tensor cores,
# float32 on the CUDA cores (TF32 would lose digits a float32 cache keeps);
# not a fallback: each dtype has one body, and a launch it refuses raises
_SCORE_ROUTE = {torch.bfloat16: "mma", torch.float32: "fma"}
SCORE_TILE = 64                # positions per tile of the bf16 body
_SMS = 132                     # streaming multiprocessors of an H100 SXM


def score_route(dtype: torch.dtype) -> str:
    """The scoring body a cache dtype runs: "mma" (bf16, tensor cores) or
    "fma" (float32, CUDA cores)."""
    route = _SCORE_ROUTE.get(dtype)
    _check(route is not None,
           f"indexer scoring: keys must be f32 or bf16, got {dtype}")
    return route


def padded_heads(h: int) -> int:
    """Heads of the bf16 body: H rounded up to a multiple of 16 (one warp's
    MMA rows), the extra heads with zero queries and zero weights."""
    return -(-h // 16) * 16


def score_ctas_per_row(rows: int, n: int):
    """(tiles per CTA, CTAs per row) of the bf16 body over `rows` score
    rows of `n` positions: two 64-position tiles per CTA, through a double
    buffer, where that still gives every SM a CTA, else one. CTA c of a
    row walks tiles c, c + ctas; the schedule never changes a score's
    sums. (More tiles per CTA were slower on the H100 at the kernel
    phase's shapes: `tools/sweep_score_tiles.py`.)"""
    tiles = -(-n // SCORE_TILE)
    per = 2 if tiles >= 2 and rows * -(-tiles // 2) >= _SMS else 1
    return per, -(-tiles // per)


def _heads_per_thread(h: int) -> int:
    """Heads one thread of the float32 body sums (HG). It fixes the order
    of every score's sum there, so it depends on H alone: B2 and B5 then
    score the same keys to the same bits whatever the page size or tile."""
    return next(hg for hg in (16, 8, 4, 2, 1) if h % hg == 0)


def score_schedule(dtype: torch.dtype, rows: int, n: int, h: int, d: int,
                   ps: int = 0) -> dict:
    """The scoring launch for q (rows, h, d) over rows of n positions,
    keys in pages of `ps` positions (0: a contiguous cache). "mma" (bf16):
    SCORE_TILE-position tiles, `heads` = padded_heads(h) (a warp per 16
    heads), `ctas_per_row` from `score_ctas_per_row` and `stages` tile
    buffers (all of a CTA's tiles in flight at once); d must be a
    multiple of 16 and at most 256, h at most 256. "fma" (float32): one
    CTA per `tile` positions (the page when paged), `heads_per_thread`.
    Raises ValueError, naming the shape, for one the body does not take."""
    route = score_route(dtype)
    if route == "mma":
        _check(d % 16 == 0 and 16 <= d <= 256 and 1 <= h <= 256,
               f"indexer scoring (bf16, tensor cores): needs d_i a multiple "
               f"of 16 in [16, 256] and 1 <= H_i <= 256, got q ({rows}, {h}, "
               f"{d})")
        per, ctas = score_ctas_per_row(rows, n)
        return dict(route=route, tile=SCORE_TILE, heads=padded_heads(h),
                    tiles_per_cta=per, ctas_per_row=ctas, stages=per)
    hg = _heads_per_thread(h)
    groups = h // hg
    tile = ps if ps else max(1, min(64, 1024 // groups))
    _check(tile * groups <= 1024,
           f"indexer scoring (f32): {tile} positions x {groups} head groups "
           f"exceed 1024 threads")
    smem = 4 * (h * d + d * tile + groups * tile)
    _check(smem <= _SMEM_BUDGET,
           f"indexer scoring (f32): {smem} B of shared memory per tile for "
           f"q ({rows}, {h}, {d}) and tile {tile}")
    return dict(route=route, tile=tile, heads=h, heads_per_thread=hg)


def _window(window: Optional[int], name: str) -> int:
    """A sliding window as the kernels take it: > 0, or 0 for none."""
    _check(window is None or window > 0, f"{name}: window must be > 0")
    return window or 0


def _scores(contig: bool, q, keys, w, table, lengths, ps: int, n: int,
            name: str, qrows: int = 1,
            window: Optional[int] = None) -> torch.Tensor:
    """Launch the scoring body of the keys' dtype over q (R, H, D) and
    lengths (R,): R = B slots, or (B9) R = B * qrows folded query rows
    over a (B, MP) table; ps the page size, 0 for a contiguous cache;
    `window` the sliding window (row r scores [length - window, length))."""
    _contig(q, keys.dtype, f"{name} q")
    _contig(keys, keys.dtype, f"{name} keys")
    _contig(w, torch.float32, f"{name} w")
    _contig(lengths, torch.int32, f"{name} lengths")
    b, h, d = q.shape
    _check(keys.shape[-1] == d and lengths.shape == (b,)
           and w.shape in ((h,), (b, h)), f"{name}: shape mismatch")
    mp = table.shape[1] if table is not None else 0
    _check(table is None or table.shape[0] * qrows == b,
           f"{name}: table rows x {qrows} query rows != {b} score rows")
    win = _window(window, name)
    sched = score_schedule(keys.dtype, b, n, h, d, ps)
    scores = torch.empty((b, n), dtype=torch.float32, device=q.device)
    lib = LIBRARIES.get("indexer_scores")
    args = (q.data_ptr(), keys.data_ptr(), w.data_ptr(),
            h if w.dim() == 2 else 0,
            table.data_ptr() if table is not None else None,
            lengths.data_ptr(), b, h, d)
    if sched["route"] == "mma":
        _check(q.data_ptr() % 16 == 0 and keys.data_ptr() % 16 == 0,
               f"{name}: q and keys must be 16-byte aligned (16-byte copies)")
        rc = lib.indexer_scores_mma_launch(
            int(contig), *args, ps, mp, keys.shape[0], n, qrows, win,
            sched["ctas_per_row"], sched["stages"], scores.data_ptr(),
            _stream(q))
    else:
        rc = lib.indexer_scores_fma_launch(
            int(contig), sched["heads_per_thread"], *args, sched["tile"], mp,
            keys.shape[0], n, qrows, win, scores.data_ptr(), _stream(q))
    _raise_on(rc, name)
    return scores


def paged_indexer_scores(q: torch.Tensor, k_pages: torch.Tensor,
                         w: torch.Tensor, table: torch.Tensor,
                         lengths: torch.Tensor,
                         window: Optional[int] = None) -> torch.Tensor:
    """B2 scoring — Eq. 1 over page-addressed indexer keys. q (B, H, D) in
    the cache dtype; k_pages (P, ps, D); w (H,) or (B, H) f32; table
    (B, MP) int32; lengths (B,) int32; `window` an optional sliding window.
    Returns the (B, MP*ps) f32 score row, NEG at or beyond length, below
    length - window and on unmapped pages (the kernel reads no key of a
    64-position tile wholly outside [length - window, length))."""
    if _on_cpu(q, k_pages, w, table, lengths):
        return ref.paged_indexer_scores_ref(q, k_pages, w, table, lengths,
                                            window)
    _contig(table, torch.int32, "paged_indexer_scores table")
    _check(table.dim() == 2, "paged_indexer_scores: table (B, MP)")
    ps = k_pages.shape[1]
    scores = _scores(False, q, k_pages, w, table, lengths, ps,
                     table.shape[1] * ps, "paged_indexer_scores",
                     window=window)
    paged_indexer_scores.launches += 1
    return scores


def paged_indexer_topk(q: torch.Tensor, k_pages: torch.Tensor,
                       w: torch.Tensor, table: torch.Tensor,
                       prev_idx: torch.Tensor, k: int, *,
                       lengths: torch.Tensor,
                       max_candidates: Optional[int] = None,
                       window: Optional[int] = None):
    """B2 — paged indexer scoring (inside the optional sliding window),
    then the GVR Top-K (B1) on the score row (two launches on the card).
    Returns (values, indices, stats) as `gvr_topk`, indices logical."""
    scores = paged_indexer_scores(q, k_pages, w, table, lengths, window)
    return gvr_topk(scores, prev_idx, k, max_candidates=max_candidates)


def paged_indexer_scores_mq(q: torch.Tensor, k_pages: torch.Tensor,
                            w: torch.Tensor, table: torch.Tensor,
                            lengths: torch.Tensor,
                            window: Optional[int] = None) -> torch.Tensor:
    """B9 scoring — B2 over the Q query rows of each slot: q (B, Q, H, D)
    in the cache dtype, table (B, MP) shared by a slot's rows, lengths
    (B, Q) each row's causal extent (and its window's end). Returns
    (B, Q, MP*ps) f32; each row equals B2's for the same slot, length and
    window bit for bit."""
    if _on_cpu(q, k_pages, w, table, lengths):
        return ref.paged_indexer_scores_mq_ref(q, k_pages, w, table, lengths,
                                               window)
    _contig(table, torch.int32, "paged_indexer_scores_mq table")
    _check(q.dim() == 4 and w.dim() == 1 and lengths.shape == q.shape[:2]
           and table.shape[0] == q.shape[0],
           "paged_indexer_scores_mq: q (B, Q, H, D), w (H,), table (B, MP), "
           "lengths (B, Q)")
    b, qn = q.shape[:2]
    ps = k_pages.shape[1]
    scores = _scores(False, q.reshape((b * qn,) + q.shape[2:]), k_pages, w,
                     table, lengths.reshape(b * qn), ps, table.shape[1] * ps,
                     "paged_indexer_scores_mq", qrows=qn, window=window)
    paged_indexer_scores_mq.launches += 1
    return scores.reshape(b, qn, -1)


def paged_indexer_topk_mq(q: torch.Tensor, k_pages: torch.Tensor,
                          w: torch.Tensor, table: torch.Tensor,
                          prev_idx: torch.Tensor, k: int, *,
                          lengths: torch.Tensor,
                          max_candidates: Optional[int] = None,
                          window: Optional[int] = None):
    """B9 — the verify tick's selection: score the Q rows of each slot
    (`paged_indexer_scores_mq`), then the chained GVR (`gvr_topk_chain`):
    row 0 warm from prev_idx (B, K), row q from row q-1 (two launches on
    the card); `window` masks each row at its own length. Returns (values
    (B,Q,K), indices (B,Q,K) logical, stats (B,Q,8))."""
    _check_chain_prev(prev_idx, k, "paged_indexer_topk_mq")
    scores = paged_indexer_scores_mq(q, k_pages, w, table, lengths, window)
    return gvr_topk_chain(scores, prev_idx, k, max_candidates=max_candidates)


def indexer_scores(q: torch.Tensor, kcache: torch.Tensor, w: torch.Tensor,
                   lengths: torch.Tensor,
                   window: Optional[int] = None) -> torch.Tensor:
    """B5 scoring — Eq. 1 over a contiguous indexer cache. q (B, H, D) in
    the cache dtype; kcache (B, N, D); w (H,) or (B, H) f32; lengths (B,)
    int32; `window` an optional sliding window. Returns the (B, N) f32
    score row, NEG at or beyond length and below length - window; bit-equal
    on the card to `paged_indexer_scores` over pages holding the same
    keys."""
    if _on_meta(q, kcache, w, lengths):
        b, h, d = q.shape
        _check(kcache.dim() == 3 and kcache.shape[0] == b
               and kcache.shape[2] == d and lengths.shape == (b,)
               and w.shape in ((h,), (b, h)),
               f"indexer_scores: q (B, H, D), kcache (B, N, D), w (H,) or "
               f"(B, H), lengths (B,); got {tuple(q.shape)}, "
               f"{tuple(kcache.shape)}, {tuple(w.shape)}, "
               f"{tuple(lengths.shape)}")
        return q.new_empty((b, kcache.shape[1]), dtype=torch.float32)
    if _on_cpu(q, kcache, w, lengths):
        return ref.indexer_scores_ref(q, kcache, w, lengths, window)
    _check(kcache.dim() == 3 and kcache.shape[0] == q.shape[0],
           "indexer_scores: kcache (B, N, D)")
    n = kcache.shape[1]
    _check(0 < n and q.shape[0] * n < 2 ** 31,
           "indexer_scores: B*N beyond int32 indexing")
    scores = _scores(True, q, kcache, w, None, lengths, 0, n,
                     "indexer_scores", window=window)
    indexer_scores.launches += 1
    return scores


def indexer_topk(q: torch.Tensor, kcache: torch.Tensor, w: torch.Tensor,
                 prev_idx: torch.Tensor, k: int, *, lengths: torch.Tensor,
                 max_candidates: Optional[int] = None,
                 window: Optional[int] = None):
    """B5 — contiguous indexer scoring (inside the optional sliding
    window), then the GVR Top-K (B1) on the score row (two launches on the
    card). Returns (values, indices, stats) as `gvr_topk`."""
    scores = indexer_scores(q, kcache, w, lengths, window)
    return gvr_topk(scores, prev_idx, k, max_candidates=max_candidates)


# ----------------------------------------------------------------- B7 ------

def paged_gather(pages: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """B7 — the contiguous logical view of a page pool: pages (P, ps, ...)
    with any trailing feature dims, table (B, MP) int32. Returns
    (B, MP*ps, ...) in the pool dtype, zero rows on unmapped pages."""
    if _on_cpu(pages, table):
        return ref.paged_gather_ref(pages, table)
    _check(pages.dim() >= 2 and pages.is_contiguous(),
           "paged_gather: pages (P, ps, ...) contiguous")
    _contig(table, torch.int32, "paged_gather table")
    _check(table.dim() == 2, "paged_gather: table (B, MP)")
    p, ps = pages.shape[:2]
    b, mp = table.shape
    feat = tuple(pages.shape[2:])
    out = torch.empty((b, mp, ps) + feat, dtype=pages.dtype,
                      device=pages.device)
    page_bytes = pages[0].numel() * pages.element_size()
    vec = int(page_bytes % 16 == 0 and pages.data_ptr() % 16 == 0
              and out.data_ptr() % 16 == 0)
    if out.numel():
        rc = LIBRARIES.get("paged_gather").paged_gather_launch(
            pages.data_ptr(), table.data_ptr(), b, mp, p, page_bytes, vec,
            out.data_ptr(), _stream(pages))
        _raise_on(rc, "paged_gather")
        paged_gather.launches += 1
    return out.reshape((b, mp * ps) + feat)


# ------------------------------------------------------------ B3 / B4 -----

_MODE = {"paged_sparse": 0, "paged_dense": 1, "contig_sparse": 2,
         "paged_pages": 3, "paged_sparse_mq": 4}
# entries per split of B3/B6/B8 (B4: positions, `dense_rows_per_split`):
# the kernel cuts each row's entries into runs of this length and merges
# the partials; `ref.py`'s split form takes the same R
ROWS_PER_SPLIT = 128
# B10's split (`pg_rows_per_split`): at least PG_MIN_ROWS positions, at most
# PG_MAX_SPLITS splits per (row, KV head); on the H100 the fastest at N =
# 8192 and within 3.4% of the fastest at N = 131072 and on short rows
# (`tools/sweep_pg_split.py`, PERF.md)
PG_MIN_ROWS = 256
PG_MAX_SPLITS = 64
# combine tickets per (device, stream): int32 counters, one per (query row,
# KV head, head chunk), zero when created and left zero by every launch;
# launches on two streams may overlap in time, so they never share an array
_TICKETS: Dict[tuple, torch.Tensor] = {}


def dense_rows_per_split(page_size: int) -> int:
    """B4's split: whole pages, at least ROWS_PER_SPLIT positions."""
    return -(-ROWS_PER_SPLIT // page_size) * page_size


def pg_rows_per_split(n: int, page_size: int) -> int:
    """B10's split: the least multiple of the page size that is at least
    PG_MIN_ROWS positions and at least n / PG_MAX_SPLITS, so a row of n
    positions has at most PG_MAX_SPLITS splits and each CTA's scan of the
    row's K entries does not grow in number with n."""
    r = max(PG_MIN_ROWS, -(-n // PG_MAX_SPLITS))
    return -(-r // page_size) * page_size


def decode_attn_splits(mode: str, kcols: int, n: int, ps: int):
    """(entries per split R, splits) of the shared decode-attention body
    for a row of `kcols` Top-K entries (B4 and B10: R positions, whole
    pages, of the `n` = MP*ps of the table). The split count is a function
    of the row's entry count alone (B4 and B10: of n and ps alone), never
    of B, the lengths or the entries."""
    if mode in ("paged_dense", "paged_pages"):
        rps = (pg_rows_per_split(n, ps) if mode == "paged_pages"
               else dense_rows_per_split(ps))
        return rps, max(1, -(-n // rps))
    return ROWS_PER_SPLIT, max(1, -(-kcols // ROWS_PER_SPLIT))


ATTN_HEAD_DIMS = (32, 64, 120, 128)   # 120 runs on the 128-lane instance
_ATTN_MAX_CHUNK = 8


def attn_head_chunk(grp: int) -> Tuple[int, int]:
    """(heads per CTA G, chunks) of the decode-attention body for grp query
    heads per KV head: G is the least power of two >= grp, capped at 8 (the
    body keeps q, scores and PV sums of its G heads in registers), and the
    grp heads are laid over ceil(grp / G) chunks on the grid's y axis, the
    last chunk's heads past grp masked (grp 7: one chunk of 8; 16: two; 48:
    six)."""
    gc = 1
    while gc < min(grp, _ATTN_MAX_CHUNK):
        gc *= 2
    return gc, -(-grp // gc)


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed combine tickets owned by (device, stream)."""
    t = _TICKETS.get((device, stream))
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[(device, stream)] = t
    return t


def _attn(mode: str, q, kc, vc, table, idx, lengths, scale, window,
          name: str, qrows: int = 1) -> torch.Tensor:
    """Launch the shared decode-attention body. Paged modes take pools
    (P, ps, KVH, hd) and a table; "contig_sparse" takes caches
    (B, N, KVH, hd), read as B pages of N rows with no table;
    "paged_sparse_mq" (B8) takes B * qrows folded query rows — q, idx and
    lengths with B * qrows rows — over a (B, MP) table. The grid is
    (splits, KVH, rows); a multi-split launch merges its partials in the
    same launch, through a workspace allocated here and the tickets of the
    current stream. The grid is (splits, KVH x head chunks, rows): any
    H/KVH (`attn_head_chunk`), head dims ATTN_HEAD_DIMS. The tensors'
    shapes are checked here; the limits of the kernel's schedule (grid,
    shared memory, int32 and 16-bit indexing) only by
    `decode_attn_launch`, which refuses a launch beyond them."""
    _check(kc.dtype in _DTYPE_CODE,
           f"{name}: caches must be f32 or bf16, got {kc.dtype}")
    dt = kc.dtype
    for t, nm in ((q, "q"), (kc, "k cache"), (vc, "v cache")):
        _contig(t, dt, f"{name} {nm}")
    _check(kc.data_ptr() % 16 == 0 and vc.data_ptr() % 16 == 0,
           f"{name}: caches must be 16-byte aligned (16-byte row gathers)")
    _contig(lengths, torch.int32, f"{name} lengths")
    b, h, hd = q.shape
    p, ps, kvh, hd2 = kc.shape
    _check(vc.shape == kc.shape and hd2 == hd,
           f"{name}: caches (.., .., KVH, hd) matching q")
    _check(h % kvh == 0, f"{name}: H={h} is no multiple of KVH={kvh}")
    _check(hd in ATTN_HEAD_DIMS,
           f"{name}: head_dim must be one of {ATTN_HEAD_DIMS}, got {hd}")
    _check(lengths.shape == (b,), f"{name}: lengths (B,)")
    if mode == "contig_sparse":
        _check(p == b, f"{name}: caches (B, N, KVH, hd)")
        ps, mp = 1, kc.shape[1]
    else:
        _contig(table, torch.int32, f"{name} table")
        _check(table.dim() == 2 and table.shape[0] * qrows == b,
               f"{name}: table (B, MP) for {b} query rows")
        mp = table.shape[1]
    kcols = 0
    if idx is not None:
        _contig(idx, torch.int32, f"{name} idx")
        _check(idx.dim() == 2 and idx.shape[0] == b, f"{name}: idx (B, K)")
        kcols = idx.shape[1]
    grp = h // kvh
    gc, chunks = attn_head_chunk(grp)
    rps, splits = decode_attn_splits(mode, kcols, mp * ps, ps)
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    stream = _stream(q)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(b * kvh * chunks * splits * gc * (hd + 2),
                         dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, b * kvh * chunks)
    rc = LIBRARIES.get("decode_attn").decode_attn_launch(
        _DTYPE_CODE[dt], _MODE[mode], grp, gc, hd, q.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), table.data_ptr() if table is not None else None,
        idx.data_ptr() if idx is not None else None, lengths.data_ptr(), b,
        qrows, kvh, ps, mp, p, kcols, window, rps, splits, float(scale),
        ws.data_ptr() if ws is not None else None,
        tickets.data_ptr() if tickets is not None else None, out.data_ptr(),
        stream)
    _raise_on(rc, name)
    return out


def paged_sparse_decode_attn(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, table: torch.Tensor,
                             idx: torch.Tensor, lengths: torch.Tensor, *,
                             scale: Optional[float] = None) -> torch.Tensor:
    """B3 — one query token per slot over exactly the K selected logical
    rows, addressed through the block table. q (B, H, hd) in the pool
    dtype; pools (P, ps, KVH, hd); table (B, MP); idx (B, K); lengths (B,).
    Entries outside [0, length) or on unmapped pages are masked. Returns
    (B, H, hd) f32 (0 for a slot with no valid entry)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _on_cpu(q, k_pages, v_pages, table, idx, lengths):
        return ref.paged_sparse_attn_ref(q, k_pages, v_pages, table, idx,
                                         lengths, scale=scale)
    out = _attn("paged_sparse", q, k_pages, v_pages, table, idx, lengths,
                scale, 0, "paged_sparse_decode_attn")
    paged_sparse_decode_attn.launches += 1
    return out


def paged_sparse_decode_attn_mq(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                idx: torch.Tensor, lengths: torch.Tensor, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """B8 — B3 over the Q query rows of each slot (the verify tick's d+1
    positions): q (B, Q, H, hd) in the pool dtype; table (B, MP) shared by
    a slot's rows; idx (B, Q, K); lengths (B, Q), each row's causal extent.
    Row (b, q) masks entries outside [0, lengths[b, q]) or on unmapped
    pages. Returns (B, Q, H, hd) f32; bit-equal on the card to B3 over the
    folded rows with the table repeated."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _check(q.dim() == 4 and idx.dim() == 3 and lengths.dim() == 2
           and q.shape[:2] == idx.shape[:2] == lengths.shape,
           "paged_sparse_decode_attn_mq: q (B, Q, H, hd), idx (B, Q, K), "
           "lengths (B, Q)")
    if _on_cpu(q, k_pages, v_pages, table, idx, lengths):
        return ref.paged_sparse_attn_mq_ref(q, k_pages, v_pages, table, idx,
                                            lengths, scale=scale)
    b, qn = q.shape[:2]
    out = _attn("paged_sparse_mq", q.reshape((b * qn,) + q.shape[2:]),
                k_pages, v_pages, table, idx.reshape(b * qn, -1),
                lengths.reshape(b * qn), scale, 0,
                "paged_sparse_decode_attn_mq", qrows=qn)
    paged_sparse_decode_attn_mq.launches += 1
    return out.reshape(q.shape)


def paged_dense_decode_attn(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, table: torch.Tensor,
                            lengths: torch.Tensor, *,
                            scale: Optional[float] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """B4 — one query token per slot over its whole causal extent
    [0, length) (inside the optional sliding window), straight off the
    page pools. Returns (B, H, hd) f32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _on_cpu(q, k_pages, v_pages, table, lengths):
        return ref.paged_dense_attn_ref(q, k_pages, v_pages, table, lengths,
                                        scale=scale, window=window)
    out = _attn("paged_dense", q, k_pages, v_pages, table, None, lengths,
                scale, _window(window, "paged_dense_decode_attn"),
                "paged_dense_decode_attn")
    paged_dense_decode_attn.launches += 1
    return out


def sparse_decode_attn(q: torch.Tensor, kcache: torch.Tensor,
                       vcache: torch.Tensor, idx: torch.Tensor,
                       lengths: torch.Tensor, *,
                       scale: Optional[float] = None) -> torch.Tensor:
    """B6 — one query token per slot over exactly the K selected rows of
    its own contiguous caches. q (B, H, hd) in the cache dtype; caches
    (B, N, KVH, hd); idx (B, K) int32 (-1 padded); lengths (B,). Entries
    outside [0, length) are masked. Returns (B, H, hd) f32 (0 for a slot
    with no valid entry); bit-equal on the card to
    `paged_sparse_decode_attn` over pages holding the same rows."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _on_meta(q, kcache, vcache, idx, lengths):
        b, h, hd = q.shape
        _check(kcache.dim() == 4 and kcache.shape == vcache.shape
               and kcache.shape[0] == b and kcache.shape[3] == hd
               and h % kcache.shape[2] == 0 and idx.dim() == 2
               and idx.shape[0] == b and lengths.shape == (b,),
               f"sparse_decode_attn: q (B, H, hd), caches (B, N, KVH, hd) "
               f"with KVH | H, idx (B, K), lengths (B,); got "
               f"{tuple(q.shape)}, {tuple(kcache.shape)}, "
               f"{tuple(idx.shape)}, {tuple(lengths.shape)}")
        return q.new_empty((b, h, hd), dtype=torch.float32)
    if _on_cpu(q, kcache, vcache, idx, lengths):
        return ref.sparse_attn_ref(q, kcache, vcache, idx, lengths,
                                   scale=scale)
    out = _attn("contig_sparse", q, kcache, vcache, None, idx, lengths,
                scale, 0, "sparse_decode_attn")
    sparse_decode_attn.launches += 1
    return out


def paged_sparse_decode_attn_pg(q: torch.Tensor, k_pages: torch.Tensor,
                                v_pages: torch.Tensor, table: torch.Tensor,
                                idx: torch.Tensor, lengths: torch.Tensor, *,
                                scale: Optional[float] = None) -> torch.Tensor:
    """B10 — `paged_sparse_decode_attn` at page granularity: the selected
    rows are taken page by page, in ascending position, each weighted by
    how often it was selected. Same arguments and masking; on the card the
    row is split into runs of whole pages (`pg_rows_per_split`) merged in
    split order, so the sum runs in page order and agrees with the
    token-granular form to rounding (the plain version, used on the CPU,
    restores Top-K order and agrees bit for bit). K must be below 65536
    (the kernel's 16-bit selection counts): a launch beyond the kernel's
    limits raises."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if _on_cpu(q, k_pages, v_pages, table, idx, lengths):
        return ref.paged_sparse_attn_pg_ref(q, k_pages, v_pages, table, idx,
                                            lengths, scale=scale)
    out = _attn("paged_pages", q, k_pages, v_pages, table, idx, lengths,
                scale, 0, "paged_sparse_decode_attn_pg")
    paged_sparse_decode_attn_pg.launches += 1
    return out


KERNELS = {
    "gvr_topk": gvr_topk,
    "paged_indexer_scores": paged_indexer_scores,
    "paged_sparse_decode_attn": paged_sparse_decode_attn,
    "paged_dense_decode_attn": paged_dense_decode_attn,
    "indexer_scores": indexer_scores,
    "sparse_decode_attn": sparse_decode_attn,
    "paged_gather": paged_gather,
    "paged_sparse_decode_attn_pg": paged_sparse_decode_attn_pg,
    "paged_sparse_decode_attn_mq": paged_sparse_decode_attn_mq,
    "paged_indexer_scores_mq": paged_indexer_scores_mq,
    "gvr_topk_chain": gvr_topk_chain,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
