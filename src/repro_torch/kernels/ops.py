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

Each wrapper's `launches` attribute is a plain integer; `launch_counts()`
reads them all and `reset_launch_counts()` zeroes them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import ref
from .build import LIBRARIES

# shared memory a CTA may use on Hopper, less room for the static part
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

def gvr_topk(scores: torch.Tensor, prev_idx: torch.Tensor, k: int, *,
             max_candidates: Optional[int] = None,
             max_secant_iters: int = 12):
    """B1 — exact Top-K of (B, N) f32 rows warm-started from (B, M) int32
    predictions. Returns (values (B,K) f32, indices (B,K) int32 in
    ascending order, stats (B,8) f32; see `ref.gvr_topk_ref`)."""
    if _on_cpu(scores, prev_idx):
        return ref.gvr_topk_ref(scores, prev_idx, k,
                                max_candidates=max_candidates,
                                max_secant_iters=max_secant_iters)
    _check(scores.dim() == 2 and prev_idx.dim() == 2, "gvr_topk: 2-D inputs")
    _contig(scores, torch.float32, "gvr_topk scores")
    _contig(prev_idx, torch.int32, "gvr_topk prev_idx")
    b, n = scores.shape
    m = prev_idx.shape[1]
    _check(prev_idx.shape[0] == b and m >= 1, "gvr_topk: prev_idx (B, M>=1)")
    _check(1 <= k <= n, f"gvr_topk: need 1 <= k={k} <= n={n}")
    _check(n < 2 ** 30, f"gvr_topk: n={n} beyond the kernel's int32 indexing")
    cmax = ref.resolve_cmax(k, n, max_candidates)
    cand_bytes = 8 * cmax
    _check(cand_bytes <= _SMEM_BUDGET,
           f"gvr_topk: candidate buffer C={cmax} needs {cand_bytes} B of "
           f"shared memory, more than the kernel's {_SMEM_BUDGET} B")
    row_in_smem = int(4 * n + cand_bytes <= _SMEM_BUDGET)
    f_target = float((k + cmax) // 2)
    c_lo0 = float(min(n, max(1.25 * m, k)))
    vals = torch.empty((b, k), dtype=torch.float32, device=scores.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=scores.device)
    stats = torch.empty((b, 8), dtype=torch.float32, device=scores.device)
    rc = LIBRARIES.get("gvr_topk").gvr_topk_launch(
        scores.data_ptr(), prev_idx.data_ptr(), b, n, m, k, cmax,
        max_secant_iters, f_target, c_lo0, row_in_smem, vals.data_ptr(),
        idx.data_ptr(), stats.data_ptr(), _stream(scores))
    _raise_on(rc, "gvr_topk")
    gvr_topk.launches += 1
    return vals, idx, stats


# ---------------------------------------------------------------- B2 ------

def _heads_per_thread(h: int, ps: int) -> int:
    for hg in (1, 2, 4, 8, 16):
        if h % hg == 0 and ps * (h // hg) <= 256:
            return hg
    if h % 16 == 0 and ps * (h // 16) <= 1024:
        return 16
    raise ValueError(f"paged_indexer_scores: no thread layout for H={h}, "
                     f"page_size={ps}")


def paged_indexer_scores(q: torch.Tensor, k_pages: torch.Tensor,
                         w: torch.Tensor, table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """B2 scoring — Eq. 1 over page-addressed indexer keys. q (B, H, D) in
    the cache dtype; k_pages (P, ps, D); w (H,) f32; table (B, MP) int32;
    lengths (B,) int32. Returns the (B, MP*ps) f32 score row, NEG beyond
    length and on unmapped pages."""
    if _on_cpu(q, k_pages, w, table, lengths):
        return ref.paged_indexer_scores_ref(q, k_pages, w, table, lengths)
    _check(k_pages.dtype in _DTYPE_CODE,
           f"paged_indexer_scores: pools must be f32 or bf16, got {k_pages.dtype}")
    _contig(q, k_pages.dtype, "paged_indexer_scores q")
    _contig(k_pages, k_pages.dtype, "paged_indexer_scores k_pages")
    _contig(w, torch.float32, "paged_indexer_scores w")
    _contig(table, torch.int32, "paged_indexer_scores table")
    _contig(lengths, torch.int32, "paged_indexer_scores lengths")
    b, h, d = q.shape
    p, ps, d2 = k_pages.shape
    _check(d2 == d and w.shape == (h,) and table.shape[0] == b
           and lengths.shape == (b,), "paged_indexer_scores: shape mismatch")
    mp = table.shape[1]
    hg = _heads_per_thread(h, ps)
    smem = 4 * (h * d + d * ps + (h // hg) * ps)
    _check(smem <= _SMEM_BUDGET,
           f"paged_indexer_scores: {smem} B of shared memory per page")
    scores = torch.empty((b, mp * ps), dtype=torch.float32, device=q.device)
    rc = LIBRARIES.get("paged_indexer").paged_indexer_scores_launch(
        _DTYPE_CODE[k_pages.dtype], hg, q.data_ptr(), k_pages.data_ptr(),
        w.data_ptr(), table.data_ptr(), lengths.data_ptr(), b, h, d, ps, mp,
        p, scores.data_ptr(), _stream(q))
    _raise_on(rc, "paged_indexer_scores")
    paged_indexer_scores.launches += 1
    return scores


def paged_indexer_topk(q: torch.Tensor, k_pages: torch.Tensor,
                       w: torch.Tensor, table: torch.Tensor,
                       prev_idx: torch.Tensor, k: int, *,
                       lengths: torch.Tensor,
                       max_candidates: Optional[int] = None):
    """B2 — paged indexer scoring, then the GVR Top-K (B1) on the score row
    (two launches on the card). Returns (values, indices, stats) as
    `gvr_topk`, indices logical."""
    scores = paged_indexer_scores(q, k_pages, w, table, lengths)
    return gvr_topk(scores, prev_idx, k, max_candidates=max_candidates)


# ------------------------------------------------------------ B3 / B4 -----

def _attn(mode: int, q, k_pages, v_pages, table, idx, lengths, scale, window,
          name: str) -> torch.Tensor:
    _check(k_pages.dtype in _DTYPE_CODE,
           f"{name}: pools must be f32 or bf16, got {k_pages.dtype}")
    dt = k_pages.dtype
    for t, nm in ((q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")):
        _contig(t, dt, f"{name} {nm}")
    _contig(table, torch.int32, f"{name} table")
    _contig(lengths, torch.int32, f"{name} lengths")
    b, h, hd = q.shape
    p, ps, kvh, hd2 = k_pages.shape
    _check(v_pages.shape == k_pages.shape and hd2 == hd,
           f"{name}: pools (P, ps, KVH, hd) matching q")
    _check(h % kvh == 0 and h // kvh in (1, 2, 4, 8),
           f"{name}: H/KVH must be 1, 2, 4 or 8, got {h}/{kvh}")
    _check(hd in (32, 64, 128), f"{name}: head_dim must be 32, 64 or 128")
    _check(table.shape[0] == b and lengths.shape == (b,),
           f"{name}: table (B, MP), lengths (B,)")
    _check(p * ps < 2 ** 31, f"{name}: pool rows beyond int32 indexing")
    kcols = 0
    if idx is not None:
        _contig(idx, torch.int32, f"{name} idx")
        _check(idx.dim() == 2 and idx.shape[0] == b, f"{name}: idx (B, K)")
        kcols = idx.shape[1]
    out = torch.empty((b, h, hd), dtype=torch.float32, device=q.device)
    rc = LIBRARIES.get("paged_attn").paged_attn_launch(
        _DTYPE_CODE[dt], mode, h // kvh, hd // 32, q.data_ptr(),
        k_pages.data_ptr(), v_pages.data_ptr(), table.data_ptr(),
        idx.data_ptr() if idx is not None else None, lengths.data_ptr(), b,
        kvh, ps, table.shape[1], p, kcols, window, float(scale),
        out.data_ptr(), _stream(q))
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
    out = _attn(0, q, k_pages, v_pages, table, idx, lengths, scale, 0,
                "paged_sparse_decode_attn")
    paged_sparse_decode_attn.launches += 1
    return out


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
    _check(window is None or window > 0, "paged_dense_decode_attn: window > 0")
    out = _attn(1, q, k_pages, v_pages, table, None, lengths, scale,
                window or 0, "paged_dense_decode_attn")
    paged_dense_decode_attn.launches += 1
    return out


KERNELS = {
    "gvr_topk": gvr_topk,
    "paged_indexer_scores": paged_indexer_scores,
    "paged_sparse_decode_attn": paged_sparse_decode_attn,
    "paged_dense_decode_attn": paged_dense_decode_attn,
}
for _fn in KERNELS.values():
    _fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
