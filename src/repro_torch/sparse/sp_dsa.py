"""SP-DSA: the sequence-parallel DSA decode layer, PyTorch port.

The KV cache is sharded along the sequence over the S ranks of a
`SeqGroup` (rank r owns the tokens [r·N/S, (r+1)·N/S)), and no rank ever
holds the whole score row:

  1. indexer  — each rank scores its own tokens (Eq. 1).
  2. SP-GVR   — the exact global Top-K with scalar-sized collectives
                (`core.sp_gvr`); each rank keeps the winners it owns.
  3. attention, in one of two forms:
     * `sp_dsa_decode_paged_local` (the sharded serving step): the
       winners are gathered into the single-device selector's ascending
       buffer, each rank reads the selected rows it owns from its own
       page pool, and one O(K) psum assembles the (B, K, KVH, hd) rows on
       every rank; attention then runs over them as on one device. The
       rows travel as their bit patterns (int32 views, summed: exactly
       one rank contributes a non-zero pattern per row), so the assembled
       rows equal the pool's to the bit, -0.0 included, and the step is
       bit-identical to the single-device fused step.
     * `sp_dsa_decode_local` (contiguous caches): each rank attends over
       its own selected rows and the partial (numerator, denominator)
       pairs combine with a pmax and a psum, flash-decoding style. On a
       ("data", "model") mesh (`make_sp_dsa`) the sequence is sharded
       over "data" and each rank attends its own heads over "model".

On the card the paged form launches kernel B2's scoring half over the
rank's pool and slice of the block table, and kernel B6 over the
assembled rows (B6 cuts a row into the same splits as B3, by its entry
count alone); SP-GVR and the assembly are plain PyTorch. The contiguous
form is plain PyTorch throughout, as the reference body is plain jnp.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from repro_torch.core.sp_gvr import sp_canonical_topk, sp_gvr_topk_local
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rotary
from repro_torch.parallel.sharding import SeqGroup

from . import dsa as dsa_mod

NEG = -3.4028234663852886e38


class SPDSAResult(NamedTuple):
    attn_out: torch.Tensor    # (B, H, HD) f32, the same on every rank
    new_k: torch.Tensor       # this rank's K cache shard (written in place)
    new_v: torch.Tensor
    new_ik: torch.Tensor
    new_topk: torch.Tensor    # (B, K) global indices, the same on every rank


def sp_dsa_decode_local(q, kc, vc, ikc, h, idx_params, prev_topk, lengths,
                        knew, vnew, iknew, *, k: int, scale: float,
                        heads: int, dim: int, rope_base: float,
                        mesh: SeqGroup) -> SPDSAResult:
    """One rank's SP-DSA decode over contiguous sequence-sharded caches.
    Shapes (per rank): q (B, H, HD); kc/vc (B, Nl, KVH, HD); ikc
    (B, Nl, dim); h (B, D); prev_topk (B, K) GLOBAL indices; lengths (B,)
    global, including the new token; knew/vnew (B, KVH, HD); iknew
    (B, dim). The rank owning position length-1 writes the new rows into
    its caches in place."""
    b, hl, hd = q.shape
    nl, kvh = kc.shape[1], kc.shape[2]
    g = hl // kvh
    off = mesh.rank * nl

    # -- 1. sequence-local cache write -----------------------------------
    pos = lengths.long() - 1
    _write_owned(((kc, knew), (vc, vnew), (ikc, iknew)), pos, off)

    # -- 2. shard-local indexer scores (Eq. 1) ---------------------------
    qi = (h @ idx_params["wq"]).reshape(b, 1, heads, dim)
    qi = apply_rotary(qi, pos[:, None], kind="rope", base=rope_base)[:, 0]
    s = torch.relu(torch.einsum("bhd,bnd->bhn", qi.float(), ikc.float()))
    scores = torch.einsum("h,bhn->bn", idx_params["w"].float(), s)
    gpos = torch.arange(nl, device=q.device)[None, :] + off
    scores = torch.where(gpos < lengths[:, None], scores, NEG)

    # -- 3. SP-GVR exact distributed Top-K --------------------------------
    sel = sp_gvr_topk_local(scores, prev_topk, k, mesh)
    loc_idx, loc_cnt = sel.local_indices, sel.local_count

    # -- 4. local sparse attention + flash combine ------------------------
    rel_idx = (loc_idx.long() - off).clamp(0, nl - 1)
    at = rel_idx[:, :, None, None].expand(b, k, kvh, hd)
    kg, vg = kc.gather(1, at), vc.gather(1, at)
    logits = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kvh, g, hd).float(),
                          kg.float()) * scale
    valid = torch.arange(k, device=q.device)[None, :] < loc_cnt[:, None]
    logits = torch.where(valid[:, None, None, :], logits, NEG)
    # stable combine: the global max by pmax, then a psum of (num, den)
    m_glob = mesh.pmax(logits.amax(-1), "combine")           # (B, KVH, G)
    p = torch.exp(logits - m_glob[..., None])
    p = torch.where(valid[:, None, None, :], p, 0.0)
    num = mesh.psum(torch.einsum("bkgs,bskd->bkgd", p, vg.float()), "combine")
    den = mesh.psum(p.sum(-1), "combine")
    out = (num / den.clamp(min=1e-30)[..., None]).reshape(b, hl, hd)

    # -- 5. feedback: the global Top-K for the next step -----------------
    all_idx = mesh.all_gather(loc_idx, dim=1, tiled=True, tag="feedback")
    order = torch.sort((all_idx < 0).int(), dim=-1, stable=True).indices
    new_topk = all_idx.gather(1, order)[:, :k].int()
    return SPDSAResult(out, kc, vc, ikc, new_topk)


def _write_owned(pairs, pos: torch.Tensor, off: int) -> None:
    """Write each new row (B, ...) into its cache (B, Nl, ...) at global
    position pos (B,), in place, on the rank whose span [off, off + Nl)
    holds it. On the meta device (the dry run) only the shapes are
    checked: which rank holds a row is data."""
    nl = pairs[0][0].shape[1]
    if pos.is_meta:
        for cache, new in pairs:
            if cache.shape[:1] + cache.shape[2:] != new.shape:
                raise ValueError(f"a row {tuple(new.shape)} does not fit "
                                 f"the cache {tuple(cache.shape)}")
        return
    rel = pos - off
    rows = ((rel >= 0) & (rel < nl)).nonzero()[:, 0]
    for cache, new in pairs:
        cache[rows, rel[rows]] = new[rows].to(cache.dtype)


def sp_dense_decode_local(q, kc, vc, ikc, h, idx_params, prev_topk, lengths,
                          knew, vnew, iknew, *, scale: float,
                          mesh: SeqGroup) -> SPDSAResult:
    """The dense counterpart of `sp_dsa_decode_local` for a cache of at
    most `dsa.min_n` positions, sharded over the sequence as that
    layer's: the new rows (the indexer key too) written on the rank that
    owns position length-1, then every query head attends all positions
    below `lengths` of the rank's span, and the partial (numerator,
    denominator) pairs combine with a pmax and a psum. The feedback is
    `prev_topk` unchanged (no selection ran), as the reference's
    unsharded step carries it. Same arguments and result."""
    b, hl, hd = q.shape
    nl, kvh = kc.shape[1], kc.shape[2]
    off = mesh.rank * nl
    _write_owned(((kc, knew), (vc, vnew), (ikc, iknew)),
                 lengths.long() - 1, off)
    logits = torch.einsum(
        "bkgd,bskd->bkgs", q.reshape(b, kvh, hl // kvh, hd).to(kc.dtype).float(),
        kc.float()) * scale
    gpos = torch.arange(nl, device=q.device) + off
    valid = (gpos[None, :] < lengths[:, None])[:, None, None, :]
    logits = torch.where(valid, logits, NEG)
    m_glob = mesh.pmax(logits.amax(-1), "combine")
    p = torch.where(valid, torch.exp(logits - m_glob[..., None]), 0.0)
    num = mesh.psum(torch.einsum("bkgs,bskd->bkgd", p, vc.float()), "combine")
    den = mesh.psum(p.sum(-1), "combine")
    out = (num / den.clamp(min=1e-30)[..., None]).reshape(b, hl, hd)
    return SPDSAResult(out, kc, vc, ikc, prev_topk)


def make_sp_dsa(mesh, *, k: int, scale: float, heads: int, dim: int,
                rope_base: float, seq_axis: str = "data",
                head_axis: Optional[str] = "model", shard_heads: bool = True,
                dense: bool = False):
    """The SP-DSA decode layer: a callable of `sp_dsa_decode_local`'s
    positional arguments, each rank passing its own blocks.

    `mesh` is a `Mesh` — the sequence over `seq_axis`, and with
    `shard_heads` the heads over `head_axis` — or a `SeqGroup`, the 1-D
    sequence mesh (no head axis). SP-GVR and the flash-style combine run
    over the sequence axis alone. With `shard_heads`, q holds the rank's
    block of query heads and the caches (and the new rows) the KV heads of
    those heads, the rank's block of KV heads as `state_specs` shards
    them: query head j attends KV head j // (H_local / KVH_local), each
    head with its own group's keys, and the output holds the rank's
    heads. `dense` takes `sp_dense_decode_local` (a cache of at most
    `dsa.min_n` positions) in place of the selection."""
    seq = mesh if isinstance(mesh, SeqGroup) else mesh.axis(seq_axis)
    if dense:
        body = partial(sp_dense_decode_local, scale=scale, mesh=seq)
    else:
        body = partial(sp_dsa_decode_local, k=k, scale=scale, heads=heads,
                       dim=dim, rope_base=rope_base, mesh=seq)
    if not shard_heads or isinstance(mesh, SeqGroup):
        return body
    hax = mesh.axis(head_axis)

    def layer(q, kc, vc, *rest):
        if q.shape[1] % kc.shape[2]:
            raise ValueError(f"{q.shape[1]} query heads of rank "
                             f"{hax.rank} over {head_axis!r} are not whole "
                             f"groups of its {kc.shape[2]} KV heads")
        return body(q, kc, vc, *rest)

    return layer


class SPDSAPagedResult(NamedTuple):
    attn_out: torch.Tensor      # (B, H, HD) f32, the same on every rank
    new_topk: torch.Tensor      # (B, K) int32 global logical indices,
                                # ascending (the same on every rank)
    secant_iters: torch.Tensor  # (B,) int32 — SP-GVR phase-2 iterations
    gvr_rows: torch.Tensor      # (B,) bool — rows served off the prior


def _assemble(rows: torch.Tensor, flags: torch.Tensor, mesh: SeqGroup):
    """The rows each rank owns (zeros elsewhere) summed over the ranks as
    int32 bit patterns — exact, -0.0 kept, no float sum on the backend —
    with the per-rank int flags summed in the same psum. Returns (rows,
    flags summed)."""
    bits = rows.contiguous().view(torch.int32)
    total = mesh.psum(torch.cat([bits.reshape(-1), flags.int().reshape(-1)]),
                      "assemble")
    return (total[:bits.numel()].view(bits.shape).view(rows.dtype),
            total[bits.numel():].view(flags.shape))


def sp_dsa_decode_paged_local(q, k_pages, v_pages, table_local, idx_params,
                              h, idx_k_pages, prev_topk, prev_valid,
                              lengths, *, k: int, scale: float, heads: int,
                              dim: int, rope_base: float, shard_offset: int,
                              page_size: int,
                              max_candidates: Optional[int] = None,
                              swa_window: Optional[int] = None,
                              mesh: SeqGroup) -> SPDSAPagedResult:
    """One rank's paged SP-DSA selection + attention, the sharded serving
    step's per-layer core (see the module docstring).

    Shapes (per rank): q (B, H, HD); k/v_pages (PL+1, ps, KVH, HD) and
    idx_k_pages (PL+1, ps, dim) this rank's pools (the last page its write
    sink); table_local (B, MP_local) int32 LOCAL page ids (-1 unmapped);
    prev_topk (B, K) GLOBAL logical indices; prev_valid (B,) bool or None;
    lengths (B,) global, including the new token; shard_offset the global
    position of this rank's first token.

    The scoring launch masks by a length and window relative to the
    rank's first position: it takes `length - shard_offset` (possibly
    <= 0 or past the span), so [length - window, length) in global
    positions is what stays, whichever shard boundary it straddles."""
    b = q.shape[0]
    kvh, hd = k_pages.shape[2], k_pages.shape[3]
    n_local = table_local.shape[1] * page_size
    sink = k_pages.shape[0] - 1
    lengths = lengths.int()

    # -- 1. shard-local indexer scores: B2's scoring half ---------------
    qi = dsa_mod.indexer_q(idx_params, h, lengths - 1, heads=heads, dim=dim,
                           rope_base=rope_base, dtype=idx_k_pages.dtype)
    scores = ops.paged_indexer_scores(
        qi, idx_k_pages, idx_params["w"].float().contiguous(),
        table_local.contiguous(), (lengths - shard_offset).int().contiguous(),
        swa_window)

    # -- 2./3. SP-GVR → the canonical global buffer ----------------------
    sel = sp_gvr_topk_local(scores, prev_topk, k, mesh,
                            max_candidates=max_candidates)
    topk = sp_canonical_topk(sel.local_indices, k, n_local * mesh.size, mesh)

    # -- 4. the owned rows from the local pool, one O(K) assembly --------
    rel = topk.long() - shard_offset
    owned = (rel >= 0) & (rel < n_local)
    rel_c = rel.clamp(0, n_local - 1)
    phys = table_local.long().gather(1, rel_c // page_size)
    mapped_loc = owned & (phys >= 0)
    flat = phys.clamp(0, sink) * page_size + rel_c % page_size    # (B, K)
    hit = mapped_loc[:, :, None, None]
    rows = torch.stack([torch.where(hit, pages.reshape(-1, kvh, hd)[flat], 0)
                        for pages in (k_pages, v_pages)])
    (kg, vg), mapped = _assemble(rows, mapped_loc, mesh)
    mapped = mapped > 0

    # -- 5. attention over the assembled rows: kernel B6 -----------------
    valid = (topk >= 0) & (topk < lengths[:, None]) & mapped
    idx = torch.where(valid, torch.arange(k, device=q.device,
                                          dtype=torch.int32), -1)
    out = dsa_mod.dsa_sparse_attention(q, kg, vg, idx,
                                       torch.full_like(lengths, k),
                                       scale=scale)
    gvr_rows = (prev_valid.bool() if prev_valid is not None
                else torch.zeros((b,), dtype=torch.bool, device=q.device))
    return SPDSAPagedResult(out, topk, sel.secant_iters, gvr_rows)
