"""Decoder-only transformer LM, decode side of the dense family, PyTorch port.

Parameters are a plain dict of tensors stacked over layers (L, ...) in the
JAX package's layout (weights (in, out), used as `x @ W`), so the JAX
parameters carry over one to one (`repro_torch.bridge`). A Python loop over
the layers takes the place of `lax.scan`.

Two cache layouts, one computation. Per layer: projections + RoPE, the new
K/V/indexer-K rows written at position `length`, then DSA (indexer → exact
Top-K → sparse attention over the K selected rows) once the logical extent
exceeds `dsa.min_n`, else dense attention over the whole extent.

* `serve_step` — the dense layout: contiguous (L, B, N, ...) caches; DSA
  runs kernels B5/B1/B6 on the card, the pre-DSA fallback is plain
  PyTorch (`layers.decode_attention`), as the JAX package leaves it to XLA.
* `serve_step_paged` — the paged layout: page pools and a block table.
  `paged_attn="fused"` addresses the pools through the table (B2/B1/B3,
  or B10 under `gather_granularity="page"`; fallback B4);
  `paged_attn="gather"` is the oracle that first builds the contiguous
  logical views (kernel B7) and then runs the dense layout's attention.

Caches and pools are updated IN PLACE — copying a multi-GB cache per tick
is what JAX's functional update costs and what this port avoids; a row
whose write is masked keeps its old contents (dense) or writes the sink
page (paged). The small per-slot leaves (length, prev_topk, topk_valid,
sel_gvr) come back as new tensors, so the engine can merge them row by row.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.temporal import (recycle_slot_arrays, reset_slot_arrays,
                                       seed_slot_idx)
from repro_torch.kernels import ops
from repro_torch.sparse import dsa as dsa_mod
from .config import ModelConfig
from .layers import (apply_rotary, decode_attention, decode_attention_paged,
                     rms_norm, swiglu_mlp)

# min_write_pos sentinel larger than any position: the row never writes.
# Rows whose write is masked (inactive slots, shared-prefix replay over
# already-materialized pages) scatter into a dedicated sink page instead.
PAGED_NEVER_WRITE = 2 ** 30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.moe.num_experts or cfg.num_patches:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP Queue A item "
            f"5: other model families)")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random-init parameters from `generator` (N(0, 1/fan_in) weights,
    unit norms), stacked over layers."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    l, d, hd, f = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff

    def dense(shape, scale):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {
        "ln1": ones((l, d)),
        "ln2": ones((l, d)),
        "wq": dense((l, d, cfg.n_heads * hd), d ** -0.5),
        "wk": dense((l, d, cfg.n_kv_heads * hd), d ** -0.5),
        "wv": dense((l, d, cfg.n_kv_heads * hd), d ** -0.5),
        "wo": dense((l, cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
        "w_gate": dense((l, d, f), d ** -0.5),
        "w_up": dense((l, d, f), d ** -0.5),
        "w_down": dense((l, f, d), f ** -0.5),
    }
    if cfg.dsa.enabled:
        layers["indexer"] = dsa_mod.indexer_init(
            generator, d, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim, dtype,
            device, layers=l)
    params = {
        "embed": dense((cfg.vocab, d), 1.0),
        "layers": layers,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab), d ** -0.5)
    return params


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer i's parameters in the stacked dict."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# --------------------------------------------------------------------------
# Decode state
# --------------------------------------------------------------------------

def _feedback_state(cfg: ModelConfig, batch: int, max_len: int,
                    device) -> Dict[str, torch.Tensor]:
    """The GVR feedback leaves: even-spacing seed, invalid until the first
    DSA step, no GVR row served yet."""
    l = cfg.n_layers
    kk = min(cfg.dsa.k, max_len)
    base = seed_slot_idx(kk, max_len, device)
    return {
        "prev_topk": base[None, None].expand(l, batch, kk).clone(),
        "topk_valid": torch.zeros((l, batch), dtype=torch.bool, device=device),
        "sel_gvr": torch.zeros((l, batch), dtype=torch.bool, device=device),
    }


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """Contiguous K/V (and DSA indexer-K) caches of `max_len` rows per slot,
    (L, batch, max_len, ...), with the reference's leaf names."""
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    l, hd = cfg.n_layers, cfg.hd
    cache = (l, batch, max_len)
    state = {
        "k": torch.zeros(cache + (cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v": torch.zeros(cache + (cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.dsa.enabled:
        state["idx_k"] = torch.zeros(cache + (cfg.dsa.indexer_dim,),
                                     dtype=dtype, device=device)
        state.update(_feedback_state(cfg, batch, max_len, device))
    return state


def state_merge_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Slot axis of each dense-state leaf that `serve_step` returns anew.
    The caches are absent: the step writes them in place and keeps the
    rows it masks, so they are never merged nor copied back."""
    axes = {"length": 0}
    if cfg.dsa.enabled:
        axes.update(prev_topk=1, topk_valid=1, sel_gvr=1)
    return axes


def state_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Slot axis of every leaf of the dense decode state."""
    axes = {"k": 1, "v": 1, **state_merge_axes(cfg)}
    if cfg.dsa.enabled:
        axes["idx_k"] = 1
    return axes


def init_paged_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                            num_pages: int, page_size: int, device,
                            dtype=None) -> Dict[str, torch.Tensor]:
    """K/V (and DSA indexer-K) caches in `num_pages` + 1 pages of
    `page_size` tokens — the extra last page is the write sink for masked
    rows. `page_table` (batch, max_len // page_size) maps each slot's
    logical pages to physical ids (-1 = unmapped)."""
    _check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    if max_len % page_size != 0:
        raise ValueError(f"max_len ({max_len}) must be a multiple of "
                         f"page_size ({page_size})")
    l, hd = cfg.n_layers, cfg.hd
    mp = max_len // page_size
    pool = (l, num_pages + 1, page_size)
    state = {
        "k_pages": torch.zeros(pool + (cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "v_pages": torch.zeros(pool + (cfg.n_kv_heads, hd), dtype=dtype, device=device),
        "page_table": torch.full((batch, mp), -1, dtype=torch.int32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.dsa.enabled:
        state["idx_k_pages"] = torch.zeros(pool + (cfg.dsa.indexer_dim,),
                                           dtype=dtype, device=device)
        state.update(_feedback_state(cfg, batch, max_len, device))
    return state


def paged_state_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Slot axis of each per-slot leaf of the paged state. The page pools
    are absent: they are pool-global (masked rows write the sink page)."""
    axes = {"page_table": 0, "length": 0}
    if cfg.dsa.enabled:
        axes.update(prev_topk=1, topk_valid=1, sel_gvr=1)
    return axes


def reset_slot_state(cfg: ModelConfig, state: Dict[str, torch.Tensor], slot,
                     seq_len_hint: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Slot admission: zero the slot's length and re-seed its GVR feedback
    (even spacing over `seq_len_hint`, invalid until the first DSA step)."""
    state = dict(state)
    length = state["length"].clone()
    length[slot] = 0
    state["length"] = length
    if cfg.dsa.enabled:
        state["prev_topk"], state["topk_valid"] = reset_slot_arrays(
            state["prev_topk"], state["topk_valid"], slot, seq_len_hint)
        sel = state["sel_gvr"].clone()
        sel[:, slot] = False
        state["sel_gvr"] = sel
    return state


def recycle_slot_state(cfg: ModelConfig, state: Dict[str, torch.Tensor],
                       slot) -> Dict[str, torch.Tensor]:
    """Slot eviction: poison the slot's predictions so they can never leak
    into the next admitted request."""
    state = dict(state)
    if cfg.dsa.enabled:
        state["prev_topk"], state["topk_valid"] = recycle_slot_arrays(
            state["prev_topk"], state["topk_valid"], slot)
        sel = state["sel_gvr"].clone()
        sel[:, slot] = False
        state["sel_gvr"] = sel
    return state


# --------------------------------------------------------------------------
# Decode step
# --------------------------------------------------------------------------

def _project_qkv(p, h, b, positions, cfg: ModelConfig):
    """Decode projections + RoPE. h: (B, D) normed input. Returns q
    (B,H,HD), kn (B,KVH,HD), vn (B,KVH,HD)."""
    hd = cfg.hd
    q = (h @ p["wq"]).reshape(b, 1, cfg.n_heads, hd)
    kn = (h @ p["wk"]).reshape(b, 1, cfg.n_kv_heads, hd)
    vn = (h @ p["wv"]).reshape(b, 1, cfg.n_kv_heads, hd)
    pos = positions[:, None]
    q = apply_rotary(q, pos, kind=cfg.rope_kind, base=cfg.rope_base,
                     fraction=cfg.rope_fraction)[:, 0]
    kn = apply_rotary(kn, pos, kind=cfg.rope_kind, base=cfg.rope_base,
                      fraction=cfg.rope_fraction)[:, 0]
    return q, kn, vn[:, 0]


def _dsa_kw(cfg: ModelConfig, state, i: int) -> Dict[str, Any]:
    """Layer i's keyword arguments of the DSA decode block."""
    valid = state.get("topk_valid")
    return dict(k=state["prev_topk"].shape[-1], scale=cfg.hd ** -0.5,
                heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
                rope_base=cfg.rope_base, selector=cfg.dsa.selector,
                prev_valid=None if valid is None else valid[i],
                max_candidates=cfg.dsa.max_candidates,
                gate_max_n=cfg.dsa.gate_max_n, min_n=cfg.dsa.min_n,
                swa_window=cfg.swa_window)


def _attend_views(cfg: ModelConfig, state, i: int, p, h, q, kc, vc, idx_kc,
                  new_len, use_dsa: bool):
    """Attention over contiguous logical views (B, N, ...): the dense
    layout's, and the paged gather oracle's once it has built the views.
    Returns (attn (B, H, HD) f32, the DSA output or None)."""
    if use_dsa:
        res = dsa_mod.dsa_decode(q, kc, vc, p["indexer"], h, idx_kc,
                                 state["prev_topk"][i], new_len,
                                 **_dsa_kw(cfg, state, i))
        return res.attn_out, res
    return decode_attention(q, kc, vc, new_len, scale=cfg.hd ** -0.5,
                            window=cfg.swa_window), None


def _decode_layers(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                   attend):
    """The layer loop shared by both layouts. `attend(i, p, h, q, kn, vn)`
    writes layer i's new rows and returns (attn, DSA output or None).
    Returns (logits (B, V) f32, new_state)."""
    _check_family(cfg)
    b = tokens.shape[0]
    x = params["embed"][tokens.long()]                   # (B, D)
    positions = state["length"]
    prev_out, sel_out = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["ln1"])
        q, kn, vn = _project_qkv(p, h, b, positions, cfg)
        attn, res = attend(i, p, h, q, kn, vn)
        if res is not None:
            prev_out.append(res.topk_idx.int())
            sel_out.append(res.gvr_rows)
        attn = attn.reshape(b, cfg.n_heads * cfg.hd).to(x.dtype)
        x = x + attn @ p["wo"]
        h = rms_norm(x, p["ln2"])
        x = x + swiglu_mlp(h, p["w_gate"], p["w_up"], p["w_down"])

    new_state = dict(state)
    if prev_out:
        new_state["prev_topk"] = torch.stack(prev_out)
        new_state["topk_valid"] = torch.ones_like(state["topk_valid"])
        new_state["sel_gvr"] = torch.stack(sel_out)
    elif cfg.dsa.enabled:
        new_state["sel_gvr"] = torch.zeros_like(state["sel_gvr"])
    new_state["length"] = positions + 1

    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (x @ head).float(), new_state


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
               min_write_pos: Optional[torch.Tensor] = None):
    """One decode step over the dense layout. tokens: (B,) int. Returns
    (logits (B, V) f32, new_state).

    The new token's rows are written in place at position `length` of each
    slot's caches, clamped to N-1 as JAX's `dynamic_update_slice` clamps
    it. A row whose position is below `min_write_pos` (B,) keeps its old
    contents: the engine masks inactive slots so, where the reference
    writes every row and restores the inactive ones afterwards.
    """
    n = state["k"].shape[2]
    b = tokens.shape[0]
    positions = state["length"]
    new_len = positions + 1
    use_dsa = cfg.dsa.enabled and n > cfg.dsa.min_n
    rows = torch.arange(b, device=positions.device)
    wpos = positions.clamp(max=n - 1).long()
    keep = None if min_write_pos is None else positions < min_write_pos

    def write(cache, new):
        new = new.to(cache.dtype)
        if keep is not None:
            new = torch.where(keep.reshape((b,) + (1,) * (new.dim() - 1)),
                              cache[rows, wpos], new)
        cache[rows, wpos] = new

    def attend(i, p, h, q, kn, vn):
        kc, vc = state["k"][i], state["v"][i]
        write(kc, kn)
        write(vc, vn)
        idx_kc = None
        if use_dsa:
            idx_kc = state["idx_k"][i]
            write(idx_kc, dsa_mod.indexer_k(p["indexer"], h, positions,
                                            dim=cfg.dsa.indexer_dim,
                                            rope_base=cfg.rope_base))
        return _attend_views(cfg, state, i, p, h, q, kc, vc, idx_kc, new_len,
                             use_dsa)

    return _decode_layers(params, state, tokens, cfg, attend)


def check_paged_options(paged_attn: str, gather_granularity: str) -> None:
    """Raise ValueError unless both options name a form `serve_step_paged`
    serves."""
    if paged_attn not in ("fused", "gather"):
        raise ValueError(f"unknown paged_attn {paged_attn!r} "
                         f"(expected 'fused' or 'gather')")
    if gather_granularity not in ("token", "page"):
        raise ValueError(f"unknown gather_granularity {gather_granularity!r} "
                         f"(expected 'token' or 'page')")


def serve_step_paged(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
                     min_write_pos: Optional[torch.Tensor] = None,
                     paged_attn: str = "fused",
                     gather_granularity: str = "token"):
    """One paged decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state).

    The new token's rows scatter into `page_table[b, length // page_size]`
    at offset `length % page_size` — in place, into the state's pools.
    `min_write_pos` (B,) redirects the write of rows whose position is below
    it to the sink page: the engine uses it to mask inactive slots and to
    replay the last prompt token over a shared prefix without touching the
    shared page. Everything the feedback loop touches stays in logical
    token space.

    `paged_attn` picks the physical form of attention, bit-identical on
    the CPU in logits and new state: "fused" addresses the pools through
    the block table and never builds the logical views; "gather" (the
    oracle) builds the K, V and indexer-K logical views first (kernel B7)
    and attends as the dense layout does. `gather_granularity` picks the
    fused sparse gather's shape: "token" reads one row per Top-K entry
    (B3), "page" each distinct touched page whole (B10; on the card it sums
    in page order, so it agrees with "token" to rounding).
    """
    check_paged_options(paged_attn, gather_granularity)
    positions = state["length"]
    new_len = positions + 1
    table = state["page_table"]
    page_size = state["k_pages"].shape[2]
    sink = state["k_pages"].shape[1] - 1
    mp = table.shape[1]
    n = mp * page_size

    lp = (positions // page_size).long()
    off = (positions % page_size).long()
    phys = table.gather(1, lp.clamp(0, mp - 1)[:, None])[:, 0]
    writable = (phys >= 0) & (lp < mp)
    if min_write_pos is not None:
        writable &= positions >= min_write_pos
    dest = torch.where(writable, phys, torch.full_like(phys, sink)).long()
    use_dsa = cfg.dsa.enabled and n > cfg.dsa.min_n

    def attend(i, p, h, q, kn, vn):
        kp, vp = state["k_pages"][i], state["v_pages"][i]
        kp[dest, off] = kn.to(kp.dtype)
        vp[dest, off] = vn.to(vp.dtype)
        idx_kp = None
        if use_dsa:
            idx_kp = state["idx_k_pages"][i]
            ik = dsa_mod.indexer_k(p["indexer"], h, positions,
                                   dim=cfg.dsa.indexer_dim,
                                   rope_base=cfg.rope_base)
            idx_kp[dest, off] = ik.to(idx_kp.dtype)
        if paged_attn == "gather":
            kc, vc = ops.paged_gather(kp, table), ops.paged_gather(vp, table)
            idx_kc = ops.paged_gather(idx_kp, table) if use_dsa else None
            return _attend_views(cfg, state, i, p, h, q, kc, vc, idx_kc,
                                 new_len, use_dsa)
        if use_dsa:
            res = dsa_mod.dsa_decode_paged(
                q, kp, vp, table, p["indexer"], h, idx_kp,
                state["prev_topk"][i], new_len,
                gather_granularity=gather_granularity,
                **_dsa_kw(cfg, state, i))
            return res.attn_out, res
        return decode_attention_paged(q, kp, vp, table, new_len,
                                      scale=cfg.hd ** -0.5,
                                      window=cfg.swa_window), None

    return _decode_layers(params, state, tokens, cfg, attend)
