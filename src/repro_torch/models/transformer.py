"""Decoder-only transformer LM of the dense, vlm and MoE families, PyTorch
port: the training forward and the decode side.

Parameters are a plain dict of tensors stacked over layers (L, ...) in the
JAX package's layout (weights (in, out), used as `x @ W`), so the JAX
parameters carry over one to one (`repro_torch.bridge`). A Python loop over
the layers takes the place of `lax.scan`.

`forward_train` / `loss_fn` are the reference's training path under
autograd: embeddings, per layer RoPE and `layers.blockwise_causal_attention`
(plain PyTorch, f32, as the reference computes it outside any kernel),
the SwiGLU or MoE feed-forward, each layer recomputed in the backward
pass under `remat`; no DSA, so the indexer weights get a zero gradient.

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
* `serve_step_spec_paged` — the speculative verify tick over the paged
  layout: all d+1 draft positions of each slot scored at once, greedy
  acceptance and exact rollback of the per-slot state on the device.
  `verify_kernel="scan"` runs d+1 `serve_step_paged` calls; "mq" one
  forward of the (B, d+1) rows (kernels B9 and B8 in the fused form).
* `serve_step_sp_paged` / `serve_step_sp_spec_paged` — the same two over
  the sequence-sharded paged layout, on each rank of a sequence mesh:
  SP-GVR selection and the O(K) row assembly (`sparse/sp_dsa.py`; B2's
  scoring half and B6 on the card), bit-identical to the fused step.
* `serve_step(..., mesh=, rules=)` — the dense layout on one rank of a
  ("data", "model") mesh, placed by `param_specs` and `state_specs`
  (`tensor_parallel`): the rank's heads, `d_ff` or experts
  (`layers.moe_mlp_ep`) and vocab over "model", its batch rows over
  "data"; B5/B1/B6 on its rows and heads.
* `serve_step_paged` / `serve_step_spec_paged(..., mesh=, rules=)` — the
  paged forms on one rank of that mesh, placed by `paged_state_specs`:
  the pools by KV head and global over the batch axes, so each layer
  all-gathers the rows' new K/V/indexer-K over the batch axes and every
  rank writes every row (`_write_rows`); selection and attention on the
  rank's rows through their table rows and at its heads (B2/B1/B3, B10,
  B7 then B5/B1/B6, B4; B9/B8 in the mq verify body). The verify tick
  accepts on the rank's rows and gathers the accept lengths for the
  global `length`.

Caches and pools are updated IN PLACE — copying a multi-GB cache per tick
is what JAX's functional update costs and what this port avoids; a row
whose write is masked keeps its old contents (dense) or writes the sink
page (paged). The small per-slot leaves (length, prev_topk, topk_valid,
sel_gvr) come back as new tensors, so the engine can merge them row by row.

The vlm family (qwen2-vl) serves its text path: M-RoPE over 2-D
positions (three identical streams); its `patch_proj` parameter is read
by `forward_train` alone, which puts the projected patch embeddings in
the first `num_patches` positions. A sliding window (`swa_window`,
h2o-danube) limits the dense fallback's extent and, under DSA, the
positions the indexer may select (`sparse/dsa.py`).

The MoE family (`cfg.moe.num_experts > 0`) differs only in the
feed-forward: `layers.moe_mlp_dense_fallback`, what the reference serves
on one device, called with the (B, 1, D) shape as the reference calls it
— in the mq verify body once per draft position, as the scan does, so
that both bodies round alike.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.temporal import (recycle_slot_arrays, reset_slot_arrays,
                                       seed_slot_idx)
from repro_torch.kernels import ops
from repro_torch.parallel.sharding import MeshRules, P, stacked, unstacked
from repro_torch.sparse import dsa as dsa_mod
from repro_torch.sparse import sp_dsa as sp_dsa_mod
from .config import ModelConfig
from .layers import (apply_rotary, blockwise_causal_attention, cross_entropy,
                     decode_attention, decode_attention_paged, moe_mlp_ep,
                     remat_call, rms_norm, swiglu_mlp)
from .tensor_parallel import NO_MESH, Heads, Placement, axis_of, heads_of

# the per-slot GVR feedback leaves: under a mesh, the rank's batch rows
_FEEDBACK = ("prev_topk", "topk_valid", "sel_gvr")

# min_write_pos sentinel larger than any position: the row never writes.
# Rows whose write is masked (inactive slots, shared-prefix replay over
# already-materialized pages) scatter into a dedicated sink page instead.
PAGED_NEVER_WRITE = 2 ** 30

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def drawer(generator: torch.Generator, device, dtype: torch.dtype,
           block=None) -> Callable:
    """The families' weight draws: `draw(lead, shape, scale, path, dt)` is
    a (lead + shape) tensor of N(0, scale^2) draws from `generator` in dt
    (`dtype` by default), one `shape` at a time (so the f32 temporary is
    one layer's). `block
    (path, x)`, when given, cuts each drawn layer of the leaf at `path`
    ("layers/wq") to the block a rank keeps: the draws are those of the
    whole tree, so the blocks are those of the unsharded parameters, and
    a rank never holds more than its blocks and one layer's draw."""

    def one(shape, scale, dt, path):
        if torch.device(device).type == "meta":     # shapes only: no draw
            x = torch.empty(shape, dtype=dt, device="meta")
            return x if block is None or path is None else block(path, x)
        x = torch.randn(shape, generator=generator,
                        device=device).mul_(scale).to(dt)
        return x if block is None or path is None else block(path, x)

    def draw(lead, shape, scale, path=None, dt=dtype):
        if not lead:
            return one(shape, scale, dt, path)
        kept = shape
        if block is not None and path is not None:
            kept = block(path, torch.empty(shape, device="meta")).shape
        out = torch.empty(tuple(lead) + tuple(kept), dtype=dt, device=device)
        layers = out.view((-1,) + tuple(kept))
        for i in range(layers.shape[0]):
            layers[i] = one(shape, scale, dt, path)
        return out

    return draw


def _check_family(cfg: ModelConfig) -> None:
    if (cfg.family not in ("dense", "moe", "vlm")
            or (cfg.num_patches and cfg.family != "vlm")
            or (cfg.family == "moe") != bool(cfg.moe.num_experts)):
        raise NotImplementedError(
            f"family {cfg.family!r} is not a transformer-family config")


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                block=None) -> Dict[str, Any]:
    """Random-init parameters from `generator` (N(0, 1/fan_in) weights,
    unit norms), stacked over layers and drawn one layer at a time
    (`drawer`; `block` cuts each to a rank's block). The MoE experts take
    the reference's scales (`_dense` scales by shape[0] ** -0.5: E^-0.5
    for w_gate and w_up, f^-0.5 for w_down, d^-0.5 for the f32 router):
    a whole f32 draw of moonshot's w_gate would be a 35 GB temporary."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    l, d, hd, f = cfg.n_layers, cfg.d_model, cfg.hd, cfg.d_ff
    draw = drawer(generator, device, dtype, block)

    def per_layer(name, shape, scale, dt=dtype):
        return draw((l,), shape, scale, "layers/" + name, dt)

    def ones(shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    layers = {
        "ln1": ones((l, d)),
        "ln2": ones((l, d)),
        "wq": per_layer("wq", (d, cfg.n_heads * hd), d ** -0.5),
        "wk": per_layer("wk", (d, cfg.n_kv_heads * hd), d ** -0.5),
        "wv": per_layer("wv", (d, cfg.n_kv_heads * hd), d ** -0.5),
        "wo": per_layer("wo", (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
    }
    if cfg.moe.num_experts:
        e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff
        layers["router"] = per_layer("router", (d, e), d ** -0.5, torch.float32)
        layers["w_gate"] = per_layer("w_gate", (e, d, fe), e ** -0.5)
        layers["w_up"] = per_layer("w_up", (e, d, fe), e ** -0.5)
        layers["w_down"] = per_layer("w_down", (e, fe, d), fe ** -0.5)
    else:
        layers["w_gate"] = per_layer("w_gate", (d, f), d ** -0.5)
        layers["w_up"] = per_layer("w_up", (d, f), d ** -0.5)
        layers["w_down"] = per_layer("w_down", (f, d), f ** -0.5)
    if cfg.dsa.enabled:
        layers["indexer"] = dsa_mod.indexer_init(
            generator, d, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim, dtype,
            device, layers=l)
    params = {
        "embed": draw((), (cfg.vocab, d), 1.0, "embed"),
        "layers": layers,
        "final_norm": ones((d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = draw((), (d, cfg.vocab), d ** -0.5, "lm_head")
    if cfg.num_patches:
        # the vlm's stubbed patch-embedding projection: `forward_train`
        # reads it, no serve step does
        params["patch_proj"] = draw((), (d, d), d ** -0.5, "patch_proj")
    return params


def param_specs(cfg: ModelConfig, rules: MeshRules) -> Dict[str, Any]:
    """The reference's specs of `init_params`'s tree under `rules`: the
    attention by heads, the SwiGLU by `d_ff`, the experts by expert, the
    embedding and head by vocab, the indexer replicated (`indexer` maps
    to no axis), each falling back to replication where it does not
    divide."""
    d, hd = cfg.d_model, cfg.hd
    sp = rules.spec
    lp = {
        "ln1": P(None), "ln2": P(None),
        "wq": sp("d_model", "heads", sizes=(d, cfg.n_heads * hd)),
        "wk": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
        "wv": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
        "wo": sp("heads", "d_model", sizes=(cfg.n_heads * hd, d)),
    }
    if cfg.moe.num_experts:
        e, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
        lp["router"] = P(None, None)
        lp["w_gate"] = sp("experts", None, None, sizes=(e, d, f))
        lp["w_up"] = sp("experts", None, None, sizes=(e, d, f))
        lp["w_down"] = sp("experts", None, None, sizes=(e, f, d))
    else:
        lp["w_gate"] = sp("d_model", "d_ff", sizes=(d, cfg.d_ff))
        lp["w_up"] = sp("d_model", "d_ff", sizes=(d, cfg.d_ff))
        lp["w_down"] = sp("d_ff", "d_model", sizes=(cfg.d_ff, d))
    if cfg.dsa.enabled:
        lp["indexer"] = {
            "wq": sp("d_model", "indexer",
                     sizes=(d, cfg.dsa.indexer_heads * cfg.dsa.indexer_dim)),
            "wk": P(None, None),
            "w": P(None),
        }
    specs = {
        "embed": sp("vocab", "d_model", sizes=(cfg.vocab, d)),
        "layers": stacked(lp),
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = sp("d_model", "vocab", sizes=(d, cfg.vocab))
    if cfg.num_patches:
        specs["patch_proj"] = P(None, None)
    return specs


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Views of layer i's parameters in the stacked dict."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def unstack_layers(layers: Dict[str, Any], n: int) -> list:
    """The n layers' parameters of a stacked dict, as `layer_params` gives
    them, taken with one `unbind` a leaf: under autograd a leaf's gradient
    is then one stack of its n layers' gradients, where n selects would
    each add a zero-filled copy of the whole leaf."""
    per_leaf = {k: unstack_layers(v, n) if isinstance(v, dict) else v.unbind(0)
                for k, v in layers.items()}
    return [{k: v[i] for k, v in per_leaf.items()} for i in range(n)]


# --------------------------------------------------------------------------
# Train forward
# --------------------------------------------------------------------------

def attention_train(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, lay, *,
                    rope: Optional[dict] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal self-attention of the training path over (B, S, D) normed:
    RoPE (`apply_rotary`'s keywords `rope`, by default the config's:
    M-RoPE for the vlm, half the dims for chatglm) and the blockwise
    attention under `window`. Under a
    mesh (`lay`, a `_layout`) on the rank's heads, or on all of them
    (the projections gathered) where the KV heads do not divide the
    axis; `wo` by rows and a psum. Shared with the hybrid and enc-dec
    families, whose layer dicts hold the same four weights."""
    b, s, _ = x.shape
    hd = cfg.hd
    hl, kvl = lay.heads.hl, lay.heads.kvl
    gather = lay.heads.axis is None
    q, k, v = (lay.pl.cols(x, p[w], lay.layer[w][1], gather=gather, tag=w)
               for w in ("wq", "wk", "wv"))
    if rope is None:
        rope = dict(kind=cfg.rope_kind, base=cfg.rope_base,
                    fraction=cfg.rope_fraction)
    q = apply_rotary(q.reshape(b, s, hl, hd), positions, **rope)
    k = apply_rotary(k.reshape(b, s, kvl, hd), positions, **rope)
    out = blockwise_causal_attention(q, k, v.reshape(b, s, kvl, hd),
                                     scale=hd ** -0.5, window=window)
    return lay.pl.rows_in(out.reshape(b, s, hl * hd).to(x.dtype), p["wo"],
                          lay.layer["wo"][0], local=not gather, tag="wo")


def _train_layer(p, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, lay) -> torch.Tensor:
    x = x + attention_train(p, rms_norm(x, p["ln1"]), cfg, positions, lay,
                            window=cfg.swa_window)
    return x + _mlp(p, rms_norm(x, p["ln2"]), cfg, lay)


def _forward_train(params, tokens, cfg, mesh, rules, patch_embeds, remat):
    """(logits of the rank's rows and vocabulary block, that block's axis
    or None, the layout: a B-row decode step's, whose heads are the
    rank's where the KV heads divide their axis)."""
    _check_family(cfg)
    lay = (_plain_layout(cfg) if mesh is None else
           _layout(cfg, mesh, rules, batch=tokens.shape[0],
                   max_len=tokens.shape[1]))
    tokens = tokens[lay.pl.rows]
    b, s = tokens.shape
    x = lay.pl.embed(params["embed"], lay.embed, tokens)
    if cfg.num_patches and patch_embeds is not None:
        proj = params["patch_proj"]
        dt = torch.promote_types(patch_embeds.dtype, proj.dtype)
        pe = (patch_embeds[lay.pl.rows].to(dt) @ proj.to(dt)).to(x.dtype)
        x = torch.cat([pe, x[:, cfg.num_patches:]], dim=1)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for p in unstack_layers(params["layers"], cfg.n_layers):
        x = remat_call(_train_layer, remat, p, x, positions, cfg, lay)
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (*lay.pl.vocab_logits(x, head, lay.head), lay)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mesh=None, rules: Optional[MeshRules] = None,
                  patch_embeds: Optional[torch.Tensor] = None,
                  remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V) in the parameter dtype, under
    autograd. The vlm's first `num_patches` positions take the stubbed
    patch embeddings through `patch_proj` (promoted as JAX promotes an f32
    input against bf16 weights) in place of the token embeddings.
    `remat` recomputes each layer in the backward pass (the reference's
    `jax.checkpoint`). The indexer weights take no part: their gradient
    is zero, as in the reference.

    Under a `mesh` and its `rules` (params the rank's blocks, tokens the
    global batch) the logits are those of the rank's batch rows and of
    its block of the vocabulary, never gathered: the attention on the
    rank's heads, the SwiGLU by `d_ff`, the MoE through
    `layers.moe_mlp_ep` (capacity drops: not the one-device function),
    the embedding and head by vocabulary (`tensor_parallel`)."""
    return _forward_train(params, tokens, cfg, mesh, rules, patch_embeds,
                          remat)[0]


def loss_fn(params, batch, cfg: ModelConfig, *, mesh=None,
            rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask and, for the vlm, patch_embeds): a 0-dim f32 tensor. Under a
    mesh: this rank's rows' share, their sum over the global mask sum
    (`parallel/sharding.py`'s loss convention)."""
    logits, vocab, lay = _forward_train(
        params, batch["tokens"], cfg, mesh, rules, batch.get("patch_embeds"),
        True)
    return train_loss(logits, vocab, lay, batch)


def train_loss(logits, vocab, lay, batch) -> torch.Tensor:
    """`layers.cross_entropy` of the rank's rows of `batch` (every
    family's `loss_fn` tail, under a mesh or not)."""
    rows = {k: batch[k][lay.pl.rows] for k in ("targets", "mask")
            if k in batch}
    return cross_entropy(logits, rows, vocab=vocab,
                         batch_sum=None if lay.pl.mesh is None
                         else lay.pl.batch_sum)


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


def state_specs(cfg: ModelConfig, rules: MeshRules, *, batch: int,
                max_len: int, seq_sharded: bool = False) -> Dict[str, Any]:
    """The reference's specs of `init_decode_state`'s leaves: the caches
    by batch (and KV head), over the sequence too under `seq_sharded`."""
    seq_ax = "seq_shard" if seq_sharded else None
    sp = rules.spec
    cache = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    specs = {
        "k": sp(None, "batch", seq_ax, "kv_heads", None, sizes=cache),
        "v": sp(None, "batch", seq_ax, "kv_heads", None, sizes=cache),
        "length": P(None),
    }
    if cfg.dsa.enabled:
        specs["idx_k"] = sp(None, "batch", seq_ax, None,
                            sizes=cache[:3] + (cfg.dsa.indexer_dim,))
        specs["prev_topk"] = sp(None, "batch", None,
                                sizes=(cfg.n_layers, batch,
                                       min(cfg.dsa.k, max_len)))
        specs["topk_valid"] = sp(None, "batch", sizes=(cfg.n_layers, batch))
        specs["sel_gvr"] = sp(None, "batch", sizes=(cfg.n_layers, batch))
    return specs


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


def paged_state_specs(cfg: ModelConfig, rules: MeshRules, *, batch: int,
                      max_len: int, num_pages: int,
                      page_size: int) -> Dict[str, Any]:
    """The specs of `init_paged_decode_state`'s leaves under `rules`, the
    placement XLA gives the reference's paged state: the K/V pools by KV
    head over the dense cache's entry (`state_specs(...)["k"][3]`) and
    replicated over the batch axes (pools are global: a shared-prefix
    page may be read by slots on any data rank); the indexer-K pool, the
    block table and `length` replicated; the feedback leaves by batch,
    as `state_specs` has them."""
    dense = state_specs(cfg, rules, batch=batch, max_len=max_len)
    specs = {
        "k_pages": P(None, None, None, dense["k"][3], None),
        "v_pages": P(None, None, None, dense["v"][3], None),
        "page_table": P(None, None),
        "length": P(None),
    }
    if cfg.dsa.enabled:
        specs["idx_k_pages"] = P(None, None, None, None)
        for key in ("prev_topk", "topk_valid", "sel_gvr"):
            specs[key] = dense[key]
    return specs


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

class _Layout(NamedTuple):
    """Where a decode step's arrays live on this rank (`tensor_parallel`):
    its placement, its heads, one layer's parameter specs and the vocab
    entries of the embedding and the output head. `_layout(cfg)`, with
    no mesh, is the identity: all heads, every entry None."""
    pl: Placement
    heads: Heads
    layer: Dict[str, Any]
    embed: Any
    head: Any


@functools.lru_cache(maxsize=None)
def _plain_layout(cfg: ModelConfig) -> _Layout:
    return _layout(cfg, None, NO_MESH)


def _layout(cfg: ModelConfig, mesh=None, rules: Optional[MeshRules] = None, *,
            batch: int = 0, max_len: int = 0) -> _Layout:
    """The layout of a step of `batch` rows over caches of `max_len` on
    this rank of `mesh` under `rules` (`param_specs`, `state_specs`)."""
    if mesh is None and rules is None:
        return _plain_layout(cfg)
    psp = param_specs(cfg, rules)
    lsp = unstacked(psp["layers"])
    heads = heads_of(cfg, state_specs(cfg, rules, batch=batch,
                                      max_len=max_len)["k"][3], mesh)
    if heads.axis is not None and any(
            axis_of(mesh, lsp[w][c]) is not heads.axis
            for w, c in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0))):
        raise NotImplementedError("the cache's KV heads and the attention "
                                  "weights are sharded over different axes")
    if (mesh is not None and cfg.moe.num_experts
            and axis_of(mesh, lsp["w_gate"][0]) is None):
        raise ValueError(f"{cfg.moe.num_experts} experts do not divide "
                         f"the expert axis of {mesh.shape}")
    head = psp["embed"][0] if cfg.tie_embeddings else psp["lm_head"][1]
    return _Layout(Placement(mesh, rules, batch), heads, lsp, psp["embed"][0],
                   head)


def _project_qkv(p, h, b, positions, cfg: ModelConfig, lay=None):
    """Decode projections + RoPE. h: (B, D) normed input. Returns q
    (B,H,HD), kn (B,KVH,HD), vn (B,KVH,HD) at the layout's head counts:
    its own heads where they are sharded, else all of them (the
    column-sharded projections gathered)."""
    lay = lay or _plain_layout(cfg)
    hd = cfg.hd
    q, kn, vn = (lay.pl.cols(h, p[w], lay.layer[w][1],
                             gather=lay.heads.axis is None, tag=w)
                 for w in ("wq", "wk", "wv"))
    pos = positions[:, None]
    rope = dict(kind=cfg.rope_kind, base=cfg.rope_base,
                fraction=cfg.rope_fraction)
    q = apply_rotary(q.reshape(b, 1, lay.heads.hl, hd), pos, **rope)[:, 0]
    kn = apply_rotary(kn.reshape(b, 1, lay.heads.kvl, hd), pos, **rope)[:, 0]
    return q, kn, vn.reshape(b, lay.heads.kvl, hd)


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


def _mlp(p, h: torch.Tensor, cfg: ModelConfig, lay=None) -> torch.Tensor:
    """Layer p's feed-forward: SwiGLU, or the MoE. h is (B, D), one token
    per row, which the MoE takes in the reference's (B, 1, D) call shape,
    or the training path's (B, S, D). Under a mesh (`lay`) the SwiGLU runs
    by `d_ff` and the MoE through `layers.moe_mlp_ep`; with none, that is
    the dense fallback, as in the reference."""
    lay = lay or _plain_layout(cfg)
    if cfg.moe.num_experts:
        return moe_mlp_ep(
            h.reshape(h.shape[0], -1, h.shape[-1]), p["router"], p["w_gate"],
            p["w_up"], p["w_down"], top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, mesh=lay.pl.mesh,
            expert_axis=lay.layer["w_gate"][0]).reshape(h.shape)
    return lay.pl.swiglu(h, p["w_gate"], p["w_up"], p["w_down"],
                         lay.layer["w_down"][0])


def _lm_head(params, x: torch.Tensor, cfg: ModelConfig,
             lay=None) -> torch.Tensor:
    """Final norm and the (tied) output projection: f32 logits (..., V),
    those of the whole vocab under a mesh (gathered). The one GEMM whose
    rounding on the CPU depends on the row count M (the tied head is a
    transposed view): the mq verify body runs it at M = B*(d+1), the
    per-token step at M = B."""
    lay = lay or _plain_layout(cfg)
    x = rms_norm(x, params["final_norm"])
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return lay.pl.logits(x, head, lay.head)


def _decode_layers(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                   attend, lay=None):
    """The layer loop shared by every layout and by the mesh step.
    `attend(i, p, h, q, kn, vn)` writes layer i's new rows and returns
    (attn, DSA output or None). Under a mesh (`lay`) tokens are the global
    batch and the step runs on the rank's rows, heads and blocks. Returns
    (logits (B, V) f32 of the rank's rows, new_state; `length` stays
    global)."""
    _check_family(cfg)
    lay = lay or _plain_layout(cfg)
    positions = state["length"][lay.pl.rows]
    b = positions.shape[0]
    x = lay.pl.embed(params["embed"], lay.embed, tokens[lay.pl.rows])  # (B, D)
    prev_out, sel_out = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        h = rms_norm(x, p["ln1"])
        q, kn, vn = _project_qkv(p, h, b, positions, cfg, lay)
        attn, res = attend(i, p, h, q, kn, vn)
        if res is not None:
            prev_out.append(res.topk_idx.int())
            sel_out.append(res.gvr_rows)
        attn = attn.reshape(b, lay.heads.hl * cfg.hd).to(x.dtype)
        x = x + lay.pl.rows_in(attn, p["wo"], lay.layer["wo"][0],
                               local=lay.heads.axis is not None, tag="wo")
        x = x + _mlp(p, rms_norm(x, p["ln2"]), cfg, lay)

    new_state = dict(state)
    if prev_out:
        new_state["prev_topk"] = torch.stack(prev_out)
        new_state["topk_valid"] = torch.ones_like(state["topk_valid"])
        new_state["sel_gvr"] = torch.stack(sel_out)
    elif cfg.dsa.enabled:
        new_state["sel_gvr"] = torch.zeros_like(state["sel_gvr"])
    new_state["length"] = state["length"] + 1

    return _lm_head(params, x, cfg, lay), new_state


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
               min_write_pos: Optional[torch.Tensor] = None, mesh=None,
               rules: Optional[MeshRules] = None):
    """One decode step over the dense layout. tokens: (B,) int. Returns
    (logits (B, V) f32, new_state).

    The new token's rows are written in place at position `length` of each
    slot's caches, clamped to N-1 as JAX's `dynamic_update_slice` clamps
    it. A row whose position is below `min_write_pos` (B,) keeps its old
    contents: the engine masks inactive slots so, where the reference
    writes every row and restores the inactive ones afterwards.

    Under a `mesh` and its `rules` the step runs on one rank, the
    reference's decode cell placed by `param_specs` and `state_specs` as
    `tensor_parallel` sets out: params and state are the rank's blocks,
    tokens the global batch, and the logits those of the rank's rows. Per
    layer the rank's heads of q/k/v (or all of them, gathered), its cache
    rows written, DSA (B5 -> B1 -> B6 on the card) over its batch rows
    with the replicated indexer, `wo` by rows and a psum; the SwiGLU by
    `d_ff` and a psum, or the experts through `layers.moe_mlp_ep`.
    """
    if mesh is not None and min_write_pos is not None:
        raise ValueError("the mesh step writes every row: the reference "
                         "takes no min_write_pos there")
    n = state["k"].shape[2]
    lay = _layout(cfg, mesh, rules, batch=tokens.shape[0], max_len=n)
    positions = state["length"][lay.pl.rows]
    new_len = positions + 1
    b = positions.shape[0]
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

    return _decode_layers(params, state, tokens, cfg, attend, lay)


def check_paged_options(paged_attn: str, gather_granularity: str) -> None:
    """Raise ValueError unless both options name a form `serve_step_paged`
    serves."""
    if paged_attn not in ("fused", "gather"):
        raise ValueError(f"unknown paged_attn {paged_attn!r} "
                         f"(expected 'fused' or 'gather')")
    if gather_granularity not in ("token", "page"):
        raise ValueError(f"unknown gather_granularity {gather_granularity!r} "
                         f"(expected 'token' or 'page')")


def _paged_dest(table: torch.Tensor, positions: torch.Tensor,
                writable: torch.Tensor, page_size: int, sink: int):
    """(page, offset) each row's token at `positions` (B,) or (B, Q)
    writes: its mapped page where `writable` allows the write, else the
    sink page."""
    mp = table.shape[1]
    lp = (positions // page_size).long()
    phys = table.gather(1, lp.clamp(0, mp - 1).reshape(table.shape[0], -1))
    phys = phys.reshape(positions.shape)
    writable = writable & (phys >= 0) & (lp < mp)
    dest = torch.where(writable, phys, torch.full_like(phys, sink)).long()
    return dest, (positions % page_size).long()


def _write_rows(lay: _Layout, dest, off, writes) -> None:
    """Scatter new rows into the pools in place: `writes` pairs a pool
    (P+1, ps, ...) with the rank's rows (B_l, ...) of what it takes at
    (`dest`, `off`), both of the global batch. Under a mesh whose batch
    rows are sharded the pools are replicated over the batch axes, so
    the rows are all-gathered there first (one call, billed
    "paged_write") and every rank scatters every row."""
    news = [new.to(pool.dtype) for pool, new in writes]
    if lay.pl.mesh is not None and lay.pl.batch_axes is not None:
        b = news[0].shape[0]
        flat = lay.pl.batch_gather(
            torch.cat([x.reshape(b, -1) for x in news], 1), "paged_write")
        sizes = [x[0].numel() for x in news]
        news = [part.reshape((flat.shape[0],) + x.shape[1:]) for part, x
                in zip(flat.split(sizes, 1), news)]
    for (pool, _), new in zip(writes, news):
        pool[dest, off] = new


def serve_step_paged(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
                     min_write_pos: Optional[torch.Tensor] = None,
                     paged_attn: str = "fused",
                     gather_granularity: str = "token", mesh=None,
                     rules: Optional[MeshRules] = None):
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

    Under a `mesh` and its `rules` the step runs on one rank, its state
    placed by `paged_state_specs` (`bridge.shard_tree`): tokens, `length`,
    the block table and `min_write_pos` are global, the logits and the
    feedback leaves the rank's rows. Each rank projects its rows at its
    heads (as `serve_step`'s mesh form), all-gathers the new K/V and
    indexer-K rows over the batch axes and writes every row into its
    pools (`_write_rows`), then selects and attends on its rows through
    their block-table rows at its heads: B2 -> B1 -> B3 (B10 at page
    granularity), B7 then B5 -> B1 -> B6 for "gather", B4 below the DSA
    gate.
    """
    check_paged_options(paged_attn, gather_granularity)
    table = state["page_table"]
    page_size = state["k_pages"].shape[2]
    sink = state["k_pages"].shape[1] - 1
    n = table.shape[1] * page_size
    lay = _layout(cfg, mesh, rules, batch=tokens.shape[0], max_len=n)
    rows = lay.pl.rows
    writable = torch.ones_like(state["length"], dtype=torch.bool)
    if min_write_pos is not None:
        writable = state["length"] >= min_write_pos
    dest, off = _paged_dest(table, state["length"], writable, page_size, sink)
    positions = state["length"][rows]
    new_len = positions + 1
    table = table[rows]
    use_dsa = cfg.dsa.enabled and n > cfg.dsa.min_n

    def attend(i, p, h, q, kn, vn):
        kp, vp = state["k_pages"][i], state["v_pages"][i]
        writes = [(kp, kn), (vp, vn)]
        idx_kp = None
        if use_dsa:
            idx_kp = state["idx_k_pages"][i]
            writes.append((idx_kp, dsa_mod.indexer_k(
                p["indexer"], h, positions, dim=cfg.dsa.indexer_dim,
                rope_base=cfg.rope_base)))
        _write_rows(lay, dest, off, writes)
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

    return _decode_layers(params, state, tokens, cfg, attend, lay)


# --------------------------------------------------------------------------
# Speculative verify step: draft, verify, roll back (paged layout)
# --------------------------------------------------------------------------
#
# One verify tick scores all d+1 positions of each slot: position j writes
# its K/V at `length + j` and attends with causal extent `length + j + 1`,
# so every position reproduces the non-speculative step it stands in for.
# The GVR feedback is extended inside the tick: position j's Top-K
# warm-starts position j+1. Greedy acceptance and the rollback of the
# per-slot leaves (length, prev_topk, topk_valid, sel_gvr) to the accepted
# position happen on the device; rows written by rejected positions need no
# clearing (every consumer masks beyond `length`), and the host rewinds the
# block table (`PagedAdmissionCore.rewind_slot`).


def _spec_verify_scan(step_fn: Callable, state, tokens: torch.Tensor,
                      draft_len: torch.Tensor, max_accept: torch.Tensor,
                      eos_id: int, base_mwp: torch.Tensor,
                      axes: Dict[str, int], dsa_enabled: bool,
                      pl: Optional[Placement] = None):
    """The scan verify body: d+1 single-token paged steps, one per
    position. step_fn(state, tok (B,), mwp (B,)) -> (logits (B, V),
    new_state). tokens (B, D+1): column 0 is the last emitted token,
    columns 1..D the draft; a row verifies positions 0..draft_len, and a
    frozen position (j > draft_len) keeps the row's state and writes the
    sink page. The pools are written in place and never merged: only the
    per-slot leaves of `axes` take the frozen rows' old values. Under a
    mesh (`pl`) the feedback leaves and the logits are the rank's rows,
    everything else global. Returns `_spec_accept_rollback`'s 5-tuple."""
    pl = pl or Placement()
    d1 = tokens.shape[1]
    length0 = state["length"]
    never = torch.full_like(base_mwp, PAGED_NEVER_WRITE)
    keys = _FEEDBACK if dsa_enabled else ()
    ys = {"logits": [], **{k: [] for k in keys}}
    st = state
    for j in range(d1):
        live = j <= draft_len                              # (B,)
        logits, st2 = step_fn(st, tokens[:, j].contiguous(),
                              torch.where(live, base_mwp, never))
        merged = {}
        for key, arr in st2.items():
            ax = axes.get(key)
            if ax is None:             # pool-global: frozen rows wrote the sink
                merged[key] = arr
                continue
            shape = [1] * arr.dim()
            shape[ax] = arr.shape[ax]
            rows = live[pl.rows] if key in _FEEDBACK else live
            merged[key] = torch.where(rows.reshape(shape), arr, st[key])
        ys["logits"].append(logits)
        for key in keys:
            # raw per-position entries: entry j is only read for rows whose
            # position j ran (accept_len <= draft_len)
            ys[key].append(st2[key])
        st = merged
    ys = {key: torch.stack(v) for key, v in ys.items()}
    return _spec_accept_rollback(length0, st, ys, tokens, draft_len,
                                 max_accept, eos_id, dsa_enabled, pl)


def _spec_accept_rollback(length0: torch.Tensor, end_state, ys,
                          tokens: torch.Tensor, draft_len: torch.Tensor,
                          max_accept: torch.Tensor, eos_id: int,
                          dsa_enabled: bool, pl: Optional[Placement] = None):
    """Greedy acceptance and exact rollback from the per-position stacks,
    shared by both verify bodies: ys["logits"] (D+1, B, V) and, with DSA
    state, "prev_topk" (D+1, L, B, K), "topk_valid" / "sel_gvr" (D+1, L, B).
    Draft token j is accepted iff it equals position j-1's argmax, j <=
    draft_len and every earlier draft was accepted; acceptance is capped by
    `max_accept` and stops at (and includes) the first eos argmax.

    Under a mesh (`pl`) the stacks hold the rank's rows and so do the
    outputs; the accept lengths are all-gathered over the batch axes
    (billed "accept") for the global `length`.

    Returns (out_tokens (B, D+1) int32 — position j's argmax, accept_len
    (B,) int32, logits (B, D+1, V) f32, sel_gvr_pos (B, D+1) bool — layer
    0's GVR path per position, new_state with length L0 + a + 1 and the
    feedback leaves of position a)."""
    pl = pl or Placement()
    tokens, draft_len = tokens[pl.rows], draft_len[pl.rows]
    max_accept = max_accept[pl.rows]
    b, d1 = tokens.shape
    dev = tokens.device
    logits_all = ys["logits"]
    argmax_all = logits_all.argmax(-1).int()               # (D+1, B)
    if d1 > 1:
        pos = torch.arange(1, d1, dtype=torch.int32, device=dev)
        match = ((tokens[:, 1:].T == argmax_all[:-1])
                 & (pos[:, None] <= draft_len[None, :]))
        raw = torch.cumprod(match.int(), dim=0).sum(0).int()
    else:
        raw = torch.zeros((b,), dtype=torch.int32, device=dev)
    a = torch.minimum(raw, max_accept.clamp(min=0))
    is_eos = argmax_all == eos_id                          # (D+1, B)
    first_eos = is_eos.int().argmax(0).int()
    a = torch.where(is_eos.any(0), torch.minimum(a, first_eos), a)

    new_state = dict(end_state)
    new_state["length"] = length0 + pl.batch_gather(a, "accept") + 1
    if dsa_enabled:
        al = a.long()
        pt = ys["prev_topk"]
        new_state["prev_topk"] = pt.gather(
            0, al[None, None, :, None].expand((1,) + pt.shape[1:]))[0]
        for key in ("topk_valid", "sel_gvr"):
            stk = ys[key]
            new_state[key] = stk.gather(
                0, al[None, None, :].expand((1,) + stk.shape[1:]))[0]
        sel_pos = ys["sel_gvr"][:, 0, :].T                 # layer 0
    else:
        sel_pos = torch.zeros((b, d1), dtype=torch.bool, device=dev)
    return (argmax_all.T, a, logits_all.transpose(0, 1), sel_pos, new_state)


def _paged_verify_mq(params, state, tokens: torch.Tensor, cfg: ModelConfig,
                     *, draft_len: torch.Tensor, base_mwp: torch.Tensor,
                     paged_attn: str, gather_granularity: str, lay: _Layout):
    """The mq verify body: one forward of all (B, d+1) positions. Per
    layer every position's K/V/indexer-K rows are written first (position
    j at L0 + j; frozen and masked rows to the sink page), then selection
    runs as a chain over the positions (row 0 warm from the incoming
    feedback, row j+1 from row j) and attention covers all (B, Q)
    selections at once.

    The forms: fused selects with kernel B9 and attends with B8 (B10 over
    the folded rows at page granularity); gather builds the logical views
    (B7), selects row by row over them (B5 + B1) and attends over the
    views repeated Q times (B6). Below the DSA gate both attend densely
    over the folded rows (B4 with the table repeated, or the plain
    attention over the repeated views).

    Under a mesh (`lay`) the body runs on the rank's rows and heads as
    the mesh paged step does: the embedding, projections, `wo`, the
    feed-forward and the head through the placement, every position's new
    rows gathered over the batch axes before the write (`_write_rows`).

    Position j's consumers all mask beyond its own extent L0 + j + 1, so
    the rows later positions have already written are invisible to it, and
    each position computes what the scan computes. Frozen positions compute
    garbage whose stack entries are never selected. Returns (ys, state) in
    the scan's stack format, for `_spec_accept_rollback`."""
    d1 = tokens.shape[1]
    hd, hl, kvl = cfg.hd, lay.heads.hl, lay.heads.kvl
    rows = lay.pl.rows
    table = state["page_table"]
    page_size = state["k_pages"].shape[2]
    sink = state["k_pages"].shape[1] - 1
    n = table.shape[1] * page_size
    use_dsa = cfg.dsa.enabled and n > cfg.dsa.min_n
    fused = paged_attn == "fused"
    dev = tokens.device

    jj = torch.arange(d1, dtype=torch.int32, device=dev)
    positions = state["length"][:, None] + jj[None, :]     # (B, Q) global
    live = ((jj[None, :] <= draft_len[:, None])
            & (positions >= base_mwp[:, None]))
    dest, off = _paged_dest(table, positions, live, page_size, sink)
    positions, table = positions[rows], table[rows]        # the rank's rows
    b = positions.shape[0]
    lengths_q = positions + 1                              # causal extents
    flat_pos = positions.reshape(b * d1)

    def repeat(x):
        return x.repeat_interleave(d1, dim=0)

    x = lay.pl.embed(params["embed"], lay.embed, tokens[rows])  # (B, Q, D)
    sel_idx, sel_gvr = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        kp, vp = state["k_pages"][i], state["v_pages"][i]
        h = rms_norm(x, p["ln1"])
        hf = h.reshape(b * d1, -1)
        q, kn, vn = _project_qkv(p, hf, b * d1, flat_pos, cfg, lay)
        q = q.reshape(b, d1, hl, hd)
        # every position writes before anything attends (see docstring)
        writes = [(kp, kn.reshape(b, d1, kvl, hd)),
                  (vp, vn.reshape(b, d1, kvl, hd))]
        if use_dsa:
            idx_kp = state["idx_k_pages"][i]
            writes.append((idx_kp, dsa_mod.indexer_k(
                p["indexer"], hf, flat_pos, dim=cfg.dsa.indexer_dim,
                rope_base=cfg.rope_base).reshape(b, d1, -1)))
        _write_rows(lay, dest, off, writes)
        if use_dsa:
            kw = _dsa_kw(cfg, state, i)
            kw.pop("scale")
            prev = state["prev_topk"][i]
            if fused:
                sel = dsa_mod.dsa_select_paged_mq(
                    p["indexer"], h, idx_kp, table, prev, lengths_q, **kw)
                idx_q, gvr_q = sel.indices, sel.gvr_rows
                attn = dsa_mod.dsa_sparse_attention_paged_mq(
                    q, kp, vp, table, idx_q, lengths_q, scale=hd ** -0.5,
                    granularity=gather_granularity)
            else:
                idx_kc = ops.paged_gather(idx_kp, table)
                valid = kw.pop("prev_valid")
                sels, gvrs = [], []
                for j in range(d1):
                    sel = dsa_mod.dsa_select(p["indexer"], h[:, j], idx_kc,
                                             prev, lengths_q[:, j],
                                             prev_valid=valid, **kw)
                    sels.append(sel.indices)
                    gvrs.append(sel.gvr_rows)
                    prev = sel.indices
                    valid = None if valid is None else torch.ones_like(valid)
                idx_q, gvr_q = torch.stack(sels, 1), torch.stack(gvrs, 1)
                kc = repeat(ops.paged_gather(kp, table))
                vc = repeat(ops.paged_gather(vp, table))
                attn = dsa_mod.dsa_sparse_attention(
                    q.reshape(b * d1, hl, hd), kc, vc,
                    idx_q.reshape(b * d1, -1), lengths_q.reshape(b * d1),
                    scale=hd ** -0.5)
            sel_idx.append(idx_q.int())                    # (B, Q, K)
            sel_gvr.append(gvr_q)                          # (B, Q)
        else:
            qf = q.reshape(b * d1, hl, hd)
            lf = lengths_q.reshape(b * d1)
            if fused:
                attn = decode_attention_paged(qf, kp, vp,
                                              repeat(table).contiguous(), lf,
                                              scale=hd ** -0.5,
                                              window=cfg.swa_window)
            else:
                attn = decode_attention(qf, repeat(ops.paged_gather(kp, table)),
                                        repeat(ops.paged_gather(vp, table)),
                                        lf, scale=hd ** -0.5,
                                        window=cfg.swa_window)
        attn = attn.reshape(b, d1, hl * hd).to(x.dtype)
        x = x + lay.pl.rows_in(attn, p["wo"], lay.layer["wo"][0],
                               local=lay.heads.axis is not None, tag="wo")
        h2 = rms_norm(x, p["ln2"])
        if cfg.moe.num_experts:
            # one call per position, as the scan makes it (see the header)
            x = x + torch.stack([_mlp(p, h2[:, j], cfg, lay)
                                 for j in range(d1)], 1)
        else:
            x = x + _mlp(p, h2, cfg, lay)

    logits = _lm_head(params, x, cfg, lay)                 # (B, Q, V)
    ys = {"logits": logits.transpose(0, 1)}                # (Q, B, V)
    if cfg.dsa.enabled:
        if sel_idx:
            ys["prev_topk"] = torch.stack(sel_idx).permute(2, 0, 1, 3)
            ys["topk_valid"] = torch.ones(
                (d1,) + state["topk_valid"].shape, dtype=torch.bool,
                device=dev)
            ys["sel_gvr"] = torch.stack(sel_gvr).permute(2, 0, 1)
        else:
            # below the gate the scan stacks the incoming feedback as is
            ys["prev_topk"] = state["prev_topk"][None].expand(
                (d1,) + state["prev_topk"].shape)
            ys["topk_valid"] = state["topk_valid"][None].expand(
                (d1,) + state["topk_valid"].shape)
            ys["sel_gvr"] = torch.zeros((d1,) + state["sel_gvr"].shape,
                                        dtype=torch.bool, device=dev)
    return ys, dict(state)


def serve_step_spec_paged(params, state, tokens: torch.Tensor,
                          cfg: ModelConfig, *, draft_len, max_accept,
                          eos_id: int = -1,
                          min_write_pos: Optional[torch.Tensor] = None,
                          paged_attn: str = "fused",
                          verify_kernel: str = "scan",
                          gather_granularity: str = "token", mesh=None,
                          rules: Optional[MeshRules] = None):
    """Speculative verify tick over the paged layout: score all d+1 draft
    positions, accept the longest greedy-matching prefix and roll the
    per-slot state back to it on the device. tokens (B, D+1) int; draft_len
    (B,) in [0, D]; max_accept (B,) caps the accepted drafts; eos_id
    truncates acceptance at the first eos argmax (-1: none); min_write_pos
    (B,) masks rows' writes as in `serve_step_paged`.

    `verify_kernel` picks the body, both ending in the same acceptance
    arithmetic: "scan" — d+1 `serve_step_paged` calls, each position
    exactly the non-speculative step; "mq" — one forward of the (B, d+1)
    rows (`_paged_verify_mq`). The pools are written in place.

    Under a `mesh` and its `rules` the tick runs on one rank as
    `serve_step_paged` does (its state placed by `paged_state_specs`):
    tokens, draft_len, max_accept and min_write_pos are global, the
    outputs but the state the rank's rows, and the new `length` global.

    Returns (out_tokens (B, D+1), accept_len (B,), logits (B, D+1, V),
    sel_gvr_pos (B, D+1), new_state)."""
    check_paged_options(paged_attn, gather_granularity)
    if verify_kernel not in ("scan", "mq"):
        raise ValueError(f"unknown verify_kernel {verify_kernel!r} "
                         f"(expected 'scan' or 'mq')")
    b = tokens.shape[0]
    dev = tokens.device
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    draft_len = torch.as_tensor(draft_len, dtype=torch.int32, device=dev)
    max_accept = torch.as_tensor(max_accept, dtype=torch.int32, device=dev)
    base_mwp = (min_write_pos if min_write_pos is not None
                else torch.zeros((b,), dtype=torch.int32, device=dev))
    lay = _layout(cfg, mesh, rules, batch=b, max_len=(
        state["page_table"].shape[1] * state["k_pages"].shape[2]))
    if verify_kernel == "mq":
        ys, end_state = _paged_verify_mq(
            params, state, tokens, cfg, draft_len=draft_len,
            base_mwp=base_mwp, paged_attn=paged_attn,
            gather_granularity=gather_granularity, lay=lay)
        return _spec_accept_rollback(state["length"], end_state, ys, tokens,
                                     draft_len, max_accept, int(eos_id),
                                     cfg.dsa.enabled, lay.pl)

    def step_fn(st, tok, mwp):
        return serve_step_paged(params, st, tok, cfg, min_write_pos=mwp,
                                paged_attn=paged_attn,
                                gather_granularity=gather_granularity,
                                mesh=mesh, rules=rules)

    return _spec_verify_scan(step_fn, state, tokens, draft_len, max_accept,
                             int(eos_id), base_mwp,
                             paged_state_batch_axes(cfg), cfg.dsa.enabled,
                             lay.pl)


# --------------------------------------------------------------------------
# Sequence-sharded paged decode: the SP-GVR serving path
# --------------------------------------------------------------------------
#
# For contexts no single device holds, the page pools shard over the S ranks
# of a sequence mesh (`launch.make_seq_mesh`): rank s owns the pages whose
# LOGICAL token range falls in [s·N/S, (s+1)·N/S), in its own pool of
# `num_pages_per_shard` pages plus its own write-sink page, and the block
# table (the same on every rank) stores SHARD-LOCAL page ids — the logical
# page index names the owner. The state keeps the reference's leaves and
# axis order; a rank's pools carry extent 1 on the shard axis, so the
# ranks' pools concatenated along axis 1 are the reference's
# (L, S, PPL+1, ...) arrays. Everything the feedback loop touches —
# prev_topk, topk_valid, sel_gvr, length — stays in GLOBAL logical token
# space and is the same on every rank, as are the parameters and logits.
# Selection runs through SP-GVR's O(1)-collective schedule and attention
# assembles exactly the K selected rows with one O(K) psum
# (`sparse/sp_dsa.py`), so the step is bit-identical to
# `serve_step_paged(paged_attn="fused")` over the same logical content.


def init_sp_paged_decode_state(cfg: ModelConfig, batch: int, max_len: int, *,
                               num_pages_per_shard: int, page_size: int,
                               seq_shards: int, device,
                               dtype=None) -> Dict[str, torch.Tensor]:
    """One rank's sequence-sharded paged state: the paged state of
    `num_pages_per_shard` pages with the pools' shard axis (extent 1:
    this rank's shard, its last page the rank's write sink) and the
    replicated block table of shard-local ids. `max_len` must split into
    `seq_shards` page-aligned spans."""
    if max_len % (page_size * seq_shards) != 0:
        raise ValueError(
            f"max_len ({max_len}) must be a multiple of page_size × "
            f"seq_shards ({page_size}×{seq_shards}) — shard token spans "
            f"must be page-aligned for whole-page ownership")
    state = init_paged_decode_state(cfg, batch, max_len,
                                    num_pages=num_pages_per_shard,
                                    page_size=page_size, device=device,
                                    dtype=dtype)
    for key in ("k_pages", "v_pages", "idx_k_pages"):
        if key in state:
            state[key] = state[key][:, None]
    return state


def sp_paged_state_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """Slot axis of each per-slot leaf of the sharded paged state: the
    single-device paged map (the sharded pools are pool-global per rank)."""
    return paged_state_batch_axes(cfg)


def _sp_paged_validate(state, cfg: ModelConfig, mesh) -> None:
    """Entry validation shared by both sequence-sharded paged steps."""
    page_size = state["k_pages"].shape[3]
    mp = state["page_table"].shape[1]
    if mp % mesh.size != 0:
        raise ValueError(f"logical pages ({mp}) must divide over "
                         f"{mesh.size} shards")
    if not (cfg.dsa.enabled and mp * page_size > cfg.dsa.min_n):
        raise ValueError(
            "sequence-sharded paged decode requires the DSA gate open "
            f"(dsa.enabled and max_len > dsa.min_n={cfg.dsa.min_n}): the "
            "sequence-sharded path has no dense fallback attention")
    if state["k_pages"].shape[1] != 1:
        raise ValueError(
            f"a rank's state holds its own shard of the page pools (extent "
            f"1 on axis 1), got {state['k_pages'].shape[1]}")


def _sp_layout(state, mesh):
    """This rank's view of the block table: (table_local (B, MP/S) of
    local ids, shard_offset, n_local, page_size, sink page id)."""
    page_size = state["k_pages"].shape[3]
    mp_local = state["page_table"].shape[1] // mesh.size
    table_local = state["page_table"][
        :, mesh.rank * mp_local:(mesh.rank + 1) * mp_local].contiguous()
    n_local = mp_local * page_size
    return (table_local, mesh.rank * n_local, n_local, page_size,
            state["k_pages"].shape[2] - 1)


def _sp_dest(table_local, positions, live_mwp, shard_offset: int,
             n_local: int, page_size: int, sink: int):
    """(page, offset) each row writes on this rank: its page where this
    rank owns the position, the page is mapped and `live_mwp` allows the
    write; else the rank's sink page."""
    owner = (positions >= shard_offset) & (positions < shard_offset + n_local)
    rel = (positions - shard_offset).clamp(0, n_local - 1)
    phys = table_local.gather(-1, (rel // page_size).long())
    writable = owner & (phys >= 0) & live_mwp
    dest = torch.where(writable, phys, torch.full_like(phys, sink)).long()
    return dest, (positions % page_size).long()


def _sp_select_attend(p, cfg: ModelConfig, state, i: int, q, h, kp, vp,
                      idx_kp, table_local, prev, valid, lengths, mesh,
                      shard_offset: int, page_size: int):
    """Layer i's sharded DSA for one query row per slot, as a `DSAOutput`."""
    res = sp_dsa_mod.sp_dsa_decode_paged_local(
        q, kp, vp, table_local, p["indexer"], h, idx_kp, prev, valid,
        lengths, k=state["prev_topk"].shape[-1], scale=cfg.hd ** -0.5,
        heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
        rope_base=cfg.rope_base, shard_offset=shard_offset,
        page_size=page_size, max_candidates=cfg.dsa.max_candidates,
        swa_window=cfg.swa_window, mesh=mesh)
    return dsa_mod.DSAOutput(res.attn_out, res.new_topk, res.secant_iters,
                             res.gvr_rows)


def _sp_paged_token_body(params, state, tokens: torch.Tensor,
                         mwp: torch.Tensor, cfg: ModelConfig, *, mesh):
    """One rank's part of ONE sequence-sharded paged decode step (the
    speculative scan calls it once per position). The rank owning
    position `length` writes the new rows into its pools in place; every
    other rank, and every row masked by `mwp`, writes its own sink page.
    Returns (logits, new_state), the same on every rank but the pools."""
    table_local, so, n_local, ps, sink = _sp_layout(state, mesh)
    positions = state["length"]
    new_len = positions + 1
    dest, off = _sp_dest(table_local, positions[:, None],
                         (positions >= mwp)[:, None], so, n_local, ps, sink)
    dest, off = dest[:, 0], off[:, 0]
    valid = state.get("topk_valid")

    def attend(i, p, h, q, kn, vn):
        kp, vp = state["k_pages"][i, 0], state["v_pages"][i, 0]
        idx_kp = state["idx_k_pages"][i, 0]
        kp[dest, off] = kn.to(kp.dtype)
        vp[dest, off] = vn.to(vp.dtype)
        ik = dsa_mod.indexer_k(p["indexer"], h, positions,
                               dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base)
        idx_kp[dest, off] = ik.to(idx_kp.dtype)
        res = _sp_select_attend(p, cfg, state, i, q, h, kp, vp, idx_kp,
                                table_local, state["prev_topk"][i],
                                None if valid is None else valid[i], new_len,
                                mesh, so, ps)
        return res.attn_out, res

    return _decode_layers(params, state, tokens, cfg, attend)


def serve_step_sp_paged(params, state, tokens: torch.Tensor,
                        cfg: ModelConfig, *, mesh,
                        min_write_pos: Optional[torch.Tensor] = None):
    """One sequence-sharded paged decode step on this rank of `mesh` (a
    `SeqGroup`; every rank calls it with the same tokens and replicated
    state). tokens: (B,) int. Returns (logits (B, V) f32, new_state).

    Per layer: the rank owning logical position `length` scatters the new
    token's K/V/indexer-K rows into ITS pools (the others, and rows masked
    by `min_write_pos`, write their sink page); each rank scores its own
    tokens; SP-GVR selects the exact global Top-K with O(1)-sized
    collectives; one O(K) psum assembles the K selected rows and attention
    runs over them on every rank (`sp_dsa_decode_paged_local`). Logits,
    feedback and telemetry are bit-identical to
    `serve_step_paged(..., paged_attn="fused")` over the same logical
    cache content. Requires the DSA gate open (`cfg.dsa.enabled` and
    `max_len > cfg.dsa.min_n`): the sharded path has no dense fallback."""
    _sp_paged_validate(state, cfg, mesh)
    mwp = (min_write_pos if min_write_pos is not None
           else torch.zeros_like(state["length"]))
    return _sp_paged_token_body(params, state, tokens, mwp, cfg, mesh=mesh)


def _sp_paged_verify_mq(params, state, tokens: torch.Tensor,
                        cfg: ModelConfig, *, draft_len: torch.Tensor,
                        base_mwp: torch.Tensor, mesh):
    """The sharded mq verify body: `_paged_verify_mq` over the rank's
    pools. Per layer every position's rows are written first (each to the
    rank owning it; frozen and masked rows to the sink page), then the
    Top-K chain and attention run position by position through
    `sp_dsa_decode_paged_local` (selection is sequential over the
    positions, and each position's collective schedule is the
    non-speculative step's). Returns (ys, state) in the scan's stack
    format, for `_spec_accept_rollback`."""
    b, d1 = tokens.shape
    hd = cfg.hd
    dev = tokens.device
    table_local, so, n_local, ps, sink = _sp_layout(state, mesh)
    length0 = state["length"]
    jj = torch.arange(d1, dtype=torch.int32, device=dev)
    positions = length0[:, None] + jj[None, :]             # (B, Q)
    lengths_q = positions + 1                              # causal extents
    live = (jj[None, :] <= draft_len[:, None]) & (positions >= base_mwp[:, None])
    dest, off = _sp_dest(table_local, positions, live, so, n_local, ps, sink)
    flat_pos = positions.reshape(b * d1)
    valid0 = state.get("topk_valid")

    x = params["embed"][tokens.long()]                     # (B, Q, D)
    sel_idx, sel_gvr = [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        kp, vp = state["k_pages"][i, 0], state["v_pages"][i, 0]
        idx_kp = state["idx_k_pages"][i, 0]
        h = rms_norm(x, p["ln1"])
        hf = h.reshape(b * d1, -1)
        q, kn, vn = _project_qkv(p, hf, b * d1, flat_pos, cfg)
        q = q.reshape(b, d1, cfg.n_heads, hd)
        # every position writes before anything attends
        kp[dest, off] = kn.reshape(b, d1, cfg.n_kv_heads, hd).to(kp.dtype)
        vp[dest, off] = vn.reshape(b, d1, cfg.n_kv_heads, hd).to(vp.dtype)
        ik = dsa_mod.indexer_k(p["indexer"], hf, flat_pos,
                               dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base)
        idx_kp[dest, off] = ik.reshape(b, d1, -1).to(idx_kp.dtype)
        prev = state["prev_topk"][i]
        valid = None if valid0 is None else valid0[i]
        rows = []
        for j in range(d1):
            rows.append(_sp_select_attend(
                p, cfg, state, i, q[:, j], h[:, j], kp, vp, idx_kp,
                table_local, prev, valid, lengths_q[:, j], mesh, so, ps))
            prev = rows[-1].topk_idx
            valid = None if valid is None else torch.ones_like(valid)
        sel_idx.append(torch.stack([r.topk_idx for r in rows], 1))  # (B, Q, K)
        sel_gvr.append(torch.stack([r.gvr_rows for r in rows], 1))  # (B, Q)
        attn = torch.stack([r.attn_out for r in rows], 1)
        x = x + attn.reshape(b, d1, cfg.n_heads * hd).to(x.dtype) @ p["wo"]
        h2 = rms_norm(x, p["ln2"])
        if cfg.moe.num_experts:
            x = x + torch.stack([_mlp(p, h2[:, j], cfg) for j in range(d1)], 1)
        else:
            x = x + swiglu_mlp(h2, p["w_gate"], p["w_up"], p["w_down"])

    logits = _lm_head(params, x, cfg)                      # (B, Q, V)
    ys = {"logits": logits.transpose(0, 1),
          "prev_topk": torch.stack(sel_idx).permute(2, 0, 1, 3),
          "topk_valid": torch.ones((d1,) + state["topk_valid"].shape,
                                   dtype=torch.bool, device=dev),
          "sel_gvr": torch.stack(sel_gvr).permute(2, 0, 1)}
    return ys, dict(state)


def serve_step_sp_spec_paged(params, state, tokens: torch.Tensor,
                             cfg: ModelConfig, *, mesh, draft_len, max_accept,
                             eos_id: int = -1,
                             min_write_pos: Optional[torch.Tensor] = None,
                             verify_kernel: str = "scan"):
    """Sequence-sharded speculative verify tick on this rank of `mesh`:
    the verify semantics of `serve_step_spec_paged` over the sharded body
    — "scan" runs d+1 `_sp_paged_token_body` steps, "mq" batches each
    layer's projections and writes (`_sp_paged_verify_mq`) — with the same
    acceptance and rollback arithmetic on every rank. Each position costs
    one non-speculative step's collective schedule. Bit-identical to the
    single-device `serve_step_spec_paged(paged_attn="fused")` with the
    same `verify_kernel`. Returns its 5-tuple."""
    _sp_paged_validate(state, cfg, mesh)
    if verify_kernel not in ("scan", "mq"):
        raise ValueError(f"unknown verify_kernel {verify_kernel!r} "
                         f"(expected 'scan' or 'mq')")
    dev = state["length"].device
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=dev)
    draft_len = torch.as_tensor(draft_len, dtype=torch.int32, device=dev)
    max_accept = torch.as_tensor(max_accept, dtype=torch.int32, device=dev)
    base_mwp = (min_write_pos if min_write_pos is not None
                else torch.zeros_like(state["length"]))
    if verify_kernel == "mq":
        ys, end_state = _sp_paged_verify_mq(params, state, tokens, cfg,
                                            draft_len=draft_len,
                                            base_mwp=base_mwp, mesh=mesh)
        return _spec_accept_rollback(state["length"], end_state, ys, tokens,
                                     draft_len, max_accept, int(eos_id), True)

    def step_fn(st, tok, mwp):
        return _sp_paged_token_body(params, st, tok, mwp, cfg, mesh=mesh)

    return _spec_verify_scan(step_fn, state, tokens, draft_len, max_accept,
                             int(eos_id), base_mwp,
                             sp_paged_state_batch_axes(cfg), True)
