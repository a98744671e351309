"""Jamba-style hybrid (hybrid family), PyTorch port of the JAX package's
`models/hybrid.py`: parameters, the training forward, the decode state
and the one-token decode step.

Superblocks of SB = 8 layers: layer 0 is attention, layers 1-7 Mamba
(selective SSM); the feed-forward after each layer is a MoE on odd layers
and a dense SwiGLU on even ones. The parameter tree has the reference's
nesting — `blocks` stacked over superblocks, and inside a superblock
`attn`, `mamba` (stacked over 7), `dense` and `moe` (over 4 each) — so
`repro_torch.bridge` carries a JAX tree over unchanged.

The attention layer is DSA-eligible: once the cache length N exceeds
`dsa.min_n`, every step scores, selects and attends through
`sparse/dsa.py:dsa_decode` (kernels B5 -> B1 -> B6 on the card), with no
validity mask and no window, as the reference passes neither; below it
the step attends densely (`layers.decode_attention`), still writes the
indexer key, and carries `prev_topk` through. The Mamba step and the
feed-forwards are plain PyTorch (the reference leaves them to XLA); the
MoE is `layers.moe_mlp_dense_fallback`, what the reference's
`moe_mlp_ep` runs without a mesh, called with its (B, 1, D) shape.

The Mamba step keeps the reference's dtype chain: the causal conv in f32
over the `conv` cache and cast back to the activation dtype, dt from a
softplus promoted to f32 by the f32 `dt_bias`, the state `h` updated in
f32, the `d_skip` term in f32, the output cast back before the SiLU gate.
The training form (`forward_train`, over superblocks, each recomputed in
the backward pass under `remat`) keeps the reference's own chain, which
differs: its conv sums in the activation dtype and its SiLU output stays
in f32 through `x_proj` (`_mamba_train`).

Under a ("data", "model") mesh (`serve_step(mesh=, rules=,
seq_sharded=)`) each rank runs the step on its blocks: heads, Mamba
channels, `d_ff` and experts over "model", the batch over "data", and
with `seq_sharded` the attention layer's caches over the sequence on
"data" through SP-DSA (`sparse/sp_dsa.py`).

The reference serves this family step by step only: it defines no
slot-wise, paged or speculative hooks, so `DecodeEngine` refuses it. The
K/V and indexer-K caches are written in place (the
`transformer.serve_step` convention); `h`, `conv`, `length` and, under
DSA, `prev_topk` come back as new tensors.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.temporal import linspace_i32
from repro_torch.parallel.sharding import (MeshRules, P, block_slices, stacked,
                                         unstacked)
from repro_torch.sparse import dsa as dsa_mod
from .config import ModelConfig
from .layers import (apply_rotary, decode_attention, moe_mlp_ep, remat_call,
                     rms_norm)
from .tensor_parallel import NO_MESH, Heads, Placement, axis_of, heads_of
from .transformer import drawer, layer_params, torch_dtype, unstack_layers

SB = 8  # superblock size: 1 attention layer + 7 Mamba layers


def _dims(cfg: ModelConfig):
    """(d_inner, d_state, dt_rank, d_conv) of the Mamba layers."""
    d = cfg.d_model
    return d * cfg.mamba_expand, cfg.mamba_d_state, max(d // 16, 1), cfg.mamba_d_conv


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device, block=None) -> Dict[str, Any]:
    """Random-init parameters from `generator` in the reference's tree and
    at its scales: N(0, 1/fan_in) weights (the experts' w_gate and w_up
    at E^-0.5, as the reference's `_dense` scales by shape[0]; the
    embedding at 1; `conv_w` N(0, 0.01)), unit norms, and the f32 Mamba
    constants (`conv_b` and `dt_bias` 0, `d_skip` 1, `a_log` =
    log(1..d_state), taken in numpy: torch's float32 log rounds log(7)
    one ulp away from the reference's). Each superblock's layers are
    drawn one at a time into the model dtype (`transformer.drawer`;
    `block` cuts each to a rank's block): a whole f32 draw of the experts
    would be a temporary as large as the bf16 weights twice over."""
    if cfg.n_layers % SB:
        raise ValueError(f"jamba layers must be a multiple of {SB}, got "
                         f"{cfg.n_layers}")
    dtype = torch_dtype(cfg.dtype)
    nsb = cfg.n_layers // SB
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    di, ds, dtr, dc = _dims(cfg)
    e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff

    draw = drawer(generator, device, dtype, block)

    def f32(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    m, h = (nsb, SB - 1), (nsb, SB // 2)
    attn = {
        "ln": f32((nsb, d), 1.0),
        "wq": draw((nsb,), (d, cfg.n_heads * hd), d ** -0.5,
                   path="blocks/attn/wq"),
        "wk": draw((nsb,), (d, cfg.n_kv_heads * hd), d ** -0.5,
                   path="blocks/attn/wk"),
        "wv": draw((nsb,), (d, cfg.n_kv_heads * hd), d ** -0.5,
                   path="blocks/attn/wv"),
        "wo": draw((nsb,), (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5,
                   path="blocks/attn/wo"),
    }
    if cfg.dsa.enabled:
        attn["indexer"] = dsa_mod.indexer_init(
            generator, d, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim, dtype,
            device, layers=nsb)
    mamba = {
        "ln": f32(m + (d,), 1.0),
        "in_proj": draw(m, (d, 2 * di), d ** -0.5, "blocks/mamba/in_proj"),
        "conv_w": draw(m, (dc, di), 0.1),
        "conv_b": f32(m + (di,), 0.0),
        "x_proj": draw(m, (di, dtr + 2 * ds), di ** -0.5),
        "dt_proj": draw(m, (dtr, di), dtr ** -0.5),
        "dt_bias": f32(m + (di,), 0.0),
        "a_log": torch.as_tensor(np.log(np.arange(1, ds + 1, dtype=np.float32)),
                                 device=device).expand(m + (di, ds)).contiguous(),
        "d_skip": f32(m + (di,), 1.0),
        "out_proj": draw(m, (di, d), di ** -0.5, "blocks/mamba/out_proj"),
    }
    ffn = {
        "ln": f32(h + (d,), 1.0),
        "w_gate": draw(h, (d, f), d ** -0.5, "blocks/dense/w_gate"),
        "w_up": draw(h, (d, f), d ** -0.5, "blocks/dense/w_up"),
        "w_down": draw(h, (f, d), f ** -0.5, "blocks/dense/w_down"),
    }
    moe = {
        "ln": f32(h + (d,), 1.0),
        "router": draw(h, (d, e), d ** -0.5, dt=torch.float32),
        "w_gate": draw(h, (e, d, fe), e ** -0.5, "blocks/moe/w_gate"),
        "w_up": draw(h, (e, d, fe), e ** -0.5, "blocks/moe/w_up"),
        "w_down": draw(h, (e, fe, d), fe ** -0.5, "blocks/moe/w_down"),
    }
    return {
        "embed": draw((), (cfg.vocab, d), 1.0, "embed"),
        "blocks": {"attn": attn, "mamba": mamba, "dense": ffn, "moe": moe},
        "final_norm": f32((d,), 1.0),
        "lm_head": draw((), (d, cfg.vocab), d ** -0.5, "lm_head"),
    }


def param_specs(cfg: ModelConfig, rules: MeshRules) -> Dict[str, Any]:
    """The reference's specs of `init_params`'s tree under `rules`: the
    attention by heads, Mamba's `in_proj` by `d_ff` columns and
    `out_proj` by rows (its other leaves replicated), the dense FFN by
    `d_ff`, the experts by expert, the embedding and head by vocab."""
    d, hd = cfg.d_model, cfg.hd
    di = _dims(cfg)[0]
    e, f = cfg.moe.num_experts, cfg.moe.expert_d_ff
    sp = rules.spec
    attn = {
        "ln": P(None),
        "wq": sp("d_model", "heads", sizes=(d, cfg.n_heads * hd)),
        "wk": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
        "wv": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
        "wo": sp("heads", "d_model", sizes=(cfg.n_heads * hd, d)),
    }
    if cfg.dsa.enabled:
        attn["indexer"] = {"wq": P(None, None), "wk": P(None, None),
                           "w": P(None)}
    mamba = {
        "ln": P(None),
        "in_proj": sp("d_model", "d_ff", sizes=(d, 2 * di)),
        "conv_w": P(None, None), "conv_b": P(None),
        "x_proj": P(None, None),
        "dt_proj": P(None, None), "dt_bias": P(None),
        "a_log": P(None, None), "d_skip": P(None),
        "out_proj": sp("d_ff", "d_model", sizes=(di, d)),
    }
    dense = {"ln": P(None),
             "w_gate": sp("d_model", "d_ff", sizes=(d, cfg.d_ff)),
             "w_up": sp("d_model", "d_ff", sizes=(d, cfg.d_ff)),
             "w_down": sp("d_ff", "d_model", sizes=(cfg.d_ff, d))}
    moe = {"ln": P(None), "router": P(None, None),
           "w_gate": sp("experts", None, None, sizes=(e, d, f)),
           "w_up": sp("experts", None, None, sizes=(e, d, f)),
           "w_down": sp("experts", None, None, sizes=(e, f, d))}
    blocks = {"attn": attn, "mamba": stacked(mamba), "dense": stacked(dense),
              "moe": stacked(moe)}
    return {
        "embed": sp("vocab", "d_model", sizes=(cfg.vocab, d)),
        "blocks": stacked(blocks),
        "final_norm": P(None),
        "lm_head": sp("d_model", "vocab", sizes=(d, cfg.vocab)),
    }


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """The reference's state: per superblock the K/V caches (nsb, B, N,
    KVH, hd), the Mamba state `h` (nsb, 7, B, d_inner, d_state) f32 and
    conv cache (nsb, 7, B, d_conv - 1, d_inner), `length`; under DSA the
    indexer-K cache and `prev_topk`, seeded with the reference's
    linspace(0, max(max_len - 1, 1), K) on every superblock and row."""
    dtype = dtype or torch_dtype(cfg.dtype)
    nsb = cfg.n_layers // SB
    di, ds, _, dc = _dims(cfg)

    def zeros(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    cache = (nsb, batch, max_len)
    state = {
        "k": zeros(cache + (cfg.n_kv_heads, cfg.hd)),
        "v": zeros(cache + (cfg.n_kv_heads, cfg.hd)),
        "h": zeros((nsb, SB - 1, batch, di, ds), torch.float32),
        "conv": zeros((nsb, SB - 1, batch, dc - 1, di)),
        "length": zeros((batch,), torch.int32),
    }
    if cfg.dsa.enabled:
        kk = min(cfg.dsa.k, max_len)
        state["idx_k"] = zeros(cache + (cfg.dsa.indexer_dim,))
        base = linspace_i32(max(max_len - 1, 1), kk, device)
        state["prev_topk"] = base[None, None].expand(nsb, batch, kk).clone()
    return state


def state_specs(cfg: ModelConfig, rules: MeshRules, *, batch: int,
                max_len: int, seq_sharded: bool = False) -> Dict[str, Any]:
    """The reference's specs of `init_decode_state`'s leaves: the caches
    by batch and KV head (and over the sequence under `seq_sharded`), the
    Mamba state and conv cache by batch and channel (`d_ff`)."""
    nsb = cfg.n_layers // SB
    di, ds, _, dc = _dims(cfg)
    seq_ax = "seq_shard" if seq_sharded else None
    sp = rules.spec
    cache = (nsb, batch, max_len, cfg.n_kv_heads, cfg.hd)
    specs = {
        "k": sp(None, "batch", seq_ax, "kv_heads", None, sizes=cache),
        "v": sp(None, "batch", seq_ax, "kv_heads", None, sizes=cache),
        "h": sp(None, None, "batch", "d_ff", None,
                sizes=(nsb, SB - 1, batch, di, ds)),
        "conv": sp(None, None, "batch", None, "d_ff",
                   sizes=(nsb, SB - 1, batch, dc - 1, di)),
        "length": P(None),
    }
    if cfg.dsa.enabled:
        specs["idx_k"] = sp(None, "batch", seq_ax, None,
                            sizes=cache[:3] + (cfg.dsa.indexer_dim,))
        specs["prev_topk"] = sp(None, "batch", None,
                                sizes=(nsb, batch, min(cfg.dsa.k, max_len)))
    return specs


def _mamba_step(p, x: torch.Tensor, h: torch.Tensor, conv: torch.Tensor,
                cfg: ModelConfig, tp: Optional["_Layout"] = None):
    """One decode token of a Mamba layer. x: (B, D) normed input; h: (B,
    d_inner, d_state) f32; conv: (B, d_conv - 1, d_inner). Returns (out
    (B, D), new h, new conv).

    Under a mesh (`tp`) h and conv hold the rank's block of channels
    where `state_specs` shards `d_ff`: `in_proj`'s column block is
    gathered and the rank keeps its channels of x1 and z, the conv and
    the scan run on them alone, and the two contractions over channels
    (`x_proj`, `out_proj`) are summed over the axis."""
    di, ds, dtr, _ = _dims(cfg)
    tp = tp or _plain_layout(cfg)
    c = tp.channels
    xz = tp.pl.cols(x, p["in_proj"], tp.mamba["in_proj"][1], gather=True,
                    tag="in_proj")
    x1, z = xz[..., :di][..., c], xz[..., di:][..., c]
    window = torch.cat([conv, x1[:, None]], dim=1)          # (B, dc, di)
    xc = torch.einsum("bcd,cd->bd", window.float(), p["conv_w"][:, c].float())
    xc = F.silu(xc + p["conv_b"][c]).to(x.dtype)
    proj = tp.pl.rows_in(xc, p["x_proj"][c], tp.mamba["out_proj"][0],
                         local=True, tag="x_proj")
    dt = F.softplus(proj[..., :dtr] @ p["dt_proj"][:, c] + p["dt_bias"][c])
    bmat = proj[..., dtr:dtr + ds].float()
    cmat = proj[..., dtr + ds:].float()
    a = -torch.exp(p["a_log"][c])
    ad = torch.exp(dt.float()[..., None] * a[None])
    h = ad * h + (dt.float() * xc.float())[..., None] * bmat[:, None, :]
    y = torch.einsum("bds,bs->bd", h, cmat) + p["d_skip"][c] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return (tp.pl.rows_in(y, p["out_proj"], tp.mamba["out_proj"][0],
                          local=True, tag="out_proj"), h, window[:, 1:])


def _ffn(p, x: torch.Tensor, cfg: ModelConfig, is_moe: bool,
         tp: Optional["_Layout"] = None) -> torch.Tensor:
    """The feed-forward over x normed: the MoE or SwiGLU. x is (B, D), one
    token per row, which the MoE takes in the reference's (B, 1, D) call
    shape, or the training path's (B, S, D). Under a mesh (`tp`) the MoE
    is `layers.moe_mlp_ep` over the experts' axis and the SwiGLU runs by
    `d_ff` with a psum; with no mesh they are the dense fallback and the
    plain SwiGLU."""
    tp = tp or _plain_layout(cfg)
    if is_moe:
        return moe_mlp_ep(
            x.reshape(x.shape[0], -1, x.shape[-1]), p["router"], p["w_gate"],
            p["w_up"], p["w_down"], top_k=cfg.moe.top_k,
            capacity_factor=cfg.moe.capacity_factor, mesh=tp.pl.mesh,
            expert_axis=tp.experts).reshape(x.shape)
    return tp.pl.swiglu(x, p["w_gate"], p["w_up"], p["w_down"],
                        tp.dense["w_down"][0])


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype, as JAX multiplies an f32 activation by
    a bf16 weight."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _mamba_train(p, x: torch.Tensor, cfg: ModelConfig,
                 tp: Optional["_Layout"] = None) -> torch.Tensor:
    """A Mamba layer over (B, S, D) normed, the reference's training form:
    the causal depthwise conv summed in x's dtype (the step form sums it
    in f32), the SiLU after the f32 `conv_b` in f32, and the selective
    scan over S in f32 from a zero state. Under a mesh (`tp`) on the
    rank's channels as `_mamba_step`: `in_proj` gathered, each
    per-channel parameter cut to the rank's channels (its gradient
    summed over the axis), `x_proj` and `out_proj` summed over it."""
    b, s, _ = x.shape
    di, ds, dtr, dc = _dims(cfg)
    tp = tp or _plain_layout(cfg)
    c, entry = tp.channels, tp.mamba["out_proj"][0]
    ax = axis_of(tp.pl.mesh, entry)

    def mine(t, tag):           # a value every rank holds, cut to channels
        return t if ax is None else ax.enter(t, tag)

    xz = mine(tp.pl.cols(x, p["in_proj"], tp.mamba["in_proj"][1],
                         gather=True, tag="in_proj"), "in_proj")
    x1, z = xz[..., :di][..., c], xz[..., di:][..., c]
    conv_w = mine(p["conv_w"], "conv_w")[:, c]
    xp = F.pad(x1, (0, 0, dc - 1, 0))
    x1 = sum(xp[:, i:i + s] * conv_w[i][None, None] for i in range(dc))
    x1 = F.silu(x1 + mine(p["conv_b"], "conv_b")[c])
    proj = _mm(x1, mine(p["x_proj"], "x_proj")[c])
    if ax is not None:
        proj = ax.enter(ax.psum(proj, "x_proj"), "x_proj")
    dt = F.softplus(_mm(proj[..., :dtr], mine(p["dt_proj"], "dt_proj")[:, c])
                    + mine(p["dt_bias"], "dt_bias")[c]).float()
    bmat = proj[..., dtr:dtr + ds].float()
    cmat = proj[..., dtr + ds:].float()
    a = -torch.exp(mine(p["a_log"], "a_log")[c])
    xf = x1.float()
    if xf.is_meta:
        # the dry run: every step's update at once, the scan's shapes and
        # graph without its S host-side steps
        h = (torch.exp(dt[..., None] * a) * (dt * xf)[..., None]
             * bmat[:, :, None, :])
        y = torch.einsum("btds,bts->btd", h, cmat)
    else:
        h = torch.zeros((b, xf.shape[-1], ds), dtype=torch.float32,
                        device=x.device)
        ys = []
        for t in range(s):
            h = (torch.exp(dt[:, t, :, None] * a[None]) * h
                 + (dt[:, t] * xf[:, t])[..., None] * bmat[:, t, None, :])
            ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
        y = torch.stack(ys, dim=1)
    y = y + mine(p["d_skip"], "d_skip")[c] * xf
    return tp.pl.rows_in(y.to(x.dtype) * F.silu(z), p["out_proj"], entry,
                         local=True, tag="out_proj")


def _superblock_train(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, tp: "_Layout") -> torch.Tensor:
    """One superblock over (B, S, D): the attention layer (RoPE, the
    blockwise causal attention), then the 8 layers' Mamba (i > 0) and
    feed-forward (MoE on odd i, dense on even) in the reference's order."""
    from .transformer import _Layout as AttnLayout, attention_train
    pa = p["attn"]
    x = x + attention_train(pa, rms_norm(x, pa["ln"]), cfg, positions,
                            AttnLayout(tp.pl, tp.heads, tp.attn, None, None),
                            rope=dict(base=cfg.rope_base))
    mamba = unstack_layers(p["mamba"], SB - 1)
    ffn = {kind: unstack_layers(p[kind], SB // 2) for kind in ("dense", "moe")}
    for i in range(SB):
        if i > 0:
            pm = mamba[i - 1]
            x = x + _mamba_train(pm, rms_norm(x, pm["ln"]), cfg, tp)
        kind = "moe" if i % 2 == 1 else "dense"
        pf = ffn[kind][i // 2]
        x = x + _ffn(pf, rms_norm(x, pf["ln"]), cfg, kind == "moe", tp)
    return x


def _forward_train(params, tokens, cfg, mesh, rules, remat):
    b, s = tokens.shape
    tp = (_plain_layout(cfg) if mesh is None
          else _layout(cfg, mesh, rules, b, s, False, False))
    tokens = tokens[tp.pl.rows]
    x = tp.pl.embed(params["embed"], tp.embed, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(tokens.shape[0], s)
    for p in unstack_layers(params["blocks"], cfg.n_layers // SB):
        x = remat_call(_superblock_train, remat, p, x, positions, cfg, tp)
    x = rms_norm(x, params["final_norm"])
    return (*tp.pl.vocab_logits(x, params["lm_head"], tp.head), tp)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mesh=None, rules: Optional[MeshRules] = None,
                  patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V), under autograd; each superblock
    is recomputed in the backward pass under `remat` (the reference's
    `jax.checkpoint` of the superblock). No DSA: the indexer weights get
    a zero gradient. Under a `mesh` and its `rules`: the logits of the
    rank's rows and vocabulary block; the heads, Mamba channels, `d_ff`
    and experts (`layers.moe_mlp_ep`: capacity drops) over "model"."""
    return _forward_train(params, tokens, cfg, mesh, rules, remat)[0]


def loss_fn(params, batch, cfg: ModelConfig, *, mesh=None,
            rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask); under a mesh this rank's share (see `transformer.loss_fn`)."""
    from .transformer import train_loss
    return train_loss(*_forward_train(params, batch["tokens"], cfg, mesh,
                                      rules, True), batch)


class _Layout(NamedTuple):
    """Where a step's arrays live on this rank (see `serve_step`);
    `_plain_layout(cfg)`, with no mesh, is the identity: all heads and
    channels, every entry None, no SP-DSA layer."""
    pl: Placement
    heads: Heads
    attn: Dict[str, Any]      # the specs of a superblock's layers
    mamba: Dict[str, Any]
    dense: Dict[str, Any]
    embed: Any                # the vocab entries of the embedding and head
    head: Any
    experts: Any              # the experts' axis
    channels: slice           # the rank's Mamba channels
    sp_layer: Any             # the SP-DSA layer, or None


@functools.lru_cache(maxsize=None)
def _plain_layout(cfg: ModelConfig) -> _Layout:
    return _layout(cfg, None, NO_MESH, 0, 0, False, False)


def _layout(cfg: ModelConfig, mesh, rules: MeshRules, batch: int,
            max_len: int, seq_sharded: bool, use_sp: bool) -> _Layout:
    psp = param_specs(cfg, rules)
    bsp = psp["blocks"]                         # (nsb[, layers], ...)
    ssp = state_specs(cfg, rules, batch=batch, max_len=max_len,
                      seq_sharded=seq_sharded)
    if mesh is not None:
        # the batch and the sequence on one axis: refused, as NamedSharding does
        block_slices(ssp["k"], (cfg.n_layers // SB, batch, max_len,
                                cfg.n_kv_heads, cfg.hd), mesh, mesh.coords)
    heads = heads_of(cfg, ssp["k"][3], mesh)
    if heads.axis is not None and any(
            axis_of(mesh, bsp["attn"][w][c]) is not heads.axis
            for w, c in (("wq", 2), ("wk", 2), ("wv", 2), ("wo", 1))):
        raise NotImplementedError("the cache's KV heads and the attention "
                                  "weights are sharded over different axes")
    ax = axis_of(mesh, ssp["h"][3])
    di = _dims(cfg)[0]
    channels = (slice(None) if ax is None else
                slice(ax.rank * di // ax.size, (ax.rank + 1) * di // ax.size))
    experts = bsp["moe"]["w_gate"][2]
    if (mesh is not None and cfg.moe.num_experts
            and axis_of(mesh, experts) is None):
        raise ValueError(f"{cfg.moe.num_experts} experts do not divide the "
                         f"expert axis of {mesh.shape}")
    sp_layer = None
    if use_sp:
        from repro_torch.sparse.sp_dsa import make_sp_dsa
        seq = ssp["k"][2]
        sp_layer = make_sp_dsa(
            mesh, k=min(cfg.dsa.k, max_len), scale=cfg.hd ** -0.5,
            heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
            rope_base=cfg.rope_base, seq_axis=seq,
            head_axis=None if heads.axis is None else heads.axis.name,
            shard_heads=heads.axis is not None,
            dense=max_len <= cfg.dsa.min_n)
    return _Layout(Placement(mesh, rules, batch), heads,
                   unstacked(bsp["attn"]), unstacked(bsp["mamba"], 2),
                   unstacked(bsp["dense"], 2), psp["embed"][0],
                   psp["lm_head"][1], experts, channels, sp_layer)


def attention_layer(pa, x: torch.Tensor, state, sb: int, cfg: ModelConfig,
                    tp: Optional[_Layout] = None):
    """Superblock `sb`'s attention layer on the residual x (B, D): writes
    the new K/V (and indexer-K) rows in place at `length`, clamped to N-1
    as the reference's `dynamic_update_slice` clamps it, then attends —
    through DSA when N > `dsa.min_n`, densely otherwise. Returns (attn
    (B, H, hd) f32, the layer's next `prev_topk` (B, K) or None).

    Under a mesh (`tp`): x and the state are the rank's rows, q/k/v its
    heads (or all heads, gathered); with the SP-DSA layer the rank's cache
    is its span of the sequence and the layer writes and attends over it
    (`sparse/sp_dsa.py`)."""
    b = x.shape[0]
    hd = cfg.hd
    tp = tp or _plain_layout(cfg)
    positions = state["length"][tp.pl.rows]
    new_len = positions + 1
    n = state["k"].shape[2]
    rows = torch.arange(b, device=positions.device)
    wpos = positions.clamp(max=n - 1).long()
    pos = positions[:, None]
    h = rms_norm(x, pa["ln"])
    hl, kvl = tp.heads.hl, tp.heads.kvl
    q, kn, vn = (tp.pl.cols(h, pa[w], tp.attn[w][1],
                            gather=tp.heads.axis is None, tag=w)
                 for w in ("wq", "wk", "wv"))
    q = apply_rotary(q.reshape(b, 1, hl, hd), pos, base=cfg.rope_base)[:, 0]
    kn = apply_rotary(kn.reshape(b, 1, kvl, hd), pos, base=cfg.rope_base)[:, 0]
    vn = vn.reshape(b, kvl, hd)
    kc, vc = state["k"][sb], state["v"][sb]
    if tp.sp_layer is not None:
        ik = dsa_mod.indexer_k(pa["indexer"], h, positions,
                               dim=cfg.dsa.indexer_dim, rope_base=cfg.rope_base)
        res = tp.sp_layer(q, kc, vc, state["idx_k"][sb], h, pa["indexer"],
                          state["prev_topk"][sb], new_len, kn, vn, ik)
        return res.attn_out, res.new_topk.int()
    kc[rows, wpos] = kn.to(kc.dtype)
    vc[rows, wpos] = vn.to(vc.dtype)
    if cfg.dsa.enabled:
        idx_kc = state["idx_k"][sb]
        idx_kc[rows, wpos] = dsa_mod.indexer_k(
            pa["indexer"], h, positions, dim=cfg.dsa.indexer_dim,
            rope_base=cfg.rope_base).to(idx_kc.dtype)
    if cfg.dsa.enabled and n > cfg.dsa.min_n:
        res = dsa_mod.dsa_decode(
            q, kc, vc, pa["indexer"], h, idx_kc, state["prev_topk"][sb],
            new_len, k=state["prev_topk"].shape[-1], scale=hd ** -0.5,
            heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
            rope_base=cfg.rope_base, selector=cfg.dsa.selector,
            max_candidates=cfg.dsa.max_candidates,
            gate_max_n=cfg.dsa.gate_max_n, min_n=cfg.dsa.min_n)
        return res.attn_out, res.topk_idx.int()
    return decode_attention(q, kc, vc, new_len, scale=hd ** -0.5), None


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
               mesh=None, rules: Optional[MeshRules] = None,
               seq_sharded: bool = False):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state). Per superblock: the attention layer, then the 8 layers in
    the reference's order — Mamba on layers 1-7, then the MoE on odd
    layers and the dense FFN on even ones.

    Under a `mesh` (`launch.make_mesh`, ("data", "model")) and its `rules`
    the step runs on one rank, as `transformer.serve_step` does:
    params and state are the rank's blocks (`bridge.shard_tree` of
    `param_specs` and `state_specs(seq_sharded=)`), tokens the global
    batch, the logits those of the rank's rows. With `seq_sharded` the
    caches are sharded over the sequence on "data" and q's heads are the
    rank's own over "model" where the cache is sharded by KV head; past
    `dsa.min_n` the attention layers run SP-DSA (SP-GVR and the
    flash-style combine over the sequence axis), at or below it a dense
    attention over the rank's span with the same combine, where the
    reference falls back to its unsharded step. The reference head-shards by its
    `ok_heads` rule (n_heads / model % n_kv_heads == 0) over replicated
    KV heads and groups the rank's query heads over all KV heads, which
    pairs a query head with another group's keys whenever n_kv_heads > 1;
    the port keeps each head with its own KV head, so the sharded step
    equals the unsharded one (ROADMAP Queue C). Without a mesh,
    `seq_sharded` changes nothing, as in the reference (its SP path needs
    a mesh)."""
    b = tokens.shape[0]
    nsb = cfg.n_layers // SB
    tp = _plain_layout(cfg)
    if mesh is not None:
        n = state["k"].shape[2]
        if seq_sharded:
            n *= mesh.index(rules.axes("seq_shard"))[1]
        if seq_sharded and not cfg.dsa.enabled:
            raise NotImplementedError("a sequence-sharded step without the "
                                      "DSA indexer's cache")
        tp = _layout(cfg, mesh, rules, b, n, seq_sharded, seq_sharded)
    x = tp.pl.embed(params["embed"], tp.embed, tokens[tp.pl.rows])  # (B, D)
    bl = x.shape[0]
    h_out, conv_out, topk_out = [], [], []
    for sb in range(nsb):
        p = layer_params(params["blocks"], sb)
        pa = p["attn"]
        att, topk = attention_layer(pa, x, state, sb, cfg, tp)
        if topk is not None:
            topk_out.append(topk)
        att = att.reshape(bl, -1).to(x.dtype)
        x = x + tp.pl.rows_in(att, pa["wo"], tp.attn["wo"][0],
                              local=tp.heads.axis is not None, tag="wo")
        hs, convs = [], []
        for i in range(SB):
            if i > 0:
                pm = layer_params(p["mamba"], i - 1)
                y, hn, cn = _mamba_step(pm, rms_norm(x, pm["ln"]),
                                        state["h"][sb, i - 1],
                                        state["conv"][sb, i - 1], cfg, tp)
                x = x + y
                hs.append(hn)
                convs.append(cn)
            kind = "moe" if i % 2 == 1 else "dense"
            pf = layer_params(p[kind], i // 2)
            x = x + _ffn(pf, rms_norm(x, pf["ln"]), cfg, kind == "moe", tp)
        h_out.append(torch.stack(hs))
        conv_out.append(torch.stack(convs))
    new_state = dict(state, h=torch.stack(h_out), conv=torch.stack(conv_out),
                     length=state["length"] + 1)
    if topk_out:
        new_state["prev_topk"] = torch.stack(topk_out)
    x = rms_norm(x, params["final_norm"])
    return tp.pl.logits(x, params["lm_head"], tp.head), new_state
