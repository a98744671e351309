"""Whisper-style encoder-decoder backbone (audio family), PyTorch port of
the JAX package's `models/encdec.py`: parameters, the encoder, the
training forward, the decode state and the one-token decode step.

The conv/mel frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_frames, d_model), adds the
learned `enc_pos` and runs bidirectional self-attention layers with the
GELU MLP. The decoder's self-attention is DSA-eligible: once the cache
length N exceeds `dsa.min_n`, every step scores, selects and attends
through `sparse/dsa.py:dsa_decode` (kernels B5 → B1 → B6 on the card),
with no validity mask (`prev_valid=None`: every row takes GVR) and no
window, as the reference passes neither. Cross-attention over the
`encoder_frames` precomputed rows stays exact (`layers.decode_attention`,
plain PyTorch, as the reference leaves it to XLA).

`forward_train` / `loss_fn` follow the reference's training path under
autograd: the encoder over the frames (gradients flow through it), then
per decoder layer RoPE and `layers.blockwise_causal_attention`, exact
cross-attention over the encoder output and the GELU MLP; no DSA, so the
indexer weights get a zero gradient.

The reference serves this family step by step only: it defines no
slot-wise or paged hooks, so `DecodeEngine` refuses it. Its
`init_decode_state` makes the cross K/V (`ck`, `cv`) zeros and no serve
path fills them from `encode`; the port keeps that as it is. The state
has the reference's leaves and no other. The K/V and indexer-K caches
are written in place (the `transformer.serve_step` convention); the
step returns `length` and, under DSA, `prev_topk` anew.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, NamedTuple, Optional

import torch

from repro_torch.core.temporal import seed_slot_idx
from repro_torch.parallel.sharding import MeshRules, P, stacked, unstacked
from repro_torch.sparse import dsa as dsa_mod
from .config import ModelConfig
from .layers import apply_rotary, decode_attention, remat_call, rms_norm
from .tensor_parallel import NO_MESH, Heads, Placement, heads_of
from .transformer import (attention_train, drawer, layer_params, torch_dtype,
                          train_loss, unstack_layers)


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                block=None) -> Dict[str, Any]:
    """Random-init parameters from `generator`, the reference's tree
    stacked over layers: N(0, 1/fan_in) weights (`enc_pos` at 0.02, the
    embedding at 1), unit norms, zero f32 MLP biases. The weights are
    drawn one layer at a time (`transformer.drawer`; `block` cuts each to
    a rank's block)."""
    dtype = torch_dtype(cfg.dtype)
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    dense = drawer(generator, device, dtype, block)

    def f32(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def attn(l, at):
        return {"wq": dense((l,), (d, cfg.n_heads * hd), d ** -0.5, at + "/wq"),
                "wk": dense((l,), (d, cfg.n_kv_heads * hd), d ** -0.5, at + "/wk"),
                "wv": dense((l,), (d, cfg.n_kv_heads * hd), d ** -0.5, at + "/wv"),
                "wo": dense((l,), (cfg.n_heads * hd, d),
                            (cfg.n_heads * hd) ** -0.5, at + "/wo")}

    def mlp(l, at):
        return {"w_up": dense((l,), (d, f), d ** -0.5, at + "/w_up"),
                "b_up": f32((l, f), 0.0),
                "w_down": dense((l,), (f, d), f ** -0.5, at + "/w_down"),
                "b_down": f32((l, d), 0.0)}

    enc_l, dec_l = cfg.encoder_layers or cfg.n_layers, cfg.n_layers
    decoder = {"ln1": f32((dec_l, d), 1.0), "ln2": f32((dec_l, d), 1.0),
               "ln3": f32((dec_l, d), 1.0),
               "self_attn": attn(dec_l, "decoder/self_attn"),
               "cross_attn": attn(dec_l, "decoder/cross_attn"),
               "mlp": mlp(dec_l, "decoder/mlp")}
    if cfg.dsa.enabled:
        decoder["indexer"] = dsa_mod.indexer_init(
            generator, d, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim, dtype,
            device, layers=dec_l)
    return {
        "embed": dense((), (cfg.vocab, d), 1.0, "embed"),
        "enc_pos": dense((), (cfg.encoder_frames, d), 0.02),
        "encoder": {"ln1": f32((enc_l, d), 1.0), "ln2": f32((enc_l, d), 1.0),
                    "attn": attn(enc_l, "encoder/attn"),
                    "mlp": mlp(enc_l, "encoder/mlp")},
        "decoder": decoder,
        "enc_norm": f32((d,), 1.0),
        "final_norm": f32((d,), 1.0),
        "lm_head": dense((), (d, cfg.vocab), d ** -0.5, "lm_head"),
    }


def param_specs(cfg: ModelConfig, rules: MeshRules) -> Dict[str, Any]:
    """The reference's specs of `init_params`'s tree under `rules`."""
    d, hd = cfg.d_model, cfg.hd
    sp = rules.spec
    attn = {"wq": sp("d_model", "heads", sizes=(d, cfg.n_heads * hd)),
            "wk": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
            "wv": sp("d_model", "kv_heads", sizes=(d, cfg.n_kv_heads * hd)),
            "wo": sp("heads", "d_model", sizes=(cfg.n_heads * hd, d))}
    mlp = {"w_up": sp("d_model", "d_ff", sizes=(d, cfg.d_ff)), "b_up": P(None),
           "w_down": sp("d_ff", "d_model", sizes=(cfg.d_ff, d)), "b_down": P(None)}
    enc = {"ln1": P(None), "ln2": P(None), "attn": attn, "mlp": mlp}
    dec = {"ln1": P(None), "ln2": P(None), "ln3": P(None),
           "self_attn": attn, "cross_attn": attn, "mlp": mlp}
    if cfg.dsa.enabled:
        dec["indexer"] = {"wq": P(None, None), "wk": P(None, None), "w": P(None)}
    return {
        "embed": sp("vocab", "d_model", sizes=(cfg.vocab, d)),
        "enc_pos": P(None, None),
        "encoder": stacked(enc), "decoder": stacked(dec),
        "enc_norm": P(None), "final_norm": P(None),
        "lm_head": sp("d_model", "vocab", sizes=(d, cfg.vocab)),
    }


def _full_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               hd: int) -> torch.Tensor:
    """Unmasked attention, f32 softmax: q (B, S, H, hd), k/v (B, Se, H,
    hd) → (B, S, H, hd) f32."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * hd ** -0.5
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1),
                        v.float())


class _Layout(NamedTuple):
    """Where a step's arrays live on this rank: `transformer._Layout`'s
    fields (one attention block's specs as `layer`, the same for every
    attention block of both stacks) and the GELU MLP's `d_ff` entry."""
    pl: Placement
    heads: Heads
    layer: Dict[str, Any]
    embed: Any
    head: Any
    mlp: Any


@functools.lru_cache(maxsize=None)
def _plain_layout(cfg: ModelConfig) -> _Layout:
    return _layout(cfg, None, NO_MESH, 0, 0)


def _layout(cfg: ModelConfig, mesh, rules: MeshRules, batch: int,
            max_len: int) -> _Layout:
    """The layout of a `batch`-row step on this rank of `mesh`: the
    rank's heads where the cache's KV heads are sharded (`state_specs`),
    `d_ff` and the vocabulary by their specs."""
    psp = param_specs(cfg, rules)
    dec = unstacked(psp["decoder"])
    heads = heads_of(cfg, state_specs(cfg, rules, batch=batch,
                                      max_len=max_len)["k"][3], mesh)
    return _Layout(Placement(mesh, rules, batch), heads, dec["self_attn"],
                   psp["embed"][0], psp["lm_head"][1], dec["mlp"]["w_down"][0])


def _qkv(p, x: torch.Tensor, kv_in: torch.Tensor, lay: _Layout):
    """q from x, k and v from kv_in, at the layout's heads."""
    gather = lay.heads.axis is None
    return tuple(lay.pl.cols(inp, p[w], lay.layer[w][1], gather=gather, tag=w)
                 for inp, w in ((x, "wq"), (kv_in, "wk"), (kv_in, "wv")))


def _out(p, att: torch.Tensor, dtype, lay: _Layout) -> torch.Tensor:
    """The attention output (B, ..., heads, hd) through `wo`."""
    att = att.reshape(att.shape[:-2] + (-1,)).to(dtype)
    return lay.pl.rows_in(att, p["wo"], lay.layer["wo"][0],
                          local=lay.heads.axis is not None, tag="wo")


def _mlp(p, x: torch.Tensor, lay: _Layout) -> torch.Tensor:
    return lay.pl.gelu(x, entry=lay.mlp, **p)


def _self_attn(p, x: torch.Tensor, cfg: ModelConfig, lay: _Layout,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self-attention over x (B, S, D) normed: bidirectional (the
    encoder) without `positions`, else the decoder's training form, RoPE
    at `positions` and the blockwise causal attention. Returns (B, S, D)
    in x's dtype."""
    if positions is not None:
        return attention_train(p, x, cfg, positions, lay,
                               rope=dict(base=cfg.rope_base))
    b, s, _ = x.shape
    q, k, v = (t.reshape(b, s, -1, cfg.hd) for t in _qkv(p, x, x, lay))
    return _out(p, _full_attn(q, k, v, cfg.hd), x.dtype, lay)


def _cross_attn(p, x: torch.Tensor, enc_out: torch.Tensor,
                cfg: ModelConfig, lay: _Layout) -> torch.Tensor:
    """The decoder's training-form cross-attention: queries from x (B, S,
    D) normed, keys and values from the encoder output (B, F, D)."""
    b = x.shape[0]
    q, k, v = (t.reshape(b, t.shape[1], -1, cfg.hd)
               for t in _qkv(p, x, enc_out, lay))
    return _out(p, _full_attn(q, k, v, cfg.hd), x.dtype, lay)


def encode(params, frames: torch.Tensor, cfg: ModelConfig,
           lay: Optional[_Layout] = None) -> torch.Tensor:
    """frames: (B, encoder_frames, D) precomputed frame embeddings (the
    stubbed frontend). Returns the normed encoder output (B, F, D). Under
    a mesh (`lay`) frames are the rank's rows and the heads and `d_ff`
    its own."""
    lay = lay or _plain_layout(cfg)
    x = frames.to(torch_dtype(cfg.dtype)) + params["enc_pos"][None]
    for p in unstack_layers(params["encoder"], cfg.encoder_layers or cfg.n_layers):
        x = x + _self_attn(p["attn"], rms_norm(x, p["ln1"]), cfg, lay)
        x = x + _mlp(p["mlp"], rms_norm(x, p["ln2"]), lay)
    return rms_norm(x, params["enc_norm"])


def _decoder_layer(p, x: torch.Tensor, enc_out: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig,
                   lay: _Layout) -> torch.Tensor:
    x = x + _self_attn(p["self_attn"], rms_norm(x, p["ln1"]), cfg, lay,
                       positions)
    x = x + _cross_attn(p["cross_attn"], rms_norm(x, p["ln2"]), enc_out, cfg,
                        lay)
    return x + _mlp(p["mlp"], rms_norm(x, p["ln3"]), lay)


def _forward_train(params, tokens, cfg, frames, mesh, rules, remat):
    b, s = tokens.shape
    lay = (_plain_layout(cfg) if mesh is None
           else _layout(cfg, mesh, rules, b, s))
    if frames is None:
        frames = torch.zeros((b, cfg.encoder_frames, cfg.d_model),
                             dtype=torch_dtype(cfg.dtype),
                             device=params["enc_pos"].device)
    enc_out = encode(params, frames[lay.pl.rows], cfg, lay)
    tokens = tokens[lay.pl.rows]
    x = lay.pl.embed(params["embed"], lay.embed, tokens)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(tokens.shape[0], s)
    for p in unstack_layers(params["decoder"], cfg.n_layers):
        x = remat_call(_decoder_layer, remat, p, x, enc_out, positions, cfg,
                       lay)
    x = rms_norm(x, params["final_norm"])
    return (*lay.pl.vocab_logits(x, params["lm_head"], lay.head), lay)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  frames: Optional[torch.Tensor] = None, mesh=None,
                  rules: Optional[MeshRules] = None,
                  patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V), under autograd: the encoder over
    `frames` (zeros in the config dtype when None, as in the reference),
    then the decoder layers, each recomputed in the backward pass under
    `remat` (the encoder is not, as in the reference). `patch_embeds` is
    taken and ignored, as the reference's is. Under a `mesh` and its
    `rules` (frames and tokens global): the logits of the rank's rows and
    vocabulary block, both stacks on the rank's heads and `d_ff`."""
    return _forward_train(params, tokens, cfg, frames, mesh, rules, remat)[0]


def loss_fn(params, batch, cfg: ModelConfig, *, mesh=None,
            rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask and frames); under a mesh this rank's share (see
    `transformer.loss_fn`)."""
    return train_loss(*_forward_train(params, batch["tokens"], cfg,
                                      batch.get("frames"), mesh, rules, True),
                      batch)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """The reference's decode state: self-attention K/V caches
    (L, B, max_len, KVH, hd), zero cross K/V (L, B, encoder_frames, KVH,
    hd), `length`, and under DSA the indexer-K cache and `prev_topk`
    seeded with the even spacing over [0, max(max_len - 1, 1)]."""
    dtype = dtype or torch_dtype(cfg.dtype)
    l, hd, kvh = cfg.n_layers, cfg.hd, cfg.n_kv_heads

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    state = {
        "k": zeros(l, batch, max_len, kvh, hd),
        "v": zeros(l, batch, max_len, kvh, hd),
        "ck": zeros(l, batch, cfg.encoder_frames, kvh, hd),
        "cv": zeros(l, batch, cfg.encoder_frames, kvh, hd),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.dsa.enabled:
        kk = min(cfg.dsa.k, max_len)
        state["idx_k"] = zeros(l, batch, max_len, cfg.dsa.indexer_dim)
        base = seed_slot_idx(kk, max(max_len, 2), device)
        state["prev_topk"] = base[None, None].expand(l, batch, kk).clone()
    return state


def state_specs(cfg: ModelConfig, rules: MeshRules, *, batch: int,
                max_len: int, seq_sharded: bool = False) -> Dict[str, Any]:
    """The reference's specs of `init_decode_state`'s leaves."""
    l, hd = cfg.n_layers, cfg.hd
    sp = rules.spec
    seq_ax = "seq_shard" if seq_sharded else None
    specs = {
        "k": sp(None, "batch", seq_ax, "kv_heads", None,
                sizes=(l, batch, max_len, cfg.n_kv_heads, hd)),
        "v": sp(None, "batch", seq_ax, "kv_heads", None,
                sizes=(l, batch, max_len, cfg.n_kv_heads, hd)),
        "ck": sp(None, "batch", None, "kv_heads", None,
                 sizes=(l, batch, cfg.encoder_frames, cfg.n_kv_heads, hd)),
        "cv": sp(None, "batch", None, "kv_heads", None,
                 sizes=(l, batch, cfg.encoder_frames, cfg.n_kv_heads, hd)),
        "length": P(None),
    }
    if cfg.dsa.enabled:
        specs["idx_k"] = sp(None, "batch", seq_ax, None,
                            sizes=(l, batch, max_len, cfg.dsa.indexer_dim))
        specs["prev_topk"] = sp(None, "batch", None,
                                sizes=(l, batch, min(cfg.dsa.k, max_len)))
    return specs


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
               mesh=None, rules: Optional[MeshRules] = None):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state). The new K/V (and indexer-K) rows are written in place at
    `length`, clamped to N-1 as the reference's `dynamic_update_slice`
    clamps it; DSA runs when N > `dsa.min_n`, decided from the shape.

    Under a `mesh` and its `rules` the step runs on one rank, as
    `transformer.serve_step` does (params and state the rank's blocks,
    tokens global, the logits of the rank's rows): the self-attention's
    DSA (B5 -> B1 -> B6 on the card) on the rank's KV heads, the
    cross-attention on its heads of `ck`/`cv`, the GELU MLP by `d_ff`,
    the embedding and head by vocabulary (replicated where it does not
    divide)."""
    hd = cfg.hd
    n = state["k"].shape[2]
    lay = (_plain_layout(cfg) if mesh is None
           else _layout(cfg, mesh, rules, tokens.shape[0], n))
    positions = state["length"][lay.pl.rows]
    b = positions.shape[0]
    new_len = positions + 1
    use_dsa = cfg.dsa.enabled and n > cfg.dsa.min_n
    rows = torch.arange(b, device=positions.device)
    wpos = positions.clamp(max=n - 1).long()
    enc_len = torch.full((b,), state["ck"].shape[2], dtype=torch.int32,
                         device=positions.device)
    pos = positions[:, None]
    hl, kvl = lay.heads.hl, lay.heads.kvl
    x = lay.pl.embed(params["embed"], lay.embed, tokens[lay.pl.rows])  # (B, D)
    topk_out = []
    for i in range(cfg.n_layers):
        p = layer_params(params["decoder"], i)
        pa = p["self_attn"]
        hs = rms_norm(x, p["ln1"])
        q, kn, vn = _qkv(pa, hs, hs, lay)
        q = apply_rotary(q.reshape(b, 1, hl, hd), pos,
                         base=cfg.rope_base)[:, 0]
        kn = apply_rotary(kn.reshape(b, 1, kvl, hd), pos,
                          base=cfg.rope_base)[:, 0]
        kc, vc = state["k"][i], state["v"][i]
        kc[rows, wpos] = kn.to(kc.dtype)
        vc[rows, wpos] = vn.reshape(b, kvl, hd).to(vc.dtype)
        if cfg.dsa.enabled:
            idx_kc = state["idx_k"][i]
            idx_kc[rows, wpos] = dsa_mod.indexer_k(
                p["indexer"], hs, positions, dim=cfg.dsa.indexer_dim,
                rope_base=cfg.rope_base).to(idx_kc.dtype)
        if use_dsa:
            res = dsa_mod.dsa_decode(
                q, kc, vc, p["indexer"], hs, idx_kc, state["prev_topk"][i],
                new_len, k=state["prev_topk"].shape[-1], scale=hd ** -0.5,
                heads=cfg.dsa.indexer_heads, dim=cfg.dsa.indexer_dim,
                rope_base=cfg.rope_base, selector=cfg.dsa.selector,
                max_candidates=cfg.dsa.max_candidates,
                gate_max_n=cfg.dsa.gate_max_n, min_n=cfg.dsa.min_n)
            att = res.attn_out
            topk_out.append(res.topk_idx.int())
        else:
            att = decode_attention(q, kc, vc, new_len, scale=hd ** -0.5)
        x = x + _out(pa, att, x.dtype, lay)
        # cross-attention over the precomputed encoder K/V (exact)
        pc = p["cross_attn"]
        qc = lay.pl.cols(rms_norm(x, p["ln2"]), pc["wq"], lay.layer["wq"][1],
                         gather=lay.heads.axis is None, tag="wq")
        attc = decode_attention(qc.reshape(b, hl, hd), state["ck"][i],
                                state["cv"][i], enc_len, scale=hd ** -0.5)
        x = x + _out(pc, attc, x.dtype, lay)
        x = x + _mlp(p["mlp"], rms_norm(x, p["ln3"]), lay)
    new_state = dict(state, length=state["length"] + 1)
    if topk_out:
        new_state["prev_topk"] = torch.stack(topk_out)
    x = rms_norm(x, params["final_norm"])
    return lay.pl.logits(x, params["lm_head"], lay.head), new_state
