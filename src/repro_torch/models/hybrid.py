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

The reference serves this family step by step only: it defines no
slot-wise, paged or speculative hooks, so `DecodeEngine` refuses it. The
K/V and indexer-K caches are written in place (the
`transformer.serve_step` convention); `h`, `conv`, `length` and, under
DSA, `prev_topk` come back as new tensors.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.temporal import linspace_i32
from repro_torch.sparse import dsa as dsa_mod
from .config import ModelConfig
from .layers import (apply_rotary, blockwise_causal_attention, cross_entropy,
                     decode_attention, moe_mlp_dense_fallback, remat_call,
                     rms_norm, swiglu_mlp)
from .transformer import layer_params, torch_dtype, unstack_layers

SB = 8  # superblock size: 1 attention layer + 7 Mamba layers


def _dims(cfg: ModelConfig):
    """(d_inner, d_state, dt_rank, d_conv) of the Mamba layers."""
    d = cfg.d_model
    return d * cfg.mamba_expand, cfg.mamba_d_state, max(d // 16, 1), cfg.mamba_d_conv


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device) -> Dict[str, Any]:
    """Random-init parameters from `generator` in the reference's tree and
    at its scales: N(0, 1/fan_in) weights (the experts' w_gate and w_up
    at E^-0.5, as the reference's `_dense` scales by shape[0]; the
    embedding at 1; `conv_w` N(0, 0.01)), unit norms, and the f32 Mamba
    constants (`conv_b` and `dt_bias` 0, `d_skip` 1, `a_log` =
    log(1..d_state), taken in numpy: torch's float32 log rounds log(7)
    one ulp away from the reference's). Each superblock's layers are drawn one at a time
    into the model dtype: a whole f32 draw of the experts would be a
    temporary as large as the bf16 weights twice over."""
    if cfg.n_layers % SB:
        raise ValueError(f"jamba layers must be a multiple of {SB}, got "
                         f"{cfg.n_layers}")
    dtype = torch_dtype(cfg.dtype)
    nsb = cfg.n_layers // SB
    d, hd, f = cfg.d_model, cfg.hd, cfg.d_ff
    di, ds, dtr, dc = _dims(cfg)
    e, fe = cfg.moe.num_experts, cfg.moe.expert_d_ff

    def dense(shape, scale, dt=dtype):
        return (torch.randn(shape, generator=generator, device=device)
                * scale).to(dt)

    def stacked(lead, shape, scale, dt=dtype):
        out = torch.empty(lead + shape, dtype=dt, device=device)
        layers = out.view((-1,) + shape)
        for i in range(layers.shape[0]):
            layers[i] = dense(shape, scale, dt)
        return out

    def f32(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    m, h = (nsb, SB - 1), (nsb, SB // 2)
    attn = {
        "ln": f32((nsb, d), 1.0),
        "wq": stacked((nsb,), (d, cfg.n_heads * hd), d ** -0.5),
        "wk": stacked((nsb,), (d, cfg.n_kv_heads * hd), d ** -0.5),
        "wv": stacked((nsb,), (d, cfg.n_kv_heads * hd), d ** -0.5),
        "wo": stacked((nsb,), (cfg.n_heads * hd, d), (cfg.n_heads * hd) ** -0.5),
    }
    if cfg.dsa.enabled:
        attn["indexer"] = dsa_mod.indexer_init(
            generator, d, cfg.dsa.indexer_heads, cfg.dsa.indexer_dim, dtype,
            device, layers=nsb)
    mamba = {
        "ln": f32(m + (d,), 1.0),
        "in_proj": stacked(m, (d, 2 * di), d ** -0.5),
        "conv_w": stacked(m, (dc, di), 0.1),
        "conv_b": f32(m + (di,), 0.0),
        "x_proj": stacked(m, (di, dtr + 2 * ds), di ** -0.5),
        "dt_proj": stacked(m, (dtr, di), dtr ** -0.5),
        "dt_bias": f32(m + (di,), 0.0),
        "a_log": torch.as_tensor(np.log(np.arange(1, ds + 1, dtype=np.float32)),
                                 device=device).expand(m + (di, ds)).contiguous(),
        "d_skip": f32(m + (di,), 1.0),
        "out_proj": stacked(m, (di, d), di ** -0.5),
    }
    ffn = {
        "ln": f32(h + (d,), 1.0),
        "w_gate": stacked(h, (d, f), d ** -0.5),
        "w_up": stacked(h, (d, f), d ** -0.5),
        "w_down": stacked(h, (f, d), f ** -0.5),
    }
    moe = {
        "ln": f32(h + (d,), 1.0),
        "router": stacked(h, (d, e), d ** -0.5, torch.float32),
        "w_gate": stacked(h, (e, d, fe), e ** -0.5),
        "w_up": stacked(h, (e, d, fe), e ** -0.5),
        "w_down": stacked(h, (e, fe, d), fe ** -0.5),
    }
    return {
        "embed": dense((cfg.vocab, d), 1.0),
        "blocks": {"attn": attn, "mamba": mamba, "dense": ffn, "moe": moe},
        "final_norm": f32((d,), 1.0),
        "lm_head": dense((d, cfg.vocab), d ** -0.5),
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


def _mamba_step(p, x: torch.Tensor, h: torch.Tensor, conv: torch.Tensor,
                cfg: ModelConfig):
    """One decode token of a Mamba layer. x: (B, D) normed input; h: (B,
    d_inner, d_state) f32; conv: (B, d_conv - 1, d_inner). Returns (out
    (B, D), new h, new conv)."""
    di, ds, dtr, _ = _dims(cfg)
    xz = x @ p["in_proj"]
    x1, z = xz[..., :di], xz[..., di:]
    window = torch.cat([conv, x1[:, None]], dim=1)          # (B, dc, di)
    xc = torch.einsum("bcd,cd->bd", window.float(), p["conv_w"].float())
    xc = F.silu(xc + p["conv_b"]).to(x.dtype)
    proj = xc @ p["x_proj"]
    dt = F.softplus(proj[..., :dtr] @ p["dt_proj"] + p["dt_bias"])  # f32
    bmat = proj[..., dtr:dtr + ds].float()
    cmat = proj[..., dtr + ds:].float()
    a = -torch.exp(p["a_log"])
    ad = torch.exp(dt.float()[..., None] * a[None])
    h = ad * h + (dt.float() * xc.float())[..., None] * bmat[:, None, :]
    y = torch.einsum("bds,bs->bd", h, cmat) + p["d_skip"] * xc.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], h, window[:, 1:]


def _ffn(p, x: torch.Tensor, cfg: ModelConfig, is_moe: bool) -> torch.Tensor:
    """The feed-forward over x normed: the MoE or SwiGLU. x is (B, D), one
    token per row, which the MoE takes in the reference's (B, 1, D) call
    shape, or the training path's (B, S, D)."""
    if is_moe:
        return moe_mlp_dense_fallback(
            x.reshape(x.shape[0], -1, x.shape[-1]), p["router"], p["w_gate"],
            p["w_up"], p["w_down"], top_k=cfg.moe.top_k).reshape(x.shape)
    return swiglu_mlp(x, p["w_gate"], p["w_up"], p["w_down"])


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype, as JAX multiplies an f32 activation by
    a bf16 weight."""
    dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt) @ w.to(dt)


def _mamba_train(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A Mamba layer over (B, S, D) normed, the reference's training form:
    the causal depthwise conv summed in x's dtype (the step form sums it
    in f32), the SiLU after the f32 `conv_b` in f32, and the selective
    scan over S in f32 from a zero state."""
    b, s, _ = x.shape
    di, ds, dtr, dc = _dims(cfg)
    xz = x @ p["in_proj"]
    x1, z = xz[..., :di], xz[..., di:]
    xp = F.pad(x1, (0, 0, dc - 1, 0))
    x1 = sum(xp[:, i:i + s] * p["conv_w"][i][None, None] for i in range(dc))
    x1 = F.silu(x1 + p["conv_b"])
    proj = _mm(x1, p["x_proj"])
    dt = F.softplus(_mm(proj[..., :dtr], p["dt_proj"]) + p["dt_bias"]).float()
    bmat = proj[..., dtr:dtr + ds].float()
    cmat = proj[..., dtr + ds:].float()
    a = -torch.exp(p["a_log"])
    xf = x1.float()
    h = torch.zeros((b, di, ds), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        h = (torch.exp(dt[:, t, :, None] * a[None]) * h
             + (dt[:, t] * xf[:, t])[..., None] * bmat[:, t, None, :])
        ys.append(torch.einsum("bds,bs->bd", h, cmat[:, t]))
    y = torch.stack(ys, dim=1) + p["d_skip"] * xf
    return (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]


def _superblock_train(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig) -> torch.Tensor:
    """One superblock over (B, S, D): the attention layer (RoPE, the
    blockwise causal attention), then the 8 layers' Mamba (i > 0) and
    feed-forward (MoE on odd i, dense on even) in the reference's order."""
    b, s, _ = x.shape
    hd = cfg.hd
    pa = p["attn"]
    h = rms_norm(x, pa["ln"])
    q = apply_rotary((h @ pa["wq"]).reshape(b, s, cfg.n_heads, hd), positions,
                     base=cfg.rope_base)
    k = apply_rotary((h @ pa["wk"]).reshape(b, s, cfg.n_kv_heads, hd),
                     positions, base=cfg.rope_base)
    v = (h @ pa["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
    att = blockwise_causal_attention(q, k, v, scale=hd ** -0.5)
    x = x + att.reshape(b, s, -1).to(x.dtype) @ pa["wo"]
    mamba = unstack_layers(p["mamba"], SB - 1)
    ffn = {kind: unstack_layers(p[kind], SB // 2) for kind in ("dense", "moe")}
    for i in range(SB):
        if i > 0:
            pm = mamba[i - 1]
            x = x + _mamba_train(pm, rms_norm(x, pm["ln"]), cfg)
        kind = "moe" if i % 2 == 1 else "dense"
        pf = ffn[kind][i // 2]
        x = x + _ffn(pf, rms_norm(x, pf["ln"]), cfg, kind == "moe")
    return x


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V), under autograd; each superblock
    is recomputed in the backward pass under `remat` (the reference's
    `jax.checkpoint` of the superblock). No DSA: the indexer weights get
    a zero gradient."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    for p in unstack_layers(params["blocks"], cfg.n_layers // SB):
        x = remat_call(_superblock_train, remat, p, x, positions, cfg)
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask)."""
    return cross_entropy(forward_train(params, batch["tokens"], cfg), batch)


def attention_layer(pa, x: torch.Tensor, state, sb: int, cfg: ModelConfig):
    """Superblock `sb`'s attention layer on the residual x (B, D): writes
    the new K/V (and indexer-K) rows in place at `length`, clamped to N-1
    as the reference's `dynamic_update_slice` clamps it, then attends —
    through DSA when N > `dsa.min_n`, densely otherwise. Returns (attn
    (B, H, hd) f32, the layer's next `prev_topk` (B, K) or None)."""
    b = x.shape[0]
    hd, kvh = cfg.hd, cfg.n_kv_heads
    positions = state["length"]
    new_len = positions + 1
    n = state["k"].shape[2]
    rows = torch.arange(b, device=positions.device)
    wpos = positions.clamp(max=n - 1).long()
    pos = positions[:, None]
    h = rms_norm(x, pa["ln"])
    q = apply_rotary((h @ pa["wq"]).reshape(b, 1, cfg.n_heads, hd), pos,
                     base=cfg.rope_base)[:, 0]
    kn = apply_rotary((h @ pa["wk"]).reshape(b, 1, kvh, hd), pos,
                      base=cfg.rope_base)[:, 0]
    kc, vc = state["k"][sb], state["v"][sb]
    kc[rows, wpos] = kn.to(kc.dtype)
    vc[rows, wpos] = (h @ pa["wv"]).reshape(b, kvh, hd).to(vc.dtype)
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
               seq_sharded: bool = False):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state). Per superblock: the attention layer, then the 8 layers in
    the reference's order — Mamba on layers 1-7, then the MoE on odd
    layers and the dense FFN on even ones."""
    if seq_sharded:
        raise NotImplementedError(
            "seq_sharded serving of the hybrid family needs a "
            "('data', 'model') mesh, which the port does not build yet "
            "(ROADMAP item 7)")
    b = tokens.shape[0]
    x = params["embed"][tokens.long()]                     # (B, D)
    h_out, conv_out, topk_out = [], [], []
    for sb in range(cfg.n_layers // SB):
        p = layer_params(params["blocks"], sb)
        pa = p["attn"]
        att, topk = attention_layer(pa, x, state, sb, cfg)
        if topk is not None:
            topk_out.append(topk)
        x = x + att.reshape(b, -1).to(x.dtype) @ pa["wo"]
        hs, convs = [], []
        for i in range(SB):
            if i > 0:
                pm = layer_params(p["mamba"], i - 1)
                y, hn, cn = _mamba_step(pm, rms_norm(x, pm["ln"]),
                                        state["h"][sb, i - 1],
                                        state["conv"][sb, i - 1], cfg)
                x = x + y
                hs.append(hn)
                convs.append(cn)
            kind = "moe" if i % 2 == 1 else "dense"
            pf = layer_params(p[kind], i // 2)
            x = x + _ffn(pf, rms_norm(x, pf["ln"]), cfg, kind == "moe")
        h_out.append(torch.stack(hs))
        conv_out.append(torch.stack(convs))
    new_state = dict(state, h=torch.stack(h_out), conv=torch.stack(conv_out),
                     length=state["length"] + 1)
    if topk_out:
        new_state["prev_topk"] = torch.stack(topk_out)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), new_state
