"""RWKV6 'Finch' (ssm family), PyTorch port of the JAX package's
`models/ssm.py`: parameters, the training forward, the decode state and
the one-token decode step.

Per layer a time-mix block (the WKV recurrence with per-channel
data-dependent decay w_t = exp(-exp(w0 + LoRA(x)))) and a channel-mix
block (token-shifted squared-ReLU FFN). The model is attention-free: no
KV cache, no Top-K selection, no DSA (DESIGN.md §Arch-applicability),
and the reference has no Pallas kernel for it, so the recurrence runs in
plain PyTorch.

The dtype chain follows the reference, which matters in bf16: the
token-shift mixes promote to f32 (the `mix_*` leaves and the stored
previous inputs are f32), each mix is cast to the weight dtype before
its matmul, the LoRA's tanh is taken in the weight dtype and `w0` added
in f32, the WKV update runs in f32 on `s`, and `x_att` / `x_ffn` keep the
normed inputs in f32. The training form (`_layer_train`) has its own
chain, as in the reference: the shifted inputs are the normed rows in
the activation dtype, r/k/v/w go to f32 for the recurrence over S, and
each block's output is cast to the activation dtype before its residual
add. The reference serves this family step by step only: it defines no
slot-wise or paged hooks, so `DecodeEngine` refuses it.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import MeshRules, P, stacked, unstacked

from .config import ModelConfig
from .layers import remat_call, rms_norm
from .tensor_parallel import Placement
from .transformer import (drawer, layer_params, torch_dtype, train_loss,
                          unstack_layers)

LORA_R = 32


def init_params(cfg: ModelConfig, generator: torch.Generator, device,
                block=None) -> Dict[str, Any]:
    """Random-init parameters from `generator`, the reference's tree
    stacked over layers: N(0, 1/fan_in) weights (the embedding at 1),
    unit norms, mixes 0.5, `w0` -0.5 and the bonus `u` 0, all f32. The
    weights are drawn one layer at a time (`transformer.drawer`; `block`
    cuts each to a rank's block)."""
    dtype = torch_dtype(cfg.dtype)
    l, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    hd = cfg.rwkv_head_dim
    draw = drawer(generator, device, dtype, block)

    def dense(name, shape, scale):
        return draw((l,), shape, scale, "layers/" + name)

    def f32(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    layers = {"ln1": f32((l, d), 1.0), "ln2": f32((l, d), 1.0)}
    for name in ("mix_r", "mix_k", "mix_v", "mix_w", "mix_g"):
        layers[name] = f32((l, d), 0.5)
    layers.update(
        w0=f32((l, d), -0.5),
        w_a=dense("w_a", (d, LORA_R), d ** -0.5),
        w_b=dense("w_b", (LORA_R, d), LORA_R ** -0.5),
        u=f32((l, d // hd, hd), 0.0),
        wr=dense("wr", (d, d), d ** -0.5), wk=dense("wk", (d, d), d ** -0.5),
        wv=dense("wv", (d, d), d ** -0.5), wg=dense("wg", (d, d), d ** -0.5),
        wo=dense("wo", (d, d), d ** -0.5),
        ln_x=f32((l, d), 1.0),
        mix_ck=f32((l, d), 0.5), mix_cr=f32((l, d), 0.5),
        ck=dense("ck", (d, f), d ** -0.5), cv=dense("cv", (f, d), f ** -0.5),
        cr=dense("cr", (d, d), d ** -0.5))
    return {
        "embed": draw((), (cfg.vocab, d), 1.0, "embed"),
        "layers": layers,
        "final_norm": f32((d,), 1.0),
        "lm_head": draw((), (d, cfg.vocab), d ** -0.5, "lm_head"),
    }


def param_specs(cfg: ModelConfig, rules: MeshRules) -> Dict[str, Any]:
    """The reference's specs of `init_params`'s tree under `rules`."""
    d = cfg.d_model
    sp = rules.spec
    vec = P(None)
    lp = {
        "ln1": vec, "ln2": vec, "ln_x": vec,
        "mix_r": vec, "mix_k": vec, "mix_v": vec, "mix_w": vec, "mix_g": vec,
        "w0": vec, "u": P(None, None),
        "w_a": P(None, None), "w_b": P(None, None),
        "wr": sp("d_model", "d_ff", sizes=(d, d)),
        "wk": sp("d_model", "d_ff", sizes=(d, d)),
        "wv": sp("d_model", "d_ff", sizes=(d, d)),
        "wg": sp("d_model", "d_ff", sizes=(d, d)),
        "wo": sp("d_ff", "d_model", sizes=(d, d)),
        "mix_ck": vec, "mix_cr": vec,
        "ck": sp("d_model", "d_ff", sizes=(d, cfg.d_ff)),
        "cv": sp("d_ff", "d_model", sizes=(cfg.d_ff, d)),
        "cr": sp("d_model", None, sizes=(d, d)),
    }
    return {
        "embed": sp("vocab", "d_model", sizes=(cfg.vocab, d)),
        "layers": stacked(lp),
        "final_norm": P(None),
        "lm_head": sp("d_model", "vocab", sizes=(d, cfg.vocab)),
    }


def _mix(x: torch.Tensor, x_prev: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Token shift: x·mix + x_prev·(1 - mix), in f32 (mix and x_prev are)."""
    return x * mix + x_prev * (1 - mix)


class _Layout(NamedTuple):
    """Where a step's arrays live on this rank: its placement, one
    layer's parameter specs and the vocabulary entries of the embedding
    and head. With no mesh the identity."""
    pl: Placement
    layer: Dict[str, Any]
    embed: Any
    head: Any


# no mesh: every weight whole
_PLAIN = _Layout(Placement(), {w: P(None, None) for w in (
    "wr", "wk", "wv", "wg", "wo", "w_a", "ck", "cv")}, None, None)


def _layout(cfg: ModelConfig, mesh, rules: MeshRules, batch: int) -> _Layout:
    psp = param_specs(cfg, rules)
    return _Layout(Placement(mesh, rules, batch), unstacked(psp["layers"]),
                   psp["embed"][0], psp["lm_head"][1])


def _time_mix(p, x: torch.Tensor, x_prev: torch.Tensor, lay: _Layout):
    """The time-mix projections of x normed against its shifted input:
    (r, k, v, g, w) with the trailing dimension D whole. Under a mesh
    `wr`/`wk`/`wv`/`wg` give the rank's columns and are gathered, so the
    recurrence runs on every head (the state spec keeps them whole)."""

    def proj(mix, w):
        return lay.pl.cols(_mix(x, x_prev, p[mix]).to(p[w].dtype), p[w],
                           lay.layer[w][1], gather=True, tag=w)

    r, k, v = (proj(f"mix_{n}", f"w{n}") for n in "rkv")
    g = F.silu(proj("mix_g", "wg"))
    # Finch: data-dependent per-channel decay
    lora = torch.tanh(proj("mix_w", "w_a")) @ p["w_b"]
    return r, k, v, g, torch.exp(-torch.exp(p["w0"] + lora))


def _time_mix_out(p, att: torch.Tensor, g: torch.Tensor,
                  lay: _Layout) -> torch.Tensor:
    """rms_norm(att) gated by g, through `wo` (its rows by the rank's
    slice of the channels, then a psum)."""
    att = rms_norm(att, p["ln_x"])
    return lay.pl.rows_in((att * g.to(att.dtype)).to(p["wo"].dtype), p["wo"],
                          lay.layer["wo"][0], local=False, tag="wo")


def _time_mix_step(p, x: torch.Tensor, x_prev: torch.Tensor, s: torch.Tensor,
                   cfg: ModelConfig, lay: Optional[_Layout] = None):
    """One token of the WKV6 recurrence. x: (B, D) normed input; x_prev:
    (B, D) f32; s: (B, H, hd, hd) f32. Returns (out (B, D) in the weight
    dtype, new s)."""
    lay = lay or _PLAIN
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    b = x.shape[0]
    r, k, v, g, w = _time_mix(p, x, x_prev, lay)
    r, k, v, w = (t.reshape(b, h, hd).float() for t in (r, k, v, w))
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, s + p["u"][None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    return _time_mix_out(p, out.reshape(b, d), g, lay), s_new


def _channel_mix_step(p, x: torch.Tensor, x_prev: torch.Tensor,
                      lay: Optional[_Layout] = None) -> torch.Tensor:
    """Token-shifted squared-ReLU FFN with a sigmoid receptance gate
    (`ck` by columns, `cv` by rows and a psum, `cr` whole)."""
    lay = lay or _PLAIN
    k = torch.relu(lay.pl.cols(_mix(x, x_prev, p["mix_ck"]).to(p["ck"].dtype),
                               p["ck"], lay.layer["ck"][1], tag="ck")).square()
    r = torch.sigmoid(_mix(x, x_prev, p["mix_cr"]).to(p["cr"].dtype) @ p["cr"])
    return r * lay.pl.rows_in(k, p["cv"], lay.layer["cv"][0], local=True,
                              tag="cv")


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """Token shift over (B, S, D): row t holds x[t - 1], row 0 zeros."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer_train(p, x: torch.Tensor, cfg: ModelConfig,
                 lay: _Layout) -> torch.Tensor:
    """One layer over (B, S, D), the reference's training form: the
    projections run over all S positions at once, only the WKV state
    update steps through time, in f32 from a zero state."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xa = rms_norm(x, p["ln1"])
    r, k, v, g, w = _time_mix(p, xa, _shifted(xa), lay)
    r, k, v, w = (t.reshape(b, s, h, hd).float() for t in (r, k, v, w))
    if k.is_meta:
        # the dry run: every step's update at once, the scan's shapes and
        # graph without its S host-side steps
        kv = torch.einsum("bthk,bthv->bthkv", k, v)
        wkv = torch.einsum("bthk,bthkv->bthv", r, w[..., None] * kv
                           + p["u"][None, None, :, :, None] * kv)
    else:
        st = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=x.device)
        outs = []
        for t in range(s):
            kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
            outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                     st + p["u"][None, :, :, None] * kv))
            st = w[:, t, ..., None] * st + kv
        wkv = torch.stack(outs, dim=1)
    att = _time_mix_out(p, wkv.reshape(b, s, d), g, lay)
    x = x + att.to(x.dtype)
    xc = rms_norm(x, p["ln2"])
    return x + _channel_mix_step(p, xc, _shifted(xc), lay).to(x.dtype)


def _forward_train(params, tokens, cfg, mesh, rules, remat):
    lay = _PLAIN if mesh is None else _layout(cfg, mesh, rules,
                                              tokens.shape[0])
    x = lay.pl.embed(params["embed"], lay.embed, tokens[lay.pl.rows])
    for p in unstack_layers(params["layers"], cfg.n_layers):
        x = remat_call(_layer_train, remat, p, x, cfg, lay)
    x = rms_norm(x, params["final_norm"])
    return (*lay.pl.vocab_logits(x, params["lm_head"], lay.head), lay)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  mesh=None, rules: Optional[MeshRules] = None,
                  patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V), under autograd; each layer is
    recomputed in the backward pass under `remat`. Under a `mesh` and its
    `rules`: the logits of the rank's rows and vocabulary block (the
    time-mix projections gathered, the recurrence on every head)."""
    return _forward_train(params, tokens, cfg, mesh, rules, remat)[0]


def loss_fn(params, batch, cfg: ModelConfig, *, mesh=None,
            rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask); under a mesh this rank's share (see `transformer.loss_fn`)."""
    return train_loss(*_forward_train(params, batch["tokens"], cfg, mesh,
                                      rules, True), batch)


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, *, device,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """O(1)-in-context decode state, f32 whatever `cfg.dtype` is: the WKV
    state `s` (L, B, H, hd, hd) and the token-shift inputs `x_att`,
    `x_ffn` (L, B, D); `max_len` and `dtype` are unused, as in the
    reference."""
    d, hd, l = cfg.d_model, cfg.rwkv_head_dim, cfg.n_layers

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"s": zeros(l, batch, d // hd, hd, hd), "x_att": zeros(l, batch, d),
            "x_ffn": zeros(l, batch, d),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


def state_specs(cfg: ModelConfig, rules: MeshRules, *, batch: int,
                max_len: int, seq_sharded: bool = False) -> Dict[str, Any]:
    """The reference's specs of `init_decode_state`'s leaves (the state
    does not grow with the sequence, so `seq_sharded` changes nothing)."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    sp = rules.spec
    return {
        "s": sp(None, "batch", None, None, None,
                sizes=(cfg.n_layers, batch, d // hd, hd, hd)),
        "x_att": sp(None, "batch", None, sizes=(cfg.n_layers, batch, d)),
        "x_ffn": sp(None, "batch", None, sizes=(cfg.n_layers, batch, d)),
        "length": P(None),
    }


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig, *,
               mesh=None, rules: Optional[MeshRules] = None):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state); the state's tensors are not modified. Under a `mesh` and
    its `rules` (params and state the rank's blocks, tokens global, the
    logits of the rank's rows): `wr`/`wk`/`wv`/`wg` and `ck` by columns,
    `wo` and `cv` by rows, the WKV state of the rank's rows with every
    head (its spec), the embedding and head by vocabulary."""
    lay = _PLAIN if mesh is None else _layout(cfg, mesh, rules,
                                              tokens.shape[0])
    x = lay.pl.embed(params["embed"], lay.embed, tokens[lay.pl.rows])  # (B, D)
    s_out, xa_out, xf_out = [], [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        xa = rms_norm(x, p["ln1"])
        att, s_new = _time_mix_step(p, xa, state["x_att"][i], state["s"][i],
                                    cfg, lay)
        x = x + att.to(x.dtype)
        xf = rms_norm(x, p["ln2"])
        x = x + _channel_mix_step(p, xf, state["x_ffn"][i], lay).to(x.dtype)
        s_out.append(s_new)
        xa_out.append(xa.float())
        xf_out.append(xf.float())
    new_state = dict(state, s=torch.stack(s_out), x_att=torch.stack(xa_out),
                     x_ffn=torch.stack(xf_out), length=state["length"] + 1)
    x = rms_norm(x, params["final_norm"])
    return lay.pl.logits(x, params["lm_head"], lay.head), new_state
