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

from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.parallel.sharding import MeshRules, P, stacked

from .config import ModelConfig
from .layers import cross_entropy, remat_call, rms_norm
from .transformer import drawer, layer_params, torch_dtype, unstack_layers

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


def _time_mix_step(p, x: torch.Tensor, x_prev: torch.Tensor, s: torch.Tensor,
                   cfg: ModelConfig):
    """One token of the WKV6 recurrence. x: (B, D) normed input; x_prev:
    (B, D) f32; s: (B, H, hd, hd) f32. Returns (out (B, D) in the weight
    dtype, new s)."""
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    h = d // hd
    b = x.shape[0]

    def proj(mix, w):
        return _mix(x, x_prev, p[mix]).to(p[w].dtype) @ p[w]

    r = proj("mix_r", "wr").reshape(b, h, hd).float()
    k = proj("mix_k", "wk").reshape(b, h, hd).float()
    v = proj("mix_v", "wv").reshape(b, h, hd).float()
    g = F.silu(proj("mix_g", "wg"))
    # Finch: data-dependent per-channel decay
    lora = torch.tanh(proj("mix_w", "w_a")) @ p["w_b"]
    w = torch.exp(-torch.exp(p["w0"] + lora)).reshape(b, h, hd).float()
    kv = torch.einsum("bhk,bhv->bhkv", k, v)
    out = torch.einsum("bhk,bhkv->bhv", r, s + p["u"][None, :, :, None] * kv)
    s_new = w[..., None] * s + kv
    out = rms_norm(out.reshape(b, d), p["ln_x"])
    return (out * g.to(out.dtype)).to(p["wo"].dtype) @ p["wo"], s_new


def _channel_mix_step(p, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Token-shifted squared-ReLU FFN with a sigmoid receptance gate."""
    k = torch.relu(_mix(x, x_prev, p["mix_ck"]).to(p["ck"].dtype) @ p["ck"]).square()
    r = torch.sigmoid(_mix(x, x_prev, p["mix_cr"]).to(p["cr"].dtype) @ p["cr"])
    return r * (k @ p["cv"])


def _shifted(x: torch.Tensor) -> torch.Tensor:
    """Token shift over (B, S, D): row t holds x[t - 1], row 0 zeros."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _layer_train(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One layer over (B, S, D), the reference's training form: the
    projections run over all S positions at once, only the WKV state
    update steps through time, in f32 from a zero state."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    h = d // hd
    xa = rms_norm(x, p["ln1"])
    xa_prev = _shifted(xa)

    def proj(mix, w):
        return _mix(xa, xa_prev, p[mix]).to(p[w].dtype) @ p[w]

    r, k, v = (proj(f"mix_{n}", f"w{n}").reshape(b, s, h, hd).float()
               for n in "rkv")
    g = F.silu(proj("mix_g", "wg"))
    lora = torch.tanh(proj("mix_w", "w_a")) @ p["w_b"]
    w = torch.exp(-torch.exp(p["w0"] + lora)).reshape(b, s, h, hd).float()
    st = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    outs = []
    for t in range(s):
        kv = torch.einsum("bhk,bhv->bhkv", k[:, t], v[:, t])
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 st + p["u"][None, :, :, None] * kv))
        st = w[:, t, ..., None] * st + kv
    att = rms_norm(torch.stack(outs, dim=1).reshape(b, s, d), p["ln_x"])
    att = (att * g.reshape(b, s, d).to(att.dtype)).to(p["wo"].dtype) @ p["wo"]
    x = x + att.to(x.dtype)
    xc = rms_norm(x, p["ln2"])
    return x + _channel_mix_step(p, xc, _shifted(xc)).to(x.dtype)


def forward_train(params, tokens: torch.Tensor, cfg: ModelConfig, *,
                  patch_embeds=None, remat: bool = True) -> torch.Tensor:
    """tokens (B, S) → logits (B, S, V), under autograd; each layer is
    recomputed in the backward pass under `remat`."""
    x = params["embed"][tokens.long()]
    for p in unstack_layers(params["layers"], cfg.n_layers):
        x = remat_call(_layer_train, remat, p, x, cfg)
    return rms_norm(x, params["final_norm"]) @ params["lm_head"]


def loss_fn(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (tokens, targets, optional
    mask)."""
    return cross_entropy(forward_train(params, batch["tokens"], cfg), batch)


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


def serve_step(params, state, tokens: torch.Tensor, cfg: ModelConfig):
    """One decode step. tokens: (B,) int. Returns (logits (B, V) f32,
    new_state); the state's tensors are not modified."""
    x = params["embed"][tokens.long()]                    # (B, D)
    s_out, xa_out, xf_out = [], [], []
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        xa = rms_norm(x, p["ln1"])
        att, s_new = _time_mix_step(p, xa, state["x_att"][i], state["s"][i], cfg)
        x = x + att.to(x.dtype)
        xf = rms_norm(x, p["ln2"])
        x = x + _channel_mix_step(p, xf, state["x_ffn"][i]).to(x.dtype)
        s_out.append(s_new)
        xa_out.append(xa.float())
        xf_out.append(xf.float())
    new_state = dict(state, s=torch.stack(s_out), x_att=torch.stack(xa_out),
                     x_ffn=torch.stack(xf_out), length=state["length"] + 1)
    x = rms_norm(x, params["final_norm"])
    return (x @ params["lm_head"]).float(), new_state
