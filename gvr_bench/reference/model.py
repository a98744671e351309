"""The served model, token by token over a restored document.

`logits(...)` runs the decoder of the configuration's `model` block over
tokens fed at positions start, start + 1, ...: the document's rows
[0, start) come from `doc_rows(layer)` (the benchmark's draws), the fed
tokens' own K, V and indexer-K rows are computed here. Per layer:

    h = RMSNorm(x);  q, k, v = h Wq, h Wk, h Wv, RoPE on the first
    `rope_fraction` of each head's dims
    DSA (on when `dsa_on`): indexer queries qI = RoPE(h WqI) (Hi heads),
    key kI = RoPE(h WkI); score of position j <= t:
    I_j = sum_h w_h ReLU(qI_h . kI_j); the K positions of largest I
    (exact Top-K); attention over them
    else: attention over every position j <= t
    attention: softmax(q . k_j / sqrt(hd)) v_j, query head g reading KV
    head g // (H / KVH)
    x += attn Wo;  x += SwiGLU(RMSNorm(x))
    logits = RMSNorm(x) W_head

Everything in float32 from the weights the benchmark drew (bf16 values).
`low` rounds every product's operands, the cache rows and the queries:
"fp8" is the control (float8 e4m3 per row); "bf16" is a witness that
computes as a bfloat16 model stores, its products and residual stream
rounded too.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from .ops import mm, rms_norm, rnd, rope


def _layer(layers: Dict, i: int) -> Dict:
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


def _attend(q: torch.Tensor, keys: torch.Tensor, vals: torch.Tensor,
            mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (T, H, hd); keys/vals (T, S, KVH, hd) per query; mask (T, S).
    Returns (T, H, hd)."""
    t, h, hd = q.shape
    kvh = keys.shape[2]
    g = h // kvh
    qg = q.reshape(t, kvh, g, hd)
    logit = torch.einsum("tkgd,tskd->tkgs", qg, keys) * scale
    logit = logit.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.softmax(logit, dim=-1)
    return torch.einsum("tkgs,tskd->tkgd", p, vals).reshape(t, h, hd)


def logits(weights: Dict, m: Dict, tokens: torch.Tensor, start: int,
           doc_rows: Callable[[int], Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]],
           *, dsa_on: bool, eps: float, low=None,
           block: int = 8) -> torch.Tensor:
    """(T, V) float32 logits of the tokens (T,) fed at positions start ..
    start + T - 1 after the document's `start` rows. `doc_rows(layer)`
    gives that layer's (K (start, KVH, hd), V, indexer-K (start, di))."""
    dev = tokens.device
    t_n = tokens.shape[0]
    h_n, kvh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    dsa = m["dsa"]
    if m.get("moe"):
        raise ValueError("the reference runs dense feed-forward layers only")
    pos = start + torch.arange(t_n, device=dev)
    n_all = start + t_n
    scale = hd ** -0.5
    rows = lambda x: rnd(x, low)                      # noqa: E731
    # the residual stream: bfloat16 in the witness, float32 otherwise
    resid = lambda x: rnd(x, low if low == "bf16" else None)  # noqa: E731
    x = resid(weights["embed"][tokens.long()].float())
    for i in range(m["n_layers"]):
        p = _layer(weights["layers"], i)
        h = rms_norm(x, p["ln1"], eps)
        q = rope(mm(h, p["wq"], low).reshape(t_n, h_n, hd), pos,
                 base=m["rope_base"], fraction=m["rope_fraction"])
        k = rope(mm(h, p["wk"], low).reshape(t_n, kvh, hd), pos,
                 base=m["rope_base"], fraction=m["rope_fraction"])
        v = mm(h, p["wv"], low).reshape(t_n, kvh, hd)
        kd, vd, ikd = doc_rows(i)
        keys = rows(torch.cat([kd.float(), k]))             # (N, KVH, hd)
        vals = rows(torch.cat([vd.float(), v]))
        q = rows(q)
        out = torch.empty((t_n, h_n, hd), device=dev)
        if dsa_on:
            ip = p["indexer"]
            hi, di = dsa["indexer_heads"], dsa["indexer_dim"]
            iq = rows(rope(mm(h, ip["wq"], low).reshape(t_n, hi, di), pos,
                           base=m["rope_base"]))
            ik = rope(mm(h, ip["wk"], low).reshape(t_n, 1, di), pos,
                      base=m["rope_base"])[:, 0]
            ikeys = rows(torch.cat([ikd.float(), ik]))      # (N, di)
            w = ip["w"].float()
        for b0 in range(0, t_n, block):
            b1 = min(b0 + block, t_n)
            causal = (torch.arange(n_all, device=dev)[None, :]
                      <= pos[b0:b1, None])                 # (tb, N)
            if dsa_on:
                sc = torch.relu(torch.einsum("thd,nd->thn", iq[b0:b1], ikeys))
                score = torch.einsum("thn,h->tn", sc, w)
                score = score.masked_fill(~causal, float("-inf"))
                kk = min(dsa["k"], n_all)
                sel = torch.topk(score, kk, dim=-1).indices  # (tb, K)
                valid = torch.gather(causal, 1, sel)
                out[b0:b1] = _attend(q[b0:b1], keys[sel], vals[sel], valid,
                                     scale)
            else:
                tb = b1 - b0
                out[b0:b1] = _attend(q[b0:b1],
                                     keys[None].expand(tb, -1, -1, -1),
                                     vals[None].expand(tb, -1, -1, -1),
                                     causal, scale)
        x = resid(x + mm(out.reshape(t_n, h_n * hd), p["wo"], low))
        h2 = rms_norm(x, p["ln2"], eps)
        x = resid(x + mm(F.silu(mm(h2, p["w_gate"], low))
                        * mm(h2, p["w_up"], low), p["w_down"], low))
    head = weights["lm_head"] if "lm_head" in weights else weights["embed"].T
    return mm(rms_norm(x, weights["final_norm"], eps), head, low)
