"""Shared model layers of the PyTorch port: norm, rotary embedding, the
training path's blockwise causal attention and cross-entropy, decode
attention, SwiGLU and GELU MLPs, the MoE feed-forward on one device.

Dtype handling follows the JAX package's `models/layers.py` step for step
(which ops run in f32, where results are cast back), so a float32 smoke
model agrees with it to rounding and a bf16 model rounds at the same places.
Weights are (in, out) and applied as `x @ W`.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    if x.is_meta:
        # the dry run: the result's shape, dtype and graph in one op (an
        # op costs ~0.2 ms on meta, and the norm runs twice a layer)
        return x * scale.to(x.dtype)
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope_freqs(dim: int, base: float, device) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (torch.tensor(base, dtype=torch.float32, device=device) ** exps)


def apply_rotary(x: torch.Tensor, positions: torch.Tensor, *, kind: str = "rope",
                 base: float = 10000.0, fraction: float = 1.0,
                 mrope_sections=(16, 24, 24)) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int, or (B, S, 3) for "mrope".
    Interleaved-pair RoPE over the first `fraction` of the head dims (the
    rest pass through). "mrope" (qwen2-vl) splits the frequency pairs into
    (temporal, height, width) sections, each rotated by its own position
    stream; 2-D positions become three identical streams, which is plain
    RoPE. Every other kind ("rope", "rope2d") is plain RoPE, as in the
    reference. On the meta device (the dry run) the positions' shape is
    checked and x's shape, dtype and graph returned in one op."""
    if x.is_meta:
        if tuple(positions.shape[:2]) != tuple(x.shape[:2]):
            raise ValueError(f"positions {tuple(positions.shape)} do not "
                             f"fit x {tuple(x.shape)}")
        return x.clone()
    d = x.shape[-1]
    rot_d = int(d * fraction) // 2 * 2
    xr, xp = x[..., :rot_d], x[..., rot_d:]
    freqs = _rope_freqs(rot_d, base, x.device)
    if kind == "mrope":
        if positions.dim() == 2:
            positions = positions[..., None].expand(positions.shape + (3,))
        sec = torch.cumsum(torch.tensor(mrope_sections, device=x.device), 0)
        sec_id = torch.searchsorted(sec, torch.arange(rot_d // 2, device=x.device),
                                    right=True) % 3
        pos = positions.float()[..., sec_id]               # (B, S, rot_d/2)
        ang = pos * freqs[None, None, :]
    else:
        ang = positions.float()[..., None] * freqs[None, None, :]
    cos = torch.cos(ang)[..., None, :].to(x.dtype)        # (B, S, 1, rot_d/2)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = xr[..., ::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    xr = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([xr, xp], dim=-1) if rot_d < d else xr


def remat_call(fn, remat: bool, *args):
    """fn(*args), recomputed in the backward pass when `remat` (the
    reference's `jax.checkpoint` of a layer): activations inside fn are
    not kept. The forward draws no random numbers, so no RNG state is
    stashed."""
    if not remat:
        return fn(*args)
    from torch.utils.checkpoint import checkpoint
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)


def blockwise_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               *, scale: float, q_block: int = 512,
                               kv_block: int = 1024,
                               window: Optional[int] = None) -> torch.Tensor:
    """The training path's causal attention, the reference's blockwise
    online softmax: q (B, S, H, D), k/v (B, S, KVH, D) → (B, S, H, D) f32,
    with no (S, S) buffer. GQA groups the H query heads as (KVH, G);
    `window` is the SWA width (a key at position j is seen from i when
    i - window < j <= i). Every (query block, key block) pair runs in the
    reference's order, masked ones too: under a window an early block
    whose row is all masked gives p = 1 that a later block's alpha = 0
    wipes, and the bits and gradients follow that order. Plain PyTorch
    under autograd: the reference has no kernel for it. On the meta device
    (the dry run) it is the two contractions over the whole row: the
    result's shape, dtype and graph to q, k and v in a few ops."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if q.is_meta and k.is_meta and v.is_meta:
        p = torch.einsum("bqkgd,bskd->bqkgs",
                         q.float().reshape(b, s, kvh, g, d), k.float())
        return torch.einsum("bqkgs,bskd->bqkgd", p,
                            v.float()).reshape(b, s, h, d)
    qb, kb = min(q_block, s), min(kv_block, s)
    assert s % qb == 0 and s % kb == 0
    nq, nk = s // qb, s // kb
    q = q.reshape(b, nq, qb, kvh, g, d)
    k = k.reshape(b, nk, kb, kvh, d)
    v = v.reshape(b, nk, kb, kvh, d)
    pos = torch.arange(s, device=q.device)
    outs = []
    for i in range(nq):
        qblk = q[:, i].float()                           # (B, qb, KVH, G, D)
        q_pos = pos[i * qb:(i + 1) * qb][None, :, None, None, None]
        m = torch.full((b, qb, kvh, g), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, qb, kvh, g), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, qb, kvh, g, d), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            k_pos = pos[j * kb:(j + 1) * kb][None, None, None, None, :]
            logits = torch.einsum("bqkgd,bskd->bqkgs", qblk,
                                  k[:, j].float()) * scale
            mask = k_pos <= q_pos
            if window is not None:
                mask &= k_pos > (q_pos - window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p, v[:, j].float())
            m = m_new
        outs.append(acc / torch.clamp_min(l, 1e-30)[..., None])
    return torch.stack(outs, dim=1).reshape(b, s, h, d)


def cross_entropy(logits: torch.Tensor, batch, *, vocab=None,
                  batch_sum=None) -> torch.Tensor:
    """Every family's `loss_fn` tail: mean over the masked positions of
    f32 logsumexp minus the gold logit, divided by max(sum(mask), 1).
    logits (B, S, V); batch["targets"] (B, S), optional batch["mask"].

    The logsumexp is the reference's form, amax + log(sum(exp(x - amax)))
    with amax detached, so that its gradient is exp(x - amax) / sum: a
    softmax normalised to float32's resolution at 1. torch.logsumexp's
    backward takes exp(x - result) instead, whose error is that of the
    result, an ulp at the logits' size (~1e-5 at |x| ~ 100); once the
    loss is near 0, the gradient p - onehot is of that size and it
    loses most of its digits.

    Under a mesh the logits are the rank's rows and, with `vocab` (the
    `MeshAxis` the head's vocabulary is sharded over), its block of the
    vocabulary: the max is a pmax of the blocks' maxima, the sum of exps
    and the gold logit are psums of the blocks' (the vocab-parallel
    form; the sum's order differs from one device's by that split).
    `batch_sum` sums the mask over the batch axes, so that every rank
    divides its rows' sum by the global mask sum (the loss convention of
    `parallel/sharding.py`)."""
    logits = logits.float()
    targets = batch["targets"].long()
    amax = logits.detach().amax(dim=-1, keepdim=True)
    if vocab is not None:
        amax = vocab.pmax(amax, "ce_max")
    amax = torch.where(torch.isfinite(amax), amax, torch.zeros_like(amax))
    sumexp = torch.sum(torch.exp(logits - amax), dim=-1)
    if vocab is None:
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    else:
        sumexp = vocab.psum(sumexp, "ce_sum")
        n = logits.shape[-1]
        loc = targets - vocab.rank * n
        hit = (loc >= 0) & (loc < n)
        gold = torch.gather(logits, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        gold = vocab.psum(torch.where(hit, gold, 0.0), "ce_gold")
    logz = torch.log(sumexp) + amax[..., 0]
    mask = batch.get("mask")
    mask = (torch.ones_like(targets, dtype=torch.float32) if mask is None
            else mask.float())
    den = torch.sum(mask)
    if batch_sum is not None:
        den = batch_sum(den, "ce_mask")
    return torch.sum((logz - gold) * mask) / torch.clamp_min(den, 1.0)


def decode_attention(q: torch.Tensor, kcache: torch.Tensor, vcache: torch.Tensor,
                     length: torch.Tensor, *, scale: float,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode attention over a contiguous cache (plain form).
    q: (B, H, D); caches: (B, N, KVH, D); length: (B,). Returns (B, H, D) f32."""
    b, h, d = q.shape
    n, kvh = kcache.shape[1], kcache.shape[2]
    g = h // kvh
    logits = torch.einsum("bkgd,bskd->bkgs",
                          q.reshape(b, kvh, g, d).to(kcache.dtype).float(),
                          kcache.float()) * scale
    pos = torch.arange(n, device=q.device)[None, None, None, :]
    mask = pos < length[:, None, None, None]
    if window is not None:
        mask &= pos > (length[:, None, None, None] - 1 - window)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(vcache.dtype).float(),
                       vcache.float())
    return out.reshape(b, h, d)


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           length: torch.Tensor, *, scale: float,
                           window: Optional[int] = None) -> torch.Tensor:
    """The dense pre-DSA fallback straight off the page pools: one query
    per slot attends its whole causal extent through the block table —
    kernel B4 on the card (`ops.paged_dense_decode_attn`), its plain
    version on the CPU. q: (B, H, D); k/v_pages: (P, ps, KVH, D);
    table: (B, MP); length: (B,). Returns (B, H, D) f32."""
    return ops.paged_dense_decode_attn(q.to(k_pages.dtype).contiguous(),
                                       k_pages, v_pages, table, length,
                                       scale=scale, window=window)


def swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
               w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The enc-dec family's MLP with f32 biases cast to x's dtype.
    `jax.nn.gelu` defaults to the tanh approximation, so this takes it
    too, not PyTorch's erf default."""
    h = F.gelu(x @ w_up + b_up.to(x.dtype), approximate="tanh")
    return h @ w_down + b_down.to(x.dtype)


def moe_route(x: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """The router: f32 logits x @ router_w (JAX promotes a bf16 x against
    the f32 router_w), the top_k experts by a stable descending sort (equal
    logits pick the lower expert index first, as `jax.lax.top_k` does;
    `torch.topk` promises no order among ties) and their f32 softmax gates.
    x (..., D); router_w (D, E). Returns (gates (..., K) f32, experts
    (..., K) int64)."""
    order = torch.sort(x.float() @ router_w, dim=-1, descending=True,
                       stable=True)
    return (torch.softmax(order.values[..., :top_k], dim=-1),
            order.indices[..., :top_k])


def moe_mlp_dense_fallback(x: torch.Tensor, router_w: torch.Tensor,
                           w_gate: torch.Tensor, w_up: torch.Tensor,
                           w_down: torch.Tensor, *, top_k: int) -> torch.Tensor:
    """The MoE feed-forward as the reference serves it on one device:
    every expert runs on every token, then the top-k outputs are combined
    with the gates cast to the activation dtype. x (B, S, D); router_w
    (D, E) f32; w_gate, w_up (E, D, F); w_down (E, F, D). Returns (B, S, D)
    in x's dtype. The experts run as a batched product over E
    ((1, T, D) @ (E, D, F)), which reads each weight in place."""
    b, s, d = x.shape
    gates, eidx = moe_route(x, router_w, top_k)           # (B, S, K)
    xt = x.reshape(1, b * s, d)
    h = F.silu(xt @ w_gate) * (xt @ w_up)                 # (E, T, F)
    all_down = (h @ w_down).transpose(0, 1)               # (T, E, D)
    sel = torch.take_along_dim(all_down, eidx.reshape(b * s, top_k, 1), dim=1)
    out = gates.reshape(b * s, 1, top_k).to(sel.dtype) @ sel     # (T, 1, D)
    return out.reshape(b, s, d)


def _ep_dispatch(xt: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 num_experts: int, capacity_factor: float):
    """The reference's expert-parallel routing of one token slice xt (tm,
    D): each of the tm * top_k assignments gets a rank within its expert
    in token order (stable), and a slot expert * cap + rank while that
    rank is below the capacity cap = max(int(a / E * cf), 4), else the
    drop bucket E * cap. Returns (slot, gates (a,) f32, kept (a,), cap)."""
    gates, eidx = moe_route(xt, router_w, top_k)           # (tm, K)
    a = eidx.numel()
    flat_e = eidx.reshape(a)
    cap = max(int(a / num_experts * capacity_factor), 4)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    seg_start = torch.searchsorted(
        sorted_e, torch.arange(num_experts, device=xt.device))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(a, device=xt.device) - seg_start[sorted_e]
    kept = rank < cap
    slot = torch.where(kept, flat_e * cap + rank, num_experts * cap)
    return slot, gates.reshape(a), kept, cap


def _ep_slices(x: torch.Tensor, ep: int):
    """The tokens of x (B, S, D) flattened, padded with zero rows to a
    multiple of ep, in ep equal slices (the EP ranks' shares)."""
    dm = x.shape[-1]
    xt = x.reshape(-1, dm)
    t_pad = -(-xt.shape[0] // ep) * ep
    if t_pad != xt.shape[0]:
        xt = torch.cat([xt, xt.new_zeros(t_pad - xt.shape[0], dm)])
    return xt.chunk(ep)


def moe_ep_drops(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
                 num_experts: int, capacity_factor: float, ep: int) -> int:
    """How many of x's expert assignments `moe_mlp_ep` drops over an EP
    extent of ep ranks (every rank's slice, each against its own
    capacity)."""
    return sum(int((~_ep_dispatch(xt, router_w, top_k, num_experts,
                                  capacity_factor)[2]).sum())
               for xt in _ep_slices(x, ep))


def moe_mlp_ep(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
               w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
               capacity_factor: float = 1.25, mesh=None,
               expert_axis: str = "model",
               stats: Optional[dict] = None) -> torch.Tensor:
    """The expert-parallel MoE feed-forward (Switch-style dispatch), the
    reference's `moe_mlp_ep` on one rank of `mesh`.

    x (B, S, D) is this rank's tokens (the batch rows its data axes give
    it, or all rows where the batch does not divide them); w_gate, w_up
    (E/ep, D, F) and w_down (E/ep, F, D) its block of the experts over
    `expert_axis` (extent ep). The tokens are padded to a multiple of ep
    and each EP rank routes its slice of them: assignments past an
    expert's capacity drop; the kept rows go to their expert's owner in
    one all_to_all, through the local experts as batched products, and
    back in a second; each token sums its gate-weighted rows in top-k
    order (the reference's scatter-add order, here deterministic on the
    card as well), and an all_gather over `expert_axis` joins the slices.

    Without a mesh it is the dense fallback, as in the reference.

    Under autograd (training) the tokens and the router enter the
    rank's slice through `enter` (each rank routes its own tokens with
    the replicated router, so their cotangents are summed over the
    axis), the two exchanges run backwards as the reverse all_to_all and
    the tokens' all_gather gives back the rank's slice. `stats`, when
    given, has this rank's dropped assignments added to stats["drops"]
    (an int: one host sync a call)."""
    if mesh is None:
        return moe_mlp_dense_fallback(x, router_w, w_gate, w_up, w_down,
                                      top_k=top_k)
    axis = mesh.axis(expert_axis)
    ep = axis.size
    e = w_gate.shape[0] * ep
    bl, s, dm = x.shape
    xt = _ep_slices(axis.enter(x, "ep_tokens"), ep)[axis.rank]
    tm = xt.shape[0]
    slot, gates, kept, cap = _ep_dispatch(
        xt, axis.enter(router_w, "ep_router"), top_k, e, capacity_factor)
    if stats is not None and not kept.is_meta:     # no count on meta
        stats["drops"] = stats.get("drops", 0) + int((~kept).sum())
    flat_tok = torch.arange(tm, device=x.device).repeat_interleave(top_k)
    send = xt.new_zeros(e * cap + 1, dm)
    send[slot] = xt[flat_tok]
    send = send[:-1].reshape(e, cap, dm)
    recv = axis.all_to_all(send, 0, 1, tag="ep_dispatch")  # (E/ep, ep*cap, D)
    h = F.silu(recv @ w_gate) * (recv @ w_up)
    back = axis.all_to_all(h @ w_down, 1, 0, tag="ep_return")  # (E, cap, D)
    back = torch.cat([back.reshape(e * cap, dm), back.new_zeros(1, dm)])
    rows = (back[slot] * gates[:, None].to(back.dtype)).reshape(tm, top_k, dm)
    yt = back.new_zeros(tm, dm)
    for j in range(top_k):
        yt = yt + rows[:, j]
    y = axis.all_gather(yt, dim=0, tiled=True, tag="ep_tokens")
    return y[:bl * s].reshape(bl, s, dm)
