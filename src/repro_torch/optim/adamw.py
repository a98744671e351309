"""AdamW + global-norm clip + cosine schedule, the JAX package's
`optim/adamw.py` in PyTorch.

The optimizer state mirrors the parameter tree: f32 moments `m` and `v`
and an int32 step `count`. Every scalar of the update (the bias
corrections b ** count, the schedule, the clip scale) is a float32
device tensor, as the reference computes them in float32, and divisions
are tensor by tensor (a CUDA division by a host scalar multiplies by its
reciprocal, which rounds differently). The global norm sums the leaves'
squares in the reference's leaf order (`repro_torch.tree`: sorted dict
keys). The update writes the new moments and parameters IN PLACE, with
the reference's bits: p <- (p.f32 - lr * step).to(p.dtype).

A leaf the loss does not reach (the DSA indexer's weights; `patch_proj`
without patch embeddings) has a zero gradient, and its weight still
decays, as in the reference. ZeRO-1 sharding of the moments
(`zero1_specs`) needs a device mesh and is not ported (ROADMAP item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: Any
    v: Any
    count: torch.Tensor


def init(params) -> OptState:
    """Zero f32 moments beside every parameter, count 0 (int32)."""
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    device = leaves(params)[0].device
    return OptState(m=zeros, v=tree_map(torch.clone, zeros),
                    count=torch.zeros((), dtype=torch.int32, device=device))


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to cfg.lr over warmup_steps, then a cosine down to
    min_lr_frac * lr at total_steps; step an int32 tensor, result f32."""
    dev = step.device
    step = step.float()
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, dev) * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares, leaf sums added in the
    reference's leaf order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig):
    """One AdamW step from `grads` (a tree like `params`). Writes the new
    moments into `state`'s tensors and the new values into `params`'
    tensors, and returns (params, OptState(m, v, count + 1), metrics)
    with metrics {"grad_norm": the norm before clipping, "lr"}."""
    count = state.count + 1
    dev = count.device
    gn = global_norm(grads)
    scale = torch.clamp_max(_f32(cfg.clip_norm, dev)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    lr = schedule(cfg, count)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), count.float())
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), count.float())
    for leaf in zip(leaves(grads), leaves(state.m), leaves(state.v),
                    leaves(params)):
        span = _span(leaf[3])
        g, m, v, p = leaf[0].reshape(-1), *(t.view(-1) for t in leaf[1:])
        for sl in zip(g.split(span), m.split(span), v.split(span),
                      p.split(span)):
            _update_slice(*sl, scale, lr, bc1, bc2, cfg)
    return params, OptState(state.m, state.v, count), {"grad_norm": gn, "lr": lr}


_CPU_SLICE = 1 << 22


def _span(p: torch.Tensor) -> int:
    """Elements of a leaf updated at once: on the CPU slices of
    _CPU_SLICE, since a temporary the size of a multi-GB leaf is fresh
    memory, zeroed page by page on first touch, where a slice's is
    reused; on the card the whole leaf, since the caching allocator
    reuses whole-leaf temporaries and slices there cost step time
    (`tools/ab_adamw_slices.py`, PERF.md §6 on training). Any span gives
    the same bits."""
    return p.numel() if p.is_cuda else _CPU_SLICE


def _update_slice(g, m, v, p, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    """The reference's expressions on one slice, evaluated in place where
    a temporary would be (each op rounds as its out-of-place form)."""
    g = g.float() * scale
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
    step = (m / bc1).div_((v / bc2).sqrt_().add_(cfg.eps))
    step.add_(p.float() * cfg.weight_decay).mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(step)
    else:
        p.copy_(p.float().sub_(step))
