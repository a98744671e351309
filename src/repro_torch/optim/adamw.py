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
decays, as in the reference.

Under a mesh (`update(..., mesh=, specs=)`) every rank holds its blocks
of the parameters and gradients (the gradients already summed over the
batch axes, `launch.train.loss_and_grads`). The global norm sums each
leaf's squares once: the rank's block, psummed over the axes the leaf's
spec shards it on and no other. ZeRO-1 (`zero1_specs`, the reference's)
shards each moment further over "data" along its first free dimension
that divides: a rank whose moment block is that slice of its parameter
block updates the slice of m, v and p, then all-gathers the parameter
over "data". AdamW is elementwise, so the bits are those of updating the
whole block.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.parallel.sharding import P, _names
from repro_torch.tree import leaves, spec_leaves, spec_map, tree_map, unflatten


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


def init(params, *, mesh=None, specs=None, moment_specs=None) -> OptState:
    """Zero f32 moments beside every parameter, count 0 (int32). Under a
    `mesh`, `params` are the rank's blocks under `specs` and the moments
    the rank's blocks under `moment_specs` (`zero1_specs`; `specs` when
    None: moments placed as their parameters)."""
    flat = leaves(params)
    shapes = [p.shape for p in flat]
    if mesh is not None:
        from repro_torch.bridge import block_shape, global_shape
        msp = spec_leaves(specs if moment_specs is None else moment_specs)
        shapes = [block_shape(m, global_shape(sp, shp, mesh), mesh)
                  for sp, m, shp in zip(spec_leaves(specs), msp, shapes)]
    device = flat[0].device
    zeros = unflatten(params, [torch.zeros(shp, dtype=torch.float32,
                                           device=device) for shp in shapes])
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


def global_norm(tree, *, mesh=None, specs=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 squares, leaf sums added in the
    reference's leaf order. Under a `mesh` each leaf is the rank's block
    under its spec in `specs`, and its sum of squares is psummed over the
    axes that spec names (once a leaf, all leaves sharing those axes in
    one collective)."""
    sums = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    if mesh is not None:
        groups = {}
        for i, spec in enumerate(spec_leaves(specs)):
            axes = tuple(a for e in spec for a in _names(e))
            if axes:
                groups.setdefault(axes, []).append(i)
        for axes, idx in groups.items():
            part = torch.stack([sums[i] for i in idx])
            for a in axes:
                part = mesh.axis(a).psum(part, "norm")
            for j, i in enumerate(idx):
                sums[i] = part[j]
    return torch.sqrt(sum(sums))


def _zero1_slice(p: torch.Tensor, m: torch.Tensor, mesh):
    """(dim, slice) of the rank's ZeRO-1 block of its parameter block p
    whose moment block is m (m's dimension over ZERO1_AXIS), or None
    where m is p's whole block."""
    if tuple(m.shape) == tuple(p.shape):
        return None
    (dim,) = [d for d in range(p.dim()) if m.shape[d] != p.shape[d]]
    n = m.shape[dim]
    r = mesh.axis(ZERO1_AXIS).rank
    return dim, slice(r * n, (r + 1) * n)


@torch.no_grad()
def update(grads, state: OptState, params, cfg: AdamWConfig, *, mesh=None,
           specs=None):
    """One AdamW step from `grads` (a tree like `params`). Writes the new
    moments into `state`'s tensors and the new values into `params`'
    tensors, and returns (params, OptState(m, v, count + 1), metrics)
    with metrics {"grad_norm": the norm before clipping, "lr"}.

    Under a `mesh`, params and grads are the rank's blocks under the spec
    tree `specs` and the moments its blocks under `zero1_specs` or
    `specs` (see the module docstring)."""
    count = state.count + 1
    dev = count.device
    gn = global_norm(grads, mesh=mesh, specs=specs)
    scale = torch.clamp_max(_f32(cfg.clip_norm, dev)
                            / torch.clamp_min(gn, 1e-9), 1.0)
    lr = schedule(cfg, count)
    bc1 = 1 - torch.pow(_f32(cfg.b1, dev), count.float())
    bc2 = 1 - torch.pow(_f32(cfg.b2, dev), count.float())
    for g, m, v, p in zip(leaves(grads), leaves(state.m), leaves(state.v),
                          leaves(params)):
        zs = None if mesh is None else _zero1_slice(p, m, mesh)
        if zs is None:
            _update_leaf(g, m, v, p, scale, lr, bc1, bc2, cfg)
            continue
        dim, sl = zs
        idx = (slice(None),) * dim + (sl,)
        part = p[idx].contiguous()
        _update_leaf(g[idx].contiguous(), m, v, part, scale, lr, bc1, bc2,
                     cfg)
        p.copy_(mesh.axis(ZERO1_AXIS).all_gather(part, dim=dim, tiled=True,
                                                 tag="zero1"))
    return params, OptState(state.m, state.v, count), {"grad_norm": gn, "lr": lr}


def _update_leaf(g, m, v, p, scale, lr, bc1, bc2, cfg: AdamWConfig) -> None:
    span = _span(p)
    g, m, v, p = g.reshape(-1), m.view(-1), v.view(-1), p.view(-1)
    for sl in zip(g.split(span), m.split(span), v.split(span), p.split(span)):
        _update_slice(*sl, scale, lr, bc1, bc2, cfg)


_CPU_SLICE = 1 << 22


def _span(p: torch.Tensor) -> int:
    """Elements of a leaf updated at once: on the CPU slices of
    _CPU_SLICE, since a temporary the size of a multi-GB leaf is fresh
    memory, zeroed page by page on first touch, where a slice's is
    reused; on the card the whole leaf, since the caching allocator
    reuses whole-leaf temporaries and slices there cost step time
    (`tools/ab_adamw_slices.py`, PERF.md §6 on training); on the meta
    device (the dry run) the whole leaf too, as nothing is allocated. Any
    span gives the same bits."""
    return p.numel() if p.is_cuda or p.is_meta else _CPU_SLICE


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


ZERO1_AXIS = "data"     # the axis `update` takes a moment block's slice over


def zero1_specs(param_specs, rules, shard_axis: str = ZERO1_AXIS,
                sizes_tree=None):
    """ZeRO-1, the reference's: each moment's spec is its parameter's
    with `shard_axis` on the first dimension that the spec leaves free
    and whose size divides (and is at least) the axis's extent.
    `sizes_tree` holds the parameters' global shapes (anything with a
    `.shape`, or shape tuples)."""
    extent = rules.mesh.shape.get(shard_axis, 1)
    if sizes_tree is None:
        raise ValueError("zero1_specs needs the shapes tree")

    def one(spec, shp):
        shape = tuple(getattr(shp, "shape", shp))
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (e, s) in enumerate(zip(entries, shape)):
            if e is None and s % extent == 0 and s >= extent:
                entries[i] = shard_axis
                break
        return P(*entries)

    return spec_map(one, param_specs, sizes_tree)

