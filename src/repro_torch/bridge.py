"""Carry the JAX package's parameters over to the PyTorch port, and cut a
tree into the blocks of a mesh's ranks.

The caller turns the JAX parameter tree into numpy arrays
(`jax.tree.map(np.asarray, params)`) and passes the nested dict; this
module never imports jax. The layouts already agree (weights (in, out),
layers stacked on a leading axis), so the conversion is leaf by leaf.
bfloat16 leaves (`ml_dtypes.bfloat16`, which torch cannot read directly)
go through float32, which holds every bfloat16 value exactly.

`shard_tree(tree, specs, mesh)` gives a rank the block of every leaf that
its spec assigns it (what JAX's NamedSharding places on that device);
`unshard_tree` puts the ranks' blocks back together (tests), and
`gather_tree` does it on a live mesh, every rank gathering every leaf
over the axes its spec names (a mesh checkpoint's logical arrays).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.parallel.sharding import _names, block_slices
from repro_torch.tree import spec_map


def to_torch(arr, device="cpu") -> torch.Tensor:
    """One numpy leaf → torch tensor of the same dtype on `device`."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """A nested dict of numpy arrays → the same dict of torch tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return to_torch(tree, device)


def shard_tree(tree: Any, specs: Any, mesh,
               coords: Optional[Dict[str, int]] = None) -> Any:
    """The block of every leaf of `tree` that the rank at `coords` (a
    `Mesh`'s own by default; give them for an `AbstractMesh`) holds under
    the same-keyed `specs`, as contiguous tensors."""
    coords = mesh.coords if coords is None else coords
    return spec_map(lambda spec, x: x[block_slices(
        spec, x.shape, mesh, coords)].contiguous(), specs, tree)


def unshard_tree(blocks: Sequence[Any], specs: Any, mesh) -> Any:
    """The inverse of `shard_tree`: `blocks[r]` is the tree of the rank
    whose coordinates are the row-major unravelling of r over
    `mesh.axis_names`; each leaf is rebuilt from its blocks (a replicated
    dimension from the last rank that holds that block)."""
    names = mesh.axis_names
    coords = []
    for r in range(len(blocks)):
        c, rest = {}, r
        for a in reversed(names):
            c[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
        coords.append(c)

    def join(spec, *parts):
        full = list(parts[0].shape)
        for d, entry in enumerate(spec):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                full[d] *= mesh.shape[a]
        out = parts[0].new_empty(full)
        for part, c in zip(parts, coords):
            out[block_slices(spec, full, mesh, c)] = part
        return out

    return spec_map(join, specs, *blocks)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole of every leaf of `tree`, this rank's blocks under the
    same-structured `specs` on the live `mesh`: each sharded dimension
    gathered over its axes, the innermost first (row-major blocks). Every
    rank of the mesh must call it; each gets every leaf whole."""

    def one(spec, x):
        with torch.no_grad():
            for d, entry in enumerate(spec):
                for a in reversed(_names(entry)):
                    x = mesh.axis(a).all_gather(x, dim=d, tiled=True,
                                                tag="gather")
        return x

    return spec_map(one, specs, tree)


def global_shape(spec, local_shape, mesh) -> tuple:
    """The shape of the array whose block under `spec` has `local_shape`."""
    out = list(local_shape)
    for d, entry in enumerate(spec):
        for a in _names(entry):
            out[d] *= mesh.shape.get(a, 1)
    return tuple(out)


def block_shape(spec, shape, mesh) -> tuple:
    """The shape of a block of an array of `shape` under `spec`."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in _names(entry):
            out[d] //= mesh.shape.get(a, 1)
    return tuple(out)

