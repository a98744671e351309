"""Carry the JAX package's parameters over to the PyTorch port.

The caller turns the JAX parameter tree into numpy arrays
(`jax.tree.map(np.asarray, params)`) and passes the nested dict; this
module never imports jax. The layouts already agree (weights (in, out),
layers stacked on a leading axis), so the conversion is leaf by leaf.
bfloat16 leaves (`ml_dtypes.bfloat16`, which torch cannot read directly)
go through float32, which holds every bfloat16 value exactly.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


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
