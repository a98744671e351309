"""Step-atomic checkpointing with resume-from-latest, the JAX package's
`checkpoint/checkpoint.py` over trees of torch tensors.

The contract is the reference's:
  * atomicity — writes go to `step_N.tmp/` then os.replace to `step_N/`;
                a crash mid-write never corrupts the latest checkpoint.
  * manifest  — the leaves' paths, a hash of the tree's paths, dtypes and
                shapes, and the step; restore checks the paths before it
                reads an array.
  * retention — keep_last prunes old steps after a successful save.
  * async     — save(..., block=False) copies the tensors to host memory
                first (the training step updates them in place), then
                writes on a background thread and returns it.

The files are the reference's: `arrays.npz` (leaf i as "a{i}") and
`manifest.json`, with the paths in `jax.tree_util.keystr` form
("[0]['layers']['wq']", "[1].m['embed']", "[1].count" for (params,
OptState)), bfloat16 leaves stored as the reference stores them (2-byte
void records of the bf16 bits). So a checkpoint written by either package
restores into the other, and the structure check means the same in both.
A mesh-aware `restore(..., shardings=...)` has no meaning without a mesh
(ROADMAP item 7); restore takes a `device` instead.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, unflatten

_MANIFEST = "manifest.json"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of `t`; bfloat16 as its bits in 2-byte void records."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)


def tree_hash(host_flat) -> str:
    spec = [(p, _dtype_name(a), tuple(a.shape)) for p, a in host_flat]
    return hashlib.sha256(json.dumps(spec).encode()).hexdigest()[:16]


def save(ckpt_dir: str, tree: Any, step: int, *, keep_last: int = 3,
         block: bool = True) -> Optional[threading.Thread]:
    """Atomically persist `tree` at `step`; with block=False the write runs
    on the returned thread (join it before relying on the files)."""
    host = [(p, _to_numpy(t)) for p, t in flatten_with_paths(tree)]

    def _write():
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "hash": tree_hash(host),
                    "leaves": [p for p, _ in host]}
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, (_, a) in enumerate(host)})
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        for s in all_steps(ckpt_dir)[:-keep_last]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                          ignore_errors=True)

    if block:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                out.append(int(d.split("_")[1]))
            except ValueError:
                pass
    return sorted(out)


def _to_torch(a: np.ndarray, ref: torch.Tensor, device) -> torch.Tensor:
    """A stored array as `ref`'s dtype on `device` (ref's own when None)."""
    if a.dtype == np.dtype("V2"):
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=ref.device if device is None else device,
                dtype=ref.dtype)


def restore(ckpt_dir: str, step: int, like: Any, device=None) -> Any:
    """Restore into the structure of `like` (the manifest's paths must be
    like's), each leaf in like's dtype on `device`, or on like's leaf's
    device when None."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_like = flatten_with_paths(like)
    if manifest["leaves"] != [p for p, _ in flat_like]:
        raise ValueError("checkpoint/manifest structure mismatch")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return unflatten(like, [_to_torch(data[f"a{i}"], ref, device)
                                for i, (_, ref) in enumerate(flat_like)])


def restore_latest(ckpt_dir: str, like: Any,
                   device=None) -> Optional[Tuple[Any, int]]:
    steps = all_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1]
    return restore(ckpt_dir, step, like, device), step
