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

Mesh-agnostic, as the reference's: under a mesh, `save(..., mesh=,
specs=)` gathers every leaf's logical array from the ranks' blocks
(`bridge.gather_tree`; every rank calls it) and rank 0 alone writes, the
same files and manifest as a one-device save of those values;
`restore(..., shardings=, mesh=)` reads the logical arrays and returns
the rank's blocks under the spec tree `shardings`, so a save on one mesh
restores on another mesh or on one device (an elastic restart).
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

from repro_torch.parallel.sharding import block_slices
from repro_torch.tree import flatten_with_paths, spec_leaves, unflatten

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
         block: bool = True, mesh=None,
         specs: Any = None) -> Optional[threading.Thread]:
    """Atomically persist `tree` at `step`; with block=False the write runs
    on the returned thread (join it before relying on the files). Under a
    `mesh`, `tree` holds the rank's blocks under the spec tree `specs`:
    every rank calls save, rank 0 writes, and with `block` every rank
    returns once the files are in place."""
    if mesh is not None:
        from repro_torch.bridge import gather_tree
        tree = gather_tree(tree, specs, mesh)
        if mesh.rank != 0:
            if block:
                mesh.barrier()
            return None
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
        if mesh is not None:
            mesh.barrier()
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


def restore(ckpt_dir: str, step: int, like: Any, device=None, *,
            shardings: Any = None, mesh=None) -> Any:
    """Restore into the structure of `like` (the manifest's paths must be
    like's), each leaf in like's dtype on `device`, or on like's leaf's
    device when None. With `shardings` (a spec tree like `like`, e.g.
    `launch.train.shardings_for`'s) and a `mesh`, each leaf is this
    rank's block of the stored array (`like` holds the blocks)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_like = flatten_with_paths(like)
    if manifest["leaves"] != [p for p, _ in flat_like]:
        raise ValueError("checkpoint/manifest structure mismatch")
    specs = ([None] * len(flat_like) if shardings is None
             else spec_leaves(shardings))
    with np.load(os.path.join(path, "arrays.npz")) as data:
        out = []
        for i, ((_, ref), spec) in enumerate(zip(flat_like, specs)):
            a = data[f"a{i}"]
            if spec is not None:
                a = a[block_slices(spec, a.shape, mesh, mesh.coords)]
            out.append(_to_torch(a, ref, device))
        return unflatten(like, out)


def restore_latest(ckpt_dir: str, like: Any, device=None, *,
                   shardings: Any = None,
                   mesh=None) -> Optional[Tuple[Any, int]]:
    steps = all_steps(ckpt_dir)
    if not steps:
        return None
    step = steps[-1]
    return restore(ckpt_dir, step, like, device, shardings=shardings,
                   mesh=mesh), step
