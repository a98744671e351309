"""Sharding of the port over `torch.distributed`: the logical-axis rules,
the meshes, and the collectives of one mesh axis.

The JAX package maps logical tensor axes to named mesh axes (`DEFAULT_RULES`,
`MeshRules.spec` with its divisibility fallback: a dimension that does not
divide its axes' extent is replicated) and lets XLA place each array. The
port keeps the rules and the specs as they are — `P` is a tuple that
compares equal to JAX's `PartitionSpec` entry by entry — and runs SPMD: one
process a rank, each holding the local block of every array that its specs
give it (`bridge.shard_tree`), and every collective written out.

Meshes:
  * `AbstractMesh(shape, axes)`: axis sizes only, no process group — what
    the specs need (the production meshes of 256 and 512 chips).
  * `Mesh(shape, axes, device=)`: the axes over the default process
    group in row-major order (rank = data_index · M + model_index on
    ("data", "model")), one sub-group per line of each axis; `axis(name)`
    is that axis as a `MeshAxis`. The device is the caller's to name
    (`launch.make_mesh` takes the rank's GPU unless told otherwise).
  * `SeqGroup`: one axis over a group, the 1-D ("seq",) mesh of the
    sequence-sharded path; `MeshAxis` is a `SeqGroup` that knows its name
    and adds `all_to_all`.

Exactness across ranks: a float sum is taken as an all-gather of the
per-rank partials summed in rank order on every rank, so each rank (and
each backend) holds the same bits and takes the same branch. Integer sums,
maxima and minima are order-free and go through `all_reduce`.

Under the gloo backend a collective over CUDA tensors is staged through
host memory (copied out, reduced on the CPU, copied back): gloo is the
backend two ranks sharing one GPU can use (NCCL refuses a second rank on
the same device). NCCL takes CUDA tensors directly.

Each collective is counted by tag: calls and the bytes this rank
contributes (`bill()`, `reset_bill()`), so a caller can read the
per-tick collective bill; a `Mesh` keys its bill by axis, then tag.

Training under a mesh (the loss convention). Every rank computes the
loss of its batch rows divided by the GLOBAL mask sum, a psum over the
batch axes (`rules.spec("batch")`'s, ("pod", "data") by default); the
loss is replicated over "model". After the backward pass each leaf's
gradient is summed over the batch axes its spec does not name. The
collectives carry gradients for that, each the adjoint of its forward
(Megatron's conjugate pairs):
  * `psum` of partial products whose sum the ranks use alike: identity
    backward (every rank already holds the whole cotangent);
  * `all_gather(tiled=True)` into a value the ranks use alike: backward
    takes the rank's own slice of the cotangent;
  * `all_to_all`: backward is the reverse all_to_all;
  * `enter`, where a value the ranks hold alike enters a computation
    that differs by rank (a column block of a weight, a slice of
    tokens or channels): identity forward, psum backward.
Without autograd (decode) each is its plain forward, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

# the default logical rules; "batch" spans pod and data for multi-pod DP
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,                 # sequence replicated in train (no SP default)
    "seq_shard": ("data",),      # SP: long-context decode KV sharding
    "heads": ("model",),
    "kv_heads": ("model",),
    "d_model": None,
    "d_ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff": None,
    "indexer": None,
    "state": None,
}


class P(tuple):
    """A partition spec: per dimension None (replicated), a mesh-axis name,
    or a tuple of names (sharded over their product, row-major). A tuple,
    so it equals `tuple(jax.sharding.PartitionSpec(...))`."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(a) for a in self) + ")"


class AbstractMesh:
    """Named axis sizes, no devices and no process group."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str]):
        if len(shape) != len(axes):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axes)} differ in length")
        self.axis_names = tuple(axes)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.size = 1
        for n in self.shape.values():
            self.size *= n

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def _names(axes) -> Tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass
class MeshRules:
    mesh: AbstractMesh
    rules: dict

    def axes(self, logical: Optional[str]) -> Optional[Union[str, tuple]]:
        """The mesh axes of a logical axis that the mesh has (a name, a
        tuple of names, or None)."""
        if logical is None:
            return None
        r = self.rules.get(logical)
        if r is None:
            return None
        present = tuple(a for a in _names(r) if a in self.mesh.axis_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def _extent(self, axes) -> int:
        e = 1
        for a in _names(axes):
            e *= self.mesh.shape[a]
        return e

    def spec(self, *logical: Optional[str],
             sizes: Optional[Sequence[int]] = None) -> P:
        """The spec of logical axes; a dimension whose size does not divide
        its axes' extent is replicated (the divisibility fallback)."""
        out = []
        for i, name in enumerate(logical):
            axes = self.axes(name)
            if axes is not None and sizes is not None:
                if sizes[i] % self._extent(axes) != 0:
                    axes = None
            out.append(axes)
        return P(*out)


def make_rules(mesh, overrides: Optional[dict] = None) -> MeshRules:
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    return MeshRules(mesh=mesh, rules=rules)


def overrides_for(cfg, shape_kind: str) -> dict:
    """The reference's per-(arch, shape) parallelism policy. Train and
    prefill: MoE models put the experts on "model" and replicate attention
    and embeddings over it; wide models (d_model >= 6144), the hybrid and
    the ssm keep the default tensor parallelism; every other model is pure
    data parallel over (pod, data, model). Decode keeps the defaults."""
    if shape_kind not in ("train", "prefill"):
        return {}
    if cfg.moe.num_experts and not cfg.attn_every:
        return {"batch": ("pod", "data"), "heads": None, "kv_heads": None,
                "d_ff": None, "vocab": None}
    if cfg.d_model >= 6144 or cfg.attn_every or cfg.family == "ssm":
        return {}
    return {"batch": ("pod", "data", "model"), "heads": None,
            "kv_heads": None, "d_ff": None, "vocab": None}


def block_slices(spec: Sequence, shape: Sequence[int], mesh,
                 coords: Dict[str, int]) -> Tuple[slice, ...]:
    """The slices of a global array of `shape` that the rank at `coords`
    holds under `spec` (each sharded dimension cut into its axes' extent
    of equal blocks, the axes row-major). Refuses what JAX's
    NamedSharding refuses: an axis on two dimensions, a dimension that
    does not divide."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {tuple(shape)}")
    used, out = set(), []
    for dim, entry in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = _names(entry)
        if used & set(names):
            raise ValueError(f"spec {spec} puts mesh axis "
                             f"{sorted(used & set(names))} on two dimensions")
        used.update(names)
        idx, ext = 0, 1
        for a in names:
            idx, ext = idx * mesh.shape[a] + coords[a], ext * mesh.shape[a]
        if shape[dim] % ext:
            raise ValueError(f"dimension {dim} of {tuple(shape)} does not "
                             f"divide the extent {ext} of {names}")
        n = shape[dim] // ext
        out.append(slice(idx * n, (idx + 1) * n))
    return tuple(out)


def constrain(x: torch.Tensor, rules: Optional[MeshRules], *logical,
              sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The reference's sharding constraint. The port holds local blocks, so
    this checks one: with `rules` and the global `sizes`, x must have the
    shape of a block of those sizes under `rules.spec(*logical, sizes=)`.
    Returns x."""
    if rules is None:
        return x
    if len(logical) != x.dim():
        raise ValueError(f"{len(logical)} logical axes for a {x.dim()}-D "
                         f"tensor")
    if sizes is not None:
        spec = rules.spec(*logical, sizes=sizes)
        want = tuple(s // rules._extent(a) for s, a in zip(sizes, spec))
        if tuple(x.shape) != want:
            raise ValueError(f"local block {tuple(x.shape)} is not the "
                             f"{spec} block {want} of {tuple(sizes)}")
    return x


class SeqGroup:
    """The "seq" mesh axis over a process group of `size` ranks (None: a
    single rank, whose collectives are the identity)."""

    axis_names = ("seq",)

    def __init__(self, group=None, *, device=None):
        import torch.distributed as dist
        self.group = group
        if group is None:
            self.size, self.rank, self.backend = 1, 0, None
        else:
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.backend = str(dist.get_backend(group))
        self.device = torch.device(device if device is not None else "cpu")
        self._calls: Dict[str, int] = {}
        self._bytes: Dict[str, int] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return {"seq": self.size}

    # ---- the bill ------------------------------------------------------

    def _count(self, tag: str, t: torch.Tensor) -> None:
        self._calls[tag] = self._calls.get(tag, 0) + 1
        self._bytes[tag] = (self._bytes.get(tag, 0)
                            + t.numel() * t.element_size())

    def bill(self) -> Dict[str, Dict[str, int]]:
        """{tag: {"calls": n, "bytes": b}} since the last reset."""
        return {k: {"calls": self._calls[k], "bytes": self._bytes[k]}
                for k in sorted(self._calls)}

    def reset_bill(self) -> None:
        self._calls.clear()
        self._bytes.clear()

    # ---- collectives ---------------------------------------------------

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor the backend reduces: a host copy under gloo."""
        t = t.contiguous()
        if self.backend == "gloo" and t.device.type != "cpu":
            return t.cpu()
        return t

    def _reduce(self, t: torch.Tensor, op, tag: str) -> torch.Tensor:
        import torch.distributed as dist
        self._count(tag, t)
        buf = self._host(t).clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

    def psum(self, t: torch.Tensor, tag: str = "psum") -> torch.Tensor:
        """Sum over the ranks, the same bits on every rank: integers and
        booleans (as int32) by all_reduce, floats as the rank-order sum of
        the gathered partials. Under autograd its backward is the
        identity (see the module docstring)."""
        if self.size == 1:
            return t
        if t.dtype == torch.bool:
            t = t.int()
        if t.is_floating_point():
            if _tracks(t):
                return _Psum.apply(t, self, tag)
            return self._psum_float(t, tag)
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.SUM, tag)

    def _psum_float(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        parts = self._gather(t, 0, False, tag)
        out = parts[0]
        for i in range(1, self.size):
            out = out + parts[i]
        return out

    def enter(self, t: torch.Tensor, tag: str = "enter") -> torch.Tensor:
        """t itself; under autograd its gradient is summed over the ranks
        (`psum`), as a value the ranks hold alike takes a cotangent from
        each rank's own part of the computation."""
        if self.size == 1 or not _tracks(t):
            return t
        return _Enter.apply(t, self, tag)

    def pmax(self, t: torch.Tensor, tag: str = "pmax") -> torch.Tensor:
        if self.size == 1:
            return t
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.MAX, tag)

    def pmin(self, t: torch.Tensor, tag: str = "pmin") -> torch.Tensor:
        if self.size == 1:
            return t
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.MIN, tag)

    def all_gather(self, t: torch.Tensor, dim: int = 0, tiled: bool = False,
                   tag: str = "all_gather") -> torch.Tensor:
        """Every rank's `t`, in rank order: concatenated along `dim` when
        `tiled`, else stacked on a new axis `dim` (`lax.all_gather`)."""
        if self.size == 1:
            return t if tiled else t.unsqueeze(dim)
        if _tracks(t):
            if not tiled:
                raise NotImplementedError("the untiled all_gather has no "
                                          "backward")
            return _AllGather.apply(t, self, dim, tag)
        return self._gather(t, dim, tiled, tag)

    def _gather(self, t: torch.Tensor, dim: int, tiled: bool,
                tag: str) -> torch.Tensor:
        import torch.distributed as dist
        self._count(tag, t)
        src = self._host(t)
        parts: List[torch.Tensor] = [torch.empty_like(src)
                                     for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
        return out.to(t.device)

    def barrier(self) -> None:
        if self.size > 1:
            import torch.distributed as dist
            dist.barrier(group=self.group)



class MeshAxis(SeqGroup):
    """One named axis of a `Mesh`: the collectives over this rank's line
    of that axis (a sub-group; None when the axis has one rank)."""

    def __init__(self, name: str, group=None, *, device=None):
        super().__init__(group, device=device)
        self.name = name
        self.axis_names = (name,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.name: self.size}

    def all_to_all(self, t: torch.Tensor, split_axis: int, concat_axis: int,
                   tiled: bool = True, tag: str = "all_to_all") -> torch.Tensor:
        """`lax.all_to_all`: `t` is cut into `size` blocks along
        `split_axis`, block j goes to rank j, and the blocks received are
        joined in rank order along `concat_axis` (`tiled`), or stacked on a
        new axis there (`tiled=False`, which drops `split_axis`, of extent
        `size`). gloo has no all-to-all (the builds of PyTorch it was
        tried on refuse it, on host and CUDA tensors alike), so under gloo
        every rank gathers the whole of `t` from every rank and keeps its
        own blocks: `size` times the bytes, billed to `tag` all the same."""
        if t.shape[split_axis] % self.size or (
                not tiled and t.shape[split_axis] != self.size):
            raise ValueError(f"all_to_all: dimension {split_axis} of "
                             f"{tuple(t.shape)} does not "
                             f"{'divide' if tiled else 'equal'} {self.size}")
        if self.size == 1:
            return t if tiled else t.movedim(split_axis, concat_axis)
        if _tracks(t):
            if not tiled:
                raise NotImplementedError("the untiled all_to_all has no "
                                          "backward")
            return _AllToAll.apply(t, self, split_axis, concat_axis, tag)
        return self._all_to_all(t, split_axis, concat_axis, tiled, tag)

    def _all_to_all(self, t, split_axis, concat_axis, tiled, tag):
        import torch.distributed as dist
        if self.backend == "gloo":
            whole = self._gather(t, 0, False, tag)
            got = [part.chunk(self.size, split_axis)[self.rank]
                   for part in whole.unbind(0)]
        else:
            self._count(tag, t)
            src = [c.contiguous() for c in t.chunk(self.size, split_axis)]
            got = [torch.empty_like(c) for c in src]
            dist.all_to_all(got, src, group=self.group)
        if tiled:
            return torch.cat(got, concat_axis)
        return torch.stack([g.squeeze(split_axis) for g in got], concat_axis)


def _tracks(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, tag):
        return axis._psum_float(t, tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, tag):
        ctx.axis, ctx.tag = axis, tag
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return (ctx.axis._psum_float(g.contiguous(), ctx.tag + "_grad"), None,
                None)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim, tag):
        ctx.axis, ctx.dim, ctx.n = axis, dim, t.shape[dim]
        return axis._gather(t, dim, True, tag)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.axis.rank * ctx.n, ctx.n), None, None,
                None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, split_axis, concat_axis, tag):
        ctx.axis, ctx.tag = axis, tag
        ctx.split, ctx.concat = split_axis, concat_axis
        return axis._all_to_all(t, split_axis, concat_axis, True, tag)

    @staticmethod
    def backward(ctx, g):
        return (ctx.axis._all_to_all(g.contiguous(), ctx.concat, ctx.split,
                                     True, ctx.tag + "_grad"),
                None, None, None, None)


class Mesh(AbstractMesh):
    """Named axes over the default process group, row-major: the rank's
    coordinate on each axis, and `axis(name)` its collectives. Every rank
    of the group builds the same mesh (the sub-groups are made in the same
    order on every rank, as `dist.new_group` requires)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *, device):
        import torch.distributed as dist
        super().__init__(shape, axes)
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError("a Mesh needs an initialised default process "
                             "group (launch.init_mesh_group)")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"mesh {self.shape} needs {self.size} ranks; "
                             f"the process group holds {world}")
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        self.device = torch.device(device)
        sizes = [self.shape[a] for a in self.axis_names]
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        self.coords = {a: (self.rank // strides[i]) % sizes[i]
                       for i, a in enumerate(self.axis_names)}
        self._axes: Dict[str, MeshAxis] = {}
        for i, a in enumerate(self.axis_names):
            group = None
            if sizes[i] > 1:
                for base in range(world):
                    if (base // strides[i]) % sizes[i]:
                        continue
                    ranks = [base + j * strides[i] for j in range(sizes[i])]
                    g = dist.new_group(ranks)
                    if self.rank in ranks:
                        group = g
            self._axes[a] = MeshAxis(a, group, device=self.device)

    def axis(self, name: str) -> MeshAxis:
        """The axis `name`; an axis the mesh lacks is a line of one rank
        (its collectives are the identity), as JAX sizes it 1."""
        if name not in self._axes:
            self._axes[name] = MeshAxis(name, None, device=self.device)
        return self._axes[name]

    def index(self, axes) -> Tuple[int, int]:
        """(this rank's index, extent) along `axes` (a name, a tuple of
        names taken row-major, or None)."""
        idx, ext = 0, 1
        for a in _names(axes):
            n = self.shape.get(a, 1)
            idx, ext = idx * n + self.coords.get(a, 0), ext * n
        return idx, ext

    def bill(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{axis: {tag: {"calls": n, "bytes": b}}} since the last reset."""
        return {a: ax.bill() for a, ax in self._axes.items() if ax.bill()}

    def reset_bill(self) -> None:
        for ax in self._axes.values():
            ax.reset_bill()

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier()


# the collective ops of XLA's HLO, as the JAX package's dry run counts them
HLO_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter",
                   "all-to-all", "collective-permute")


class _ShadowAxis(MeshAxis):
    """One axis of a `ShadowMesh`: `size` ranks of which this is `rank`,
    and no process group. Each collective is billed as the live axis
    bills it (`SeqGroup._count`: the call and the bytes of the input)
    and returns a tensor of the shape and dtype the live collective
    returns, built from this rank's input alone: a sum, maximum or
    minimum is the input, a gather tiles it, an all_to_all sends each
    block back to itself. `ops` counts the same calls by the HLO
    collective each is (calls and the bytes of its result)."""

    def __init__(self, name: str, size: int, rank: int, *, device):
        super().__init__(name, None, device=device)
        self.size, self.rank, self.backend = size, rank, "shadow"
        self.ops: Dict[str, Dict[str, int]] = {}

    def _op(self, kind: str, tag: str, t, out):
        self._count(tag, t)
        op = self.ops.setdefault(kind, {"count": 0, "bytes": 0})
        op["count"] += 1
        op["bytes"] += out.numel() * out.element_size()
        return out

    def _reduce(self, t, op, tag):
        return self._op("all-reduce", tag, t, t.clone())

    def _psum_float(self, t, tag):
        return self._op("all-reduce", tag, t, t.clone())

    def _gather(self, t, dim, tiled, tag):
        parts = [t] * self.size
        return self._op("all-gather", tag, t, torch.cat(parts, dim) if tiled
                        else torch.stack(parts, dim))

    def _all_to_all(self, t, split_axis, concat_axis, tiled, tag):
        got = t.chunk(self.size, split_axis)
        out = (torch.cat(got, concat_axis) if tiled else torch.stack(
            [g.squeeze(split_axis) for g in got], concat_axis))
        return self._op("all-to-all", tag, t, out)

    def reset_bill(self) -> None:
        super().reset_bill()
        self.ops.clear()

    def barrier(self) -> None:
        pass


class ShadowMesh(Mesh):
    """One rank of a mesh, with no process group: the dry run's stand-in
    for the mesh a step runs on (`launch.dryrun`). It has `Mesh`'s API
    (`axis(name)`, `index`, `coords`, `rank`, `device`, `bill`,
    `reset_bill`, `barrier`) for the rank at `coords` (rank 0 by
    default), and its axes bill every collective exactly as a live mesh
    does, but move no data: each returns a tensor of the live result's
    shape and dtype made from this rank's own input (`_ShadowAxis`). So
    the values that pass through a collective are NOT the mesh's values;
    a step run under it checks shapes, bytes and the collective bill, not
    results. Nothing but the dry run builds one."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], *,
                 coords: Optional[Dict[str, int]] = None, device="meta"):
        AbstractMesh.__init__(self, shape, axes)
        coords = dict(coords or {})
        if set(coords) - set(self.axis_names):
            raise ValueError(f"coords {coords} name axes the mesh "
                             f"{self.shape} lacks")
        self.coords = {a: int(coords.get(a, 0)) for a in self.axis_names}
        for a, c in self.coords.items():
            if not 0 <= c < self.shape[a]:
                raise ValueError(f"coordinate {c} outside axis {a!r} of "
                                 f"extent {self.shape[a]}")
        self.rank = 0
        for a in self.axis_names:
            self.rank = self.rank * self.shape[a] + self.coords[a]
        self.backend = "shadow"
        self.device = torch.device(device)
        self._axes = {a: _ShadowAxis(a, self.shape[a], self.coords[a],
                                     device=self.device)
                      for a in self.axis_names}

    def axis(self, name: str) -> _ShadowAxis:
        """The axis `name`; one the mesh lacks is a line of one rank."""
        if name not in self._axes:
            self._axes[name] = _ShadowAxis(name, 1, 0, device=self.device)
        return self._axes[name]

    def collectives(self) -> Dict[str, Any]:
        """The calls since the last reset by HLO collective: {name:
        {"count", "bytes"}} (bytes of each result) for every name of
        `HLO_COLLECTIVES`, "total_bytes" and "total_count", the fields of
        the JAX package's `parse_collectives`."""
        out = {n: {"count": 0, "bytes": 0} for n in HLO_COLLECTIVES}
        for ax in self._axes.values():
            for kind, op in ax.ops.items():
                out[kind]["count"] += op["count"]
                out[kind]["bytes"] += op["bytes"]
        out["total_bytes"] = sum(v["bytes"] for v in out.values())
        out["total_count"] = sum(v["count"] for v in out.values()
                                 if isinstance(v, dict))
        return out

    def barrier(self) -> None:
        pass


def stacked(specs):
    """Every spec of a nested dict with a leading replicated axis: the
    stacked-layer axis of a layer stack, which is never sharded."""
    if isinstance(specs, dict):
        return {k: stacked(v) for k, v in specs.items()}
    return P(None, *specs)


def unstacked(specs, n: int = 1):
    """`stacked`'s inverse: every spec without its n leading entries, the
    specs of one layer of an n-deep stack."""
    if isinstance(specs, dict):
        return {k: unstacked(v, n) for k, v in specs.items()}
    return P(*specs[n:])
