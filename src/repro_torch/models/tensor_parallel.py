"""The decode steps' placement on one rank of a ("data", "model") mesh.

The JAX package serves a decode cell by placing every array by its spec
(`param_specs`, `state_specs`) and letting XLA partition the step. The port
runs SPMD: each rank holds the blocks its specs give it
(`bridge.shard_tree`) and this module writes out what XLA derives, weight
by weight, from those specs:

  * the batch rows over the "batch" axes (("pod", "data")), or every row
    where the batch does not divide them;
  * a weight whose output columns are sharded (`wq`/`wk`/`wv` by heads,
    the SwiGLU's `d_ff`, Mamba's `in_proj`) is applied to its column
    block; one whose input rows are sharded (`wo`, `w_down`, `out_proj`)
    to the matching slice of its input, and the partial products are
    summed over the axis (`psum`);
  * the embedding sharded over vocab is a masked lookup of the rank's
    rows, then a `psum`; the logits of a vocab-sharded head are gathered
    (`all_gather`);
  * a weight that falls back to replication takes no collective.

Attention runs on the rank's own heads where the KV cache is sharded by
KV head (KVH divides the axis, and so does H): its query heads are those
of its KV heads, and kernels B5 -> B1 -> B6 run at the local head counts.
Elsewhere every rank attends all heads over the replicated cache (the
projections gathered first where they are column-sharded), which is what
the reference's replicated-heads constraint in the DSA block asks for.

A float `psum` is the rank-order sum of the gathered partials
(`sharding.SeqGroup`), so the ranks of an axis hold the same bits and
select the same Top-K.

The paged forms keep the page pools global: K/V pools by KV head as the
dense cache (replicated over the batch axes, since a shared-prefix page
may be read by slots on any data rank), the indexer-K pool, the block
table and `length` replicated. So each rank computes its own rows' new
K/V (at its KV heads) and indexer-K, all-gathers them over the batch
axes (`batch_gather`, one call a layer) and scatters every row, and
every replica of a pool stays the pool of one device. Selection and
attention then run on the rank's rows through their block-table rows.

With no mesh a `Placement()` is the identity: every spec entry is None
(`NO_MESH`), every product the plain one, so the one-device step runs
the same lines.

The training path uses the same forms over (B, S, D) rows, under
autograd: a value the ranks of an axis hold alike enters a column block
(`cols`) or is sliced (`rows_in(local=False)`) through `enter`, whose
backward sums the ranks' cotangents; the embedding's masked lookup
scatters its gradient into the rank's own rows only; and the head gives
the rank's block of the vocabulary (`vocab_logits`), which
`layers.cross_entropy` reduces without gathering the logits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.parallel.sharding import (AbstractMesh, MeshAxis, MeshRules,
                                         make_rules)

# the rules of no mesh: every logical axis replicated
NO_MESH = make_rules(AbstractMesh((), ()))


def axis_of(mesh, entry) -> Optional[MeshAxis]:
    """The mesh axis a spec entry shards a dimension over, or None."""
    if mesh is None or entry is None:
        return None
    if isinstance(entry, str):
        return mesh.axis(entry)
    raise NotImplementedError(
        f"a decode weight sharded over several mesh axes {entry}: the "
        f"decode rules map each dimension to one axis")


def require_live(mesh) -> None:
    """Raise ValueError unless `mesh` is a live `Mesh` with this rank's
    coordinates (an `AbstractMesh` has axis sizes alone)."""
    if not hasattr(mesh, "coords"):
        raise ValueError(f"{mesh!r}: a step runs on a rank of a live Mesh "
                         f"(launch.make_mesh); an AbstractMesh has axis "
                         f"sizes and no rank")


class Heads(NamedTuple):
    """The attention heads one rank computes: hl query heads (its block
    over `axis`, or all) over kvl KV heads (its block, or all)."""
    axis: Optional[MeshAxis]   # the axis the heads are sharded over
    hl: int
    kvl: int


def heads_of(cfg, cache_entry, mesh) -> Heads:
    """The rank's heads: its block where the cache is sharded by KV head
    (`cache_entry`, the KV-head entry of the cache's spec), else all."""
    ax = axis_of(mesh, cache_entry)
    if ax is None or ax.size == 1:
        return Heads(None, cfg.n_heads, cfg.n_kv_heads)
    return Heads(ax, cfg.n_heads // ax.size, cfg.n_kv_heads // ax.size)


class Placement:
    """The placement of one decode step of a global batch of `batch` rows
    on this rank of `mesh` under `rules`; with no mesh, the identity."""

    def __init__(self, mesh=None, rules: MeshRules = NO_MESH, batch: int = 0):
        self.mesh = mesh
        self.rows = slice(None)
        # the mesh axes the batch rows are sharded over (None: replicated)
        self.batch_axes = None
        if mesh is not None:
            require_live(mesh)
            self.batch_axes = rules.spec("batch", sizes=(batch,))[0]
            idx, ext = mesh.index(self.batch_axes)
            n = batch // ext
            self.rows = slice(idx * n, (idx + 1) * n)

    def batch_sum(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """t summed over the batch axes (axis by axis, the last first)."""
        if self.mesh is None or self.batch_axes is None:
            return t
        names = ((self.batch_axes,) if isinstance(self.batch_axes, str)
                 else self.batch_axes)
        for a in reversed(names):
            t = self.mesh.axis(a).psum(t, tag)
        return t

    def batch_gather(self, t: torch.Tensor, tag: str) -> torch.Tensor:
        """The rows of every rank of the batch axes, t (B_l, ...) being
        this rank's: all-gathered along dim 0 axis by axis, the last
        first, so the rows come out in global order; t itself where the
        rows are not sharded."""
        if self.mesh is None or self.batch_axes is None:
            return t
        names = ((self.batch_axes,) if isinstance(self.batch_axes, str)
                 else self.batch_axes)
        for a in reversed(names):
            t = self.mesh.axis(a).all_gather(t, dim=0, tiled=True, tag=tag)
        return t

    def enter(self, x: torch.Tensor, entry, tag: str = "enter") -> torch.Tensor:
        """x, entering a computation split over `entry`'s axis (see the
        module docstring); the identity without that axis or autograd."""
        ax = axis_of(self.mesh, entry)
        return x if ax is None else ax.enter(x, tag)

    def embed(self, table: torch.Tensor, entry, tokens: torch.Tensor):
        """table[tokens] with the table's rows sharded by `entry`: each
        rank looks up the tokens in its rows (zeros elsewhere) and the
        ranks' rows are summed. tokens (B,) or (B, S)."""
        ax = axis_of(self.mesh, entry)
        if ax is None:
            return table[tokens.long()]
        n = table.shape[0]
        loc = tokens.long() - ax.rank * n
        hit = ((loc >= 0) & (loc < n))[..., None]
        x = torch.where(hit, table[loc.clamp(0, n - 1)], 0)
        return ax.psum(x, "embed")

    def cols(self, x: torch.Tensor, w: torch.Tensor, entry, *, tag: str,
             gather: bool = False) -> torch.Tensor:
        """x @ w for w's columns sharded by `entry`: the rank's column
        block, or (`gather`) all columns joined in rank order."""
        ax = axis_of(self.mesh, entry)
        if ax is not None:
            x = ax.enter(x, tag)
        y = x @ w
        if gather and ax is not None:
            y = ax.all_gather(y, dim=-1, tiled=True, tag=tag)
        return y

    def cols_of(self, v: torch.Tensor, entry) -> torch.Tensor:
        """The rank's block of a replicated vector v (a bias, a per-channel
        constant) along the last dimension, where `entry` shards that
        dimension's partner (a weight's columns); v itself otherwise."""
        ax = axis_of(self.mesh, entry)
        if ax is None:
            return v
        n = v.shape[-1] // ax.size
        return ax.enter(v, "cols_of")[..., ax.rank * n:(ax.rank + 1) * n]

    def rows_in(self, x: torch.Tensor, w: torch.Tensor, entry, *,
                local: bool, tag: str) -> torch.Tensor:
        """x @ w for w's rows sharded by `entry`, summed over the axis. x
        holds the rank's slice of the input features (`local`) or all of
        them (its slice is taken)."""
        ax = axis_of(self.mesh, entry)
        if ax is None:
            return x @ w
        if not local:
            n = w.shape[0]
            x = ax.enter(x, tag)[..., ax.rank * n:(ax.rank + 1) * n]
        return ax.psum(x @ w, tag)

    def swiglu(self, h, w_gate, w_up, w_down, entry) -> torch.Tensor:
        """The SwiGLU with `d_ff` sharded by `entry` (columns, then rows)."""
        h = self.enter(h, entry, "ffn")
        return self.rows_in(torch.nn.functional.silu(h @ w_gate) * (h @ w_up),
                            w_down, entry, local=True, tag="ffn")

    def gelu(self, h, w_up, b_up, w_down, b_down, entry) -> torch.Tensor:
        """`layers.gelu_mlp` with `d_ff` sharded by `entry`: the rank's
        columns of w_up and of b_up, its rows of w_down, a psum, then
        b_down."""
        u = self.cols(h, w_up, entry, tag="ffn")
        u = torch.nn.functional.gelu(
            u + self.cols_of(b_up, entry).to(h.dtype), approximate="tanh")
        return (self.rows_in(u, w_down, entry, local=True, tag="ffn")
                + b_down.to(h.dtype))

    def logits(self, x: torch.Tensor, head: torch.Tensor, entry):
        """f32 logits of x against `head` (D, V) with V sharded by `entry`."""
        return self.cols(x, head, entry, gather=True, tag="logits").float()

    def vocab_logits(self, x: torch.Tensor, head: torch.Tensor, entry):
        """x @ head in x's dtype for the rank's block of the vocabulary
        (all of it where `entry` shards nothing), and the axis of that
        block (None): the training head, whose logits are never gathered
        (`layers.cross_entropy(vocab=)`)."""
        return self.cols(x, head, entry, tag="logits"), axis_of(self.mesh,
                                                                 entry)
