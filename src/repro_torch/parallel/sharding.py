"""The sequence axis of the port: a 1-D mesh of S ranks over a
`torch.distributed` process group.

The JAX package shard_maps one program over a ("seq",) mesh; the port runs
S processes (SPMD), one per shard, and `SeqGroup` stands in for the
mesh axis inside them: `size` and `rank` (`axis_size` / `axis_index`),
`psum`, `pmax`, `pmin` and `all_gather`. Every rank must call the same
collectives in the same order, so every data-dependent branch of the
sharded path tests values that came out of a collective.

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
per-tick collective bill.
"""

from __future__ import annotations

from typing import Dict, List

import torch


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
        the gathered partials."""
        if self.size == 1:
            return t
        if t.dtype == torch.bool:
            t = t.int()
        if t.is_floating_point():
            parts = self.all_gather(t, dim=0, tiled=False, tag=tag)
            out = parts[0]
            for i in range(1, self.size):
                out = out + parts[i]
            return out
        import torch.distributed as dist
        return self._reduce(t, dist.ReduceOp.SUM, tag)

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

