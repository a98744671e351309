"""The sequence mesh of the sharded serving path, over `torch.distributed`.

The JAX package builds a 1-D ("seq",) device mesh in one process; the port
runs one process per shard. Each of the S processes initialises the
default process group (`init_seq_group`, or `torch.distributed` directly)
and then takes `make_seq_mesh(S)`, the `SeqGroup` its sharded step runs
its collectives over. Nothing here picks a backend or a device for the
caller, and nothing falls back to one rank.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch

from repro_torch.parallel.sharding import SeqGroup

_LAUNCH_HINT = (
    "start one process per shard and initialise the default process group "
    "in each (repro_torch.launch.init_seq_group(rank, S, init_method=..., "
    "backend=...) or torch.distributed.init_process_group with world_size "
    "S), e.g. with torch.multiprocessing.spawn")


def init_seq_group(rank: int, world_size: int, *, init_method: str,
                   backend: str, timeout_s: float = 60.0) -> None:
    """Initialise this process's default group: rank `rank` of
    `world_size`, rendezvous at `init_method` (`file://...` or
    `tcp://localhost:PORT`). A collective that waits longer than
    `timeout_s` raises, so a rank that diverges fails the run instead of
    hanging it."""
    import torch.distributed as dist
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))


def make_seq_mesh(seq_shards: int, *, backend: Optional[str] = None,
                  device=None) -> SeqGroup:
    """The sequence axis for `DecodeEngine(kv_layout="paged",
    seq_shards=S)` and the `serve_step_sp_*` steps: a `SeqGroup` over the
    default process group, which must hold exactly `seq_shards` ranks
    (one rank needs no group). `backend`, when given, must be the group's.
    The rank's device is `cuda:{rank % device_count}` unless `device`
    names another (the CPU tests pass "cpu"). NCCL with more ranks than
    devices is refused: it cannot run two ranks on one GPU."""
    import torch.distributed as dist
    seq_shards = int(seq_shards)
    if seq_shards < 1:
        raise ValueError(f"seq_shards must be >= 1, got {seq_shards}")
    initialised = dist.is_available() and dist.is_initialized()
    if seq_shards == 1 and not initialised:
        return SeqGroup(None, device=_device(0, device))
    if not initialised:
        raise ValueError(
            f"seq_shards={seq_shards} needs a process group of "
            f"{seq_shards} ranks and none is initialised: {_LAUNCH_HINT}")
    world = dist.get_world_size()
    if world != seq_shards:
        raise ValueError(
            f"seq_shards={seq_shards} but the process group holds {world} "
            f"rank(s): {_LAUNCH_HINT}")
    got = str(dist.get_backend())
    if backend is not None and got != backend:
        raise ValueError(f"the process group runs {got!r}, not the "
                         f"requested backend {backend!r}")
    rank = dist.get_rank()
    dev = _device(rank, device)
    if got == "nccl" and dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"backend 'nccl' with {world} ranks on "
            f"{torch.cuda.device_count()} GPU(s): NCCL runs one rank per "
            f"device; run the ranks on 'gloo' to share a device")
    return SeqGroup(dist.group.WORLD, device=dev)


def _device(rank: int, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the sharded path runs on the GPU by "
            "default. Pass device='cpu' to run its plain PyTorch path on "
            "the CPU.")
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")
