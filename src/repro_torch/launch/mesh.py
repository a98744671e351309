"""The meshes of the port's sharded serving paths, over `torch.distributed`.

The JAX package builds a device mesh in one process; the port runs one
process per rank. Each process initialises the default process group
(`init_mesh_group`, or `torch.distributed` directly) and then takes its
mesh: `make_seq_mesh(S)`, the 1-D `SeqGroup` of the sequence-sharded
step, or `make_mesh(shape, axes)`, a named `Mesh` such as ("data",
"model") for the tensor- and expert-parallel steps. The production meshes
(16 x 16, 2 x 16 x 16) are abstract: one machine cannot raise their ranks,
and the specs need only the sizes. Nothing here picks a backend or a
device for the caller, and nothing falls back to one rank.
"""

from __future__ import annotations

from datetime import timedelta
from typing import Optional

import torch

from repro_torch.parallel.sharding import AbstractMesh, Mesh, SeqGroup

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


init_mesh_group = init_seq_group


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The reference's production mesh, abstract: (16, 16) over ("data",
    "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape, axes, *, backend: Optional[str] = None,
              device=None) -> Mesh:
    """A named mesh over the default process group, which must hold
    prod(shape) ranks, row-major over `axes`. `backend`, when given, must
    be the group's; the device is `cuda:{rank % device_count}` unless
    `device` names another (the CPU tests pass "cpu"); NCCL with more
    ranks than devices is refused."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs a process "
                         f"group and none is initialised: {_LAUNCH_HINT}")
    world = dist.get_world_size()
    got = _check_backend(backend)
    dev = _device(dist.get_rank(), device)
    _check_nccl(got, dev, world)
    return Mesh(shape, axes, device=dev)


def _check_backend(backend: Optional[str]) -> str:
    import torch.distributed as dist
    got = str(dist.get_backend())
    if backend is not None and got != backend:
        raise ValueError(f"the process group runs {got!r}, not the "
                         f"requested backend {backend!r}")
    return got


def _check_nccl(backend: str, dev: torch.device, world: int) -> None:
    if backend == "nccl" and dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(
            f"backend 'nccl' with {world} ranks on "
            f"{torch.cuda.device_count()} GPU(s): NCCL runs one rank per "
            f"device; run the ranks on 'gloo' to share a device")


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
    got = _check_backend(backend)
    dev = _device(dist.get_rank(), device)
    _check_nccl(got, dev, world)
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
