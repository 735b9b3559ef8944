"""Device groups for the sharded encoder, on ``torch.distributed``.

Port of ``deflate_rs_tpu/parallel/mesh.py``.  The unit of data parallelism
is the independent chunk: a batch's chunks are split into contiguous row
blocks, one per rank, each rank drives one device, and the only collective
is the all-gather of the per-chunk compressed sizes
(``parallel/sharded.py``).  Ranks talk over NCCL on CUDA devices and over
gloo on the CPU.

A JAX mesh spans the devices of every process; here a process owns one
device, so a ``Mesh`` is a process group, this process's rank in it and its
device.  Without an initialised process group, ``make_mesh`` gives the
one-rank mesh of this process alone.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device per rank: the group (None for a single process without
    ``torch.distributed``), its size, this process's rank and device."""

    group: object
    size: int
    rank: int
    device: torch.device


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, *, device="cuda") -> None:
    """Join (or start) a process group of ``world_size`` ranks.

    A thin wrapper over ``torch.distributed.init_process_group``: NCCL for a
    CUDA ``device``, gloo for the CPU.  Arguments default to ``torchrun``'s
    environment (``env://`` with ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``init_method="file:///path"`` rendezvous
    through a file that no other run uses, with no socket.
    """
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=int(os.environ["WORLD_SIZE"]) if world_size is None else world_size,
        rank=int(os.environ["RANK"]) if rank is None else rank,
    )


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def make_mesh(num_devices: int | None = None, *, device="cuda") -> Mesh:
    """The mesh of every rank of the process group, one device per rank.

    A CUDA ``device`` without an index means this rank's card,
    ``cuda:<LOCAL_RANK>`` (``torchrun``'s variable; the rank when unset)
    modulo the cards this process sees.  ``num_devices``, where given, must
    be the world size: a rank drives exactly one device.
    """
    initialised = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if initialised else 1
    rank = dist.get_rank() if initialised else 0
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh of {num_devices} devices needs {num_devices} ranks, one a "
                         f"device; the process group has {size}")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return Mesh(dist.group.WORLD if initialised else None, size, rank, dev)


def local_chunk_range(global_b: int, mesh: Mesh | None = None) -> range:
    """The [start, stop) rows of a ``global_b``-row batch that THIS rank
    encodes, fetches and writes: contiguous row blocks in rank order.

    A batch that does not divide over the ranks is an error (pad it), as is
    a mesh whose devices do not split over the processes.
    """
    initialised = dist.is_available() and dist.is_initialized()
    n_proc = dist.get_world_size() if initialised else 1
    pid = dist.get_rank() if initialised else 0
    if mesh is not None and mesh.size % n_proc:
        raise ValueError(f"mesh of {mesh.size} devices does not split over {n_proc} processes")
    if global_b % n_proc:
        raise ValueError(f"global batch {global_b} is not divisible by the process count "
                         f"{n_proc}; pad the batch")
    per = global_b // n_proc
    return range(pid * per, (pid + 1) * per)
