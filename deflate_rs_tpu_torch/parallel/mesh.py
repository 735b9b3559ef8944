"""Device meshes for the sharded encoder, on ``torch.distributed``.

Port of ``deflate_rs_tpu/parallel/mesh.py``.  The unit of data parallelism
is the independent chunk: a batch's chunks are split into contiguous row
blocks, one per device in mesh order, and the only collective is the
all-gather of the per-chunk compressed sizes (``parallel/sharded.py``).

A ``Mesh`` is a 1-D row of devices, as the JAX package's is.  It holds this
process's devices (a tuple, in mesh order), the device count over every
process, and the process group with this process's rank in it.  Three
forms:

- one process, no process group: the first ``num_devices`` cards this
  process sees, as ``jax.devices()[:num_devices]`` (on the CPU,
  ``num_devices`` logical devices, each the ``cpu`` device, as the JAX
  tests' ``--xla_force_host_platform_device_count``);
- one card a rank of a process group (``LOCAL_RANK``'s card): ranks talk
  over NCCL on CUDA devices and over gloo on the CPU;
- ``local_devices`` cards a rank: every rank drives several cards, and the
  mesh is every rank's cards in rank order.

A process's rows are a contiguous block of the batch
(``local_chunk_range``), which it splits over its own devices in order.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The group (None for a single process without ``torch.distributed``),
    the device count over every process, this process's rank and its
    devices in mesh order."""

    group: object
    size: int
    rank: int
    devices: tuple

    @property
    def device(self) -> torch.device:
        """This process's first device: the one its collectives run on."""
        return self.devices[0]


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, *, device="cuda",
                     local_devices: int = 1) -> None:
    """Join (or start) a process group of ``world_size`` ranks.

    A thin wrapper over ``torch.distributed.init_process_group``: NCCL for a
    CUDA ``device``, gloo for the CPU.  Arguments default to ``torchrun``'s
    environment (``env://`` with ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``).  ``init_method="file:///path"`` rendezvous
    through a file that no other run uses, with no socket.  On CUDA the
    rank's first card (:func:`rank_card` of ``local_devices`` cards a rank,
    the card :func:`make_mesh` gives the rank first) becomes the current
    device first, so the group's collectives run on it.
    """
    rank = int(os.environ["RANK"]) if rank is None else rank
    dev = torch.device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(dev if dev.index is not None and local_devices == 1
                              else rank_card(rank, local_devices))
    dist.init_process_group(
        backend,
        init_method=init_method or "env://",
        world_size=int(os.environ["WORLD_SIZE"]) if world_size is None else world_size,
        rank=rank,
    )


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def rank_card(rank: int, per_rank: int = 1) -> torch.device:
    """The first of a rank's ``per_rank`` cards, the one place that picks
    it: ``LOCAL_RANK`` (torchrun's variable; the rank when unset) times
    ``per_rank``; one card a rank wraps around the cards this process
    sees."""
    first = int(os.environ.get("LOCAL_RANK", rank)) * per_rank
    return torch.device("cuda", first % torch.cuda.device_count() if per_rank == 1 else first)


def make_mesh(num_devices: int | None = None, *, device="cuda",
              local_devices: int | None = None) -> Mesh:
    """A 1-D mesh of devices (see the module docstring for its forms).

    Without a process group: the first ``num_devices`` cards of this process
    (by default every card it sees), or ``num_devices`` logical CPU devices
    (by default one); a CUDA ``device`` with an index is that card alone.
    In a process group: ``local_devices`` devices a rank (by default one),
    a rank's cards from ``LOCAL_RANK * local_devices`` on, and ``num_devices``,
    where given, must be the mesh's size.  More cards than the process sees,
    or ranks that do not hold as many devices each, raise ``ValueError``.
    """
    dev = torch.device(device)
    initialised = dist.is_available() and dist.is_initialized()
    if not initialised:
        if local_devices is not None:
            raise ValueError("local_devices= sets a rank's devices in a process group; "
                             "without one, num_devices= is the mesh")
        if dev.type != "cuda":
            devices = (dev,) * (1 if num_devices is None else num_devices)
        elif dev.index is not None:
            if num_devices not in (None, 1):
                raise ValueError(f"{dev} is one card, not a mesh of {num_devices}")
            devices = (dev,)
        else:
            seen = torch.cuda.device_count()
            n = seen if num_devices is None else num_devices
            if n > seen:
                raise ValueError(f"a mesh of {n} cards needs {n} cards; this process sees "
                                 f"{seen}")
            devices = tuple(torch.device("cuda", i) for i in range(n))
        if not devices:
            raise ValueError("a mesh needs at least one device")
        return Mesh(None, len(devices), 0, devices)

    rank, world = dist.get_rank(), dist.get_world_size()
    per_rank = 1 if local_devices is None else local_devices
    if per_rank < 1:
        raise ValueError(f"local_devices={local_devices}: a rank drives at least one device")
    if dev.type != "cuda":
        devices = (dev,) * per_rank
    else:
        first = dev if dev.index is not None and per_rank == 1 else rank_card(rank, per_rank)
        if first.index + per_rank > torch.cuda.device_count():
            raise ValueError(f"rank {rank} needs cards {first.index} to "
                             f"{first.index + per_rank - 1}; this process sees "
                             f"{torch.cuda.device_count()}")
        devices = tuple(torch.device("cuda", first.index + i) for i in range(per_rank))
        # The group's collectives run on the rank's first card; bind it before
        # the first one (init_distributed(local_devices=k) bound the same card;
        # a group formed without it is bound here).
        torch.cuda.set_device(devices[0])
    counts = [None] * world
    dist.all_gather_object(counts, per_rank)
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks hold {counts} devices: every rank must hold as many, "
                         "so that the rows split evenly")
    size = sum(counts)
    if num_devices is not None and num_devices != size:
        if per_rank == 1:
            raise ValueError(f"a mesh of {num_devices} devices needs {num_devices} ranks, one "
                             f"a device; the process group has {world}")
        raise ValueError(f"a mesh of {num_devices} devices does not match {world} ranks of "
                         f"{per_rank} devices")
    return Mesh(dist.group.WORLD, size, rank, devices)


def local_chunk_range(global_b: int, mesh: Mesh | None = None) -> range:
    """The [start, stop) rows of a ``global_b``-row batch that THIS process
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
