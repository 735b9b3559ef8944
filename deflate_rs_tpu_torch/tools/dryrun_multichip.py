"""Dry run of the sharded encoder over a mesh of ``n`` devices, and the
spawner it uses.

The torch form of ``__graft_entry__.dryrun_multichip`` and
``scripts/multihost_dryrun.py``: one sharded encode step over mixed content,
four chunks a device: text (dynamic blocks and splits), random bytes (stored
chunks, which contribute no words to the compacted fetch), runs, periodic
binary and a text/binary alternation.  Three forms of the mesh:

- ``--single-process``: one process drives all ``n`` devices, as
  ``__graft_entry__.dryrun_multichip(n)`` does with one JAX process;
- ``n`` spawned ranks of one device each (gloo on the CPU, NCCL on CUDA);
- ``--local-devices k``: ``n / k`` spawned ranks of ``k`` devices each.

Each process writes its byte-aligned segment at its global offset into one
shared file, the multi-host pattern; the parent checks the file against
``zlib`` and against the one-shot bytes at the same chunk grid, then splices
every process's shard packed and checks that against the one-shot packed
bytes.

    python3 -m deflate_rs_tpu_torch.tools.dryrun_multichip --ranks 2 --device cpu --emit 4096
    python3 -m deflate_rs_tpu_torch.tools.dryrun_multichip --ranks 4 --single-process
    python3 -m deflate_rs_tpu_torch.tools.dryrun_multichip --ranks 4 --local-devices 2
    python3 -m deflate_rs_tpu_torch.tools.dryrun_multichip --ranks 1   # one card, NCCL

Ranks meet through ``init_method="file://..."`` in a fresh temporary
directory: no socket is opened for the rendezvous.  On CUDA the kernel
library is built once, before any rank starts.
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import sys
import tempfile
import zlib

import numpy as np
import torch

from ..ops.chunk_encode import HALO, PAD
from ..utils.mix import PG11


def build_batch(data: bytes, emit: int):
    """Chunk buffers uint8[B, HALO + emit + PAD] of ``data`` on an ``emit``
    grid, each with its 32 KiB of history, and per-row (hist_len, n,
    is_last)."""
    n = len(data)
    offsets = list(range(0, max(n, 1), emit))
    B = len(offsets)
    src = np.frombuffer(data, np.uint8)
    bufs = np.zeros((B, HALO + emit + PAD), np.uint8)
    hist = np.zeros(B, np.int64)
    ns = np.zeros(B, np.int64)
    lasts = np.zeros(B, bool)
    for i, off in enumerate(offsets):
        ln = min(n - off, emit)
        h = min(off, HALO)
        bufs[i, HALO - h : HALO + ln] = src[off - h : off + ln]
        hist[i], ns[i], lasts[i] = h, ln, off + ln >= n
    return bufs, hist, ns, lasts


def dryrun_data(emit: int, n_chunks: int) -> bytes:
    """The dry run's mixed input: ``n_chunks`` chunks of ``emit`` bytes."""
    rng = np.random.default_rng(0)
    with open(PG11, "rb") as f:
        text = f.read()
    pieces = [
        (text * 2)[: 2 * emit],                                     # 2 chunks of text
        rng.integers(0, 256, emit, dtype=np.uint8).tobytes(),       # stored
        b"\x00" * (emit // 2) + b"\xff" * (emit // 2),              # runs
        bytes(range(64)) * (emit // 64),                            # periodic
        (text[:2048] + rng.integers(0, 256, 2048, dtype=np.uint8).tobytes())
        * max(1, emit // 4096),                                     # text/binary
    ]
    unit = b"".join(pieces)
    return (unit * (emit * n_chunks // len(unit) + 1))[: emit * n_chunks]


def _rank_entry(rank: int, world: int, init_file: str, device: str, local_devices: int, fn,
                args, result_dir: str) -> None:
    from ..parallel.mesh import init_distributed, make_mesh

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # ranks share the machine's cores
    init_distributed(f"file://{init_file}", world, rank, device=device,
                     local_devices=local_devices)
    try:
        result = fn(make_mesh(device=device, local_devices=local_devices), *args)
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(result_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def spawn_ranks(fn, world: int, args: tuple = (), *, device="cuda",
                local_devices: int = 1) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` spawned ranks of one process
    group, each with ``local_devices`` devices of the mesh, and return their
    results in rank order.  ``fn`` is a module-level function (it is pickled
    by name); its module is imported afresh in every rank.  A rank that
    raises makes this raise."""
    if torch.device(device).type == "cuda":
        from ..runtime import cuda

        cuda.load_library()  # build once, before the ranks load it
    tmp = tempfile.mkdtemp(prefix="deflate_ranks_")
    try:
        torch.multiprocessing.spawn(
            _rank_entry, args=(world, os.path.join(tmp, "rendezvous"), str(device),
                               local_devices, fn, args, tmp),
            nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))  # written by our own ranks
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _dryrun_rank(mesh, emit: int, chunks_per_device: int, out_path: str) -> dict:
    """One process of the dry run: encode its rows, write its segment at its
    global offset, return its shard for the parent's packed check."""
    from ..compression_options import CompressionOptions
    from ..parallel.corpus import chunk_options
    from ..parallel.mesh import local_chunk_range
    from ..parallel.sharded import assemble_local, make_sharded_encoder

    B = mesh.size * chunks_per_device
    data = dryrun_data(emit, B)
    bufs, hist, ns, lasts = build_batch(data, emit)
    # The corpus engine's options at this chunk size, so both give one stream.
    step = make_sharded_encoder(mesh, chunk_options(CompressionOptions.default(), emit), emit)
    shard = step(bufs, hist, ns, lasts)
    own = local_chunk_range(B, mesh)
    payloads = [data[i * emit : i * emit + int(ns[i])] if i in own else None
                for i in range(B)]
    segment, offset = assemble_local(shard, payloads=payloads, is_lasts=lasts, mesh=mesh)
    fd = os.open(out_path, os.O_WRONLY)
    try:
        os.pwrite(fd, segment, offset)
    finally:
        os.close(fd)
    return shard


def dryrun_multichip(n: int, *, emit: int = 65536, chunks_per_device: int = 4,
                     device="cuda", single_process: bool = False,
                     local_devices: int = 1) -> dict:
    """Run the dry run over a mesh of ``n`` devices and check it; returns a
    summary.  ``single_process``: this process drives them all; otherwise
    ``n / local_devices`` spawned ranks of ``local_devices`` devices each.
    Raises ``RuntimeError`` when a check fails, and ``ValueError`` before
    any device is used where the sharded encoder does not take chunks of
    ``emit`` bytes at Default (``corpus.check_chunk_size``) or the devices
    do not split over the ranks."""
    from .. import constants as C
    from ..compression_options import CompressionOptions
    from ..ops.compaction import used_words_host
    from ..parallel.corpus import check_chunk_size, compress_corpus
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import assemble_host

    check_chunk_size(emit, CompressionOptions.default())
    if n % local_devices:
        raise ValueError(f"{n} devices do not split into ranks of {local_devices}")
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(f"need {n} CUDA devices, have {torch.cuda.device_count()}")
    B = n * chunks_per_device
    data = dryrun_data(emit, B)
    _, _, ns, lasts = build_batch(data, emit)
    fd, out_path = tempfile.mkstemp(prefix="deflate_dryrun_")
    os.close(fd)
    try:
        if single_process:
            shards = [_dryrun_rank(make_mesh(n, device=device), emit, chunks_per_device,
                                   out_path)]
        else:
            shards = spawn_ranks(_dryrun_rank, n // local_devices,
                                 (emit, chunks_per_device, out_path), device=device,
                                 local_devices=local_devices)
        with open(out_path, "rb") as f:
            written = f.read()
    finally:
        os.remove(out_path)
    btype = np.concatenate([s["btype"] for s in shards])
    used = used_words_host(btype, np.concatenate([s["data_bits"] for s in shards]))
    payloads = [data[i * emit : i * emit + int(ns[i])] for i in range(B)]
    packed = assemble_host(shards, packed=True, payloads=payloads, is_lasts=lasts)
    checks = {
        "a stored chunk": (btype == C.BTYPE_STORED).any(),
        "no words for stored chunks": (used[btype == C.BTYPE_STORED] == 0).all(),
        "file round-trips": zlib.decompress(written, -15) == data,
        "file == one-shot byte-aligned bytes": written == compress_corpus(
            data, chunk_size=emit, packed=False, device=device).deflate,
        "packed == one-shot packed bytes": packed == compress_corpus(
            data, chunk_size=emit, device=device).deflate,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n}): failed: {failed}")
    return {"devices": n, "processes": len(shards), "chunks": B, "emit": emit,
            "input_bytes": len(data),
            "aligned_bytes": len(written), "packed_bytes": len(packed),
            "fetched_word_bytes": int(used.sum()) * 4,
            "block_types": sorted({int(b) for b in btype})}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="devices of the mesh (default: the CUDA devices, or 2 on the CPU)")
    ap.add_argument("--single-process", action="store_true",
                    help="drive every device from this process, with no process group")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="devices a spawned rank drives (--ranks / this ranks)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--emit", type=int, default=65536, help="chunk size in bytes")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("dryrun_multichip: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    n = a.ranks or (torch.cuda.device_count() if a.device == "cuda" else 2)
    s = dryrun_multichip(n, emit=a.emit, device=a.device, single_process=a.single_process,
                         local_devices=a.local_devices)
    form = ("one process" if a.single_process else
            f"{s['processes']} ranks of {a.local_devices} device{'s' * (a.local_devices > 1)}")
    print(f"dryrun_multichip({n}): {s['chunks']} chunks x {s['emit']} B on {a.device}, "
          f"{s['input_bytes']} -> {s['aligned_bytes']} B (packed {s['packed_bytes']}), "
          f"compacted fetch {s['fetched_word_bytes']} B, block types {s['block_types']}: "
          f"the file written by {form} round-trips and equals the one-shot bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
