"""Soak of the sharded encoder: many steps over a large corpus.

The torch form of ``scripts/sharded_soak.py``: the corpus goes through the
sharded encoder (``parallel/sharded.py``) in steps of 32 chunks of 64 KiB,
over ``--world`` spawned ranks (gloo on the CPU, NCCL on CUDA devices, one
card a rank) or, with ``--single-process``, over a mesh of ``--world``
devices that this process drives alone.  Each step, every process assembles
its rows with ``assemble_local`` and writes the byte-aligned segment at its
offset in the whole stream (the bytes of the steps before, plus its offset
in the step) into one shared file, the multi-host pattern.  The last
step is padded with empty rows, which are dropped.  The parent then checks,
and exits non-zero on any miss:

- ``zlib.decompress(file, -15)`` gives the corpus back (offsets across step
  boundaries, stored and Huffman chunks, padding rows);
- the chunks' Adler-32 and CRC-32 partials, combined in stream order, equal
  ``zlib``'s;
- every process's shards spliced packed equal the one-shot
  ``deflate_bytes_conf`` of the corpus at the same preset.

It prints MB/s per world size (the slowest process's steps and assembly).

    python3 -m deflate_rs_tpu_torch.tools.sharded_soak --mb 512 --world 1 2 4
    python3 -m deflate_rs_tpu_torch.tools.sharded_soak --mb 1024 --world 4 --single-process
    python3 -m deflate_rs_tpu_torch.tools.sharded_soak --mb 4 --world 2 4 --device cpu

The corpus follows ``scripts/sharded_soak.py``'s recipe with files of the
checkout in place of the system's binaries and license texts: the
regression inputs of ``tests/data`` (fuzzer finds, a zlib stream, binaries),
pg11 and 1 MiB of seeded random bytes, repeated to size.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from .dryrun_multichip import PG11, spawn_ranks

EMIT = 65536  # the one-shot path's chunk size: its bytes are the reference
STEP_CHUNKS = 32


def build_corpus(total: int) -> bytes:
    """``total`` bytes: pg11, 1 MiB of seeded random bytes (stored chunks) and
    the files of ``tests/data``, repeated to size."""
    with open(PG11, "rb") as f:
        pieces = [f.read()]
    pieces.append(np.random.default_rng(0).integers(0, 256, 1 << 20, dtype=np.uint8).tobytes())
    data_dir = os.path.dirname(PG11)
    for path in sorted(glob.glob(os.path.join(data_dir, "*")) +
                       glob.glob(os.path.join(data_dir, "afl", "*"))):
        if os.path.isfile(path) and path != PG11 and not path.endswith(".md"):
            with open(path, "rb") as f:
                pieces.append(f.read())
    unit = b"".join(pieces)
    return (unit * (total // len(unit) + 1))[:total]


class _Chunks:
    """Chunk ``g`` of the corpus by global row (empty past its end)."""

    def __init__(self, data: bytes):
        self.data = data

    def __getitem__(self, g: int) -> bytes:
        return self.data[g * EMIT : (g + 1) * EMIT]


def step_batch(data: bytes, g0: int, rows: int):
    """The global batch of one step: chunk buffers of rows ``g0 ..
    g0 + rows - 1`` of the corpus, each with its 32 KiB of history, and per
    row (hist_len, n, is_last); rows past the corpus are empty."""
    from ..ops.chunk_encode import HALO, PAD

    n = len(data)
    src = np.frombuffer(data, np.uint8)
    bufs = np.zeros((rows, HALO + EMIT + PAD), np.uint8)
    hist = np.zeros(rows, np.int64)
    ns = np.zeros(rows, np.int64)
    lasts = np.zeros(rows, bool)
    for i in range(rows):
        off = (g0 + i) * EMIT
        ln = max(0, min(n - off, EMIT))
        h = min(off, HALO) if ln else 0
        bufs[i, HALO - h : HALO + ln] = src[off - h : off + ln]
        hist[i], ns[i], lasts[i] = h, ln, off + ln >= n
    return bufs, hist, ns, lasts


def _soak_rank(mesh, total: int, preset: str, step_chunks: int, out_path: str) -> dict:
    """One process: every step of the corpus, its segments written into
    ``out_path``; returns its shards (rows numbered over the whole corpus)
    and its seconds."""
    from ..compression_options import CompressionOptions
    from ..parallel.sharded import assemble_local, make_sharded_encoder

    data = build_corpus(total)
    chunks = _Chunks(data)
    n_chunks = -(-len(data) // EMIT)
    step = make_sharded_encoder(mesh, getattr(CompressionOptions, preset)(), EMIT)
    shards, stream_off = [], 0
    fd = os.open(out_path, os.O_WRONLY)
    try:
        t0 = time.perf_counter()
        for g0 in range(0, n_chunks, step_chunks):
            real = min(step_chunks, n_chunks - g0)  # the rest of the step is padding
            bufs, hist, ns, lasts = step_batch(data, g0, step_chunks)
            shard = step(bufs, hist, ns, lasts)
            segment, offset = assemble_local(
                shard, payloads=[chunks[g0 + i] for i in range(step_chunks)], is_lasts=lasts,
                n=real, mesh=mesh)
            os.pwrite(fd, segment, stream_off + offset)
            stream_off += int(shard["all_nbytes"][:real].sum())
            shard["row0"] += g0
            shards.append(shard)
        seconds = time.perf_counter() - t0
    finally:
        os.close(fd)
    return {"shards": shards, "seconds": seconds}


def soak(total: int, *, preset: str = "default", world: int = 1, device="cuda",
         step_chunks: int = STEP_CHUNKS, single_process: bool = False,
         one_shot: bytes | None = None) -> dict:
    """Run the soak over ``world`` ranks, or over a mesh of ``world`` devices
    in this process (``single_process``), and check it; returns a summary.
    ``one_shot``, where given, is the corpus's ``deflate_bytes_conf`` at
    ``preset`` (it saves computing it again).  Raises ``RuntimeError`` when
    a check fails."""
    from .. import deflate_bytes_conf
    from ..compression_options import CompressionOptions
    from ..ops import checksum as ck
    from ..parallel.mesh import make_mesh
    from ..parallel.sharded import assemble_host

    if step_chunks % world:
        raise ValueError(f"a step of {step_chunks} chunks does not divide over {world} devices")
    if torch.device(device).type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"need {world} CUDA devices, have {torch.cuda.device_count()}")
    data = build_corpus(total)
    n = len(data)
    fd, out_path = tempfile.mkstemp(prefix="deflate_soak_")
    os.close(fd)
    try:
        args = (total, preset, step_chunks, out_path)
        if single_process:
            ranks = [_soak_rank(make_mesh(world, device=device), *args)]
        else:
            ranks = spawn_ranks(_soak_rank, world, args, device=device)
        with open(out_path, "rb") as f:
            stream = f.read()
    finally:
        os.remove(out_path)
    shards = sorted((s for r in ranks for s in r["shards"]), key=lambda s: s["row0"])
    n_chunks = -(-n // EMIT)
    adler, crc_raw, btypes = ck.ADLER_INIT, 0, []
    for s in shards:
        for i in range(min(len(s["nbytes"]), n_chunks - s["row0"])):
            ln = min(EMIT, n - (s["row0"] + i) * EMIT)
            adler = ck.adler32_combine(adler, int(s["s1"][i]), int(s["s2"][i]), ln)
            crc_raw = ck.crc32_combine_raw(crc_raw, int(s["crc_raw"][i]), ln)
            btypes.append(int(s["btype"][i]))
    # Every shard as rows of one batch over the whole corpus, spliced packed.
    all_nbytes = np.concatenate([s["nbytes"] for s in shards])
    packed = assemble_host([dict(s, all_nbytes=all_nbytes) for s in shards], n_chunks,
                           packed=True, payloads=_Chunks(data),
                           is_lasts=np.arange(len(all_nbytes)) == n_chunks - 1)
    if one_shot is None:
        one_shot = deflate_bytes_conf(data, getattr(CompressionOptions, preset)(), device=device)
    checks = {
        "stream round-trips through zlib": zlib.decompress(stream, -15) == data,
        "Adler-32 of the partials == zlib's": ck.adler32_value(adler) == zlib.adler32(data),
        "CRC-32 of the partials == zlib's": ck.crc32_from_raw(crc_raw, n) == zlib.crc32(data),
        "packed splice == one-shot bytes": packed == one_shot,
        "every chunk has its partials": len(btypes) == n_chunks,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise RuntimeError(f"sharded soak at world size {world}: failed: {failed}")
    seconds = max(r["seconds"] for r in ranks)
    return {"world": world, "processes": len(ranks), "input_bytes": n, "chunks": n_chunks,
            "steps": -(-n_chunks // step_chunks), "stream_bytes": len(stream),
            "packed_bytes": len(packed), "seconds": seconds, "mb_per_s": n / 1e6 / seconds,
            "block_types": {b: btypes.count(b) for b in sorted(set(btypes))},
            "fetched_bytes": sum(int(s["cw"].nbytes) + 6 * 8 * len(s["nbytes"])
                                 for s in shards)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=512, help="corpus size in MiB")
    ap.add_argument("--preset", default="default",
                    choices=("default", "fast", "high", "rle", "huffman_only", "turbo"))
    ap.add_argument("--world", type=int, nargs="+", default=[1],
                    help="world sizes to run (devices of the mesh)")
    ap.add_argument("--single-process", action="store_true",
                    help="drive the mesh's devices from this process, with no process group")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("sharded_soak: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
        return 1
    for world in a.world:
        s = soak(int(a.mb * (1 << 20)), preset=a.preset, world=world, device=a.device,
                 single_process=a.single_process)
        form = "one process" if a.single_process else f"{world} ranks"
        print(f"sharded_soak: world size {world} ({form}) on {a.device}, preset {a.preset}: "
              f"{s['input_bytes']} B in {s['steps']} steps of {STEP_CHUNKS} x {EMIT} B -> "
              f"{s['stream_bytes']} B byte-aligned ({s['packed_bytes']} B packed); round-trips, "
              f"checksums == zlib's, packed == one-shot; {s['mb_per_s']:.2f} MB/s "
              f"({s['seconds']:.2f} s, slowest process); block types {s['block_types']}; fetched "
              f"{s['fetched_bytes']} B", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
