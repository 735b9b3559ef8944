"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``--phases sharded,soak`` runs the setup and only the named phases (any of
``PHASES``, the function phases below from decode on) and prints no kernels
line: on a machine with four cards, ``python3 chip_smoke.py --phases
sharded,soak`` runs the multi-card rows alone.

Phases (each prints a line; any failure exits non-zero):

1. setup: a CUDA device is required (no CPU fallback); prints the card's
   name and power limit and builds the CUDA kernels from
   ``deflate_rs_tpu_torch/csrc``.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, on inputs harvested from the encoders' own runs over chunks of
   the mix below: Default (every kernel; quarter histograms at nq = 8),
   fast (nq = 1), rle (nq = 4) and high (lr_measure at 32 segments,
   package-merge at its many rows).  Exact equality is required at every
   batch the paths below launch.  In the 64 KiB tier: the corpus engine's
   batch (``corpus.BATCH_SIZE`` chunks, the shape of the one-shot and the
   corpus run: every kernel timed there, and the ``kernels`` line's ``ms``,
   ``plain_ms`` and ``bound_ms`` are at that batch), one chunk alone (B = 1,
   the single-chunk streaming path: every kernel timed again, ``b1_ms``),
   15 and 16 chunks (a 1 MiB write to a streaming encoder) and 32 (the
   chunk-batch engine, ``pipelined=False``).  The sharded step's batches, on
   the operands of its own encoder (Default): every chunk of the mix at once
   (world size 1, timed, ``sharded_*``) and one rank of the dry run (four
   chunks: text, stored, runs, periodic).  In the 4 KiB tier: 32 streams
   of 4 KiB, timed, and one alone, the only batch that tier is launched at.
   Then the adversarial operands of
   ``deflate_rs_tpu_torch/utils/kernel_cases.py`` go through ``parse_scan``,
   ``package_merge``, ``lr_measure``, ``quarter_hist`` and ``token_fields``
   (its ``FIELD_CASES`` and odd shapes, each also one element into its
   buffers: rows not 16-byte aligned) and their plain versions, exact
   equality again.  Prints per kernel: its time (CUDA events around replays
   of a CUDA graph of 20 calls of the wrapper, so the card's time without
   the host's launch cost; the eager loop's time beside it), the plain
   version's time, the bound computed from the operands just timed, and for
   the quarter histograms the time of one ``torch.bincount`` over
   precomputed offsets (a yardstick the port never calls).
3. default: ``deflate_bytes``, ``deflate_bytes_zlib`` and
   ``deflate_bytes_gzip`` on a 16 MiB mix (pg11 text, structured records,
   random bytes, runs); each output must round-trip through stdlib
   zlib/gzip, pg11 must compress to 60,196 bytes, the CUDA bytes must equal
   the CPU port's on pg11 and the first 1 MiB of the mix, and every
   kernel's launch counter must have moved during the timed run.
4. presets: fast, high, rle, huffman_only, turbo, ForceFixed and
   ForceStored on pg11, CUDA bytes equal to the CPU port's and
   round-tripping; high and fast on the 16 MiB mix, timed warm, in all
   three framings, CUDA bytes equal to the CPU port's on its first 1 MiB;
   every kernel's launch counter must move during the timed high run.

5. kernels, wide: all five kernels against their plain versions on operands
   harvested from a Default run over 8 chunks of 262,144 bytes
   (``parse_scan`` then walks four windows a chunk and ``lr_measure``
   windows of 1,219 words; 1 to 4 MiB chunks are phase 16's), exact
   equality, with time, bound and share; then the adversarial operands at
   that width and at 1 to 4 MiB (``kernel_cases``' ``*_MIB`` and
   ``*_GRANULE`` cases: 16 to 64 windows and partial segments of
   ``parse_scan``, high's local pass on the tiled path, rows of 1 MiB, of
   4 MiB and of 4,112 positions).
6. corpus: ``compress_corpus`` on the 16 MiB mix.  Its bytes must equal
   ``compress_stream(..., pipelined=False)``'s (the chunk-batch engine) on the
   card and the CPU port's on the first 1 MiB; the zlib and gzip forms and
   ``packed=False`` round-trip; ``chunk_size=262_144`` on 4 MiB round-trips
   and equals the CPU port's on its first 1 MiB; MB/s warm for batch sizes
   16, 32, 64, 128 and queue depths 1 and 3, three runs each, the chunk-batch
   engine's three runs beside them, with the bytes fetched per batch by both;
   every kernel's launch counter must move during a timed corpus run.
7. streaming: ``DeflateEncoder``, ``ZlibEncoder`` and ``GzEncoder`` over the
   mix in writes of 1 MiB (all of it) and of 99,991 B (all of it for raw
   deflate, its first 4 MiB for zlib and gzip): bytes equal to the one-shot
   CUDA bytes; a stream over 4 MiB with a ``flush()`` every 300,000 B
   round-trips, and one over pg11 with a ``flush()`` every 50,000 B equals
   the CPU port's; ``reset`` reuse; the single-chunk row: one 64 KiB write
   plus ``flush()``, 20 times after a warm one, and a 4 KiB write plus
   ``finish()``; every kernel's launch counter must move at B = 1.
8. checksums: ``ChunkEncoder(with_checksums=True)`` partials, combined over
   the mix, equal ``zlib.adler32`` and ``zlib.crc32``.
9. decode: ``ops.inflate_device.inflate_device`` on the card, no CPU
   fallback, on the port's CUDA streams of pg11 at every preset (Default,
   fast, high, rle, huffman_only, turbo, ForceFixed, ForceStored) and of the
   mix's first 1 MiB at Default (a bit window that covers one chunk's block):
   each gives the input back, as do the host ``inflate``, ``inflate_zlib``
   and ``inflate_gzip``.  Prints MB/s of output (the host clock around each
   uninstrumented decode), then ms per block and per dynamic header parse
   (CUDA events, read after the stream; median and spread, per block type),
   and the top-level operations and device kernels of one dynamic block and
   of its header under ``torch.profiler``.  Malformed streams raise
   ``ValueError`` and a decode after them still works (no device-side
   assert).  No kernel may launch while decoding: the path has none.
10. sharded: ``parallel.sharded.make_sharded_encoder`` over NCCL at world
   size 1 in this process (rendezvous through a file): on the mix, packed
   bytes equal the one-shot bytes, byte-aligned bytes (``assemble_host`` and
   ``assemble_local``) equal ``compress_corpus(packed=False)``'s, the
   checksum partials combine to zlib's; MB/s of three warm runs (step plus
   packed splice) beside three of the corpus engine; every kernel's launch
   counter must move during a timed run.  In the same process group,
   ``tools/sharded_overhead.py``: ms per chunk of a trivial op, the plain
   encoder without and with checksums and the sharded step, in turns, at 16
   and 64 chunks of the mix, with the step's words equal to the plain
   encoder's (printed as ``overhead:`` lines).  Then
   ``tools.dryrun_multichip.dryrun_multichip`` spawns one rank a card (with
   two cards or more also in one process, and with four or more as ranks of
   two cards).  Then the mesh of every card in this process, with no process
   group (``make_mesh``, the JAX package's own mode): packed and byte-aligned
   bytes equal the one-shot bytes, on one card its shard equals the
   world-size-1 step's array for array, and each card launches the kernels
   once a step (timed, three runs).  With one card the phase says that the
   multi-card rows were not run.  With two or more: each kernel on every
   card, called with ``cuda:0`` current, against its plain version on the
   operands of that card's block; the scaling rows of
   ``tools/scaling_curve.py`` (64 MiB of the mix at 64 KiB chunks, steps of
   256 chunks, step plus packed splice: MB/s of five warm runs, each card's
   peak memory and busy share) at 1, 2, 4 ... cards, in one process from one
   host thread and as one rank a card, plus ranks of two cards over every
   card; over every card also 512 MiB of the mix at
   32 MiB chunks, fast and Default at 1,024 segments, one chunk a card a
   step, in every form (one warm run timed after one); every stream equal to
   the one-shot ``compress_corpus`` bytes of one card (``SCALING_ROW`` and
   ``BYTES_ROW`` lines).
11. knobs: the long-range knobs on Default and high, each with
   ``lr_global=64``, ``lr_global=256`` and ``lr_stride=2``, on pg11 and the
   mix's first 1 MiB: CUDA bytes equal the CPU port's and round-trip.
   ``lr_measure`` at the ``lr_global`` pass's whole-chunk window (one
   segment, M = D slots: its tiled path) against its plain version on the
   operands the pass hands it: Default at D = 64 on 64 chunks (timed: the
   ``lr_measure_global`` row of the kernels line), one chunk, D = 256, high,
   32 streams of 4 KiB and 8 chunks of 256 KiB; then the whole-window
   adversarial operands of ``utils/kernel_cases.py``, its other tiled
   geometries (more than 64 slots, Default's widest union) and the 64-bit
   winner keys (8,193 slots at a 256 KiB chunk's window, against the plain
   version taken 512 slots at a time).  MB/s of the one-shot
   on the 16 MiB mix, Default with ``lr_global=64`` and without a knob in
   turns, three runs each, and high with ``lr_global=64`` once; a knob run
   must launch the tiled path and not the block path, every knob-free path
   the block path and not the tiled one.
12. soak: ``tools/sharded_soak.py`` at world size 1 over NCCL on 128 MiB of
   its corpus (the tool's default of 512 MiB cut to a quarter, to keep this
   script short), in steps of 32 chunks: the byte-aligned stream round-trips through
   zlib, the combined checksums equal zlib's, the packed splice equals the
   one-shot bytes; MB/s and bytes fetched.  With two cards or more, the same
   over 1 GiB on every card, in one process and as one rank a card, 32
   chunks a card a step.
13. stages: ``tools/stage_timing.py`` for Default, fast and high at 64
   chunks of the mix and Default at one chunk: each stage of
   ``ChunkEncoder.forward`` on the real outputs of the stages before it, its
   wall time, its busy time under ``torch.profiler``, its kernels and its
   three longest kernels, then the whole ``forward`` (all the device work
   of the traced call, read from a range of its own around it).  The
   stages' kernels must sum to the ``forward``'s within 1 % and their busy
   time to its own within 10 %; every kernel's launch counter must move.
   Each run's rows are printed whole on a ``STAGE_ROWS`` line.
14. fuzz: ``tools/fuzz.py`` at seed 0, 100 mutants at Default and fast
   (10 inputs held to the CPU port's bytes) and 25 at high, rle and
   huffman_only (5 held), each input round-tripping through ``zlib`` and the
   port's ``inflate``, every 8th multi-chunk one through ``compress_corpus``
   too; structures before and after; any failure fails the run; every
   kernel's launch counter must move.
15. margins: ``tools/contract_margins.py`` at 128 KiB for Default and high
   (CUDA bytes equal the CPU port's and round-trip) and at 512 and 1,024 KiB
   (round trips); every class's margin under the contract's ceiling.
16. chunks: ``compress_corpus`` on a 64 MiB mix at its default batch (64
   chunks up to 1 MiB, 64 MiB of payload above: 4 chunks of 16 MiB, 2 of
   32 MiB) at ``chunk_size`` 65,536, 262,144, 524,288, 1,048,576,
   2,097,152 and 4,161,280 with Default, 65,536, 1,048,576 and 2,064,128
   with high, 4,194,304, 8,388,608, 16,777,216 and 33,554,432 with fast and
   rle, 16,777,216 and 33,554,432 with huffman_only and turbo, 16,777,216
   with Default at 512 segments and 33,554,432 at 1,024: round trip through
   zlib, CUDA bytes equal to the CPU port's on the first 2 MiB (above 1 MiB
   the first chunk and an eighth of the next, above 4 MiB the first chunk;
   above 8 MiB none: the pins below hold those chunk sizes), above 1 MiB
   the whole stream equal to the one at one chunk a batch, warm MB/s
   (median and spread of three runs), the ratio beside the 64 KiB run's
   (above 4 MiB the 4 MiB run's, at 32 MiB the 16 MiB run's), the peak
   ``max_memory_allocated`` and the batches; every kernel's launch counter
   must move, the tiled path of ``lr_measure`` (and not its block path)
   where the local windows pass the block's (high from 1 MiB, Default from
   2 MiB), neither at fast, rle, huffman_only and turbo.  Default at 2 MiB on 2 MiB and 64 KiB of random
   bytes (stored chunks) and fast at 4 MiB with ``packed=False`` on a stored
   chunk and text: CUDA bytes equal the CPU port's.  fast, rle and turbo at
   4,112 bytes on the first 4 MiB: CUDA bytes equal the CPU port's.
   huffman_only and turbo at 1, 2 and 4 MiB on a chunk of zeros and one of
   b"a" (one litlen symbol of frequency 2**20 to 2**22): CUDA bytes equal
   the CPU port's, round trips through zlib and ``inflate_device`` on the
   card, every kernel but ``lr_measure`` launched.  fast, rle and
   huffman_only on pg11 repeated to one 16 MiB chunk, fast and huffman_only
   to one of 32 MiB (symbols of 2**20 and more in a block, where the JAX
   package's stream is invalid): CUDA bytes equal the CPU port's, round
   trips through zlib and ``inflate_device``; huffman_only on 32 MiB of
   b"a" (a leaf of 2**25) round-trips.  The JAX package's pinned streams of
   one 16 and one 32 MiB chunk (``tests/data/torch_pins_{16,32}mib.json``,
   five presets each): the card's whole stream has the pinned length and
   sha256.  Each size at which the JAX package fails, and the cap (32 MiB +
   16, 64 MiB), raises ``ValueError`` at the entry, no kernel launched.
   The kernels at the first batch of the 1 MiB runs (all five at Default;
   the tiled path at high), of Default's 2 MiB, 4,161,280 B, 512-segment
   16 MiB and 1,024-segment 32 MiB runs (32, 16, 4 and 2 chunks; the tiled
   path held to its plain version on two rows), of the other runs above
   4 MiB, ``parse_scan`` at fast's 4,112 bytes and 4 MiB, and the four
   kernels of the one-byte MiBs' batch (package-merge at a leaf of 2**20,
   at huffman_only and turbo): exact equality with the plain versions
   (``lr_measure``'s two rows at a time), graph-replay time, bound and
   share, ``torch.bincount`` beside ``quarter_hist``.  The CPU port's bytes
   of this phase are computed after its timed runs, in four spawned
   processes (``Witnesses``), while the card runs the checks after them.

The bound of a kernel is the larger of two times: its operands' bytes (each
input read once, each output written once) over 3.35 TB/s, and its integer
operations over 16.75 T op/s (the card's 67 TFLOP/s of float32 counts an FMA
as two on 128 lanes per SM; int32 has 64 lanes and counts one).  Operations
counted, from the data of the run: parse_scan 2 per token of the result;
package_merge 3 per live leaf and level (a merge of about 2m entries and m
pair sums); lr_measure 8 per word and live dominant (at either geometry);
token_fields 10 and quarter_hist 2 per position.

The last two lines are a JSON object describing the kernels and the
``{"ok": true, "device": ...}`` line.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import json
import os
import subprocess
import sys
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH = 32
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_OPS_PER_S = 67e12 / 4  # see the module docstring


def cuda_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Per-call ms of a kernel wrapper on the card alone: CUDA events around
    replays of a CUDA graph that holds ``reps`` calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, replays) / reps


def bound_of(key: str, args, outs) -> tuple:
    """(bytes_ms, operations_ms) of one call: see the module docstring."""
    import torch

    from deflate_rs_tpu_torch.ops.pm_kernel import BIG

    nbytes = sum(t.numel() * t.element_size()
                 for t in (*args, *outs) if torch.is_tensor(t))
    if key.startswith("parse_scan"):
        ops = 2 * int(outs[0].sum())
    elif key.startswith("lengths_by_rank"):
        leaf, max_len = args
        ops = 3 * (max_len - 1) * int((leaf < BIG).sum())
    elif key.startswith("lr_measure"):
        ops = 8 * int((args[1] > 0).sum()) * outs[0].shape[-1]
    elif key.startswith("token_fields"):
        ops = 10 * args[1].numel()
    elif key.startswith("quarter_hist"):
        ops = 2 * args[0].numel()
    else:
        raise KeyError(key)
    return nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3


def bincount_yardstick(args, outs):
    """One ``torch.bincount`` that computes the quarter histograms from flat
    offsets made beforehand; returns (ms, agrees with ``outs``)."""
    import torch

    lsym, dcode, nq = args
    B, E = lsym.shape
    nl, nd = outs[0].shape[-1], outs[1].shape[-1]
    q = torch.arange(E, device=lsym.device) // (E // nq)
    b = torch.arange(B, device=lsym.device)[:, None]
    trash = B * nq * (nl + nd)
    off_l = torch.where((lsym >= 0) & (lsym < nl), (b * nq + q) * nl + lsym, trash)
    off_d = torch.where((dcode >= 0) & (dcode < nd), B * nq * nl + (b * nq + q) * nd + dcode, trash)
    flat = torch.cat([off_l.reshape(-1), off_d.reshape(-1)])
    counts = torch.bincount(flat, minlength=trash + 1)
    same = (torch.equal(counts[: B * nq * nl].view(B, nq, nl), outs[0].long())
            and torch.equal(counts[B * nq * nl : trash].view(B, nq, nd), outs[1].long()))
    return cuda_ms(lambda: torch.bincount(flat, minlength=trash + 1), 20), same


def tier_buffers(mix: bytes, emit: int, batch: int = BATCH):
    """The encoder's operands for one batch of the mix in the emit tier:
    the first ``batch`` chunks of 64 KiB with their history, or ``batch``
    pieces of 4 KiB (each a stream of its own) for the small tier."""
    import numpy as np

    from deflate_rs_tpu_torch.models.deflate import _chunk_buffers

    if emit == 65536:
        return _chunk_buffers(mix, [i * 65536 for i in range(batch)], emit)
    pieces = [mix[i * 4096 * 7 : i * 4096 * 7 + 4096] for i in range(batch)]
    bufs = np.stack([_chunk_buffers(p, [0], emit)[0][0] for p in pieces])
    return (bufs, np.zeros(batch, np.int64), np.full(batch, 4096, np.int64),
            np.ones(batch, bool))


def harvest(encoder, bufs, hist, ns, last):
    """Run ``encoder`` once, recording the first inputs of each kernel wrapper."""
    from deflate_rs_tpu_torch.ops import chunk_encode, longrange, package_merge

    seen = {}
    patches = [(longrange, "lr_measure"), (chunk_encode, "parse_scan"),
               (chunk_encode, "token_fields"), (package_merge, "lengths_by_rank"),
               (chunk_encode, "quarter_histograms")]
    originals = [getattr(m, name) for m, name in patches]

    def recorder(name, fn):
        def wrapped(*args):
            key = name if name != "lengths_by_rank" else f"{name}_{args[1]}"
            seen.setdefault(key, args)
            return fn(*args)
        return wrapped

    for (m, name), fn in zip(patches, originals):
        setattr(m, name, recorder(name, fn))
    try:
        encoder(bufs, hist, ns, last)
    finally:
        for (m, name), fn in zip(patches, originals):
            setattr(m, name, fn)
    return seen


WIDE_EMIT = 262144
WIDE_BATCH = 8
HALO = 32768


def global_operands(preset: str, D: int, operands, emit: int, lo: int, hi: int):
    """What the ``lr_global=D`` pass of ``preset`` hands ``lr_measure`` (its
    tiled path: S = 1, M = D) for rows lo..hi of ``operands`` on the card."""
    import dataclasses

    import torch

    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder

    dev = torch.device("cuda", 0)
    o = dataclasses.replace(getattr(dt.CompressionOptions, preset)(), lr_global=D,
                            chain_scale=max(1, emit // 65536))
    bufs, hist, ns, last = (torch.from_numpy(a[lo:hi]) for a in operands)
    with torch.no_grad():
        seen = harvest(ChunkEncoder(o, emit).to(dev), bufs.to(dev), hist, ns, last)
    return seen["lr_measure"]


def unaligned(t):
    """``t`` one element into a larger buffer: contiguous, not 16-byte aligned."""
    import torch

    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


def emit_buffers(data: bytes, emit: int, batch: int):
    """The encoder's operands for the first ``batch`` chunks of ``emit`` bytes
    of ``data`` (all full, none the last), each with the 32 KiB before it."""
    import numpy as np

    from deflate_rs_tpu_torch.ops.chunk_encode import PAD

    src = np.frombuffer(data, np.uint8)
    bufs = np.zeros((batch, HALO + emit + PAD), np.uint8)
    hist = np.zeros(batch, np.int64)
    for i in range(batch):
        off = i * emit
        h = min(off, HALO)
        bufs[i, HALO - h : HALO + emit] = src[off - h : off + emit]
        hist[i] = h
    return bufs, hist, np.full(batch, emit, np.int64), np.zeros(batch, bool)


def wide_buffers(mix: bytes):
    """The encoder's operands for ``WIDE_BATCH`` chunks of ``WIDE_EMIT`` bytes
    of the mix, each with the 32 KiB before it."""
    return emit_buffers(mix, WIDE_EMIT, WIDE_BATCH)


def stream_through(cls, data: bytes, write_size: int, flush_every: int = 0, **kw) -> bytes:
    """``data`` through a streaming encoder in writes of ``write_size`` bytes,
    with a ``flush()`` after every ``flush_every`` bytes where that is set."""
    import io

    sink = io.BytesIO()
    enc = cls(sink, **kw)
    since = 0
    for off in range(0, len(data), write_size):
        piece = data[off : off + write_size]
        enc.write(piece)
        since += len(piece)
        if flush_every and since >= flush_every:
            enc.flush()
            since = 0
    enc.finish()
    return sink.getvalue()


def spread(values: list) -> str:
    v = sorted(values)
    return (f"median {v[len(v) // 2]:.3f} min {v[0]:.3f} quartiles {v[len(v) // 4]:.3f} / "
            f"{v[3 * len(v) // 4]:.3f} max {v[-1]:.3f}")


TILED = "lr_measure_tiled"  # lr_measure's tiled path: lr_global, and high from 679,680 B chunks


def check_launches(label: str, counts: dict, off_path: tuple = (TILED,)) -> None:
    """Every kernel must have launched on the path, but those ``off_path``,
    which must not have (the presets' long-range windows fit the block path
    below high's chunks of 679,680 bytes, so the tiled one is off every
    knob-free path at 64 KiB)."""
    missing = [k for k, v in counts.items() if v == 0 and k not in off_path]
    stray = [k for k in off_path if counts.get(k)]
    if missing or stray:
        raise SystemExit(f"{label}: kernels not launched on its path: {missing}; launched "
                         f"off it: {stray}")


def timed_run(dt, cuda, data: bytes, opts, label: str, off_path: tuple = (TILED,)) -> dict:
    """Warm run, then ``deflate_bytes_conf`` timed with the launch counters
    set to 0 just before it; zlib and gzip framings after.  All three must
    round-trip, and every kernel but those ``off_path`` must have launched
    (see ``check_launches``).  Returns the launch counts of the timed run."""
    import torch

    dt.deflate_bytes_conf(data, opts, device="cuda")  # warm run
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    out_raw = dt.deflate_bytes_conf(data, opts, device="cuda")
    wall = time.perf_counter() - t0
    launches = {name: k.launches for name, k in cuda.KERNELS.items()}
    t0 = time.perf_counter()
    out_z = dt.deflate_bytes_zlib_conf(data, opts, device="cuda")
    wall_z = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_g = dt.deflate_bytes_gzip_conf(data, dt.GzBuilder(), opts, device="cuda")
    wall_g = time.perf_counter() - t0
    if zlib.decompress(out_raw, -15) != data:
        raise SystemExit(f"{label}: raw deflate stream does not round-trip")
    if zlib.decompress(out_z) != data:
        raise SystemExit(f"{label}: zlib stream does not round-trip")
    if gzip.decompress(out_g) != data:
        raise SystemExit(f"{label}: gzip stream does not round-trip")
    mb = len(data) / 1e6
    print(f"{label}: 16 MiB mix round-trips in raw/zlib/gzip; ratio "
          f"{len(out_raw) / len(data):.4f}; deflate {wall:.3f} s = {mb / wall:.2f} MB/s, "
          f"zlib {mb / wall_z:.2f} MB/s, gzip {mb / wall_g:.2f} MB/s (warm; above four "
          f"chunks through the corpus engine at its default batch)")
    print(f"{label}: launches during the timed deflate run: {launches}")
    check_launches(label, launches, off_path)
    return launches


def wall_of(fn):
    """(``fn()``, host seconds from a sync of every card to the next)."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def _cap(n: int) -> int:
    return max(4096, (n + 4095) & ~4095)


def top_level_ops(fn) -> tuple:
    """(host operations ``fn`` issues at the top level, kernels the card ran
    for it; None where the profiler traced no device activity) under
    ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    # Top-level CPU events, less the runtime's own calls (the synchronize).
    ops = sum(1 for e in events if e.device_type == DeviceType.CPU and e.cpu_parent is None
              and not e.name.startswith("cuda"))
    kernels = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    return ops, kernels or None


def decode_phase(dt, cuda, pg11: bytes, head: bytes, presets: dict) -> dict:
    """The device inflate validator on the card, and the host decoders, on the
    port's CUDA streams; MB/s, ms per block and the operations of one block.
    Returns the kernels' launches during the decodes (none is on this path)."""
    import statistics

    import torch

    from deflate_rs_tpu_torch.ops import inflate_device as idev

    # Every stream is encoded first: the launch counters then see the decodes alone.
    streams = {}
    for name, o in {"Default": dt.CompressionOptions.default(), **presets}.items():
        streams[name] = (dt.deflate_bytes_conf(pg11, o, device="cuda"),
                         dt.deflate_bytes_zlib_conf(pg11, o, device="cuda"),
                         dt.deflate_bytes_gzip_conf(pg11, dt.GzBuilder(), o, device="cuda"))
    mix_raw = dt.deflate_bytes(head, device="cuda")
    bad = {"all ones": b"\xff" * 64, "truncated": streams["Default"][0][:-40]}
    after = dt.deflate_bytes(b"after the malformed streams", device="cuda")
    window = 9 * 65536 + 4096  # covers one chunk's block: at most 64 KiB of output
    cases = {f"pg11 at {name}": (raw, pg11, 0) for name, (raw, _, _) in streams.items()}
    cases["mix[:1 MiB] at Default"] = (mix_raw, head, window)

    def walls():
        """Every case decoded as a user calls it, timed by the host clock."""
        out = {}
        for label, (raw, want, w) in cases.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = idev.inflate_device(raw, _cap(len(want)), block_window=w, device="cuda")
            out[label] = time.perf_counter() - t0
            if got != want:
                raise SystemExit(f"decode: inflate_device does not give the input back ({label})")
        return out

    torch.cuda.synchronize()
    cuda.reset_launches()
    walls()  # warm
    wall = walls()
    for name, (raw, z, g) in streams.items():
        if not dt.inflate(raw) == dt.inflate_zlib(z) == dt.inflate_gzip(g) == pg11:
            raise SystemExit(f"decode: the host inflate does not give pg11 back ({name})")
    if dt.inflate(mix_raw) != head:
        raise SystemExit("decode: the host inflate does not give mix[:1 MiB] back")

    # Per block: CUDA events around each block's launches and each dynamic
    # header's, read once the stream is decoded, so the timing adds no wait.
    # A block's time runs from its first operation to its last on the card,
    # gaps while the host launches included.
    blocks, headers = [], []  # (btype, start, end) per block; (start, end) per header
    decode, parse = idev.BlockDecoder.decode, idev._parse_dynamic_header

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def timed_decode(self, bitpos, *a):
        t0 = event()
        res = decode(self, bitpos, *a)
        blocks.append((int(self.host_bits[bitpos + 1]) | int(self.host_bits[bitpos + 2]) << 1,
                       t0, event()))
        return res

    def timed_parse(*a):
        t0 = event()
        res = parse(*a)
        headers.append((t0, event()))
        return res

    per_block = {}
    idev.BlockDecoder.decode, idev._parse_dynamic_header = timed_decode, timed_parse
    try:
        for label, (raw, want, w) in cases.items():
            blocks.clear()
            headers.clear()
            idev.inflate_device(raw, _cap(len(want)), block_window=w, device="cuda")
            torch.cuda.synchronize()
            per_block[label] = ([(bt, t0.elapsed_time(t1)) for bt, t0, t1 in blocks],
                                [t0.elapsed_time(t1) for t0, t1 in headers])
    finally:
        idev.BlockDecoder.decode, idev._parse_dynamic_header = decode, parse
    for label, (raw, want, w) in cases.items():
        ms, hdr = per_block[label]
        by_type = {}
        for bt, m in ms:
            by_type.setdefault(bt, []).append(m)
        print(f"decode: {label}: {len(raw)} B, {len(ms)} blocks, window "
              f"{w or 'the default'} bits: {wall[label] * 1e3:.1f} ms = "
              f"{len(want) / 1e6 / wall[label]:.3f} MB/s of output (host clock, no "
              f"instrumentation); ms per block (CUDA events) " + "; ".join(
                  f"btype {bt}: {len(v)} blocks, {spread(v)}" for bt, v in sorted(by_type.items()))
              + (f"; dynamic header parse, ms: {spread(hdr)}" if hdr else ""))

    # The operations of one dynamic block, and of its header alone.
    raw = streams["Default"][0]
    dec = idev.BlockDecoder(raw, _cap(len(pg11)), window, device="cuda")
    state = (torch.zeros(dec.OUT, dtype=torch.int64, device=dec.device),
             torch.arange(dec.OUT, device=dec.device),
             torch.zeros(dec.OUT, dtype=torch.bool, device=dec.device))
    meta = dec.decode(0, 0, *state)[3].tolist()  # warm
    if meta[4] != 2 or not meta[3]:
        raise SystemExit(f"decode: the first block of pg11 at Default is not a good dynamic "
                         f"block: {meta}")
    block_ops, block_kernels = top_level_ops(lambda: dec.decode(0, 0, *state))
    header_ops, header_kernels = top_level_ops(lambda: idev._parse_dynamic_header(dec.bits, 3))
    ms = statistics.median(m for _, m in per_block["mix[:1 MiB] at Default"][0])
    print(f"decode: one dynamic block of pg11 at Default (window {dec.W} bits), under "
          f"torch.profiler on the card: {block_ops} top-level operations, {block_kernels} "
          f"kernels (None: no device trace); its header parse {header_ops} operations, "
          f"{header_kernels} kernels; the mix's median dynamic block "
          f"{ms:.3f} ms = {1e3 * ms / block_ops:.2f} us per operation")

    # Malformed streams raise ValueError, with no device-side assert.
    for name, stream in bad.items():
        try:
            idev.inflate_device(stream, _cap(len(pg11)), device="cuda")
        except ValueError as e:
            print(f"decode: malformed stream ({name}) raises ValueError: {e}")
        else:
            raise SystemExit(f"decode: malformed stream ({name}) did not raise")
    torch.cuda.synchronize()  # a device-side assert would surface here
    if idev.inflate_device(after, 4096, device="cuda") != b"after the malformed streams":
        raise SystemExit("decode: the context did not survive the malformed streams")
    counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    if any(counts.values()):
        raise SystemExit(f"decode: a kernel was launched while decoding: {counts}")
    print(f"decode: launches of the five kernels while decoding: {counts} (none on this path)")
    return counts


def overhead_phase(mix: bytes, smi: str) -> None:
    """``tools/sharded_overhead.py`` in the sharded phase's process group (NCCL,
    world size 1): ms per chunk of a trivial op, the plain encoder without and
    with checksums and the sharded step, in turns, at 16 and 64 chunks; the
    step's words must equal the plain encoder's."""
    from deflate_rs_tpu_torch.tools.sharded_overhead import overhead

    for batch in (16, 64):
        r = overhead(batch, 65536, iters=8, data=mix, card=smi)
        ms = r["ms_per_chunk"]
        print(f"overhead: B={batch}: ms per chunk (median of {r['iters']} rounds in turns): floor "
              f"{ms['floor']:.4f}, plain {ms['plain']:.4f}, plain with checksums "
              f"{ms['plain_checksums']:.4f}, sharded step {ms['sharded']:.4f}; overhead "
              f"{r['overhead_ms_per_chunk']:.4f} ms per chunk = {100 * r['overhead']:.1f} % of "
              f"the floor-corrected plain time; words == plain encoder's")
        print("OVERHEAD_ROW " + json.dumps(r))


def sharded_phase(dt, cuda, mix: bytes, one_shot: bytes, aligned_one_shot: bytes,
                  wall_of, smi: str) -> tuple:
    """The sharded encoder over NCCL at world size 1 (in this process, so the
    launch counters see it) on the mix, the dry run over every card, then
    the mesh of every card in this process (``mesh_run``) and, with two cards
    or more, the multi-card rows (``multi_card_rows``).  Returns the kernels'
    launches during one timed run of the world-size-1 step and of the mesh."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from deflate_rs_tpu_torch.ops import checksum
    from deflate_rs_tpu_torch.parallel import corpus
    from deflate_rs_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from deflate_rs_tpu_torch.parallel.sharded import (assemble_host, assemble_local,
                                                       make_sharded_encoder)
    from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch, dryrun_multichip

    emit = 65536
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on loopback
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    init_distributed(f"file://{tmp}/rendezvous", 1, 0, device="cuda")
    try:
        mesh = make_mesh(device="cuda")
        step = make_sharded_encoder(mesh, dt.CompressionOptions.default(), emit)
        bufs, hist, ns, lasts = build_batch(mix, emit)
        payloads = [mix[i * emit : i * emit + int(ns[i])] for i in range(len(ns))]

        def run():
            shard = step(bufs, hist, ns, lasts)
            return shard, assemble_host(shard, packed=True, payloads=payloads, is_lasts=lasts)

        shard, packed = run()  # warm
        aligned = assemble_host(shard, payloads=payloads, is_lasts=lasts)
        local, offset = assemble_local(shard, payloads=payloads, is_lasts=lasts, mesh=mesh)
        if packed != one_shot:
            raise SystemExit("sharded: packed bytes differ from the one-shot bytes on the mix")
        if aligned != aligned_one_shot or (local, offset) != (aligned, 0):
            raise SystemExit(f"sharded: byte-aligned bytes ({len(aligned)} B; assemble_local "
                             f"{len(local)} B at {offset}) differ from the one-shot "
                             f"compress_stream(packed=False) bytes ({len(aligned_one_shot)} B)")
        state, raw = checksum.ADLER_INIT, 0
        for i in range(len(ns)):
            state = checksum.adler32_combine(state, int(shard["s1"][i]), int(shard["s2"][i]),
                                             int(ns[i]))
            raw = checksum.crc32_combine_raw(raw, int(shard["crc_raw"][i]), int(ns[i]))
        if (checksum.adler32_value(state), checksum.crc32_from_raw(raw, len(mix))) != (
                zlib.adler32(mix), zlib.crc32(mix)):
            raise SystemExit("sharded: checksum partials do not combine to zlib's")
        mb = len(mix) / 1e6
        rates, counts = [], None
        for _ in range(3):
            cuda.reset_launches()
            (_, out), wall = wall_of(run)
            counts = counts or {n_: k.launches for n_, k in cuda.KERNELS.items()}
            if out != one_shot:
                raise SystemExit("sharded: bytes changed between runs")
            rates.append(mb / wall)
        corpus_rates = [mb / wall_of(lambda: corpus.compress_corpus(mix, device="cuda"))[1]
                        for _ in range(3)]
        check_launches("sharded", counts)
        fetched = shard["cw"].nbytes + 6 * 8 * len(ns)
        print(f"sharded: world size {mesh.size} over {dist.get_backend()}, {len(ns)} chunks of {emit} B on "
              f"{mesh.device}: packed == one-shot bytes, byte-aligned (assemble_host and "
              f"assemble_local) == compress_stream(packed=False) bytes, checksum partials == "
              f"zlib's; step + packed splice {[round(r, 2) for r in rates]} MB/s (warm); corpus "
              f"engine in this process {[round(r, 2) for r in corpus_rates]} MB/s; fetched "
              f"{fetched} B ({int(np.sum(shard['btype'] == 0))} stored chunks fetch no words); "
              f"launches of one run {counts}")
        overhead_phase(mix, smi)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    n = torch.cuda.device_count()
    forms = [(f"{n} ranks of one card", {})]
    if n > 1:
        forms.append(("one process", {"single_process": True}))
    if n >= 4 and n % 2 == 0:
        forms.append((f"{n // 2} ranks of two cards", {"local_devices": 2}))
    for form, kw in forms:
        t0 = time.perf_counter()
        s = dryrun_multichip(n, emit=emit, device="cuda", **kw)
        print(f"sharded: dryrun_multichip({n}), {form}, in {time.perf_counter() - t0:.1f} s: "
              f"{s['chunks']} chunks, {s['input_bytes']} -> {s['aligned_bytes']} B (packed "
              f"{s['packed_bytes']}), block types {s['block_types']}; the file the processes "
              "wrote round-trips and equals the one-shot bytes")
    mesh_counts = mesh_run(dt, cuda, mix, one_shot, aligned_one_shot, shard, counts, wall_of)
    if n == 1:
        print("sharded: one card: the multi-card rows (a mesh of several cards in one process, "
              "several NCCL ranks, ranks of two cards, the kernels on every card, the scaling "
              "rows) were not run")
    else:
        multi_card_rows(dt, cuda, mix, smi)
    return counts, mesh_counts


def mesh_run(dt, cuda, mix: bytes, one_shot: bytes, aligned_one_shot: bytes, w1_shard: dict,
             w1_counts: dict, wall_of) -> dict:
    """The sharded step on the mesh of every card this process sees, with no
    process group (the JAX package's own mode): packed and byte-aligned bytes
    equal the one-shot bytes, and on one card its shard equals the
    world-size-1 step's array for array; each card launches the world-size-1
    step's kernels once a step.  Returns the launches of one timed run."""
    import numpy as np
    import torch

    from deflate_rs_tpu_torch.parallel.mesh import make_mesh
    from deflate_rs_tpu_torch.parallel.sharded import assemble_host, make_sharded_encoder
    from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch

    emit = 65536
    mesh = make_mesh(device="cuda")
    step = make_sharded_encoder(mesh, dt.CompressionOptions.default(), emit)
    bufs, hist, ns, lasts = build_batch(mix, emit)
    payloads = [mix[i * emit : i * emit + int(ns[i])] for i in range(len(ns))]

    def run():
        shard = step(bufs, hist, ns, lasts)
        return shard, assemble_host(shard, packed=True, payloads=payloads, is_lasts=lasts)

    shard, packed = run()  # warm
    aligned = assemble_host(shard, payloads=payloads, is_lasts=lasts)
    if packed != one_shot or aligned != aligned_one_shot:
        raise SystemExit(f"sharded mesh: {mesh.size} cards in one process: the packed "
                         f"({packed == one_shot}) or byte-aligned ({aligned == aligned_one_shot}) "
                         "bytes differ from the one-shot bytes")
    if mesh.size == 1:
        differ = [k for k in w1_shard if not np.array_equal(np.asarray(w1_shard[k]),
                                                             np.asarray(shard[k]))]
        if differ or set(shard) != set(w1_shard):
            raise SystemExit(f"sharded mesh: the one-card mesh's shard differs from the "
                             f"world-size-1 step's in {differ or set(shard) ^ set(w1_shard)}")
    mb = len(mix) / 1e6
    rates, counts = [], None
    for _ in range(3):
        cuda.reset_launches()
        (_, out), wall = wall_of(run)
        counts = counts or {n_: k.launches for n_, k in cuda.KERNELS.items()}
        if out != one_shot:
            raise SystemExit("sharded mesh: bytes changed between runs")
        rates.append(mb / wall)
    check_launches("sharded mesh", counts)
    want = {k: v * mesh.size for k, v in w1_counts.items()}
    if counts != want:
        raise SystemExit(f"sharded mesh: launches {counts}, not once a card a step ({want})")
    same = " and its shard == the world-size-1 step's array for array" if mesh.size == 1 else ""
    print(f"sharded mesh: {mesh.size} card{'s' * (mesh.size > 1)} in one process "
          f"({', '.join(map(str, mesh.devices))}), no process group, {len(ns)} chunks of {emit} "
          f"B: packed == one-shot, byte-aligned == compress_stream(packed=False){same}; step + "
          f"packed splice {[round(r, 2) for r in rates]} MB/s (warm); launches of one run "
          f"{counts}")
    del step
    torch.cuda.empty_cache()
    return counts


def multi_card_rows(dt, cuda, mix: bytes, smi: str) -> None:
    """With two cards or more: each kernel on every card, called from a
    process whose current device is ``cuda:0``, against its plain version on
    the operands of that card's block of the mesh; then the scaling rows of
    ``tools/scaling_curve.py`` on the 64 MiB mix at 64 KiB chunks (steps of
    256 chunks) at 1, 2, 4 ... cards in the process and ranks forms,
    and, over every card, the same and 512 MiB of the mix at 32 MiB chunks
    (fast, and Default at 1,024 segments; one chunk a card a step; one warm
    run timed after one) in every form and as ranks of two cards: every
    packed stream equals the one-shot ``compress_corpus`` bytes on one
    card."""
    import torch

    from deflate_rs_tpu_torch.ops import field_kernel, hist_kernel, lr_kernel, parse_scan, pm_kernel
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.tools import scaling_curve as sc
    from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch

    n = torch.cuda.device_count()
    emit = 65536
    pairs = {
        "lr_measure": (lr_kernel.lr_measure, lr_kernel.lr_measure_plain),
        "parse_scan": (parse_scan.parse_scan, parse_scan.parse_scan_plain),
        "token_fields": (field_kernel.token_fields, field_kernel.token_fields_plain),
        "lengths_by_rank_15": (pm_kernel.lengths_by_rank, pm_kernel.lengths_by_rank_plain),
        "lengths_by_rank_7": (pm_kernel.lengths_by_rank, pm_kernel.lengths_by_rank_plain),
        "quarter_histograms": (hist_kernel.quarter_histograms,
                               hist_kernel.quarter_histograms_plain),
    }
    operands = build_batch(mix, emit)
    per = len(operands[2]) // n
    torch.cuda.set_device(0)
    for k in range(n):
        card = torch.device("cuda", k)
        enc = ChunkEncoder(dt.CompressionOptions.default(), emit, with_checksums=True,
                           stored_payload_fields=False).to(card)
        bufs, hist, ns, last = (torch.from_numpy(a[k * per : (k + 1) * per]) for a in operands)
        with torch.no_grad():
            seen = harvest(enc, bufs.to(card), hist, ns, last)
        errs = {}
        for key, (kern, plain) in pairs.items():
            args = seen[key]
            got, want = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize(card)
            if any(g.device != card for g in got) or torch.cuda.current_device() != 0:
                raise SystemExit(f"kernels on {card}: {key} ran off its card or moved the "
                                 "current device")
            errs[key] = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                            for g, w in zip(got, want))
        if any(errs.values()):
            raise SystemExit(f"kernels on {card}: disagree with their plain versions: {errs}")
        print(f"kernels on {card} (current device cuda:0), its block of {per} chunks of the mix: "
              f"every kernel == its plain version, max_abs_err {errs}")
        del enc, seen
    torch.cuda.empty_cache()

    curve = sc.Spec(64 << 20)
    big = [sc.Spec(512 << 20, 32 << 20, n, "fast", runs=1, profile=False),
           sc.Spec(512 << 20, 32 << 20, n, "default", 1024, runs=1, profile=False)]
    t0 = time.perf_counter()
    wants = {spec: sc.one_shot(spec) for spec in [curve, *big]}
    torch.cuda.empty_cache()
    print(f"scaling: one-shot references on cuda:0 in {time.perf_counter() - t0:.1f} s")
    counts = [m for m in (1, 2, 4, 8, 16) if m <= n]
    runs = [(form, m, {}) for m in counts for form in sc.FORMS]
    if n >= 4 and n % 2 == 0:
        runs.append(("ranks", n, {"local_devices": 2}))
    summary = {}
    for form, m, kw in runs:
        specs = [curve] + (big if m == n else [])
        label = form if not kw else f"ranks of {kw['local_devices']} cards"
        t0 = time.perf_counter()
        results = sc.run_form(form, m, specs, **kw)
        for spec, res in zip(specs, results):
            r = sc.row(label, m, spec, res, wants[spec], smi)
            print(("SCALING_ROW " if spec is curve else "BYTES_ROW ") + json.dumps(r))
            summary[label, m, spec.emit >> 10, spec.preset] = r["mb_per_s_median"]
        print(f"scaling: {label}, {m} card{'s' * (m > 1)}: {len(specs)} inputs, packed == "
              f"one-shot bytes, {time.perf_counter() - t0:.1f} s")
    print("scaling: MB/s, step + packed splice, median of 5 warm runs on 64 MiB of the mix at "
          "64 KiB chunks (steps of 256 chunks), one warm run on 512 MiB at 32 MiB chunks (one "
          "a card a step): " + "; ".join(f"{label} x{m} {kib} KiB {preset} {v:.2f}"
                                       for (label, m, kib, preset), v in summary.items()))


def lr_plain_rows(args, step: int = 16):
    """``lr_measure``'s plain version a few rows at a time (its [B, S, M, LW]
    temporaries are large); rows are independent."""
    import torch

    from deflate_rs_tpu_torch.ops import lr_kernel

    buf, doms, N = args
    parts = [lr_kernel.lr_measure_plain(buf[i : i + step], doms[i : i + step], N)
             for i in range(0, buf.shape[0], step)]
    return tuple(torch.cat(p) for p in zip(*parts))


def knobs_phase(dt, cuda, pg11: bytes, mix: bytes, wall_of) -> dict:
    """The long-range knobs ``lr_global`` and ``lr_stride``: CUDA bytes equal
    the CPU port's; ``lr_measure`` at the whole-chunk window (its tiled path)
    against its plain version on the operands the global pass hands it, and
    on the adversarial ones, timed; MB/s of Default with ``lr_global=64``.
    Returns the ``lr_measure_global`` row of the kernels line."""
    import dataclasses

    import torch

    from deflate_rs_tpu_torch.ops import lr_kernel
    from deflate_rs_tpu_torch.parallel import corpus
    from deflate_rs_tpu_torch.utils import kernel_cases

    dev = torch.device("cuda", 0)
    O = dt.CompressionOptions
    head = mix[: 1 << 20]
    knobs = ({"lr_global": 64}, {"lr_global": 256}, {"lr_stride": 2})
    for preset in ("default", "high"):
        for knob in knobs:
            o = dataclasses.replace(getattr(O, preset)(), **knob)
            sizes = []
            for name, data in (("pg11", pg11), ("mix[:1 MiB]", head)):
                got = dt.deflate_bytes_conf(data, o, device="cuda")
                if got != dt.deflate_bytes_conf(data, o, device="cpu"):
                    raise SystemExit(f"knobs: {preset} {knob}: CUDA bytes differ from the CPU "
                                     f"port's on {name}")
                if zlib.decompress(got, -15) != data:
                    raise SystemExit(f"knobs: {preset} {knob}: {name} does not round-trip")
                sizes.append(len(got))
            print(f"knobs: {preset} {knob}: pg11 -> {sizes[0]} B, mix[:1 MiB] -> {sizes[1]} B; "
                  "CUDA bytes == CPU port bytes, round-trip")

    # lr_measure at the global pass's operands: S = 1, M = D.
    kb = corpus.BATCH_SIZE
    t64 = tier_buffers(mix, 65536, kb)
    sets = {
        "default_d64": ("default", 64, t64, 65536, 0, kb, True),
        "default_d64_b1": ("default", 64, t64, 65536, 1, 2, True),
        "default_d256": ("default", 256, t64, 65536, 0, kb, True),
        "high_d64": ("high", 64, t64, 65536, 0, kb, True),
        "default_d64_4k": ("default", 64, tier_buffers(mix, 4096, BATCH), 4096, 0, BATCH, False),
        "default_d64_wide": ("default", 64, wide_buffers(mix), WIDE_EMIT, 0, WIDE_BATCH, True),
    }
    res = {"max_abs_err": 0}
    for key, (preset, D, operands, emit, lo, hi, timed) in sets.items():
        args = global_operands(preset, D, operands, emit, lo, hi)
        buf, doms, N = args
        if tuple(doms.shape[1:]) != (1, D):
            raise SystemExit(f"knobs: the global pass handed lr_measure {tuple(doms.shape)}")
        got = lr_kernel.lr_measure(*args)
        want = lr_plain_rows(args)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        res["max_abs_err"] = max(res["max_abs_err"], err)
        live = int((doms > 0).sum())
        if err != 0:
            raise SystemExit(f"kernel lr_measure_global disagrees with its plain version on "
                             f"{key}: max_abs_err={err}")
        if not timed:
            print(f"kernel lr_measure_global ({key}) shapes={tuple(buf.shape)}, "
                  f"{tuple(doms.shape)}: max_abs_err=0, {live} live slots")
            continue
        k_ms = kernel_ms(lambda: lr_kernel.lr_measure(*args))
        e_ms = cuda_ms(lambda: lr_kernel.lr_measure(*args), 20)
        p_ms = cuda_ms(lambda: lr_plain_rows(args), 2)
        bytes_ms, ops_ms = bound_of("lr_measure", args, got)
        bound = max(bytes_ms, ops_ms)
        res[key] = {"ms": k_ms, "eager_ms": e_ms, "plain_ms": p_ms, "bytes_ms": bytes_ms,
                    "ops_ms": ops_ms, "bound_ms": bound, "live": live}
        print(f"kernel lr_measure_global ({key}) shapes={tuple(buf.shape)}, {tuple(doms.shape)}, "
              f"{live} live slots: max_abs_err=0 kernel {k_ms:.4f} ms (eager loop {e_ms:.4f}) "
              f"plain {p_ms:.4f} ms bound {bound:.5f} ms (bytes {bytes_ms:.5f}, operations "
              f"{ops_ms:.5f}) share {100 * bound / k_ms:.1f} %")
    torch.cuda.empty_cache()
    for B, N, D, seed in kernel_cases.LR_GLOBAL_CASES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_global_batch(B, N, D, seed))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the whole-window case B={B} N={N} D={D} "
                             f"seed={seed}")
    for N, S, M in kernel_cases.LR_TILED_GEOMETRIES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_tiled_batch(N, S, M))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the tiled geometry N={N} S={S} M={M}")
    N, S, M = kernel_cases.LR_WIDE_KEY_GEOMETRY
    a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_tiled_batch(N, S, M, rows=2))
    if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                 lr_kernel.lr_measure_plain_sliced(*a, N, 512))):
        raise SystemExit(f"lr_measure disagrees with 64-bit keys at N={N} S={S} M={M}")
    del a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"kernels: whole-window adversarial cases equal the plain version exactly: "
          f"{len(kernel_cases.LR_GLOBAL_CASES)}; other tiled geometries "
          f"{kernel_cases.LR_TILED_GEOMETRIES} and the 64-bit keys at {(N, S, M)} too")

    # MB/s of the one-shot with lr_global=64 beside the knob-free Default, in turns.
    o64, o0 = dataclasses.replace(O.default(), lr_global=64), O.default()
    mb = len(mix) / 1e6
    dt.deflate_bytes_conf(mix, o64, device="cuda")  # warm
    rates = {"lr_global=64": [], "no knob": []}
    counts = None
    for _ in range(3):
        for name, o in (("lr_global=64", o64), ("no knob", o0)):
            cuda.reset_launches()
            out, wall = wall_of(lambda: dt.deflate_bytes_conf(mix, o, device="cuda"))
            rates[name].append(mb / wall)
            if name == "lr_global=64":
                counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
                if zlib.decompress(out, -15) != mix:
                    raise SystemExit("knobs: Default lr_global=64 on the mix does not round-trip")
                ratio = len(out) / len(mix)
    check_launches("knobs: Default lr_global=64", counts, off_path=("lr_measure",))
    cuda.reset_launches()
    hi, wall_hi = wall_of(lambda: dt.deflate_bytes_conf(
        mix, dataclasses.replace(O.high(), lr_global=64), device="cuda"))
    counts_high = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    check_launches("knobs: high lr_global=64", counts_high, off_path=("lr_measure",))
    print(f"knobs: one-shot on the 16 MiB mix, Default lr_global=64 "
          f"{[round(r, 2) for r in rates['lr_global=64']]} MB/s (ratio {ratio:.4f}), knob-free "
          f"Default {[round(r, 2) for r in rates['no knob']]} MB/s, in turns; launches of a "
          f"lr_global=64 run {counts}; high lr_global=64 {mb / wall_hi:.2f} MB/s (one run, "
          f"ratio {len(hi) / len(mix):.4f}), launches {counts_high}")
    d64 = res["default_d64"]
    return {
        "name": "lr_measure_global", "route": "cuda",
        "source": "deflate_rs_tpu_torch/csrc/lr_measure.cu",
        "replaces": "deflate_rs_tpu/ops/lr_kernel.py:84",
        "launches": counts[TILED], "launches_high": counts_high[TILED],
        "batch": kb, "live": d64["live"],
        "b1_ms": res["default_d64_b1"]["ms"], "b1_plain_ms": res["default_d64_b1"]["plain_ms"],
        "b1_bound_ms": res["default_d64_b1"]["bound_ms"],
        "d256_ms": res["default_d256"]["ms"], "d256_bound_ms": res["default_d256"]["bound_ms"],
        "d256_plain_ms": res["default_d256"]["plain_ms"],
        "high_ms": res["high_d64"]["ms"], "high_bound_ms": res["high_d64"]["bound_ms"],
        "high_plain_ms": res["high_d64"]["plain_ms"],
        "wide_batch": WIDE_BATCH, "wide_ms": res["default_d64_wide"]["ms"],
        "wide_bound_ms": res["default_d64_wide"]["bound_ms"],
        "wide_plain_ms": res["default_d64_wide"]["plain_ms"],
        "max_abs_err": res["max_abs_err"],
        "ms": d64["ms"], "eager_ms": d64["eager_ms"], "plain_ms": d64["plain_ms"],
        "bound_ms": d64["bound_ms"],
        "bound_by": "bytes" if d64["bytes_ms"] >= d64["ops_ms"] else "operations",
        "library_ms": None,
        "mb_per_s": rates["lr_global=64"], "mb_per_s_no_knob": rates["no knob"],
    }


SOAK_MIB = 128  # the tool's default is 512 MiB: cut to keep this script short
SOAK_CARDS_MIB = 1024  # over several cards, in both forms
SOAK_CARD_STEP = 32  # chunks a card a step over several cards, as at world size 1


def soak_phase() -> None:
    """The sharded soak at world size 1 over NCCL: steps of 32 chunks over
    ``SOAK_MIB`` MiB, byte-aligned stream through zlib, combined checksums,
    packed splice == the one-shot bytes.  With two cards or more, the same
    over ``SOAK_CARDS_MIB`` MiB on every card, in one process and as one
    rank a card, ``SOAK_CARD_STEP`` chunks a card a step."""
    import torch

    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.tools.sharded_soak import build_corpus, soak

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    s = soak(SOAK_MIB << 20, world=1, device="cuda")
    print(f"soak: world size 1 over NCCL, {SOAK_MIB} MiB (the tool's default 512 MiB cut to "
          f"a quarter), {s['steps']} steps of 32 chunks: {s['input_bytes']} -> {s['stream_bytes']} B "
          f"byte-aligned ({s['packed_bytes']} B packed), round-trips through zlib, checksums "
          f"== zlib's, packed == one-shot bytes; {s['mb_per_s']:.2f} MB/s ({s['seconds']:.2f} s "
          f"of steps and splices); fetched {s['fetched_bytes']} B; block types "
          f"{s['block_types']}; {time.perf_counter() - t0:.1f} s with the spawn and the checks")
    n = torch.cuda.device_count()
    if n == 1:
        print(f"soak: one card: the {SOAK_CARDS_MIB} MiB soak over several cards was not run")
        return
    t0 = time.perf_counter()
    total = SOAK_CARDS_MIB << 20
    one_shot = dt.deflate_bytes_conf(build_corpus(total), dt.CompressionOptions.default(),
                                     device="cuda")
    print(f"soak: one-shot bytes of {SOAK_CARDS_MIB} MiB on cuda:0, {len(one_shot)} B, in "
          f"{time.perf_counter() - t0:.1f} s")
    for single in (True, False):
        t0 = time.perf_counter()
        s = soak(total, world=n, device="cuda", step_chunks=SOAK_CARD_STEP * n,
                 single_process=single, one_shot=one_shot)
        form = "one process" if single else f"{n} ranks over NCCL"
        print(f"soak: {n} cards, {form}, {SOAK_CARDS_MIB} MiB, {s['steps']} steps of "
              f"{SOAK_CARD_STEP * n} chunks: {s['input_bytes']} -> {s['stream_bytes']} B "
              f"byte-aligned ({s['packed_bytes']} B packed), round-trips through zlib, "
              f"checksums == zlib's, packed == one-shot bytes; {s['mb_per_s']:.2f} MB/s "
              f"({s['seconds']:.2f} s of steps and splices); fetched {s['fetched_bytes']} B; "
              f"{time.perf_counter() - t0:.1f} s with the checks")


STAGE_RUNS = (("default", 64), ("fast", 64), ("high", 64), ("default", 1))


def stages_phase(cuda, mix: bytes, smi: str) -> dict:
    """``tools/stage_timing.py`` on the card: the stages of
    ``ChunkEncoder.forward`` one by one on the mix's first chunks, at the
    presets and batches of ``STAGE_RUNS``.  The stages' kernels must sum to
    the whole ``forward``'s within 1 %, and their busy time to its own within
    10 %.  Returns the launches of the phase (every kernel must move)."""
    from deflate_rs_tpu_torch.tools.stage_timing import stage_rows

    cuda.reset_launches()
    for preset, batch in STAGE_RUNS:
        rows = stage_rows(preset, batch, 65536, device="cuda", reps=3, data=mix, card=smi)
        whole = rows[-1]
        summed = whole["sum_of_stages"]
        for r in rows[:-1]:
            if not r["runs"]:
                print(f"stages: {preset} B={batch} {r['stage']}: does not run at this preset")
                continue
            print(f"stages: {preset} B={batch} {r['stage']}: wall {r['wall_ms']:.3f} ms, busy "
                  f"{r['busy_ms']:.3f} ms, {r['kernels']} kernels, {r['copies']} copies; top "
                  f"{r['top']}")
        print(f"stages: {preset} B={batch} forward: wall {whole['wall_ms']:.3f} ms, busy "
              f"{whole['busy_ms']:.3f} ms, {whole['kernels']} kernels, {whole['copies']} copies; "
              f"the stages sum to wall {summed['wall_ms']:.3f} ms, busy {summed['busy_ms']:.3f} "
              f"ms, {summed['kernels']} kernels; host {whole['host_ms']:.3f} ms, idle gaps "
              f"{whole['gap_ms']:.3f} ms")
        if abs(summed["kernels"] - whole["kernels"]) > 0.01 * whole["kernels"]:
            raise SystemExit(f"stages: {preset} B={batch}: the stages launch {summed['kernels']} "
                             f"kernels, forward {whole['kernels']}: more than 1 % apart")
        if abs(summed["busy_ms"] - whole["busy_ms"]) > 0.1 * whole["busy_ms"]:
            raise SystemExit(f"stages: {preset} B={batch}: the stages' busy time "
                             f"{summed['busy_ms']:.3f} ms is more than 10 % from forward's "
                             f"{whole['busy_ms']:.3f} ms")
        print("STAGE_ROWS " + json.dumps(rows))
    counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    check_launches("stages", counts)
    print(f"stages: launches of the phase {counts}")
    return counts


FUZZ_RUNS = (("default,fast", 100, 10), ("high,rle,huffman_only", 25, 5))


def fuzz_phase(cuda) -> dict:
    """``tools/fuzz.py`` on the card at seed 0: ``FUZZ_RUNS`` gives the
    presets, the iterations and the inputs held to the CPU port's bytes.
    Any failure fails the phase.  Returns the launches of the phase."""
    from deflate_rs_tpu_torch.tools.fuzz import OUT, fuzz

    cuda.reset_launches()
    for presets, iters, compare in FUZZ_RUNS:
        s = fuzz(iters, seed=0, presets=presets, device="cuda", compare_cpu=compare,
                 log=lambda m, p=presets: print(f"fuzz: {p}: {m}", flush=True))
        print(f"fuzz: {presets}: {s['seeds']} seeds + {s['iters']} mutants, corpus grew to "
              f"{s['corpus']}, structures {s['structures_seeded']} -> {s['structures']}, "
              f"{s['compared_with_cpu']} inputs == CPU port bytes, {s['corpus_checks']} "
              f"compress_corpus round trips, failures {len(s['failures'])}, {s['seconds']:.1f} s")
        if s["failures"] or s["compared_with_cpu"] < compare:
            raise SystemExit(f"fuzz: {presets}: failures {s['failures']} (inputs in {OUT}); "
                             f"compared with the CPU port {s['compared_with_cpu']} of {compare}")
    counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    check_launches("fuzz", counts)
    print(f"fuzz: launches of the phase {counts}")
    return counts


def margins_phase() -> None:
    """``tools/contract_margins.py`` on the card: at 128 KiB, Default and
    high, the bytes equal the CPU port's and round-trip; at 512 and 1,024 KiB
    they round-trip.  Prints every margin."""
    from deflate_rs_tpu_torch.tools.contract_margins import margin_rows

    t0 = time.perf_counter()
    for sizes, compare in (([128], [128]), ([512, 1024], [])):
        rows, skipped = margin_rows(sizes, device="cuda", compare_cpu=compare,
                                    log=lambda m: print(f"margins: {m}", flush=True))
        if compare and not all(r["equals_cpu"] for r in rows):
            raise SystemExit("margins: a stream was not held to the CPU port's bytes")
        print(f"margins: {sizes} KiB: {len(rows)} streams round-trip"
              + (", CUDA bytes == CPU port bytes" if compare else "")
              + f"; classes skipped (no files on this machine): {skipped or 'none'}")
    print(f"margins: {time.perf_counter() - t0:.1f} s")


CHUNKS_MIX_BYTES = 64 << 20  # a full default batch of 1 MiB chunks
MIB = 1 << 20
# (preset, chunk size): the corpus engine on the 64 MiB mix at its default
# batch (64 chunks up to 1 MiB, 64 MiB of payload above); the 64 KiB runs are
# the baseline of each preset's ratio and MB/s.  Above 1 MiB: Default at
# 2 MiB and at 4,161,280 (the widest its long-range pass takes), high at
# 2,064,128 (its widest), fast and rle at 4 MiB (the cap).
# Above 4 MiB: fast and rle at 8 and 16 MiB, huffman_only and turbo at
# 16 MiB, and Default at 512 segments at 16 MiB (the widest long-range pass
# the JAX package takes there); at the cap, 32 MiB, fast, rle, huffman_only,
# turbo and Default at 1,024 segments (the widest long-range pass the JAX
# package takes there).  Default's long-range pass is on lr_measure's tiled
# path in both.
WIDE_CHUNK_RUNS = (("fast", 8 * MIB), ("rle", 8 * MIB), ("fast", 16 * MIB), ("rle", 16 * MIB),
                   ("huffman_only", 16 * MIB), ("turbo", 16 * MIB),
                   ("default_segs512", 16 * MIB), ("fast", 32 * MIB), ("rle", 32 * MIB),
                   ("huffman_only", 32 * MIB), ("turbo", 32 * MIB),
                   ("default_segs1024", 32 * MIB))
# The 16 MiB run a 32 MiB run's ratio is printed beside, where its preset
# is another one.
RATIO_BASE_16M = {"default_segs1024": "default_segs512"}
# The timed runs' CPU-port witnesses (their first chunk and more) reach this
# chunk size; above it the card's bytes are held to the JAX pins of the
# seeded input (``PINS_PATHS``) and, on text, to the CPU port's.
HEAD_WITNESS_MAX = 8 * MIB
CHUNK_RUNS = (("default", 65536), ("default", 262144), ("default", 524288),
              ("default", 1048576), ("high", 65536), ("high", 1048576),
              ("default", 2 * MIB), ("default", 4_161_280), ("high", 2_064_128),
              ("fast", 4 * MIB), ("rle", 4 * MIB)) + WIDE_CHUNK_RUNS
SMALL_CHUNK_RUNS = ("fast", "rle", "turbo")  # at 4,112 B on the mix's first 4 MiB
SMALL_EMIT = 4112
# One byte value at the presets without a match search, one chunk a stream:
# its block gives one litlen symbol the frequency of the chunk's size,
# package-merge's widest leaf (2**20 to 2**22; on symbol 0, and on 97 above
# unused symbols).
ONE_BYTE_PRESETS = ("huffman_only", "turbo")
ONE_BYTE_SIZES = (MIB, 2 * MIB, 4 * MIB)
ONE_BYTE_VALUES = (("zeros", b"\x00"), ("b'a'", b"a"))
# pg11 repeated to one chunk of 16 or 32 MiB, at presets where one block
# gives litlen symbols 2**20 or more and the JAX package's stream is invalid.
TEXT_RUNS = ((16 * MIB, ("fast", "rle", "huffman_only")), (32 * MIB, ("fast", "huffman_only")))
# One byte value in one 32 MiB chunk at huffman_only: a litlen leaf of 2**25,
# package-merge's widest (held by its round trip; no CPU witness).
ONE_BYTE_32M = ("huffman_only", b"a")
# The JAX package's streams of one chunk of ``utils.mix.spread`` of 16 and
# 32 MiB, by length and sha256 (``tests/test_torch_pins_{16,32}mib.py`` write
# them).
PINS_PATHS = tuple(os.path.join(HERE, "tests", "data", f"torch_pins_{m}mib.json")
                   for m in (16, 32))
# (preset, chunk size) at which the JAX package's compress_corpus fails, and
# the cap (32 MiB + 16 at fast and 64 MiB at huffman_only, which the JAX
# package takes): each must raise ValueError at the entry.
REFUSED = (tuple((p, E) for p in ("default", "high", "ForceFixed", "ForceStored")
                 for E in (4112, 8208))
           + (("default", 4_161_280 + 256), ("default", 4 * MIB), ("high", 2 * MIB),
              ("default", 4 * MIB + 16), ("default", 8 * MIB), ("default_segs256", 16 * MIB),
              ("default_segs512", 32 * MIB), ("fast", 32 * MIB + 16),
              ("huffman_only", 64 * MIB)))
# Rows of a batch above 1 MiB at which lr_measure is held to its plain
# version, which takes seconds a row there.
LR_PLAIN_ROWS = 2
# The chunks phase's CPU-port witnesses run in this many spawned processes
# of WITNESS_THREADS intra-op threads each, while the card runs the phase's
# other checks (after its timed runs), the costliest first: CPU seconds a
# MiB of the CPU port by preset, about (two threads on the H100 machine's
# host: high 28, Default 6-10, fast 3-5, the others under 1).
WITNESS_PROCS = 4
WITNESS_THREADS = 2
WITNESS_COST = {"high": 28.0, "default": 8.0, "fast": 4.6}


def _preset(dt, name: str):
    """A preset by name, a ``SpecialOptions`` member, or ``<preset>_segs<S>``:
    the preset with ``dom_segs=S``."""
    import dataclasses

    O = dt.CompressionOptions
    if name.startswith("Force"):
        return O(special=getattr(dt.SpecialOptions, name))
    preset, _, segs = name.partition("_segs")
    o = getattr(O, preset)()
    return dataclasses.replace(o, dom_segs=int(segs)) if segs else o


@functools.lru_cache(maxsize=None)
def chunk_source(kind: str) -> bytes:
    """An input of the chunks phase, rebuilt from the checkout and seeds
    (the witness processes build their own): "mix" (64 MiB), "rand" (4 MiB
    of random bytes), "text16" and "text32" (pg11 repeated to 16 or 32 MiB),
    "spread16" and "spread32" (the pinned inputs of 16 and 32 MiB)."""
    import numpy as np

    from deflate_rs_tpu_torch.utils.mix import build_mix, pg11, spread

    if kind == "mix":
        return build_mix(CHUNKS_MIX_BYTES, pg11())
    if kind == "rand":
        return np.random.default_rng(12).integers(0, 256, 4 * MIB, dtype=np.uint8).tobytes()
    if kind in ("text16", "text32"):
        n, text = int(kind[4:]) * MIB, pg11()
        return (text * (n // len(text) + 1))[:n]
    if kind in ("spread16", "spread32"):
        return spread(int(kind[6:]) * MIB)
    raise ValueError(kind)


def chunk_input(pieces) -> bytes:
    """The bytes of ``pieces``: (kind, start, stop) slices of
    :func:`chunk_source`, or ("fill", byte, count)."""
    return b"".join(bytes([a]) * b if kind == "fill" else chunk_source(kind)[a:b]
                    for kind, a, b in pieces)


def cpu_witness(task) -> tuple:
    """(sha256, length, seconds, peak RSS of the process in GB so far) of
    the CPU port's ``compress_corpus`` stream of one witness task, in a
    spawned process."""
    pieces, preset, E, kw = task
    import resource

    import torch

    torch.set_num_threads(WITNESS_THREADS)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.parallel import corpus

    data = chunk_input(pieces)
    t0 = time.perf_counter()
    out = corpus.compress_corpus(data, _preset(dt, preset), chunk_size=E, device="cpu",
                                 **kw).deflate
    return (hashlib.sha256(out).hexdigest(), len(out), time.perf_counter() - t0,
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6)


class Witnesses:
    """The CPU port's streams of the chunks phase's inputs, computed in
    ``WITNESS_PROCS`` spawned processes while the card runs the phase's
    other checks.  :meth:`submit` queues one (a key names it),
    :meth:`expect` gives the CUDA bytes it must equal, :meth:`add` does
    both; :meth:`check` holds each and :meth:`close` ends the processes."""

    def __init__(self):
        import multiprocessing as mp

        self.pool = mp.get_context("spawn").Pool(WITNESS_PROCS)
        self.jobs, self.pending = {}, []

    def submit(self, key, pieces, preset: str, E: int, **kw) -> None:
        what = " + ".join(f"{b} x {bytes([a])!r}" if kind == "fill" else f"{kind}[{a}:{b}]"
                          for kind, a, b in pieces)
        self.jobs[key] = what, self.pool.apply_async(cpu_witness, ((pieces, preset, E, kw),))

    def expect(self, key, label: str, cuda_bytes: bytes) -> None:
        self.pending.append((label, key, hashlib.sha256(cuda_bytes).hexdigest(),
                             len(cuda_bytes)))

    def add(self, label: str, cuda_bytes: bytes, pieces, preset: str, E: int, **kw) -> None:
        self.submit(label, pieces, preset, E, **kw)
        self.expect(label, label, cuda_bytes)

    def check(self) -> None:
        for label, key, sha, n in self.pending:
            what, res = self.jobs[key]
            got_sha, got_n, secs, rss = res.get(timeout=1200)
            if (got_sha, got_n) != (sha, n):
                raise SystemExit(f"{label}: CUDA bytes differ from the CPU port's on {what}")
            print(f"{label}: CUDA bytes == CPU port bytes on {what} ({n} B; the CPU port "
                  f"took {secs:.1f} s in a witness process, whose peak RSS is now "
                  f"{rss:.1f} GB)", flush=True)

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def chunks_phase(dt, cuda, wall_of) -> tuple:
    """The corpus engine at the chunk sizes above 64 KiB and at 4,112 bytes.

    On a 64 MiB mix, ``compress_corpus`` at each of ``CHUNK_RUNS`` at its
    default batch: a warm run and three timed ones (MB/s median and spread,
    launch counters set to 0 just before each and read after; every kernel
    of the path must move: ``lr_measure``'s tiled path and not its block
    path where the local windows pass ``MAX_WINDOW_WORDS`` (high from
    679,680 B, Default from 1,392,640 B, Default at 512 segments at 16 MiB
    and at 1,024 at 32 MiB), neither without the long-range pass), the
    stream round-trips through zlib, CUDA bytes equal the CPU port's on the
    first 2 MiB (above 1 MiB its first chunk and an eighth, above 4 MiB its
    first chunk, none above ``HEAD_WITNESS_MAX``; above 1 MiB the whole
    stream equals a CUDA run at one chunk a batch, whose chunks all sit in
    the slot the CPU port or a JAX pin holds), the peak
    ``max_memory_allocated`` of the four runs, the batches and the ratio
    beside the 64 KiB run's (the 4 MiB run's above 4 MiB, the 16 MiB run's
    at 32 MiB).  Default at 2 MiB on 2 MiB and 64 KiB of
    random bytes (stored chunks, range totals of 2**21), and fast at 4 MiB
    with ``packed=False`` on a stored chunk of 4 MiB and text: CUDA bytes
    equal the CPU port's.
    fast, rle and turbo at 4,112 bytes on the first 4 MiB: CUDA bytes equal
    the CPU port's.  huffman_only and turbo at 1, 2 and 4 MiB on a chunk of
    zeros and one of b"a", one stream each (launch counters set to 0 just
    before it, every kernel but ``lr_measure`` must move): CUDA bytes equal
    the CPU port's, the stream round-trips through zlib and
    ``inflate_device`` on the card.  fast, rle and huffman_only on pg11
    repeated to one 16 MiB chunk, fast and huffman_only to one of 32 MiB
    (``TEXT_RUNS``; a block gives litlen symbols 2**20 and more: the JAX
    package's stream is invalid there): CUDA bytes equal the CPU port's,
    round trips through zlib and ``inflate_device``.  huffman_only on 32 MiB
    of b"a" (a leaf of 2**25): round trips.  Every pinned JAX stream of a
    16 and a 32 MiB chunk (``PINS_PATHS``): the card's whole stream has its
    length and sha256.  The sizes at which the JAX package
    fails, and the cap, raise ``ValueError`` at the entry, with no kernel
    launched.  Then the kernels at the first batch of the 1 MiB runs
    (Default's, and high's for the tiled path), of Default's 2 MiB,
    4,161,280 B, 512-segment 16 MiB and 1,024-segment 32 MiB runs (32, 16,
    4 and 2 chunks;
    ``lr_measure`` there is the tiled path, held to its plain version on
    ``LR_PLAIN_ROWS`` rows), of fast's at 4,112 bytes and at 4 MiB
    (``parse_scan``: 64 full windows a chunk), of the other runs above
    4 MiB (all four kernels of their path) and of the two one-byte MiBs in
    one batch (package-merge at a leaf of 2**20, at both presets), against
    their plain versions, exact, with graph-replay time and bound
    (``torch.bincount`` timed beside ``quarter_hist`` at the Default runs
    and at 32 MiB).  The CPU port's
    witnesses run in ``WITNESS_PROCS`` spawned processes from the end of the
    timed runs on, beside the card's checks, and are held at the end.
    Returns (launches by run, kernel rows by key, the runs above 4 MiB by
    (preset, chunk size))."""
    import torch

    from deflate_rs_tpu_torch.ops import lr_kernel
    from deflate_rs_tpu_torch.parallel import corpus

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    mix = chunk_source("mix")
    mb = len(mix) / 1e6
    launches, base, heads, wide_runs, ratios = {}, {}, [], {}, {}
    for preset, E in CHUNK_RUNS:
        o = _preset(dt, preset)
        label = f"chunks: {preset} chunk_size={E}"
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        first = corpus.compress_corpus(mix, o, chunk_size=E, device="cuda")  # warm
        rates = []
        for _ in range(3):
            cuda.reset_launches()
            res, wall = wall_of(lambda: corpus.compress_corpus(mix, o, chunk_size=E,
                                                               device="cuda"))
            counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
            if res.deflate != first.deflate:
                raise SystemExit(f"{label}: bytes changed between runs")
            rates.append(mb / wall)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if zlib.decompress(first.deflate, -15) != mix:
            raise SystemExit(f"{label}: the stream does not round-trip")
        # The CPU port's witness (in the witness processes below): above
        # 1 MiB its first chunk and an eighth of the next, above 4 MiB its
        # first chunk; none above HEAD_WITNESS_MAX.
        if E != 65536 and E <= HEAD_WITNESS_MAX:
            n_head = E if E > 4 * MIB else E + E // 8 if E > MIB else 2 * MIB
            heads.append((label, preset, E, n_head, corpus.compress_corpus(
                mix[:n_head], o, chunk_size=E, device="cuda").deflate))
        if E > MIB:
            # The bytes do not depend on the batch: one chunk a batch puts
            # every chunk of the timed batches in slot 0, which the CPU port
            # holds, with no CPU time.
            tc = time.perf_counter()
            if corpus.compress_corpus(mix, o, chunk_size=E, batch_size=1,
                                      device="cuda").deflate != first.deflate:
                raise SystemExit(f"{label}: the stream at batch_size=1 differs from the one at "
                                 f"the default batch of {corpus.default_batch_size(E)}")
            b1_s = time.perf_counter() - tc
        if o.matcher_mode == "hash" and o.use_long_range:
            tiled = (lr_kernel.window_words(HALO + E, o.resolved_dom_segs)
                     > lr_kernel.MAX_WINDOW_WORDS)
            off_path = ("lr_measure",) if tiled else (TILED,)
        else:
            off_path = ("lr_measure", TILED)
        check_launches(label, counts, off_path=off_path)
        ratio = ratios[preset, E] = len(first.deflate) / len(mix)
        if E in (65536, 4 * MIB):
            base[preset] = (E, ratio)
        if E == 32 * MIB:
            base[preset] = (16 * MIB, ratios[RATIO_BASE_16M.get(preset, preset), 16 * MIB])
        launches[preset, E] = counts
        if (preset, E) in WIDE_CHUNK_RUNS:
            wide_runs[preset, E] = {"mb_per_s": sorted(rates), "ratio": ratio, "peak_gib": peak,
                                    "batches": first.fetched["batches"]}
            if E == 32 * MIB:
                wide_runs[preset, E]["ratio_16mib"] = base[preset][1]
        base_txt = (f" ({base[preset][0]} B chunks: {base[preset][1]:.5f})"
                    if preset in base and base[preset][0] != E else "")
        print(f"{label}: {len(mix) >> 20} MiB mix round-trips at ratio {ratio:.5f}{base_txt}; "
              f"{first.fetched['batches']} batches of {corpus.default_batch_size(E)} chunks; "
              f"peak max_memory_allocated {peak:.3f} GiB; warm MB/s {spread(rates)}"
              + ("" if E <= MIB else f"; the whole stream == the one at batch_size=1 "
                 f"({b1_s:.1f} s)")
              + f"; launches of the last timed run {counts}", flush=True)
    witnesses = Witnesses()
    try:
        # The timed runs' heads and the text chunks, the costliest first:
        # the witness processes take them in order.
        early = ([(label, (("mix", 0, n_head),), preset, E) for label, preset, E, n_head, _
                  in heads]
                 + [((f"text{E >> 20}", p), ((f"text{E >> 20}", 0, E),), p, E)
                    for E, presets in TEXT_RUNS for p in presets])
        for key, pieces, preset, E in sorted(early, key=lambda w: -WITNESS_COST.get(
                w[2], 0.8) * sum(b - a for _, a, b in w[1])):
            witnesses.submit(key, pieces, preset, E)
        for label, preset, E, n_head, got in heads:
            witnesses.expect(label, label, got)
        launches_rest, rows = _chunks_checks(dt, cuda, mix, witnesses, wall_of)
        launches.update(launches_rest)
        t_wait = time.perf_counter()
        witnesses.check()
        host_gb = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9
        print(f"chunks: {len(witnesses.pending)} CPU-port witnesses held ({WITNESS_PROCS} "
              f"processes of {WITNESS_THREADS} threads on a host of {host_gb:.1f} GB; "
              f"{time.perf_counter() - t_wait:.1f} s waited for them after the card's checks)",
              flush=True)
    finally:
        witnesses.close()
    torch.cuda.empty_cache()
    print(f"chunks: phase took {time.perf_counter() - t0:.1f} s")
    return launches, rows, wide_runs


def _chunks_checks(dt, cuda, mix: bytes, witnesses, wall_of) -> tuple:
    """The chunks phase after its timed runs (see :func:`chunks_phase`); the
    CPU port's bytes go to ``witnesses``.  Returns (launches by run, kernel
    rows by key)."""
    import torch

    from deflate_rs_tpu_torch.ops import (field_kernel, hist_kernel, lr_kernel, parse_scan,
                                          pm_kernel)
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.ops.inflate_device import inflate_device
    from deflate_rs_tpu_torch.parallel import corpus

    dev = torch.device("cuda", 0)
    launches = {}
    for E, presets in TEXT_RUNS:
        kind = f"text{E >> 20}"
        text = chunk_source(kind)
        for preset in presets:
            o = _preset(dt, preset)
            label = f"chunks: {preset} chunk_size={E} on pg11 repeated to {E >> 20} MiB"
            cuda.reset_launches()
            got = corpus.compress_corpus(text, o, chunk_size=E, device="cuda").deflate
            torch.cuda.synchronize()
            counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
            witnesses.expect((kind, preset), label, got)
            if zlib.decompress(got, -15) != text:
                raise SystemExit(f"{label}: the stream does not round-trip through zlib")
            ti = time.perf_counter()
            if inflate_device(got, len(text), device="cuda") != text:
                raise SystemExit(f"{label}: inflate_device does not give the input back")
            ti = time.perf_counter() - ti
            check_launches(label, counts, off_path=("lr_measure", TILED))
            launches[preset, E, "text"] = counts
            print(f"{label} (a block of litlen symbols of 2**20 and more, where the JAX "
                  f"package's stream is invalid): {len(got)} B, round-trips through zlib and "
                  f"inflate_device on the card ({ti:.1f} s); launches {counts}", flush=True)
    rand = chunk_source("rand")
    pieces = (("rand", 0, 2 * MIB + 65536),)
    data, o = chunk_input(pieces), _preset(dt, "default")
    got = corpus.compress_corpus(data, o, chunk_size=2 * MIB, device="cuda").deflate
    witnesses.add("chunks: default chunk_size=2097152 on random bytes", got, pieces, "default",
                  2 * MIB)
    if zlib.decompress(got, -15) != data or got[0] & 0b111:
        raise SystemExit("chunks: default chunk_size=2097152 on random bytes: not a stored "
                         "first chunk that round-trips")
    print(f"chunks: default chunk_size=2097152 on {len(data)} random bytes: {len(got)} B, stored "
          "chunks", flush=True)
    pieces = (("rand", 0, len(rand)), ("mix", 0, 100_000))
    data, o = chunk_input(pieces), _preset(dt, "fast")
    got = corpus.compress_corpus(data, o, chunk_size=4 * MIB, packed=False, device="cuda").deflate
    witnesses.add("chunks: fast chunk_size=4194304 packed=False", got, pieces, "fast", 4 * MIB,
                  packed=False)
    if zlib.decompress(got, -15) != data or got[0] & 0b111:
        raise SystemExit("chunks: fast chunk_size=4194304 packed=False on a stored chunk and text: "
                         "no stored first chunk that round-trips")
    print(f"chunks: fast chunk_size=4194304 packed=False on 4 MiB of random bytes and 100,000 of "
          f"the mix: {len(got)} B, a stored 4 MiB chunk", flush=True)
    pieces = (("mix", 0, 4 << 20),)
    quarter = chunk_input(pieces)
    for preset in SMALL_CHUNK_RUNS:
        o = _preset(dt, preset)
        label = f"chunks: {preset} chunk_size={SMALL_EMIT}"
        cuda.reset_launches()
        got, wall = wall_of(lambda: corpus.compress_corpus(quarter, o, chunk_size=SMALL_EMIT,
                                                           device="cuda"))
        counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
        witnesses.add(label, got.deflate, pieces, preset, SMALL_EMIT)
        if zlib.decompress(got.deflate, -15) != quarter:
            raise SystemExit(f"{label}: does not round-trip")
        check_launches(label, counts, off_path=("lr_measure", TILED))
        launches[preset, SMALL_EMIT] = counts
        print(f"{label}: mix[:4 MiB] ratio {len(got.deflate) / len(quarter):.5f}, "
              f"{len(quarter) / 1e6 / wall:.2f} MB/s (one run, cold); launches {counts}",
              flush=True)
    for size in ONE_BYTE_SIZES:
        for preset in ONE_BYTE_PRESETS:
            o = _preset(dt, preset)
            for what, byte in ONE_BYTE_VALUES:
                pieces = (("fill", byte[0], size),)
                data = chunk_input(pieces)
                label = f"chunks: {preset} chunk_size={size} on {size >> 20} MiB of {what}"
                cuda.reset_launches()
                got = corpus.compress_corpus(data, o, chunk_size=size, device="cuda").deflate
                torch.cuda.synchronize()
                counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
                witnesses.add(label, got, pieces, preset, size)
                if zlib.decompress(got, -15) != data:
                    raise SystemExit(f"{label}: the stream does not round-trip through zlib")
                if inflate_device(got, len(data), device="cuda") != data:
                    raise SystemExit(f"{label}: inflate_device does not give the input back")
                check_launches(label, counts, off_path=("lr_measure", TILED))
                launches[preset, size, what] = counts
                print(f"{label}: {len(got)} B, round-trips through zlib and inflate_device on "
                      f"the card; launches {counts}", flush=True)
    preset, byte = ONE_BYTE_32M
    data = byte * (32 * MIB)
    label = f"chunks: {preset} chunk_size={32 * MIB} on 32 MiB of {byte!r}"
    cuda.reset_launches()
    got = corpus.compress_corpus(data, _preset(dt, preset), chunk_size=32 * MIB,
                                 device="cuda").deflate
    torch.cuda.synchronize()
    counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    if zlib.decompress(got, -15) != data:
        raise SystemExit(f"{label}: the stream does not round-trip through zlib")
    if inflate_device(got, len(data), device="cuda") != data:
        raise SystemExit(f"{label}: inflate_device does not give the input back")
    check_launches(label, counts, off_path=("lr_measure", TILED))
    launches[preset, 32 * MIB, "one_byte"] = counts
    print(f"{label} (a litlen leaf of 2**25): {len(got)} B, round-trips through zlib and "
          f"inflate_device on the card; launches {counts}", flush=True)
    for path in PINS_PATHS:
        with open(path) as f:
            pins = json.load(f)
        E = pins["chunk_size"]
        src = chunk_source(f"spread{E >> 20}")
        if hashlib.sha256(src).hexdigest() != pins["input_sha256"]:
            raise SystemExit(f"chunks: the pinned {E >> 20} MiB input is not the one the pins "
                             "were made of")
        for preset, pin in sorted(pins["streams"].items()):
            o = _preset(dt, preset)
            label = f"chunks: {preset} chunk_size={E} on the pinned {E >> 20} MiB input"
            got = corpus.compress_corpus(src, o, chunk_size=E, device="cuda").deflate
            if (len(got), hashlib.sha256(got).hexdigest()) != (pin["bytes"], pin["sha256"]):
                raise SystemExit(f"{label}: {len(got)} B, not the JAX package's pinned stream "
                                 f"of {pin['bytes']} B")
            if zlib.decompress(got, -15) != src:
                raise SystemExit(f"{label}: the stream does not round-trip through zlib")
            print(f"{label}: {len(got)} B, length and sha256 == the JAX package's pin, "
                  "round-trips", flush=True)
    for preset, E in REFUSED:
        cuda.reset_launches()
        try:
            corpus.compress_corpus(mix[:100_000], _preset(dt, preset), chunk_size=E,
                                   device="cuda")
        except ValueError as e:
            if any(k.launches for k in cuda.KERNELS.values()):
                raise SystemExit(f"chunks: {preset} chunk_size={E} launched before refusing")
            print(f"chunks: {preset} chunk_size={E} refused at the entry: {e}")
        else:
            raise SystemExit(f"chunks: {preset} chunk_size={E} was taken"
                             + ("; the JAX package fails there" if E <= corpus.MAX_CHUNK_SIZE
                                else ", past the cap"))

    # Kernels at the first batch of the wide runs, of fast's 4,112 B and 4 MiB
    # runs, of the runs above 4 MiB and of the one-byte MiBs (one batch of
    # the two).
    kern = {"lr_measure": lambda a: lr_kernel.lr_measure(*a),
            "parse_scan": lambda a: parse_scan.parse_scan(*a),
            "token_fields": lambda a: field_kernel.token_fields(*a),
            "lengths_by_rank": lambda a: pm_kernel.lengths_by_rank(*a),
            "quarter_hist": lambda a: hist_kernel.quarter_histograms(*a)}
    plain = {"lr_measure": lambda a: lr_plain_rows(a, 2),
             "parse_scan": lambda a: parse_scan.parse_scan_plain(*a),
             "token_fields": lambda a: field_kernel.token_fields_plain(*a),
             "lengths_by_rank": lambda a: pm_kernel.lengths_by_rank_plain(*a),
             "quarter_hist": lambda a: hist_kernel.quarter_histograms_plain(*a)}
    every = (("lr_measure", "lr_measure"), ("parse_scan", "parse_scan"),
             ("token_fields", "token_fields"), ("lengths_by_rank_15", "lengths_by_rank"),
             ("lengths_by_rank_7", "lengths_by_rank"), ("quarter_histograms", "quarter_hist"))
    # (row key, preset, chunk size, recorded wrapper, which of its calls)
    sets = ([("mib", "default", MIB, rec, name) for rec, name in every]
            + [("high_mib", "high", MIB, "lr_measure", "lr_measure")]
            + [("mib2", "default", 2 * MIB, rec, name) for rec, name in every]
            + [("mib4", "default", 4_161_280, rec, name) for rec, name in every]
            + [("mib16", "default_segs512", 16 * MIB, rec, name) for rec, name in every]
            + [("mib32", "default_segs1024", 32 * MIB, rec, name) for rec, name in every]
            + [(f"{p}_{E >> 20}m", p, E, rec, name) for p, E in WIDE_CHUNK_RUNS
               if not p.startswith("default_segs") for rec, name in every[1:]]
            + [("granule", "fast", SMALL_EMIT, "parse_scan", "parse_scan"),
               ("fast4m", "fast", 4 * MIB, "parse_scan", "parse_scan")]
            + [("one_byte", "huffman_only", MIB, rec, name) for rec, name in every[1:]]
            + [("one_byte_turbo", "turbo", MIB, "lengths_by_rank_15", "lengths_by_rank")])
    one_byte = b"".join(byte * MIB for _, byte in ONE_BYTE_VALUES)
    rows, seen = {}, {}
    for row_key, preset, E, rec, name in sets:
        if (preset, E) not in seen:
            seen.clear()
            torch.cuda.empty_cache()
            o = corpus.chunk_options(_preset(dt, preset), E)
            src, batch = ((one_byte, len(ONE_BYTE_VALUES)) if row_key.startswith("one_byte")
                          else (mix, corpus.default_batch_size(E)))
            bufs, hist, ns, last = (torch.from_numpy(a) for a in emit_buffers(src, E, batch))
            with torch.no_grad():
                seen[preset, E] = harvest(ChunkEncoder(o, E).to(dev), bufs.to(dev), hist, ns,
                                          last)
            del bufs
        args = seen[preset, E][rec]
        if rec == "lengths_by_rank_15" and row_key.startswith("one_byte") and not bool(
                (args[0] == MIB).any()):
            raise SystemExit(f"chunks: {preset}'s litlen rows of the one-byte MiBs hold no "
                             "leaf of 2**20")
        got = kern[name](args)
        got = got if isinstance(got, tuple) else (got,)
        held = args
        if name == "lr_measure" and E > MIB:
            held = (args[0][:LR_PLAIN_ROWS], args[1][:LR_PLAIN_ROWS], args[2])
            got_held = tuple(g[:LR_PLAIN_ROWS] for g in got)
        else:
            got_held = got
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        want = plain[name](held)
        end.record()
        torch.cuda.synchronize()
        p_ms = start.elapsed_time(end)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got_held, want))
        if err != 0:
            raise SystemExit(f"chunks: kernel {name} disagrees with its plain version at "
                             f"{preset} chunk_size={E}: max_abs_err={err}")
        del want
        k_ms = kernel_ms(lambda: kern[name](args), reps=5)
        bytes_ms, ops_ms = bound_of(name if name != "lengths_by_rank" else rec, args, got)
        bound = max(bytes_ms, ops_ms)
        path = (" (tiled path)" if name == "lr_measure" and lr_kernel.window_words(
            args[2], args[1].shape[1]) > lr_kernel.MAX_WINDOW_WORDS else "")
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        lib_ms = None
        if name == "quarter_hist" and (row_key in ("mib", "mib2", "mib4", "mib16")
                                       or E == 32 * MIB):
            lib_ms, same = bincount_yardstick(args, got)
            if not same:
                raise SystemExit("chunks: the bincount yardstick computes another function")
        print(f"kernel {rec}{path} ({preset}, chunks) emit={E} shapes={shapes}: max_abs_err=0 "
              + (f"on its first {LR_PLAIN_ROWS} rows " if held is not args else "")
              + f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms"
              + (f" ({LR_PLAIN_ROWS} rows)" if held is not args else "")
              + f" bound {bound:.5f} ms (bytes {bytes_ms:.5f}, operations {ops_ms:.5f}) share "
              f"{100 * bound / k_ms:.1f} %"
              + (f" bincount {lib_ms:.4f} ms" if lib_ms is not None else ""), flush=True)
        r = rows.setdefault((row_key, name), {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0})
        r["ms"] += k_ms
        r["plain_ms"] += p_ms
        r["bound_ms"] += bound
        if held is not args:
            r["plain_rows"] = LR_PLAIN_ROWS
        if lib_ms is not None:
            r["library_ms"] = lib_ms
        del got, got_held
    seen.clear()
    return launches, rows


def some_phases(dt, cuda, only: list, pg11: bytes, mix: bytes, presets: dict, smi: str,
                t_start: float) -> int:
    """The phases ``only`` names, in the order of a whole run, each with what
    it would be handed there; the ``{"ok": true, ...}`` line, no kernels line."""
    import torch

    from deflate_rs_tpu_torch.parallel import corpus

    for name in [p for p in PHASES if p in only]:
        if name == "decode":
            decode_phase(dt, cuda, pg11, mix[: 1 << 20], presets)
        elif name == "sharded":
            sharded_phase(dt, cuda, mix, corpus.compress_corpus(mix, device="cuda").deflate,
                          corpus.compress_corpus(mix, packed=False, device="cuda").deflate,
                          wall_of, smi)
        elif name == "knobs":
            knobs_phase(dt, cuda, pg11, mix, wall_of)
        elif name == "soak":
            soak_phase()
        elif name == "stages":
            stages_phase(cuda, mix, smi)
        elif name == "fuzz":
            fuzz_phase(cuda)
        elif name == "margins":
            margins_phase()
        else:
            chunks_phase(dt, cuda, wall_of)
        print(f"{name}: phase done at {time.perf_counter() - t_start:.1f} s")
    print(f"done in {time.perf_counter() - t_start:.1f} s: the phases {only} alone, so no "
          "kernels line")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# The phases of a run that ``--phases`` may name alone: each is a function of
# this module that needs nothing of the phases before it.
PHASES = ("decode", "sharded", "knobs", "soak", "stages", "fuzz", "margins", "chunks")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help=f"run only these phases, comma-separated, of {', '.join(PHASES)} "
                         "(the setup too, and no kernels line); by default every phase")
    a = ap.parse_args(argv)
    only = None if a.phases is None else a.phases.split(",")
    if only is not None and (not only or set(only) - set(PHASES)):
        print(f"chip_smoke: --phases takes names of {PHASES}, not {a.phases!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import deflate_rs_tpu_torch as dt
    from deflate_rs_tpu_torch.ops import (field_kernel, hist_kernel, lr_kernel, parse_scan,
                                          pm_kernel)
    from deflate_rs_tpu_torch.models.deflate import BATCH_CHUNKS
    from deflate_rs_tpu_torch.ops.chunk_encode import ChunkEncoder
    from deflate_rs_tpu_torch.parallel import corpus
    from deflate_rs_tpu_torch.runtime import cuda
    from deflate_rs_tpu_torch.tools.dryrun_multichip import build_batch, dryrun_data
    from deflate_rs_tpu_torch.utils import kernel_cases
    from deflate_rs_tpu_torch.utils.mix import MIX_BYTES, build_mix

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    # ------------------------------------------------------------- setup
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"setup: {smi}")
    t0 = time.perf_counter()
    cuda.load_library()
    print(f"setup: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {cuda.build_seconds if cuda.build_seconds is not None else 0:.1f} s), "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    with open(os.path.join(HERE, "tests", "data", "pg11.txt"), "rb") as f:
        pg11 = f.read()
    mix = build_mix(MIX_BYTES, pg11)
    O = dt.CompressionOptions
    presets = {
        "fast": O.fast(), "high": O.high(), "rle": O.rle(),
        "huffman_only": O.huffman_only(), "turbo": O.turbo(),
        "ForceFixed": O(special=dt.SpecialOptions.ForceFixed),
        "ForceStored": O(special=dt.SpecialOptions.ForceStored),
    }
    if only is not None:
        return some_phases(dt, cuda, only, pg11, mix, presets, smi, t_start)

    # ------------------------------------------ kernels vs plain, both tiers
    def quarter_hist_plain(a):
        return hist_kernel.quarter_histograms_plain(*a)

    def quarter_hist_kernel(a):
        return hist_kernel.quarter_histograms(*a)

    plain = {
        "lr_measure": lambda a: lr_kernel.lr_measure_plain(*a),
        "parse_scan": lambda a: parse_scan.parse_scan_plain(*a),
        "token_fields": lambda a: field_kernel.token_fields_plain(*a),
        "lengths_by_rank_15": lambda a: pm_kernel.lengths_by_rank_plain(*a),
        "lengths_by_rank_7": lambda a: pm_kernel.lengths_by_rank_plain(*a),
        "quarter_hist_nq8": quarter_hist_plain,
        "quarter_hist_nq1": quarter_hist_plain,
        "quarter_hist_nq4": quarter_hist_plain,
        "lr_measure_s32": lambda a: lr_kernel.lr_measure_plain(*a),
        "lengths_by_rank_15_high": lambda a: pm_kernel.lengths_by_rank_plain(*a),
    }
    kern = {
        "lr_measure": lambda a: lr_kernel.lr_measure(*a),
        "parse_scan": lambda a: parse_scan.parse_scan(*a),
        "token_fields": lambda a: field_kernel.token_fields(*a),
        "lengths_by_rank_15": lambda a: pm_kernel.lengths_by_rank(*a),
        "lengths_by_rank_7": lambda a: pm_kernel.lengths_by_rank(*a),
        "quarter_hist_nq8": quarter_hist_kernel,
        "quarter_hist_nq1": quarter_hist_kernel,
        "quarter_hist_nq4": quarter_hist_kernel,
        "lr_measure_s32": lambda a: lr_kernel.lr_measure(*a),
        "lengths_by_rank_15_high": lambda a: pm_kernel.lengths_by_rank(*a),
    }
    # Which encoder's run supplies each kernel's inputs: (preset, recorded key).
    source = {
        "lr_measure": ("default", "lr_measure"),
        "parse_scan": ("default", "parse_scan"),
        "token_fields": ("default", "token_fields"),
        "lengths_by_rank_15": ("default", "lengths_by_rank_15"),
        "lengths_by_rank_7": ("default", "lengths_by_rank_7"),
        "quarter_hist_nq8": ("default", "quarter_histograms"),
        "quarter_hist_nq1": ("fast", "quarter_histograms"),
        "quarter_hist_nq4": ("rle", "quarter_histograms"),
        "lr_measure_s32": ("high", "lr_measure"),
        "lengths_by_rank_15_high": ("high", "lengths_by_rank_15"),
    }
    harvest_opts = {"default": O.default(), "fast": O.fast(), "rle": O.rle(), "high": O.high()}
    results = {}
    encoders = {}
    kb = corpus.BATCH_SIZE

    def harvest_rows(operands, emit, lo, hi, names, kw):
        """What the encoders of the presets ``names`` (built with ``kw``)
        hand the kernels for rows lo..hi of ``operands``."""
        seen = {}
        for name in names:
            ekey = (name, emit, tuple(sorted(kw.items())))
            if ekey not in encoders:
                encoders[ekey] = ChunkEncoder(harvest_opts[name], emit, **kw).to(dev)
            bufs, hist, ns, last = (torch.from_numpy(a[lo:hi]) for a in operands)
            with torch.no_grad():
                seen[name] = harvest(encoders[ekey], bufs.to(dev), hist, ns, last)
        return seen

    def compare(key, args):
        """(the kernel's outputs, max_abs_err against the plain version)."""
        got, want = kern[key](args), plain[key](args)
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
                  for g, w in zip(got, want))
        return got, err

    # The operand sets: (emit, rows, presets harvested, encoder arguments).
    # The sharded step (parallel/sharded.py) builds its ChunkEncoder with
    # checksums and without stored payload fields and runs Default only: at
    # world size 1 over all of the mix at once, and in the dry run over four
    # mixed chunks a rank.
    step_kw = {"with_checksums": True, "stored_payload_fields": False}
    tiers = {
        4096: (4096, tier_buffers(mix, 4096, BATCH), tuple(harvest_opts), {}),
        65536: (65536, tier_buffers(mix, 65536, max(kb, BATCH)), tuple(harvest_opts), {}),
        "sharded": (65536, build_batch(mix, 65536), ("default",), step_kw),
        "dryrun": (65536, build_batch(dryrun_data(65536, 4), 65536), ("default",), step_kw),
    }
    n_sharded = len(tiers["sharded"][1][2])
    # (operand set, first row, end row, what launches that batch, timed).
    # The rows of a batch smaller than the tier's start at chunk 1, which has
    # its 32 KiB of history as every chunk of a stream but the first has.
    batches = [
        (4096, 0, BATCH, "32 streams of 4 KiB", True),
        (4096, 3, 4, "one 4 KiB stream, the small tier's only batch", False),
        (65536, 0, kb, "the corpus engine's batch: one-shot and corpus runs", True),
        (65536, 1, 2, "one chunk: the single-chunk streaming path", True),
        (65536, 1, 16, "a 1 MiB write to a streaming encoder, one byte held back", False),
        (65536, 0, 16, "a 1 MiB write to a streaming encoder", False),
        (65536, 0, BATCH_CHUNKS, "the chunk-batch engine, pipelined=False", False),
        ("sharded", 0, n_sharded, "the sharded step at world size 1: every chunk of the mix",
         True),
        ("dryrun", 0, 4, "one rank of the dry run: text, stored, runs, periodic", False),
    ]
    for tier, lo, hi, what, timed in batches:
        emit, operands, names, kw = tiers[tier]
        B = hi - lo
        seen = harvest_rows(operands, emit, lo, hi, names, kw)
        keys = [key for key in plain if source[key][0] in seen]
        for key in keys:
            preset, rec = source[key]
            args = seen[preset][rec]
            got, err = compare(key, args)
            r = results.setdefault(key, {"max_abs_err": 0})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if err != 0:
                raise SystemExit(f"kernel {key} disagrees with its plain version at emit={emit} "
                                 f"B={B} ({what}): max_abs_err={err}")
            if not timed:
                continue
            shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
            k_ms = kernel_ms(lambda: kern[key](args))
            e_ms = cuda_ms(lambda: kern[key](args), 50)
            p_ms = cuda_ms(lambda: plain[key](args))
            bytes_ms, ops_ms = bound_of(key, args, got)
            lib_ms = None
            if key.startswith("quarter_hist"):
                lib_ms, same = bincount_yardstick(args, got)
                if not same:
                    raise SystemExit(f"{key}: the bincount yardstick computes another function")
            print(f"kernel {key} ({preset}) emit={emit} B={B} shapes={shapes}: max_abs_err={err} "
                  f"kernel {k_ms:.4f} ms (eager loop {e_ms:.4f}) plain {p_ms:.4f} ms "
                  f"bound {max(bytes_ms, ops_ms):.5f} ms (bytes {bytes_ms:.5f}, operations "
                  f"{ops_ms:.5f})" + (f" bincount {lib_ms:.4f} ms" if lib_ms is not None else ""))
            if tier == 65536 and B == kb:
                r.update(ms=k_ms, eager_ms=e_ms, plain_ms=p_ms, bytes_ms=bytes_ms, ops_ms=ops_ms,
                         library_ms=lib_ms)
            elif tier == 65536 and B == 1:
                r.update(b1_ms=k_ms, b1_eager_ms=e_ms, b1_plain_ms=p_ms,
                         b1_bound_ms=max(bytes_ms, ops_ms))
            elif tier == "sharded":
                r.update(sharded_ms=k_ms, sharded_plain_ms=p_ms,
                         sharded_bound_ms=max(bytes_ms, ops_ms))
        print(f"kernels: emit={emit} B={B} ({what}): all {len(keys)} operand sets equal the "
              f"plain versions exactly")
    del tiers, seen
    encoders.clear()
    torch.cuda.empty_cache()

    # Adversarial operands: exact equality with the plain versions.
    for E, B, seed in kernel_cases.PARSE_CASES:
        steps, n = kernel_cases.parse_scan_batch(E, B, seed)
        st, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
        if not torch.equal(parse_scan.parse_scan(st, nn), parse_scan.parse_scan_plain(st, nn)):
            raise SystemExit(f"parse_scan disagrees on the adversarial case E={E} B={B} seed={seed}")
    pm_cases = kernel_cases.package_merge_cases()
    for name, freqs, max_len in pm_cases:
        leaf = torch.from_numpy(kernel_cases.sorted_leaves(freqs)).to(dev)
        got = pm_kernel.lengths_by_rank(leaf, max_len)
        if got.shape != leaf.shape or (leaf.numel() and not torch.equal(
                got, pm_kernel.lengths_by_rank_plain(leaf, max_len))):
            raise SystemExit(f"package_merge disagrees on the adversarial case {name}")
    for B, S, N, seed in kernel_cases.LR_CASES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_measure_batch(B, S, N, seed))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the adversarial case B={B} S={S} N={N} "
                             f"seed={seed}")
    for B, E, nq, seed in kernel_cases.HIST_CASES:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.hist_batch(B, E, seed))
        if not all(torch.equal(g, w) for g, w in zip(
                hist_kernel.quarter_histograms(*a, nq),
                hist_kernel.quarter_histograms_plain(*a, nq))):
            raise SystemExit(f"quarter_hist disagrees on the adversarial case B={B} E={E} "
                             f"nq={nq} seed={seed}")
    field_sets = [(c, kernel_cases.field_batch(*c)) for c in kernel_cases.FIELD_CASES]
    field_sets += [(c, kernel_cases.field_batch(*c, 2)) for c in kernel_cases.FIELD_ODD_SHAPES]
    for case, ops in field_sets:
        a = tuple(torch.from_numpy(x).to(dev) for x in ops)
        # Each [B, E] operand also one element in: rows not 16-byte aligned.
        for form, args in (("aligned", a), ("unaligned", tuple(
                unaligned(x) if x.dim() == 2 else x for x in a))):
            if not all(torch.equal(g, w) for g, w in zip(field_kernel.token_fields(*args),
                                                         field_kernel.token_fields_plain(*args))):
                raise SystemExit(f"token_fields disagrees on the adversarial case {case} "
                                 f"({form})")
    torch.cuda.synchronize()
    print(f"kernels: adversarial cases equal the plain versions exactly: parse_scan "
          f"{len(kernel_cases.PARSE_CASES)}, package_merge {len(pm_cases)}, lr_measure "
          f"{len(kernel_cases.LR_CASES)}, quarter_hist {len(kernel_cases.HIST_CASES)}, "
          f"token_fields {len(field_sets)}, each aligned and one element in")
    print(f"kernels: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------ default path
    raw = dt.deflate_bytes(pg11, device="cuda")
    if len(raw) != 60196:
        raise SystemExit(f"pg11 compressed to {len(raw)} bytes, expected 60196")
    if raw != dt.deflate_bytes(pg11, device="cpu"):
        raise SystemExit("pg11: CUDA bytes differ from the CPU port's")
    head = mix[: 1 << 20]
    cpu_head = dt.deflate_bytes(head, device="cpu")
    if dt.deflate_bytes(head, device="cuda") != cpu_head:
        raise SystemExit("mix[:1 MiB]: CUDA bytes differ from the CPU port's")
    print("default: pg11 -> 60196 B; CUDA bytes == CPU port bytes on pg11 and mix[:1 MiB]")
    launches = {"default": timed_run(dt, cuda, mix, O.default(), "default")}
    print(f"default: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------- other presets
    for name, o in presets.items():
        got = dt.deflate_bytes_conf(pg11, o, device="cuda")
        if got != dt.deflate_bytes_conf(pg11, o, device="cpu"):
            raise SystemExit(f"{name}: CUDA bytes differ from the CPU port's on pg11")
        if zlib.decompress(got, -15) != pg11:
            raise SystemExit(f"{name}: pg11 stream does not round-trip")
        print(f"presets: {name} pg11 -> {len(got)} B, CUDA bytes == CPU port bytes, round-trips")
    for name in ("fast", "high"):
        o = presets[name]
        if dt.deflate_bytes_conf(head, o, device="cuda") != dt.deflate_bytes_conf(head, o, device="cpu"):
            raise SystemExit(f"{name}: CUDA bytes differ from the CPU port's on mix[:1 MiB]")
        print(f"presets: {name} CUDA bytes == CPU port bytes on mix[:1 MiB]")
        # fast runs no long-range pass (the only preset with a matcher
        # that skips it), so lr_measure is off its path.
        launches[name] = timed_run(dt, cuda, mix, o, name,
                                   off_path=("lr_measure", TILED) if name == "fast" else (TILED,))
    print(f"presets: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------- kernels, wide
    import dataclasses

    from deflate_rs_tpu_torch.models.deflate import compress_stream
    from deflate_rs_tpu_torch.ops import checksum
    from deflate_rs_tpu_torch.write import DeflateEncoder, GzEncoder, ZlibEncoder

    wide_opts = dataclasses.replace(O.default(), chain_scale=WIDE_EMIT // 65536)
    bufs, hist, ns, last = wide_buffers(mix)
    with torch.no_grad():
        seen_wide = harvest(ChunkEncoder(wide_opts, WIDE_EMIT).to(dev),
                            torch.from_numpy(bufs).to(dev), torch.from_numpy(hist),
                            torch.from_numpy(ns), torch.from_numpy(last))
    wide = {}
    for key, rec in (("lr_measure", "lr_measure"), ("parse_scan", "parse_scan"),
                     ("token_fields", "token_fields"),
                     ("lengths_by_rank_15", "lengths_by_rank_15"),
                     ("lengths_by_rank_7", "lengths_by_rank_7"),
                     ("quarter_hist_nq8", "quarter_histograms")):
        args = seen_wide[rec]
        got, err = compare(key, args)
        k_ms = kernel_ms(lambda: kern[key](args))
        p_ms = cuda_ms(lambda: plain[key](args), 2)
        bytes_ms, ops_ms = bound_of(key, args, got)
        bound = max(bytes_ms, ops_ms)
        shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
        print(f"kernel {key} (default, wide) emit={WIDE_EMIT} shapes={shapes}: max_abs_err={err} "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms bound {bound:.5f} ms (bytes "
              f"{bytes_ms:.5f}, operations {ops_ms:.5f}) share {100 * bound / k_ms:.1f} %")
        if err != 0:
            raise SystemExit(f"kernel {key} disagrees with its plain version at emit={WIDE_EMIT}")
        wide[key] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": bound, "max_abs_err": err}
        results[key]["max_abs_err"] = max(results[key]["max_abs_err"], err)
    torch.cuda.empty_cache()
    for E, B, seed in kernel_cases.PARSE_CASES_WIDE:
        steps, n = kernel_cases.parse_scan_batch_wide(E, B, seed)
        st, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
        if not torch.equal(parse_scan.parse_scan(st, nn), parse_scan.parse_scan_plain(st, nn)):
            raise SystemExit(f"parse_scan disagrees on the wide case E={E} B={B} seed={seed}")
    for B, S, N, seed in kernel_cases.LR_CASES_WIDE:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_measure_batch(B, S, N, seed))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the wide case B={B} S={S} N={N} "
                             f"seed={seed}")
    for B, E, nq, seed in kernel_cases.HIST_CASES_WIDE:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.hist_batch(B, E, seed))
        if not all(torch.equal(g, w) for g, w in zip(
                hist_kernel.quarter_histograms(*a, nq),
                hist_kernel.quarter_histograms_plain(*a, nq))):
            raise SystemExit(f"quarter_hist disagrees on the wide case B={B} E={E} nq={nq}")
    # The chunk sizes above 256 KiB and the multiples of 16 that are no
    # multiple of 64: partial segments and 16 to 256 windows of parse_scan,
    # high's local pass and Default's at 512 segments on lr_measure's tiled
    # path, Default's at 1,024 segments of 16 MiB chunks on its block path,
    # rows of 1 MiB, 4 MiB and of 4,112.
    parse_sets = ([(c, kernel_cases.parse_scan_batch(*c, kernel_cases.parse_payloads_granule))
                   for c in kernel_cases.PARSE_CASES_GRANULE]
                  + [(c, kernel_cases.parse_scan_batch_wide(*c))
                     for c in kernel_cases.PARSE_CASES_WIDE_GRANULE + kernel_cases.PARSE_CASES_MIB
                     + kernel_cases.PARSE_CASES_16MIB])
    for case, (steps, n) in parse_sets:
        st, nn = torch.from_numpy(steps).to(dev), torch.from_numpy(n).to(dev)
        if not torch.equal(parse_scan.parse_scan(st, nn), parse_scan.parse_scan_plain(st, nn)):
            raise SystemExit(f"parse_scan disagrees on the case (E, B, seed) = {case}")
    for B, S, N, seed in kernel_cases.LR_CASES_MIB + kernel_cases.LR_CASES_16MIB:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.lr_measure_batch(B, S, N, seed))
        if not all(torch.equal(g, w) for g, w in zip(lr_kernel.lr_measure(*a, N),
                                                     lr_kernel.lr_measure_plain(*a, N))):
            raise SystemExit(f"lr_measure disagrees on the case B={B} S={S} N={N} seed={seed}")
    for B, E, nq, seed in kernel_cases.HIST_CASES_GRANULE:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.hist_batch(B, E, seed))
        for form in (lambda x: x, unaligned):
            if not all(torch.equal(g, w) for g, w in zip(
                    hist_kernel.quarter_histograms(*map(form, a), nq),
                    hist_kernel.quarter_histograms_plain(*map(form, a), nq))):
                raise SystemExit(f"quarter_hist disagrees on the case B={B} E={E} nq={nq}")
    for case in kernel_cases.FIELD_CASES_GRANULE:
        a = tuple(torch.from_numpy(x).to(dev) for x in kernel_cases.field_batch(*case))
        for args in (a, tuple(unaligned(x) if x.dim() == 2 else x for x in a)):
            if not all(torch.equal(g, w) for g, w in zip(field_kernel.token_fields(*args),
                                                         field_kernel.token_fields_plain(*args))):
                raise SystemExit(f"token_fields disagrees on the case {case}")
    del a
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"kernels, wide: adversarial cases equal the plain versions exactly: parse_scan "
          f"{len(kernel_cases.PARSE_CASES_WIDE)} wide, {len(parse_sets)} at partial segments "
          f"and 1 to 16 MiB; lr_measure {len(kernel_cases.LR_CASES_WIDE)} wide, "
          f"{len(kernel_cases.LR_CASES_MIB)} at 512 KiB and 1 MiB, "
          f"{len(kernel_cases.LR_CASES_16MIB)} at 16 MiB and 512 or 1,024 segments; quarter_hist "
          f"{len(kernel_cases.HIST_CASES_WIDE)} wide, {len(kernel_cases.HIST_CASES_GRANULE)} at "
          f"1 MiB, 4 MiB and 4,112 (aligned and one element in); token_fields "
          f"{len(kernel_cases.FIELD_CASES_GRANULE)} at 1 MiB and 4,112 (both forms); phase done "
          f"at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------- corpus
    mb = len(mix) / 1e6
    default = O.default()

    old = compress_stream(mix, default, pipelined=False, device="cuda")  # warm
    new = corpus.compress_corpus(mix, device="cuda")
    if new.deflate != old.deflate:
        raise SystemExit("corpus: bytes differ from the chunk-batch engine's on the mix")
    if (new.adler, new.crc32, new.isize) != (zlib.adler32(mix), zlib.crc32(mix), len(mix)):
        raise SystemExit("corpus: checksums of the mix are wrong")
    if corpus.compress_corpus(head, device="cuda").deflate != cpu_head:
        raise SystemExit("corpus: CUDA bytes differ from the CPU port's on mix[:1 MiB]")
    if zlib.decompress(corpus.compress_corpus_zlib(mix, device="cuda")) != mix:
        raise SystemExit("corpus: zlib form does not round-trip")
    if gzip.decompress(corpus.compress_corpus_gzip(mix, device="cuda")) != mix:
        raise SystemExit("corpus: gzip form does not round-trip")
    unpacked = corpus.compress_corpus(mix, packed=False, device="cuda").deflate
    if zlib.decompress(unpacked, -15) != mix or len(unpacked) <= len(new.deflate):
        raise SystemExit("corpus: packed=False does not round-trip behind its sync markers")
    quarter = mix[: 4 << 20]
    wide_out = corpus.compress_corpus(quarter, chunk_size=WIDE_EMIT, device="cuda").deflate
    if zlib.decompress(wide_out, -15) != quarter:
        raise SystemExit("corpus: chunk_size=262144 does not round-trip")
    if (corpus.compress_corpus(head, chunk_size=WIDE_EMIT, device="cuda").deflate
            != corpus.compress_corpus(head, chunk_size=WIDE_EMIT, device="cpu").deflate):
        raise SystemExit("corpus: chunk_size=262144 CUDA bytes differ from the CPU port's")
    print(f"corpus: 16 MiB mix == chunk-batch engine's bytes; == CPU port on mix[:1 MiB]; zlib, "
          f"gzip and packed=False ({len(unpacked) - len(new.deflate)} B of markers) round-trip; "
          f"chunk_size=262144: 4 MiB round-trips at ratio {len(wide_out) / len(quarter):.4f} "
          f"(64 KiB chunks: {len(corpus.compress_corpus(quarter, device='cuda').deflate) / len(quarter):.4f}), "
          "== CPU port on mix[:1 MiB]")
    walls = []
    for _ in range(3):
        walls.append(wall_of(lambda: compress_stream(mix, default, pipelined=False,
                                                   device="cuda"))[1])
    nw_old = ChunkEncoder(default, 65536).num_words
    old_fetch = BATCH_CHUNKS * nw_old * 8 + BATCH_CHUNKS * 3 * 8
    print(f"corpus: chunk-batch engine (pipelined=False, {BATCH_CHUNKS} chunks a batch): "
          f"{[round(mb / w, 2) for w in walls]} MB/s; fetches {old_fetch} B a batch "
          f"({-(-len(mix) // (65536 * BATCH_CHUNKS))} batches)")
    corpus_rates = {}
    for bs in (16, 32, 64, 128):
        for qd in (1, 3):
            corpus.compress_corpus(mix, batch_size=bs, queue_depth=qd, device="cuda")  # warm
            rates = []
            for _ in range(3):
                cuda.reset_launches()
                res, wall = wall_of(lambda: corpus.compress_corpus(
                    mix, batch_size=bs, queue_depth=qd, device="cuda"))
                if res.deflate != old.deflate:
                    raise SystemExit(f"corpus: bytes changed at batch_size={bs} queue_depth={qd}")
                rates.append(mb / wall)
            st_ = res.fetched  # of the last run; every run fetches the same
            corpus_rates[bs, qd] = rates
            launches[f"corpus_{bs}_{qd}"] = {n_: k.launches for n_, k in cuda.KERNELS.items()}
            print(f"corpus: batch_size={bs} queue_depth={qd}: {[round(r, 2) for r in rates]} MB/s; "
                  f"fetched per batch {(st_['meta_bytes'] + st_['words_bytes']) // st_['batches']} B "
                  f"(meta {st_['meta_bytes'] // st_['batches']}, words "
                  f"{st_['words_bytes'] // st_['batches']}; {st_['batches']} batches)")
    launches["corpus"] = launches[f"corpus_{corpus.BATCH_SIZE}_{corpus.QUEUE_DEPTH}"]
    check_launches("corpus", launches["corpus"])
    print(f"corpus: launches during a timed run at the defaults: {launches['corpus']}; phase "
          f"done at {time.perf_counter() - t_start:.1f} s")

    # ---------------------------------------------------------- streaming
    one_shot = {
        DeflateEncoder: dt.deflate_bytes(mix, device="cuda"),
        ZlibEncoder: dt.deflate_bytes_zlib(mix, device="cuda"),
        GzEncoder: dt.deflate_bytes_gzip(mix, device="cuda"),
    }
    one_shot_quarter = {
        ZlibEncoder: dt.deflate_bytes_zlib(quarter, device="cuda"),
        GzEncoder: dt.deflate_bytes_gzip(quarter, device="cuda"),
    }
    for cls, want in one_shot.items():
        cuda.reset_launches()
        got, wall = wall_of(lambda: stream_through(cls, mix, 1 << 20, device="cuda"))
        if got != want:
            raise SystemExit(f"streaming: {cls.__name__} in 1 MiB writes differs from the one-shot")
        counts = {n_: k.launches for n_, k in cuda.KERNELS.items()}
        if cls is DeflateEncoder:
            launches["streaming"] = counts
            data99, want99 = mix, want
        else:
            data99, want99 = quarter, one_shot_quarter[cls]
        got99, wall99 = wall_of(lambda: stream_through(cls, data99, 99_991, device="cuda"))
        if got99 != want99:
            raise SystemExit(f"streaming: {cls.__name__} in 99,991 B writes differs from the "
                             "one-shot")
        print(f"streaming: {cls.__name__} == one-shot CUDA bytes; 1 MiB writes {mb / wall:.2f} "
              f"MB/s, 99,991 B writes {len(data99) / 1e6 / wall99:.2f} MB/s over "
              f"{len(data99) >> 20} MiB; launches (1 MiB writes) {counts}")
    check_launches("streaming", launches["streaming"])
    flushed = stream_through(ZlibEncoder, quarter, 99_991, flush_every=300_000, device="cuda")
    if zlib.decompress(flushed) != quarter or flushed.count(b"\x00\x00\xff\xff") < 10:
        raise SystemExit("streaming: a stream with a flush every 300,000 B does not round-trip")
    if (stream_through(DeflateEncoder, pg11, 20_000, flush_every=50_000, device="cuda")
            != stream_through(DeflateEncoder, pg11, 20_000, flush_every=50_000, device="cpu")):
        raise SystemExit("streaming: flushed pg11 stream differs from the CPU port's")
    import io

    sink_a, sink_b = io.BytesIO(), io.BytesIO()
    enc = ZlibEncoder(sink_a, device="cuda")
    enc.write(pg11)
    if enc.reset(sink_b) is not sink_a:
        raise SystemExit("streaming: reset did not return the old writer")
    enc.write(pg11)
    enc.finish()
    if not (sink_a.getvalue() == sink_b.getvalue() == dt.deflate_bytes_zlib(pg11, device="cuda")):
        raise SystemExit("streaming: reset reuse changed the stream")
    print("streaming: flush every 300,000 B over 4 MiB round-trips; flushed pg11 CUDA bytes == "
          "CPU port's; reset reuse gives the one-shot zlib bytes twice")
    # The single-chunk row: the latency of one chunk alone (B = 1).
    enc = DeflateEncoder(io.BytesIO(), device="cuda")
    enc.write(mix[:65536])
    enc.flush()  # warm
    cuda.reset_launches()
    chunk_ms = []
    for i in range(1, 21):
        piece = mix[i * 65536 : (i + 1) * 65536]
        chunk_ms.append(1e3 * wall_of(lambda: (enc.write(piece), enc.flush()))[1])
    launches["single_chunk"] = {n_: k.launches for n_, k in cuda.KERNELS.items()}
    enc.finish()
    small_ms = []
    for i in range(21):
        sink = io.BytesIO()
        piece = mix[i * 4096 : (i + 1) * 4096]

        def small():
            e = DeflateEncoder(sink, device="cuda")
            e.write(piece)
            e.finish()

        ms = 1e3 * wall_of(small)[1]
        if zlib.decompress(sink.getvalue(), -15) != piece:
            raise SystemExit("streaming: a 4 KiB stream does not round-trip")
        if i:
            small_ms.append(ms)
    check_launches("streaming at B = 1", launches["single_chunk"])
    print(f"streaming: single chunk, 64 KiB write + flush(), 20 after a warm one: "
          f"{spread(chunk_ms)} ms; launches of the 20: {launches['single_chunk']}")
    print(f"streaming: single chunk, 4 KiB write + finish(), 20 after a warm one: "
          f"{spread(small_ms)} ms; phase done at {time.perf_counter() - t_start:.1f} s")

    # ---------------------------------------------------------- checksums
    enc_cs = ChunkEncoder(default, 65536, with_checksums=True).to(dev)
    state, raw = checksum.ADLER_INIT, 0
    offsets = list(range(0, len(mix), 65536))
    from deflate_rs_tpu_torch.models.deflate import _chunk_buffers

    for b0 in range(0, len(offsets), kb):
        bufs, hist, ns, last = _chunk_buffers(mix, offsets[b0 : b0 + kb], 65536)
        with torch.no_grad():
            out = enc_cs(torch.from_numpy(bufs).to(dev), torch.from_numpy(hist),
                         torch.from_numpy(ns), torch.from_numpy(last))
        parts = torch.stack([out["s1"], out["s2"], out["crc_raw"]]).cpu().numpy()
        for i in range(len(ns)):
            state = checksum.adler32_combine(state, int(parts[0, i]), int(parts[1, i]), int(ns[i]))
            raw = checksum.crc32_combine_raw(raw, int(parts[2, i]), int(ns[i]))
    if checksum.adler32_value(state) != zlib.adler32(mix):
        raise SystemExit("checksums: combined Adler-32 partials differ from zlib.adler32")
    if checksum.crc32_from_raw(raw, len(mix)) != zlib.crc32(mix):
        raise SystemExit("checksums: combined CRC-32 partials differ from zlib.crc32")
    print(f"checksums: device partials of {len(offsets)} chunks combine to zlib.adler32 and "
          f"zlib.crc32 of the mix; phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------- decode
    launches["decode"] = decode_phase(dt, cuda, pg11, head, presets)
    print(f"decode: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------ sharded
    launches["sharded"], launches["sharded_mesh"] = sharded_phase(
        dt, cuda, mix, new.deflate, unpacked, wall_of, smi)
    print(f"sharded: phase done at {time.perf_counter() - t_start:.1f} s")

    # -------------------------------------------------------------- knobs
    global_row = knobs_phase(dt, cuda, pg11, mix, wall_of)
    print(f"knobs: phase done at {time.perf_counter() - t_start:.1f} s")

    # --------------------------------------------------------------- soak
    soak_phase()
    print(f"soak: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------- stages
    launches["stages"] = stages_phase(cuda, mix, smi)
    print(f"stages: phase done at {time.perf_counter() - t_start:.1f} s")

    # --------------------------------------------------------------- fuzz
    launches["fuzz"] = fuzz_phase(cuda)
    print(f"fuzz: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------ margins
    margins_phase()
    print(f"margins: phase done at {time.perf_counter() - t_start:.1f} s")

    # ------------------------------------------------------------- chunks
    chunk_launches, chunk_rows, wide_runs = chunks_phase(dt, cuda, wall_of)
    print(f"chunks: phase done at {time.perf_counter() - t_start:.1f} s")

    sources = {
        "lr_measure": ("deflate_rs_tpu_torch/csrc/lr_measure.cu", "deflate_rs_tpu/ops/lr_kernel.py:84",
                       ["lr_measure", "lr_measure_s32"], ["lr_measure"]),
        "parse_scan": ("deflate_rs_tpu_torch/csrc/parse_scan.cu", "deflate_rs_tpu/ops/parse_scan.py:44",
                       ["parse_scan"], ["parse_scan"]),
        "package_merge": ("deflate_rs_tpu_torch/csrc/package_merge.cu",
                          "deflate_rs_tpu/ops/pm_kernel.py:57",
                          ["lengths_by_rank_15", "lengths_by_rank_7", "lengths_by_rank_15_high"],
                          ["lengths_by_rank_15", "lengths_by_rank_7"]),
        "token_fields": ("deflate_rs_tpu_torch/csrc/token_fields.cu",
                         "deflate_rs_tpu/ops/field_kernel.py:33", ["token_fields"], ["token_fields"]),
        "quarter_hist": ("deflate_rs_tpu_torch/csrc/quarter_hist.cu",
                         "deflate_rs_tpu/ops/hist_kernel.py:35",
                         ["quarter_hist_nq8", "quarter_hist_nq1", "quarter_hist_nq4"],
                         ["quarter_hist_nq8"]),
    }
    mib = chunk_launches["default", MIB]
    high_mib = chunk_launches["high", MIB]
    mib2, mib4 = chunk_launches["default", 2 * MIB], chunk_launches["default", 4_161_280]
    mib16 = chunk_launches["default_segs512", 16 * MIB]
    mib32 = chunk_launches["default_segs1024", 32 * MIB]
    wide_keys = [(p, E, f"{p}_{E >> 20}m") for p, E in WIDE_CHUNK_RUNS
                 if not p.startswith("default_segs")]
    chunk_key = {"lr_measure": "lr_measure", "parse_scan": "parse_scan",
                 "package_merge": "lengths_by_rank", "token_fields": "token_fields",
                 "quarter_hist": "quarter_hist"}
    rows = []
    for name, (src, rep, checked, timed) in sources.items():
        # A batch of Default calls every key of ``timed`` once: the sums are
        # the kernel's cost per batch of ``kb`` chunks (``batch``), the shape
        # of the main path's launches, and per single chunk (``b1_*``).
        bytes_ms = sum(results[k]["bytes_ms"] for k in timed)
        ops_ms = sum(results[k]["ops_ms"] for k in timed)
        lib = [results[k]["library_ms"] for k in timed]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches["default"][name],
            "launches_default": launches["default"][name],
            "launches_high": launches["high"][name],
            "launches_corpus": launches["corpus"][name],
            "launches_streaming": launches["streaming"][name],
            "launches_single_chunk": launches["single_chunk"][name],
            "launches_sharded": launches["sharded"][name],
            "launches_sharded_mesh": launches["sharded_mesh"][name],
            "launches_decode": launches["decode"][name],
            "batch": kb,
            "b1_ms": sum(results[k]["b1_ms"] for k in timed),
            "b1_eager_ms": sum(results[k]["b1_eager_ms"] for k in timed),
            "b1_plain_ms": sum(results[k]["b1_plain_ms"] for k in timed),
            "b1_bound_ms": sum(results[k]["b1_bound_ms"] for k in timed),
            "sharded_batch": n_sharded,
            "sharded_ms": sum(results[k]["sharded_ms"] for k in timed),
            "sharded_plain_ms": sum(results[k]["sharded_plain_ms"] for k in timed),
            "sharded_bound_ms": sum(results[k]["sharded_bound_ms"] for k in timed),
            "wide_batch": WIDE_BATCH,
            "wide_ms": sum(wide[k]["ms"] for k in timed),
            "wide_bound_ms": sum(wide[k]["bound_ms"] for k in timed),
            "wide_plain_ms": sum(wide[k]["plain_ms"] for k in timed),
            "max_abs_err": max(results[k]["max_abs_err"] for k in checked),
            "ms": sum(results[k]["ms"] for k in timed),
            "eager_ms": sum(results[k]["eager_ms"] for k in timed),
            "plain_ms": sum(results[k]["plain_ms"] for k in timed),
            "bound_ms": sum(max(results[k]["bytes_ms"], results[k]["ops_ms"]) for k in timed),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None if None in lib else sum(lib),
            "launches_chunks_mib": mib[name],
            "launches_chunks_high_mib": high_mib[name],
            "launches_chunks_mib2": mib2[name],
            "launches_chunks_mib4": mib4[name],
            "launches_chunks_mib16": mib16[name],
            "launches_chunks_mib32": mib32[name],
            "launches_chunks_wide": sum(chunk_launches[p, E][name] for p, E, _ in wide_keys),
            "mib_batch": corpus.BATCH_SIZE,
            **{f"mib_{k}": v for k, v in chunk_rows["mib", chunk_key[name]].items()},
        })
        if name != "lr_measure":  # above 1 MiB Default's local pass is on the tiled path
            for row_key, E in (("mib2", 2 * MIB), ("mib4", 4_161_280), ("mib16", 16 * MIB),
                               ("mib32", 32 * MIB)):
                rows[-1][f"{row_key}_batch"] = corpus.default_batch_size(E)
                rows[-1].update({f"{row_key}_{k}": v
                                 for k, v in chunk_rows[row_key, chunk_key[name]].items()})
            rows[-1]["chunks_wide"] = {
                key: {"batch": corpus.default_batch_size(E), **chunk_rows[key, chunk_key[name]]}
                for _, E, key in wide_keys}
        if name == "parse_scan":
            rows[-1].update({f"granule_{k}": v for k, v in chunk_rows["granule", name].items()})
            rows[-1].update({f"fast4m_{k}": v for k, v in chunk_rows["fast4m", name].items()})
        rows[-1]["launches_chunks_one_byte"] = sum(
            chunk_launches[p, MIB, what][name] for p in ONE_BYTE_PRESETS
            for what, _ in ONE_BYTE_VALUES)
        rows[-1]["launches_chunks_one_byte_wide"] = sum(
            chunk_launches[p, size, what][name] for p in ONE_BYTE_PRESETS
            for what, _ in ONE_BYTE_VALUES for size in ONE_BYTE_SIZES if size > MIB)
        for row_key in ("one_byte", "one_byte_turbo"):
            rows[-1].update({f"{row_key}_{k}": v for k, v in
                             chunk_rows.get((row_key, chunk_key[name]), {}).items()})
    global_row["launches_chunks_high_mib"] = high_mib[TILED]
    global_row.update({f"high_mib_{k}": v for k, v in chunk_rows["high_mib", "lr_measure"].items()})
    global_row["launches_chunks_high_2m"] = chunk_launches["high", 2_064_128][TILED]
    for row_key, launched, E in (("mib2", mib2, 2 * MIB), ("mib4", mib4, 4_161_280),
                                 ("mib16", mib16, 16 * MIB), ("mib32", mib32, 32 * MIB)):
        global_row[f"launches_chunks_{row_key}"] = launched[TILED]
        global_row[f"{row_key}_batch"] = corpus.default_batch_size(E)
        global_row.update({f"{row_key}_{k}": v for k, v in chunk_rows[row_key, "lr_measure"].items()})
    rows.append(global_row)
    high_pm = results["lengths_by_rank_15_high"]
    print(f"package_merge at high's shape: kernel {high_pm['ms']:.4f} ms plain "
          f"{high_pm['plain_ms']:.4f} ms bound {max(high_pm['bytes_ms'], high_pm['ops_ms']):.5f} ms")
    print(f"done in {time.perf_counter() - t_start:.1f} s; kernels row: launches of the timed "
          "Default run (the main path; above four chunks it is the corpus engine), of the timed "
          "high run, of a timed corpus run at the defaults, of the DeflateEncoder over the mix "
          "in 1 MiB writes, of 20 single 64 KiB chunks, of a timed sharded run (world size 1) "
          "and of the decode phase (none: no kernel is on that path); ms (CUDA-graph replay), "
          "eager_ms, "
          f"plain_ms, bound_ms, library_ms at the 64 KiB tier on Default's inputs at {kb} chunks, the "
          "batch of the one-shot and corpus runs; b1_* the same at one chunk, the batch of the "
          f"single-chunk run; sharded_* the same at {n_sharded} chunks, the sharded step's batch; "
          f"wide_ms and wide_bound_ms at {WIDE_BATCH} chunks of {WIDE_EMIT} bytes; max_abs_err "
          "over every batch and tier checked. The lr_measure_global row is lr_measure's tiled "
          "path at the lr_global pass's whole-chunk window: launches of the timed Default "
          "lr_global=64 run (launches_high: high's), ms to bound_ms at 64 chunks on Default's "
          "global operands at D = 64 (live: their live slots), b1_* at one chunk, d256_* at "
          "D = 256, high_* on high's, wide_* at 8 chunks of 262,144 bytes; mb_per_s of three "
          "Default lr_global=64 runs and mb_per_s_no_knob of three knob-free ones, in turns. "
          "chunks phase: launches_chunks_mib and launches_chunks_high_mib of the timed Default "
          "and high compress_corpus runs at 1 MiB chunks on the 64 MiB mix; mib_ms, "
          "mib_plain_ms, mib_bound_ms at the first batch of Default's 1 MiB run "
          f"({corpus.BATCH_SIZE} chunks), quarter_hist's mib_library_ms the bincount there; "
          f"granule_* at fast's {SMALL_EMIT} B chunks; launches_chunks_one_byte of the four "
          "huffman_only and turbo streams of a MiB of zeros and of b'a' at 1 MiB chunks, "
          "one_byte_* at the two MiBs in one batch at huffman_only, one_byte_turbo_* "
          "(package_merge) at turbo: a leaf of 2**20; launches_chunks_one_byte_wide the same "
          "at 2 and 4 MiB; launches_chunks_mib2 and launches_chunks_mib4 of the timed Default "
          "runs at 2,097,152 and 4,161,280 B chunks, mib2_* and mib4_* at their first batches "
          "(mib2_batch, mib4_batch chunks; the lr_measure_global row holds lr_measure's there, "
          "Default's local pass on the tiled path, its plain_ms on plain_rows rows); parse_scan's "
          "fast4m_* at fast's first batch of 4 MiB chunks; the "
          "lr_measure_global row's high_mib_* at high's 1 MiB chunks, its local pass on the "
          "tiled path, and launches_chunks_high_2m of the timed high run at 2,064,128 B; "
          "launches_chunks_mib16 of the timed Default run at 512 segments and 16 MiB chunks, "
          "mib16_* at its first batch (4 chunks; lr_measure's tiled path in the "
          "lr_measure_global row), launches_chunks_mib32 and mib32_* the same at 1,024 "
          "segments and 32 MiB chunks (2 chunks); launches_chunks_wide the sum over the timed "
          "fast and rle runs at 8, 16 and 32 MiB and huffman_only and turbo at 16 and 32 MiB, "
          "chunks_wide their first batches' ms, plain_ms and bound_ms by run (quarter_hist's "
          "library_ms the bincount at 32 MiB); the CHUNKS_WIDE line holds those runs' MB/s, "
          "ratio, peak GiB and batches, and the 32 MiB runs' ratio at 16 MiB")
    print("CHUNKS_WIDE " + json.dumps({f"{p} {E}": v for (p, E), v in wide_runs.items()}))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
