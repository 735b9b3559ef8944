"""Sharded chunk-parallel encoding over a mesh of devices.

Port of ``deflate_rs_tpu/parallel/sharded.py`` on ``torch.distributed``.
One step, on every device of the mesh at once:

  1. each process takes its contiguous rows of the batch
     (``mesh.local_chunk_range``) and splits them into contiguous blocks,
     one per device of its own in mesh order (the JAX ``P(DATA_AXIS)``
     split); each device encodes its block with its own ``ChunkEncoder``;
  2. the per-chunk compressed byte counts of the process's devices, in row
     order, are all-gathered across the ranks (the path's only collective),
     so every process can place any chunk in the final stream by an int64
     host scan (``global_offsets``);
  3. each process fetches its own rows only: per device the meta first,
     then, in compact mode, the used prefix of one compacted word buffer
     (``ops/compaction``: ``ceil(data_bits / 32)`` words a Huffman chunk,
     none a stored chunk, which the host re-emits from the raw payload), as
     one copy, as the corpus engine does.

Every device's encode and compaction is queued before the first fetch, the
stages of ``ChunkEncoder.forward`` in turns over the devices, so the devices
run at once from one host thread.

A step's output is this process's shard: a dict of host arrays.  Assembly is
an ordered host-side splice (``models/assembly.py``, the native bit
splicer): ``assemble_local`` makes this process's byte-aligned segment and
its global byte offset, so processes write their segments in parallel and
nothing holds the whole stream; ``assemble_host`` splices the shards of
every process held by one process (after ``dist.gather_object``, or with
one process), packed (bytes of the one-shot stream) or byte-aligned (a sync
marker after every chunk but the last, bytes of
``compress_stream(packed=False)``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from .. import constants as C
from ..compression_options import CompressionOptions
from ..models.assembly import BitAssembler, splice_encoded_chunk
from ..ops.chunk_encode import ChunkEncoder
from ..ops.compaction import compact_words_device, used_words_device, used_words_host
from ..runtime import native
from .corpus import check_chunk_size
from .mesh import Mesh, local_chunk_range

_META = ("nbytes", "btype", "data_bits", "s1", "s2", "crc_raw")


def _all_gather(nbytes: np.ndarray, mesh: Mesh) -> np.ndarray:
    """Every process's ``nbytes`` (same length on each), concatenated in rank
    order; the collective runs on the process's first device."""
    if mesh.group is None:
        return nbytes
    x = torch.from_numpy(nbytes).to(mesh.device)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(mesh.group))]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts).cpu().numpy()


def _on(device: torch.device):
    """``device`` as the current CUDA device (its current stream); nothing on
    the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def make_sharded_encoder(mesh: Mesh, options: CompressionOptions, emit_size: int, *,
                         compact: bool = True):
    """Build the sharded encode step of this process.

    Returns ``fn(bufs, hist_lens, ns, is_lasts)``: the arguments are the
    GLOBAL batch (``B`` rows, divisible by the mesh size, or ``ValueError``;
    host arrays or tensors), of which this process uploads and encodes its
    own rows only, ``B / mesh.size`` a device.  The result is the process's
    shard, a dict of host arrays whose rows are its devices' in order:

      row0:       the shard's first global row
      nbytes:     int64[local_b] compressed byte counts (sync-marker framing)
      all_nbytes: int64[B] every process's counts, from the all-gather; the
                  global byte offsets are ``global_offsets(all_nbytes)``,
                  an int64 host scan (an int32 one overflows past 2 GiB)
      btype, data_bits: block metadata for the host splice
      s1, s2, crc_raw: checksum partials
      compact=True:  cw: uint32, the used words of the shard's chunks, in
                     row order (``used_words_host`` counts them): each
                     device's compacted words, one after another
      compact=False: words: uint32[local_b, NW] whole per-chunk word rows

    ``emit_size`` must be a chunk size the corpus engine takes at ``options``
    (``corpus.check_chunk_size``); anything else raises ``ValueError`` here.
    """
    check_chunk_size(emit_size, options)
    # One encoder a distinct device (the logical CPU devices share one).
    by_device = {d: ChunkEncoder(options, emit_size, with_checksums=True,
                                 # Compact mode never reads stored chunks' device
                                 # words; leaving their fields out shrinks the pack.
                                 stored_payload_fields=not compact).to(d)
                 for d in dict.fromkeys(mesh.devices)}
    encoders = [by_device[d] for d in mesh.devices]

    def upload(k: int, block) -> dict:
        """Device k's block on the device: its encoder's first state."""
        dev = mesh.devices[k]
        with _on(dev):
            return encoders[k].inputs(*(torch.as_tensor(a).to(dev) for a in block))

    def stage(k: int, name: str, state: dict) -> dict:
        """Queue one stage of ``ChunkEncoder.forward`` on device k."""
        with _on(mesh.devices[k]):
            return encoders[k].run_stage(name, state)

    def finish(k: int, state: dict) -> tuple:
        """Queue device k's meta and its compaction."""
        out = encoders[k].outputs(state)
        with _on(mesh.devices[k]):
            nbytes = (out["total_bits"] + 7) // 8  # sync marker => byte aligned
            meta = torch.stack([nbytes, *(out[key] for key in _META[1:])]).long()
            if compact:
                words = compact_words_device(
                    out["words"], used_words_device(out["btype"], out["data_bits"]))
            else:
                words = out["words"].to(torch.int32)
        return meta, words

    def fetch(meta, words) -> tuple:
        """A device's meta, then its used words: the host waits for it here."""
        meta = meta.cpu().numpy()
        if compact:
            words = words[: int(used_words_host(meta[1], meta[2]).sum())]
        return meta, words.cpu().numpy().view(np.uint32)

    def step(bufs, hist_lens, ns, is_lasts) -> dict:
        B = len(ns)
        if B % mesh.size:
            raise ValueError(f"global batch {B} is not divisible by the mesh size {mesh.size}; "
                             "pad the batch")
        rows = local_chunk_range(B, mesh)
        per = B // mesh.size
        host = [np.asarray(a)[rows.start : rows.stop] for a in (bufs, hist_lens, ns, is_lasts)]
        blocks = [[a[k * per : (k + 1) * per] for a in host] for k in range(len(mesh.devices))]
        cards = range(len(blocks))
        with torch.no_grad():
            # The stages in turns over the devices: a device's launch queue
            # holds about a thousand kernels, and the host blocks on a full
            # one, so one device's whole forward would hold the next device
            # back until it is nearly done.
            states = [upload(k, block) for k, block in zip(cards, blocks)]
            for name in ChunkEncoder.STAGES:
                states = [stage(k, name, state) for k, state in zip(cards, states)]
            got = [fetch(*one) for one in [finish(k, st) for k, st in zip(cards, states)]]
        meta = np.concatenate([m for m, _ in got], axis=1)
        shard = {"row0": rows.start, "all_nbytes": _all_gather(meta[0], mesh)}
        shard.update(zip(_META, meta))
        if compact:
            shard["cw"] = np.concatenate([w for _, w in got])
        else:
            shard["words"] = np.concatenate([w for _, w in got])
        return shard

    return step


def global_offsets(all_nbytes) -> np.ndarray:
    """Exclusive int64 prefix sum of per-chunk byte counts: every chunk's
    byte offset in the final stream.  In int64 on purpose: the running total
    passes int32 once the output passes 2 GiB."""
    nb = np.asarray(all_nbytes, dtype=np.int64)
    return np.cumsum(nb) - nb


def _splice_compact_shard(asm: BitAssembler, shard: dict, payloads, lasts, B: int,
                          packed: bool) -> None:
    """Splice one shard's chunks from its compacted words."""
    btypes, dbits, row0 = shard["btype"], shard["data_bits"], shard["row0"]
    used = used_words_host(btypes, dbits)
    woff = np.cumsum(used) - used
    bwords = shard["cw"].view(np.uint8)
    for i in range(btypes.shape[0]):
        g = row0 + i
        if g >= B:
            break
        stored = int(btypes[i]) == C.BTYPE_STORED
        if stored and (payloads is None or payloads[g] is None):
            # A stored chunk has no device words under compaction; without
            # its raw payload the splicer would emit an EMPTY stored block.
            raise ValueError("assembly of compacted output with stored chunks requires the "
                             "raw payloads (pass payloads=[chunk bytes, ...])")
        is_last = bool(lasts[g]) if lasts is not None else g == B - 1
        splice_encoded_chunk(asm, int(btypes[i]), int(dbits[i]),
                             bwords[4 * woff[i] : 4 * (woff[i] + used[i])],
                             payloads[g] if stored else b"", is_last)
        if not packed and not is_last:
            # Byte-aligned framing: re-append the sync marker the device
            # emits after a non-final chunk (the fetch holds data_bits only).
            asm.append_sync_marker()


def assemble_host(shards, n: int | None = None, *, packed: bool = False, payloads=None,
                  is_lasts=None) -> bytes:
    """Ordered splice of the shards of EVERY process, held by this one.

    ``shards``: one shard dict (one process) or a list of them, in any
    order.  ``packed=False`` emits the byte-aligned sync-marker framing;
    ``packed=True`` bit-splices marker-free (the one-shot packed stream).
    Compacted shards and stored chunks need ``payloads`` (raw bytes per
    chunk, by global row) and ``is_lasts``; ``n`` drops padding rows.
    """
    shards = sorted([shards] if isinstance(shards, dict) else list(shards),
                    key=lambda s: s["row0"])
    total = len(shards[0]["all_nbytes"])
    starts = [s["row0"] for s in shards]
    ends = [s["row0"] + len(s["nbytes"]) for s in shards]
    if starts[0] != 0 or ends[-1] != total or starts[1:] != ends[:-1]:
        raise ValueError(
            f"assemble_host needs every rank's shard (rows from {starts} to {ends} of "
            f"{total}); a rank "
            "assembles its own rows with assemble_local() and writes them at the returned "
            "global offset")
    nbytes = np.concatenate([s["nbytes"] for s in shards])
    B = total if n is None else n
    asm = BitAssembler(int(nbytes[:B].sum()) + 4096)
    if "cw" in shards[0]:
        for s in shards:
            _splice_compact_shard(asm, s, payloads, is_lasts, B, packed)
        return asm.take_aligned()

    words = np.concatenate([s["words"] for s in shards])[:B]
    if not packed:
        return native.assemble_chunks(np.ascontiguousarray(words).view(np.uint8), nbytes[:B])
    btypes = np.concatenate([s["btype"] for s in shards])
    dbits = np.concatenate([s["data_bits"] for s in shards])
    if payloads is None and (btypes[:B] == C.BTYPE_STORED).any():
        raise ValueError("packed assembly of a batch containing stored chunks requires the "
                         "raw payloads (pass payloads=[chunk bytes, ...])")
    for i in range(B):
        splice_encoded_chunk(asm, int(btypes[i]), int(dbits[i]), words[i],
                             payloads[i] if payloads is not None else b"",
                             bool(is_lasts[i]) if is_lasts is not None else i == B - 1)
    return asm.take_aligned()


def assemble_local(shard: dict, *, payloads=None, is_lasts=None, n: int | None = None,
                   mesh: Mesh | None = None) -> tuple[bytes, int]:
    """This process's byte-aligned segment and its global byte offset.

    The multi-process form of :func:`assemble_host`: every process assembles
    its own chunks (sync-marker framing) and writes the segment at the
    offset, so no process holds the whole stream.  The shard's rows must be
    the ones :func:`.mesh.local_chunk_range` gives this process.  Compacted
    shards need the raw ``payloads`` of any stored chunk (by global row) and
    the global ``is_lasts``.
    """
    offsets = global_offsets(shard["all_nbytes"])
    total = len(offsets)
    first, local_b = shard["row0"], len(shard["nbytes"])
    owned = local_chunk_range(total, mesh)
    if (first, first + local_b) != (owned.start, owned.stop):
        raise ValueError(f"shard rows {first}:{first + local_b} are not this rank's rows "
                         f"{owned.start}:{owned.stop}")
    offset = int(offsets[first]) if total else 0
    if "cw" in shard:
        asm = BitAssembler(int(shard["nbytes"].sum()) + 4096)
        _splice_compact_shard(asm, shard, payloads, is_lasts, total if n is None else n,
                              packed=False)
        return asm.take_aligned(), offset
    u8 = np.ascontiguousarray(shard["words"]).view(np.uint8)
    return native.assemble_chunks(u8, shard["nbytes"]), offset
