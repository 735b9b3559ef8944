"""Sharded chunk-parallel encoding over the ranks of a process group.

Port of ``deflate_rs_tpu/parallel/sharded.py`` on ``torch.distributed``.
One step, on every rank at once:

  1. each rank encodes its contiguous rows of the batch
     (``mesh.local_chunk_range``) with ``ChunkEncoder`` on its device;
  2. the per-chunk compressed byte counts are all-gathered (the path's only
     collective), so every rank can place any chunk in the final stream by
     an int64 host scan (``global_offsets``);
  3. each rank fetches its own rows only: the meta first, then, in compact
     mode, the used prefix of one compacted word buffer (``ops/compaction``:
     ``ceil(data_bits / 32)`` words a Huffman chunk, none a stored chunk,
     which the host re-emits from the raw payload), as one copy, as the
     corpus engine does.

A step's output is this rank's shard: a dict of host arrays.  Assembly is
an ordered host-side splice (``models/assembly.py``, the native bit
splicer): ``assemble_local`` makes this rank's byte-aligned segment and its
global byte offset, so ranks write their segments in parallel and nothing
holds the whole stream; ``assemble_host`` splices the shards of every rank
held by one process (after ``dist.gather_object``, or at world size 1),
packed (bytes of the one-shot stream) or byte-aligned (a sync marker after
every chunk but the last, bytes of ``compress_stream(packed=False)``).
"""

from __future__ import annotations

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


def _all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (same shape on each), concatenated in rank order."""
    if mesh.group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


def make_sharded_encoder(mesh: Mesh, options: CompressionOptions, emit_size: int, *,
                         compact: bool = True):
    """Build the sharded encode step of this rank.

    Returns ``fn(bufs, hist_lens, ns, is_lasts)``: the arguments are the
    GLOBAL batch (``B`` rows, divisible by the mesh size; host arrays or
    tensors), of which this rank uploads and encodes its own rows only.
    The result is this rank's shard, a dict of host arrays:

      row0:       the shard's first global row
      nbytes:     int64[local_b] compressed byte counts (sync-marker framing)
      all_nbytes: int64[B] every rank's counts, from the all-gather; the
                  global byte offsets are ``global_offsets(all_nbytes)``,
                  an int64 host scan (an int32 one overflows past 2 GiB)
      btype, data_bits: block metadata for the host splice
      s1, s2, crc_raw: checksum partials
      compact=True:  cw: uint32, the used words of the shard's chunks, in
                     row order (``used_words_host`` counts them)
      compact=False: words: uint32[local_b, NW] whole per-chunk word rows

    ``emit_size`` must be a chunk size the corpus engine takes at ``options``
    (``corpus.check_chunk_size``); anything else raises ``ValueError`` here.
    """
    check_chunk_size(emit_size, options)
    encoder = ChunkEncoder(options, emit_size, with_checksums=True,
                           # Compact mode never reads stored chunks' device
                           # words; leaving their fields out shrinks the pack.
                           stored_payload_fields=not compact).to(mesh.device)

    def step(bufs, hist_lens, ns, is_lasts) -> dict:
        B = len(ns)
        rows = local_chunk_range(B, mesh)
        part = [torch.as_tensor(np.asarray(a)[rows.start:rows.stop])
                for a in (bufs, hist_lens, ns, is_lasts)]
        with torch.no_grad():
            out = encoder(part[0].to(mesh.device), *part[1:])
            nbytes = (out["total_bits"] + 7) // 8  # sync marker => byte aligned
            all_nbytes = _all_gather(nbytes, mesh)
            meta = torch.stack([nbytes, out["btype"], out["data_bits"], out["s1"], out["s2"],
                                out["crc_raw"]]).long().cpu().numpy()
            shard = {"row0": rows.start, "all_nbytes": all_nbytes.cpu().numpy()}
            shard.update(zip(("nbytes", "btype", "data_bits", "s1", "s2", "crc_raw"), meta))
            if compact:
                words = compact_words_device(
                    out["words"], used_words_device(out["btype"], out["data_bits"]))
                need = int(used_words_host(shard["btype"], shard["data_bits"]).sum())
                shard["cw"] = words[:need].cpu().numpy().view(np.uint32)
            else:
                shard["words"] = out["words"].to(torch.int32).cpu().numpy().view(np.uint32)
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
    """Ordered splice of the shards of EVERY rank, held by this process.

    ``shards``: one shard dict (world size 1) or a list of them, in any
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
    """This rank's byte-aligned segment and its global byte offset.

    The multi-process form of :func:`assemble_host`: every rank assembles
    its own chunks (sync-marker framing) and writes the segment at the
    offset, so no process holds the whole stream.  The shard's rows must be
    the ones :func:`.mesh.local_chunk_range` gives this rank.  Compacted
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
