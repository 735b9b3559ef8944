"""One-shot compression API and host-side stream assembly.

Port of ``deflate_rs_tpu/models/deflate.py`` (the reference's lib.rs:110-286:
``deflate_bytes[_conf]``, ``deflate_bytes_zlib[_conf]``,
``deflate_bytes_gzip[_conf]``).  The input is cut into 64 KiB chunks, each
carrying the previous 32 KiB as match history; chunks are encoded in batches
by ``ChunkEncoder`` on the requested device, fetched once per batch, and
bit-spliced in order on the host (models/assembly.py).  Checksums come from
the native host runtime.

Every entry takes ``device`` (default ``"cuda"``); nothing picks a device on
its own.  As in the JAX package, inputs above four chunks go through the
corpus engine (parallel/corpus.py: flat uploads, compacted fetches, batches
in flight while the host splices), whose bytes equal this module's own
chunk-batch engine's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import constants as C
from ..compression_options import Compression, CompressionOptions
from ..ops.chunk_encode import HALO, PAD, ChunkEncoder
from ..runtime import native
from .assembly import BitAssembler, splice_encoded_chunk
from .gzip_header import GzBuilder

# Chunk capacity tiers: inputs up to SMALL_EMIT use the small encoder;
# chunk boundaries are always multiples of FULL_EMIT (chunk determinism,
# lib.rs:408-433).
SMALL_EMIT = 4096
FULL_EMIT = 65536
BATCH_CHUNKS = 32


class StreamResult:
    """Assembled deflate stream plus checksums of the raw input."""

    __slots__ = ("deflate", "adler", "crc32", "isize")

    def __init__(self, deflate: bytes, adler: int, crc32: int, isize: int):
        self.deflate = deflate
        self.adler = adler
        self.crc32 = crc32
        self.isize = isize


@functools.lru_cache(maxsize=64)
def get_chunk_encoder(options: CompressionOptions, emit_size: int, device: str) -> ChunkEncoder:
    """The encoder module for one configuration, on ``device``."""
    return ChunkEncoder(options, emit_size).to(device)


def _chunk_buffers(data: bytes, offsets: list, emit: int) -> tuple:
    """Padded chunk buffers uint8[B, HALO + emit + PAD] and per-row
    (hist_len, n, is_last) for the chunks starting at ``offsets``."""
    n_all = len(data)
    src = np.frombuffer(data, np.uint8)
    bufs = np.zeros((len(offsets), HALO + emit + PAD), np.uint8)
    hist = np.zeros(len(offsets), np.int64)
    ns = np.zeros(len(offsets), np.int64)
    last = np.zeros(len(offsets), bool)
    for i, off in enumerate(offsets):
        ln = min(n_all - off, FULL_EMIT)
        h = min(off, HALO)
        bufs[i, HALO - h : HALO + ln] = src[off - h : off + ln]
        hist[i], ns[i], last[i] = h, ln, off + ln >= n_all
    return bufs, hist, ns, last


def compress_stream(data: bytes, options: CompressionOptions, *, packed: bool = True,
                    pipelined: bool | None = None, device="cuda",
                    batch_chunks: int = BATCH_CHUNKS) -> StreamResult:
    """Compress ``data`` into a raw DEFLATE stream (with checksums).

    ``packed`` (the default) splices consecutive blocks at arbitrary bit
    phase, the reference's one-shot framing (sync markers only on an explicit
    flush, compress.rs:257-262).  ``packed=False`` byte-aligns every chunk
    behind a sync marker.

    ``pipelined`` selects the corpus engine (parallel/corpus.py); by default
    inputs above four chunks go there.  Both engines give the same bytes;
    ``pipelined=False`` pins this module's own engine, which encodes
    ``batch_chunks`` chunks per device call and fetches their whole word
    buffers.
    """
    n = len(data)
    if pipelined is None:
        pipelined = packed and n > 4 * FULL_EMIT
    if pipelined and packed:
        from ..parallel.corpus import compress_corpus

        # FULL_EMIT is read here, at call time, so that a changed chunk size
        # keeps both engines in step.
        return compress_corpus(data, options, chunk_size=FULL_EMIT, device=device)
    emit = SMALL_EMIT if n <= SMALL_EMIT else FULL_EMIT
    encoder = get_chunk_encoder(options, emit, str(torch.device(device)))
    asm = BitAssembler(n + n // 128 + 4096) if packed else None
    pieces = []
    offsets = list(range(0, n, FULL_EMIT)) if n else [0]
    for b0 in range(0, len(offsets), batch_chunks):
        batch = offsets[b0 : b0 + batch_chunks]
        bufs, hist, ns, last = _chunk_buffers(data, batch, emit)
        with torch.no_grad():
            out = encoder(torch.from_numpy(bufs).to(device), torch.from_numpy(hist),
                          torch.from_numpy(ns), torch.from_numpy(last))
        # One host fetch per batch.
        words = out["words"].cpu().numpy()
        meta = torch.stack([out["total_bits"], out["data_bits"], out["btype"]],
                           dim=1).cpu().numpy()
        for i, off in enumerate(batch):
            total_bits, data_bits, btype = (int(v) for v in meta[i])
            if total_bits > words.shape[1] * 32:
                raise RuntimeError(
                    f"encoder overflow: {total_bits} bits exceeds the "
                    f"{words.shape[1] * 32}-bit word buffer (bug)")
            if packed:
                splice_encoded_chunk(asm, btype, data_bits, words[i],
                                     data[off : off + int(ns[i])], bool(last[i]))
            else:
                pieces.append(
                    words[i].astype("<u4").view(np.uint8)[: (total_bits + 7) // 8].tobytes())
    return StreamResult(
        deflate=asm.take_aligned() if packed else b"".join(pieces),
        adler=native.adler32(data),
        crc32=native.crc32(data),
        isize=n % (1 << 32),
    )


def _resolve(options) -> CompressionOptions:
    if isinstance(options, Compression):
        return CompressionOptions.from_compression(options)
    return options


def deflate_bytes_conf(data: bytes, options, *, device="cuda") -> bytes:
    """Raw DEFLATE (lib.rs:137-165)."""
    return compress_stream(bytes(data), _resolve(options), device=device).deflate


def deflate_bytes(data: bytes, *, device="cuda") -> bytes:
    return deflate_bytes_conf(data, CompressionOptions.default(), device=device)


def deflate_bytes_zlib_conf(data: bytes, options, *, device="cuda") -> bytes:
    """zlib-framed DEFLATE with big-endian Adler-32 trailer (lib.rs:182-218)."""
    res = compress_stream(bytes(data), _resolve(options), device=device)
    return C.zlib_header() + res.deflate + res.adler.to_bytes(4, "big")


def deflate_bytes_zlib(data: bytes, *, device="cuda") -> bytes:
    return deflate_bytes_zlib_conf(data, CompressionOptions.default(), device=device)


def deflate_bytes_gzip_conf(data: bytes, builder: GzBuilder, options, *,
                            device="cuda") -> bytes:
    """gzip member with CRC-32 + ISIZE little-endian trailer (lib.rs:241-286)."""
    res = compress_stream(bytes(data), _resolve(options), device=device)
    return (
        builder.header_bytes()
        + res.deflate
        + res.crc32.to_bytes(4, "little")
        + res.isize.to_bytes(4, "little")
    )


def deflate_bytes_gzip(data: bytes, *, device="cuda") -> bytes:
    return deflate_bytes_gzip_conf(data, GzBuilder(), CompressionOptions.default(),
                                   device=device)
