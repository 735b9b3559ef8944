"""Streaming encoder writers: DeflateEncoder / ZlibEncoder / GzEncoder.

Port of ``deflate_rs_tpu/models/streaming.py``, the counterpart of the
reference's ``write`` module (writer.rs:89/183/331) with the same surface:
``write`` / ``flush`` (sync flush) / ``finish`` / ``reset``, plus Python
context-manager support.  Bytes are buffered until a full chunk (64 KiB)
*plus one byte* is available: the extra byte guarantees that a chunk is
encoded as non-final only when data provably follows it, which makes
streaming output byte-identical to one-shot output for any split of the
writes (the chunk-determinism invariant, lib.rs:408-433).  Consecutive chunks
are bit-spliced (models/assembly.py): sync markers appear only on an explicit
``flush()``, exactly the reference's framing.

``flush()`` compresses everything buffered and ends byte-aligned with the
empty-stored-block sync marker ``00 00 FF FF`` (compress.rs:257-262); writing
can continue afterwards with the full match history kept across the flush.

Every encoder takes ``device`` (default ``"cuda"``).  A write that completes
two or more chunks encodes them through the corpus engine's pipeline
(parallel/corpus.py) in batches of up to its batch size; anything else is one
single-chunk device call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..compression_options import Compression, CompressionOptions
from ..ops.chunk_encode import HALO, PAD
from ..ops.compaction import used_words_host
from ..runtime import native
from ..utils.debug import ByteAccountant, enabled as debug_enabled
from .assembly import BitAssembler, splice_encoded_chunk
from . import deflate as _deflate  # chunk sizes are read at call time (see feed)
from .deflate import _resolve, get_chunk_encoder
from .gzip_header import GzBuilder

# An empty final fixed block: 3-bit header 0b011 + 7-bit EOB code 0 (10 bits,
# spliced at any phase by the assembler).  The sync-flush marker has a single
# source of truth: BitAssembler.append_sync_marker (it is phase-dependent).
FINAL_EMPTY_BLOCK = b"\x03\x00"


# How many consecutive zero-byte writes _drain tolerates before raising
# (the analogue of std::io::ErrorKind::WriteZero; the reference's zero-write bug class,
# tests/test.rs:163-200: a throttled writer must not spin forever).
MAX_ZERO_WRITES = 16


class _DeflateCore:
    """Shared chunked-compression state machine."""

    def __init__(self, options: CompressionOptions, device):
        self.options = options
        self.device = torch.device(device)
        self.reset_state()

    def reset_state(self):
        self.pending = bytearray()
        self.history = b""
        self.total_in = 0
        self.started = False  # any chunk emitted yet?
        # Device-resident copy of the last HALO history bytes, carried
        # between batched encodes so that consecutive feed() calls skip the
        # 32 KiB history upload.  None = stale (a single-chunk _encode ran,
        # or nothing is encoded yet): the next batched encode uploads it
        # from self.history.
        self._tail_dev = None
        # Running checksums over consumed bytes, updated on the host
        # (native C, runtime/native.py).
        self.adler_v = 1
        self.crc_v = 0
        # Persistent bit-phase assembler: consecutive chunks are spliced at
        # arbitrary bit phase (no per-chunk sync markers), so streaming output
        # is byte-identical to the one-shot packed stream.  The partial tail
        # byte lives here between write() calls.
        self.asm = BitAssembler(_deflate.FULL_EMIT + (_deflate.FULL_EMIT >> 3) + 4096)
        self.accountant = ByteAccountant() if debug_enabled() else None

    def _encode(self, payload: bytes, is_last: bool) -> None:
        """Encode one chunk and splice it into the assembler."""
        SMALL_EMIT, FULL_EMIT = _deflate.SMALL_EMIT, _deflate.FULL_EMIT
        small = not self.started and not payload[SMALL_EMIT:] and is_last
        emit = SMALL_EMIT if small else FULL_EMIT
        encoder = get_chunk_encoder(self.options, emit, str(self.device))
        buf = np.zeros((1, HALO + emit + PAD), dtype=np.uint8)
        hist = self.history[-HALO:]
        if hist:
            buf[0, HALO - len(hist) : HALO] = np.frombuffer(hist, np.uint8)
        if payload:
            buf[0, HALO : HALO + len(payload)] = np.frombuffer(payload, np.uint8)
        with torch.no_grad():
            out = encoder(torch.from_numpy(buf).to(self.device), torch.tensor([len(hist)]),
                          torch.tensor([len(payload)]), torch.tensor([is_last]))
            # Two small fetches: the meta, then the words the splicer reads.
            total_bits, btype, data_bits = (int(v) for v in torch.stack(
                [out["total_bits"][0], out["btype"][0], out["data_bits"][0]]).cpu())
            if total_bits > out["words"].shape[1] * 32:
                raise RuntimeError(
                    f"encoder overflow: {total_bits} bits exceeds the "
                    f"{out['words'].shape[1] * 32}-bit word buffer (bug: the buffer is "
                    "sized for the worst legal output)")
            used = int(used_words_host(btype, data_bits))
            words = out["words"][0, :used].to(torch.int32).cpu().numpy()
        emitted = splice_encoded_chunk(self.asm, btype, data_bits, words.view(np.uint8),
                                       payload, is_last)
        if self.accountant is not None:
            self.accountant.account_chunk(len(payload), emitted, is_last)
        self.history = (self.history + payload)[-HALO:]
        self._tail_dev = None  # the device tail no longer matches self.history
        self.started = True

    def _encode_batch(self, nfull: int, E: int) -> None:
        """Encode ``nfull`` complete chunks of the backlog through the corpus
        engine's pipeline, in batches of up to its batch size, splicing in
        order: one large write() pays a few batched device calls, with the
        host's fetch and splice of a batch under the device's encode of the
        next ones, instead of ``nfull`` single-chunk round trips."""
        from ..parallel import corpus

        inflight = []
        hist0 = len(self.history)
        with corpus.borrow_pipeline(self.options, E, str(self.device), corpus.BATCH_SIZE,
                                     corpus.QUEUE_DEPTH, True) as pipe:
            pipe.start(self.history, self._tail_dev)

            def drain_one():
                g, payload = inflight.pop(0)
                meta, words, used = pipe.fetch_next()
                woff = np.cumsum(used) - used
                for i in range(g):
                    stored = int(meta[1, i]) == C.BTYPE_STORED
                    emitted = splice_encoded_chunk(
                        self.asm, int(meta[1, i]), int(meta[2, i]),
                        words[4 * woff[i] : 4 * (woff[i] + used[i])],
                        payload[i * E : (i + 1) * E] if stored else b"", False)
                    if self.accountant is not None:
                        self.accountant.account_chunk(E, emitted, False)

            done = 0
            while done < nfull:
                g = min(nfull - done, corpus.BATCH_SIZE)
                payload = bytes(self.pending[: g * E])
                del self.pending[: g * E]
                hist = [HALO] * g  # E >= HALO: full history after the first chunk
                hist[0] = min(hist0 + done * E, HALO)
                pipe.submit(np.frombuffer(payload, np.uint8), hist, [E] * g, [False] * g)
                inflight.append((g, payload))
                self.history = payload[-HALO:]
                done += g
                if len(inflight) > corpus.QUEUE_DEPTH:
                    drain_one()
            while inflight:
                drain_one()
            self._tail_dev = pipe.tail
        self.started = True

    def feed(self, data) -> list[bytes]:
        """Buffer input; emit compressed bytes for every complete chunk."""
        data = bytes(data)
        self.pending += data
        # Checksums cover bytes the moment write() accepts them, the
        # reference's semantics (writer.rs:258-265 checksums &buf[..n] with
        # n = write's return), observable via the checksum() accessor before
        # a chunk boundary is reached.
        self.adler_v = native.adler32(data, self.adler_v)
        self.crc_v = native.crc32(data, self.crc_v)
        self.total_in += len(data)
        if self.accountant is not None:
            self.accountant.consume(len(data))
        # Complete chunks ready to encode, always holding one byte back: a
        # chunk is encoded as non-final only when data provably follows it
        # (the chunk-determinism invariant).  FULL_EMIT is read at call time
        # (not bound at import) so that a changed chunk size keeps streaming
        # and one-shot output in step.
        E = _deflate.FULL_EMIT
        nfull = (len(self.pending) - 1) // E if self.pending else 0
        if nfull >= 2 and E >= HALO:
            self._encode_batch(nfull, E)
        else:
            while len(self.pending) > E:
                payload = bytes(self.pending[:E])
                del self.pending[:E]
                self._encode(payload, is_last=False)
        return [self.asm.drain_whole_bytes()]

    def sync_flush(self) -> list[bytes]:
        if self.pending:
            payload = bytes(self.pending)
            self.pending.clear()
            self._encode(payload, is_last=False)
        self.started = True  # a bare marker still yields a resumable stream
        # Empty stored block at the current phase: byte-aligns the stream
        # (compress.rs:257-262), leaving the assembler with no partial byte.
        self.asm.append_sync_marker()
        return [self.asm.drain_whole_bytes()]

    def finish_stream(self) -> list[bytes]:
        payload = bytes(self.pending)
        self.pending.clear()
        if payload or not self.started:
            self._encode(payload, is_last=True)
        else:
            # Data already emitted as non-final chunks: close with an empty
            # final fixed block at the current bit phase (header 0b011 +
            # 7-bit EOB code 0).
            self.asm.append(FINAL_EMPTY_BLOCK, 10)
        if self.accountant is not None:
            self.accountant.reconcile()
        return [self.asm.take_aligned_drain()]


class DeflateEncoder:
    """Raw-DEFLATE streaming encoder (writer.rs:89)."""

    def __init__(self, writer, options: CompressionOptions | Compression | None = None, *,
                 device="cuda"):
        self._writer = writer
        self._core = _DeflateCore(_resolve(options or CompressionOptions.default()), device)
        self._finished = False
        self._header_written = False
        # Bytes accepted by the encoder but not yet accepted by the wrapped
        # writer.  A failed write leaves the remainder here, so a retried
        # flush()/finish() resumes exactly where the writer stopped: in
        # particular the gzip trailer can never be half-emitted and then
        # lost (writer.rs:409-426 buffers it for the same reason).
        self._outbuf = bytearray()

    # -- framing hooks ----------------------------------------------------

    def _header(self) -> bytes:
        return b""

    def _trailer(self) -> bytes:
        return b""

    # -- io.Write surface -------------------------------------------------

    def _drain(self):
        """Write everything in _outbuf, tolerating partial writes
        (compress_until_done, writer.rs:15-58).  A writer that repeatedly
        reports zero progress raises instead of looping forever (the
        WriteZero analogue; the reference's zero-write bug class, tests/test.rs:163)."""
        zero_streak = 0
        while self._outbuf:
            written = self._writer.write(memoryview(self._outbuf))
            if written is None:
                # Only RawIOBase returns None, and there it means NOTHING
                # was accepted (non-blocking backpressure), never "all of
                # it" (BufferedIOBase raises BlockingIOError instead of
                # returning None).  Treating it as complete would silently
                # drop the compressed tail.
                written = 0
            if written == 0:
                zero_streak += 1
                if zero_streak >= MAX_ZERO_WRITES:
                    raise OSError("writer made no progress (wrote 0 bytes repeatedly)")
                continue
            zero_streak = 0
            del self._outbuf[:written]

    def _emit(self, pieces):
        if not self._header_written:
            self._outbuf += self._header()
            self._header_written = True
        for p in pieces:
            self._outbuf += p
        self._drain()

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("write after finish()")
        self._emit(self._core.feed(data))
        return len(data)

    def flush(self):
        """Sync flush: compress all buffered input, end byte-aligned with the
        00 00 FF FF marker, and flush the wrapped writer."""
        if self._finished:
            return
        self._emit(self._core.sync_flush())
        if hasattr(self._writer, "flush"):
            self._writer.flush()

    def finish(self):
        """Terminate the stream (BFINAL + trailer); returns the inner writer.

        If the wrapped writer fails mid-write, the unwritten tail (including
        the trailer) stays buffered and a subsequent finish() retries it."""
        if not self._finished:
            # Stage final block + trailer fully before touching the writer so
            # a write failure can be retried without re-consuming core state.
            if not self._header_written:
                self._outbuf += self._header()
                self._header_written = True
            for p in self._core.finish_stream():
                self._outbuf += p
            self._outbuf += self._trailer()
            self._finished = True
        self._drain()
        return self._writer

    def reset(self, writer):
        """Start a fresh stream into ``writer``; returns the old writer.

        Matches the reference's reset semantics exactly: ``reset`` runs
        ``output_all`` first, which for the zlib/gzip encoders *includes* the
        trailer (writer.rs:205-214: ZlibEncoder::output_all calls
        write_trailer; writer.rs:370-375 likewise for gzip), so the old
        writer holds a complete, valid stream.

        finish() is called unconditionally: if a previous finish() staged
        the final block + trailer but the writer failed mid-drain, the
        staged tail is still in the output buffer and must reach the OLD
        writer (retry); otherwise it would corrupt the next stream."""
        self.finish()
        old, self._writer = self._writer, writer
        self._core.reset_state()
        self._finished = False
        self._header_written = False
        return old

    # -- conveniences ------------------------------------------------------

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.finish()
        return False

    def __del__(self):
        """Best-effort finish on drop, like the reference's Drop impl
        (writer.rs:139-152: output_all unless already panicking).  Errors
        are swallowed: an unfinished encoder being collected must never
        raise; call finish() explicitly to observe failures.  Skipped while
        an exception is propagating (the ``thread::panicking()`` analogue):
        an encoder abandoned during unwinding must not write a compressed
        tail into a writer the error handler may be repurposing."""
        try:
            import sys  # inside try: fails (harmlessly) at interpreter teardown
            if sys.exc_info()[0] is not None or sys.is_finalizing():
                # Active exception: the panicking-guard analogue.  Interpreter
                # shutdown: a device encode from a finalizer could hang.
                return
            if getattr(self, "_finished", True) is False:
                # Like the reference's Drop, a never-written encoder still
                # emits a valid EMPTY stream (header + final block + trailer).
                self.finish()
        except Exception:
            pass


class ZlibEncoder(DeflateEncoder):
    """zlib-framed streaming encoder (writer.rs:183).

    The Adler-32 trailer covers exactly the bytes consumed
    (writer.rs:253-267 semantics).
    """

    def _header(self) -> bytes:
        return C.zlib_header()

    def checksum(self) -> int:
        """Running Adler-32 over the bytes consumed so far (writer.rs:248)."""
        return self._core.adler_v

    def _trailer(self) -> bytes:
        return self._core.adler_v.to_bytes(4, "big")


class GzEncoder(DeflateEncoder):
    """gzip-framed streaming encoder (writer.rs:331), with builder support."""

    def __init__(self, writer, options=None, builder: GzBuilder | None = None, *,
                 device="cuda"):
        super().__init__(writer, options, device=device)
        self._builder = builder or GzBuilder()

    def _header(self) -> bytes:
        return self._builder.header_bytes()

    def reset(self, writer):
        """Reset to a fresh stream with a *blank* gzip header, matching the
        reference (writer.rs:394-399: ``self.header = GzBuilder::new()``)."""
        old = super().reset(writer)
        self._builder = GzBuilder()
        return old

    def reset_with_builder(self, writer, builder: GzBuilder):
        """Reset using ``builder`` for the next stream's header
        (writer.rs:401-407)."""
        old = super().reset(writer)
        self._builder = builder
        return old

    def checksum(self) -> int:
        """Running CRC-32 over the bytes consumed so far (writer.rs:429)."""
        return self._core.crc_v

    def _trailer(self) -> bytes:
        return self._core.crc_v.to_bytes(4, "little") + (
            self._core.total_in % (1 << 32)
        ).to_bytes(4, "little")
