"""Batched one-shot compression for large inputs: the corpus engine.

Port of ``deflate_rs_tpu/parallel/corpus.py``.  Many chunks are encoded per
device call; the host uploads only payload bytes, fetches only the words it
will splice, and splices one batch while the next ones are encoded.  The
bytes equal ``models.deflate.compress_stream``'s chunk-batch engine.

How a batch moves on a CUDA device:

* **upload**: exactly ``B * E`` payload bytes, from pinned host memory, on a
  copy stream (``non_blocking``).  Each chunk's 32 KiB of history is cut on
  the device from the bytes before it; the last 32 KiB of a batch stay on the
  device as the next batch's history and are never uploaded again.
* **encode**: ``ChunkEncoder`` on the current stream, after the upload's
  event; then the used-prefix compaction of ``ops/compaction.py``.
* **fetch**: on a third stream, after the encode's event: the ``(3, B)``
  int32 meta first (total bits, block type, data bits), then, once the host
  knows how many words the batch used, that prefix of the compacted buffer
  as one copy into pinned memory.
* **splice**: on the host, in order, while up to ``queue_depth`` later
  batches are queued or running on the device.

On the CPU the same steps run one after the other.  With
``DEFLATE_TPU_TRACE_CORPUS=1`` the five steps are ``torch.profiler``
ranges (``corpus.upload``, ``corpus.encode``, ``corpus.meta_fetch``,
``corpus.words_fetch``, ``corpus.splice``), and the same switch opens the
chunk encoder's stage ranges inside ``corpus.encode`` (``encoder.lz77`` to
``encoder.checksums``, one each a batch): ``runtime/trace.py``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import threading

import numpy as np
import torch
from torch import nn

from .. import constants as C
from ..compression_options import Compression, CompressionOptions
from ..models import deflate as _deflate  # FULL_EMIT is read at call time
from ..models.assembly import BitAssembler, splice_encoded_chunk
from ..models.deflate import StreamResult, _resolve
from ..models.gzip_header import GzBuilder
from ..ops.chunk_encode import HALO, PAD, ChunkEncoder
from ..ops.compaction import compact_words_device, used_words_device, used_words_host
from ..runtime import native
from ..runtime.trace import span

# Chunks per device call and batches in flight, from chip_smoke.py's runs over
# its 16 MiB mix on an NVIDIA H100 80GB HBM3 (700.00 W), PERF.md section 6:
# the host's launches bound a run, their number falls with the batches, and
# 64 chunks a batch ran at 50-61 MB/s against 33-52 at 32 and 15-26 at 16.
# Queue depths 1 and 3 read alike at every batch size (a deeper queue is
# unproven there), so the depth is the one that pins the least staging memory.
# Device memory grows with the payload bytes of a batch, about 0.28 GiB a MiB
# (64 chunks of 1 MiB peak at about 18 GiB at Default and at high:
# ``tools/corpus_memory.py`` and ``chip_smoke.py``, PERF.md section 6), so
# without a ``batch_size`` from the caller a batch holds at most
# ``BATCH_PAYLOAD_BYTES`` of payload: 64 chunks up to 1 MiB, 32 of 2 MiB, 16
# of 4 MiB, 8 of 8 MiB, 4 of 16 MiB, 2 of 32 MiB (``default_batch_size``).
BATCH_SIZE = 64
BATCH_PAYLOAD_BYTES = 64 << 20
QUEUE_DEPTH = 1

# Chunk sizes: multiples of 16 (the JAX package's rule, from the row count
# its parse kernel reshapes the emit region to) up to 32 MiB.  There a block
# holds at most 2**25 + 1 symbols: the block-split proxy's switch table
# covers its range totals (``ops/proxy.py``: ``TOT_MAX``), and package-merge's
# int32 package sums stay under their clamp (``ops/package_merge.py``:
# ``MAX_ROW_SUM``; twice the chunk would pass it).  The presets add rules of
# their own; see ``check_chunk_size``.
CHUNK_GRANULE = 16
MAX_CHUNK_SIZE = 1 << 25

# Pipelines kept between calls, over all configurations together: each pins
# ``queue_depth + 1`` staging and result buffers of a whole batch.
POOL_MAX = 4


class CorpusResult(StreamResult):
    """A stream, its checksums, and what its run fetched from the device:
    ``fetched`` counts the batches and the bytes of their meta and words."""

    __slots__ = ("fetched",)

    def __init__(self, deflate: bytes, adler: int, crc32: int, isize: int, fetched: dict):
        super().__init__(deflate, adler, crc32, isize)
        self.fetched = fetched


def check_chunk_size(E: int, options: CompressionOptions) -> None:
    """Raise ``ValueError`` unless the encoder takes chunks of ``E`` bytes at
    the resolved ``options``: exactly the sizes up to ``MAX_CHUNK_SIZE`` at
    which the JAX package's ``compress_corpus`` gives a stream.

    Default and high reach their own end below the cap: the long-range
    pass's harvest row, ``(32,768 + E) / segments / 2`` positions, must stay
    below 2**15, so Default (64 segments) takes chunks up to 4,161,280 bytes
    and high (32) up to 2,064,128, and a raised ``dom_segs`` moves that end
    (512 segments reach 16 MiB, 1,024 the cap); the presets without that
    pass take any size up to the cap.  A block of a 32 MiB chunk holds at
    most 2**25 symbols, a frequency package-merge is proven at
    (``ops/package_merge.py``)."""
    if E <= 0 or E % CHUNK_GRANULE:
        raise ValueError(
            f"chunk_size must be a positive multiple of {CHUNK_GRANULE}, got {E}: the "
            f"JAX package's parse kernel reshapes a chunk into {CHUNK_GRANULE} rows")
    if E > MAX_CHUNK_SIZE:
        raise ValueError(
            f"chunk_size must be at most {MAX_CHUNK_SIZE}, got {E}: the block-split "
            "proxy's switch table and package-merge's int32 package sums cover the "
            "symbol totals of chunks up to that size")
    nq = options.num_quarters
    if E % nq:
        raise ValueError(
            f"chunk_size {E} must divide by the {nq} quarters of these options' block "
            "split: the split scores quarters of equal length")
    if options.matcher_mode != "hash" or not options.use_long_range:
        return
    N, S = HALO + E, options.resolved_dom_segs
    if options.lr_global:
        if N % S or (options.resolved_lr_pair and N // S % 2):
            raise ValueError(
                f"chunk_size {E} plus its {HALO} bytes of history must divide into the "
                f"{S} harvest segments of the long-range pass"
                + (", each of an even length (the harvest takes positions in pairs)"
                   if options.resolved_lr_pair else ""))
    elif N % (4 * S):
        raise ValueError(
            f"chunk_size {E} plus its {HALO} bytes of history must divide by {4 * S}: "
            f"the long-range pass measures {S} segments of whole 4-byte words")
    row = N // S // 2 if options.resolved_lr_pair else -(-(N // S) // options.resolved_lr_stride)
    if row >= 1 << 15:
        raise ValueError(
            f"chunk_size {E}: the long-range pass's dominant-selection rows of {row} "
            "harvested positions overflow its packed freq << 16 sort; raise dom_segs or "
            "lr_stride")


class FlatCorpusEncoder(nn.Module):
    """``ChunkEncoder`` over a flat payload, with on-device history windows.

    ``compact=True`` packs the used word prefixes into one flat int32 buffer
    (stored chunks keep none, so the encoder packs no stored fields);
    ``compact=False`` returns whole int32 rows, stored chunks included, for
    the byte-aligned framing."""

    def __init__(self, options: CompressionOptions, emit_size: int, compact: bool = True):
        super().__init__()
        self.E = emit_size
        self.compact = compact
        self.encoder = ChunkEncoder(options, emit_size, stored_payload_fields=not compact)

    def forward(self, payload, prev_tail, hist, ns, lasts):
        """Encode ``payload`` uint8[B * E] whose 32 KiB of history are
        ``prev_tail`` uint8[HALO] (zeros before the start of the stream).

        Returns (meta int32[3, B] of total bits, block type and data bits;
        the compacted int32[B * NW] buffer or the int32[B, NW] rows; the
        next batch's ``prev_tail``)."""
        E = self.E
        full = torch.cat([prev_tail, payload])
        bufs = torch.nn.functional.pad(full.unfold(0, HALO + E, E), (0, PAD))
        out = self.encoder(bufs, hist, ns, lasts)
        meta = torch.stack([out["total_bits"], out["btype"], out["data_bits"]]).int()
        if self.compact:
            words = compact_words_device(out["words"], used_words_device(meta[1], meta[2]))
        else:
            words = out["words"].to(torch.int32)
        return meta, words, full[-HALO:].clone()


@functools.lru_cache(maxsize=32)
def corpus_encoder_flat(options: CompressionOptions, emit_size: int, device: str,
                        compact: bool = True) -> FlatCorpusEncoder:
    """The flat encoder of one configuration on ``device`` (shared with the
    streaming encoders' batched path)."""
    return FlatCorpusEncoder(options, emit_size, compact).to(device)


def history_tail(history: bytes, device) -> torch.Tensor:
    """uint8[HALO] on ``device``: ``history`` right-aligned, zeros before."""
    tail = np.zeros(HALO, np.uint8)
    h = history[-HALO:]
    if h:
        tail[HALO - len(h):] = np.frombuffer(h, np.uint8)
    return torch.from_numpy(tail).to(device)


class _Slot:
    """Host buffers and device results of one batch in flight.  On a CUDA
    device the buffers are pinned; on the CPU only the staging buffer exists
    (the results are host tensors already)."""

    def __init__(self, payload_bytes: int, words: int, batch: int, cuda: bool):
        self.stage = torch.empty(payload_bytes, dtype=torch.uint8, pin_memory=cuda)
        if cuda:
            self.meta = torch.empty((3, batch), dtype=torch.int32, pin_memory=True)
            self.words = torch.empty(words, dtype=torch.int32, pin_memory=True)
            self.meta_ready = torch.cuda.Event()
        self.meta_d = self.words_d = None


class BatchPipeline:
    """Upload, encode and fetch batches of whole chunks with up to
    ``queue_depth`` batches in flight; results come back in order.

    ``submit`` queues one batch, ``fetch_next`` waits for the oldest one.  On
    a CUDA device the three steps run on three streams ordered by events; on
    the CPU they run at once.  One pipeline serves one stream of input at a
    time (the history tail is carried from batch to batch)."""

    def __init__(self, options: CompressionOptions, emit_size: int, device, *,
                 batch_size: int, queue_depth: int, compact: bool = True):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.E = emit_size
        self.batch_size = batch_size
        self.compact = compact
        self.encoder = corpus_encoder_flat(options, emit_size, str(self.device), compact)
        nw = self.encoder.encoder.num_words
        self.slots = [_Slot(batch_size * emit_size, batch_size * nw, batch_size, self.cuda)
                      for _ in range(queue_depth + 1)]
        self.queue = collections.deque()
        self.submitted = 0
        self.tail = None
        if self.cuda:
            self.copy_stream = torch.cuda.Stream(self.device)
            self.fetch_stream = torch.cuda.Stream(self.device)

    def start(self, history: bytes = b"", tail: torch.Tensor | None = None) -> None:
        """Begin a run of batches whose previous bytes are ``history``, or
        whose history is ``tail``, the device-resident ``self.tail`` that an
        earlier run over the same stream of input left behind.  ``self.fetched``
        counts the run's batches and the bytes fetched for them."""
        if self.queue:
            raise RuntimeError("a batch is still in flight")
        self.fetched = {"batches": 0, "meta_bytes": 0, "words_bytes": 0}
        self.tail = history_tail(history, self.device) if tail is None else tail

    def submit(self, payload: np.ndarray, hist, ns, lasts) -> None:
        """Queue ``len(ns)`` chunks whose bytes are ``payload`` (zero-filled
        up to a whole number of chunks here)."""
        B = len(ns)
        if len(self.queue) >= len(self.slots) or B > self.batch_size:
            raise RuntimeError("too many batches in flight or too many chunks in a batch")
        slot = self.slots[self.submitted % len(self.slots)]
        self.submitted += 1
        nbytes = B * self.E
        with span("corpus.upload"):
            stage = slot.stage[:nbytes]
            host = stage.numpy()  # shares the (pinned) memory
            host[: len(payload)] = payload
            host[len(payload):] = 0
            if self.cuda:
                compute = torch.cuda.current_stream(self.device)
                with torch.cuda.stream(self.copy_stream):
                    payload_d = stage.to(self.device, non_blocking=True)
                payload_d.record_stream(compute)
                compute.wait_stream(self.copy_stream)
            else:
                payload_d = stage.clone()
        with span("corpus.encode"), torch.no_grad():
            slot.meta_d, slot.words_d, self.tail = self.encoder(
                payload_d, self.tail, torch.as_tensor(hist), torch.as_tensor(ns),
                torch.as_tensor(lasts))
        if self.cuda:
            self.fetch_stream.wait_stream(compute)
            with torch.cuda.stream(self.fetch_stream):
                slot.meta[:, :B].copy_(slot.meta_d, non_blocking=True)
                slot.meta_ready.record()
        self.queue.append((slot, B))

    def fetch_next(self):
        """(meta int32[3, B], words, used) of the oldest batch in flight.

        Compacted: ``words`` is the uint8 view of the used words of all its
        chunks and ``used`` their counts.  Otherwise ``words`` is
        uint8[B, 4 * NW] and ``used`` is None.  The arrays are views of
        buffers that the batch after next ``queue_depth`` submits reuses."""
        slot, B = self.queue.popleft()
        with span("corpus.meta_fetch"):
            if self.cuda:
                slot.meta_ready.synchronize()
                meta = slot.meta[:, :B].numpy()
            else:
                meta = slot.meta_d.numpy()
        if self.compact:
            used = used_words_host(meta[1], meta[2])
            need = int(used.sum())
        else:
            used, need = None, slot.words_d.numel()
        with span("corpus.words_fetch"):
            if self.cuda:
                with torch.cuda.stream(self.fetch_stream):
                    slot.words[:need].copy_(slot.words_d.reshape(-1)[:need], non_blocking=True)
                self.fetch_stream.synchronize()
                words = slot.words[:need].numpy()
            else:
                words = slot.words_d.reshape(-1)[:need].numpy()
        slot.meta_d = slot.words_d = None
        self.fetched["batches"] += 1
        self.fetched["meta_bytes"] += meta.nbytes
        self.fetched["words_bytes"] += words.nbytes
        words = words.view(np.uint8)
        return meta, (words if self.compact else words.reshape(B, -1)), used


_pipelines: list = []  # (key, pipeline) not in use, oldest first
_pipelines_lock = threading.Lock()


@contextlib.contextmanager
def borrow_pipeline(*key):
    """A pipeline of this configuration for one call: pinned buffers and
    streams are kept between calls, at most ``POOL_MAX`` pipelines in all,
    and two threads never share one."""
    with _pipelines_lock:
        held = [i for i, (k, _) in enumerate(_pipelines) if k == key]
        pipe = _pipelines.pop(held[-1])[1] if held else None
    if pipe is None:
        options, E, device, batch_size, queue_depth, compact = key
        pipe = BatchPipeline(options, E, device, batch_size=batch_size,
                             queue_depth=queue_depth, compact=compact)
    yield pipe
    # Reached only when the caller's block ended without an exception: a
    # pipeline that may still have batches in flight is dropped, not reused.
    with _pipelines_lock:
        _pipelines.append((key, pipe))
        del _pipelines[:-POOL_MAX]


def chunk_options(options: CompressionOptions, chunk_size: int) -> CompressionOptions:
    """The resolved ``options`` the encoder runs at chunks of ``chunk_size``
    bytes: above 64 KiB the matcher's chain budget is scaled with the chunk
    size (``chain_scale``), as in the JAX package's ``compress_corpus``.  The
    sharded encoder gives these bytes when it is built with them."""
    if chunk_size > _deflate.FULL_EMIT and options.max_hash_checks:
        return dataclasses.replace(options, chain_scale=max(1, chunk_size // _deflate.FULL_EMIT))
    return options


def default_batch_size(chunk_size: int) -> int:
    """Chunks a batch when the caller names no ``batch_size``: ``BATCH_SIZE``,
    or fewer where that many chunks would pass ``BATCH_PAYLOAD_BYTES``."""
    return min(BATCH_SIZE, max(1, BATCH_PAYLOAD_BYTES // chunk_size))


def compress_corpus(
    data: bytes,
    options: CompressionOptions | Compression | None = None,
    *,
    batch_size: int | None = None,
    packed: bool = True,
    queue_depth: int = QUEUE_DEPTH,
    chunk_size: int | None = None,
    device="cuda",
) -> CorpusResult:
    """Compress ``data`` as one DEFLATE stream using batched device encodes.

    ``packed`` bit-splices blocks marker-free on the host (identical output
    to ``models.deflate.compress_stream``); ``packed=False`` keeps every
    chunk byte-aligned behind a sync marker.

    Up to ``queue_depth`` batches of ``batch_size`` chunks stay in flight, so
    the host's fetch and splice of batch i overlap the device's encode of the
    batches after it.  Without a ``batch_size`` a batch holds
    :func:`default_batch_size` chunks (64, or 64 MiB of payload at chunks
    above 1 MiB); the bytes do not depend on it.

    ``chunk_size`` is the per-chunk block granularity (the analogue of
    pigz's block size); the default is the one-shot path's 64 KiB and gives
    its bytes exactly.  Larger chunks (up to 32 MiB) spread the fixed 32 KiB
    of history and the per-chunk tables over more payload; the sizes taken
    are those of :func:`check_chunk_size` at ``options``.  The suffix-order
    matcher's candidate neighbourhoods dilute as the chunk grows, so the
    chain budget is scaled with the chunk size, as in the JAX package.
    """
    options = _resolve(options or CompressionOptions.default())
    n = len(data)
    E = int(_deflate.FULL_EMIT if chunk_size is None else chunk_size)
    check_chunk_size(E, options)
    if batch_size is None:
        batch_size = default_batch_size(E)
    if batch_size < 1 or queue_depth < 1:
        raise ValueError(f"batch_size and queue_depth must be positive, got {batch_size}, "
                         f"{queue_depth}")
    options = chunk_options(options, E)

    offsets = list(range(0, n, E)) if n else [0]
    arr = np.frombuffer(data, np.uint8)
    asm = BitAssembler(n + n // 128 + 4096) if packed else None
    pieces = []
    inflight = collections.deque()  # (group, ns, lasts) of the batches in flight

    def drain_one(pipe):
        group, ns, lasts = inflight.popleft()
        meta, words, used = pipe.fetch_next()
        with span("corpus.splice"):
            if packed:
                woff = np.cumsum(used) - used
                for i, off in enumerate(group):
                    stored = int(meta[1, i]) == C.BTYPE_STORED
                    splice_encoded_chunk(
                        asm, int(meta[1, i]), int(meta[2, i]),
                        words[4 * woff[i] : 4 * (woff[i] + used[i])],
                        # The splicer reads the payload of stored chunks only.
                        data[off : off + ns[i]] if stored else b"", lasts[i])
            else:
                nbytes = (meta[0].astype(np.int64) + 7) // 8
                if int(nbytes.max()) > words.shape[1]:
                    raise RuntimeError(
                        f"encoder overflow: {int(nbytes.max())} B exceeds the "
                        f"{words.shape[1]} B word buffer (bug)")
                pieces.append(native.assemble_chunks(words, nbytes))

    with borrow_pipeline(options, E, str(torch.device(device)), batch_size, queue_depth,
                          packed) as pipe:
        pipe.start()
        for base in range(0, len(offsets), batch_size):
            group = offsets[base : base + batch_size]
            ns = [min(n - off, E) for off in group]
            lasts = [off + ln >= n for off, ln in zip(group, ns)]
            hist = [min(off, HALO) for off in group]
            pipe.submit(arr[group[0] : group[-1] + E], hist, ns, lasts)
            inflight.append((group, ns, lasts))
            if len(inflight) > queue_depth:
                drain_one(pipe)
        while inflight:
            drain_one(pipe)
        fetched = pipe.fetched

    return CorpusResult(
        deflate=asm.take_aligned() if packed else b"".join(pieces),
        adler=native.adler32(data),
        crc32=native.crc32(data),
        isize=n % (1 << 32),
        fetched=fetched,
    )


def compress_corpus_zlib(data: bytes, options=None, *, batch_size: int | None = None,
                         device="cuda") -> bytes:
    res = compress_corpus(data, options, batch_size=batch_size, device=device)
    return C.zlib_header() + res.deflate + res.adler.to_bytes(4, "big")


def compress_corpus_gzip(data: bytes, options=None, *, builder: GzBuilder | None = None,
                         batch_size: int | None = None, device="cuda") -> bytes:
    res = compress_corpus(data, options, batch_size=batch_size, device=device)
    return (
        (builder or GzBuilder()).header_bytes()
        + res.deflate
        + res.crc32.to_bytes(4, "little")
        + res.isize.to_bytes(4, "little")
    )
