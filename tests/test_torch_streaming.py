"""The port's streaming encoders: every case of ``tests/test_streaming.py``
with ``deflate_rs_tpu_torch.write``, bytes equal to the JAX encoders' and to
the port's one-shot output.  Tolerance: exact equality.  Each JAX reference
stream is computed once per module.
"""

import functools
import gc
import gzip
import io
import os
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu import write as jwrite  # noqa: E402
from deflate_rs_tpu_torch import CompressionOptions, GzBuilder  # noqa: E402
from deflate_rs_tpu_torch.write import DeflateEncoder, GzEncoder, ZlibEncoder  # noqa: E402

DATA_DIR = os.path.join(os.path.dirname(__file__), "data")
CPU = {"device": "cpu"}


@functools.lru_cache(maxsize=None)
def _pg11():
    with open(os.path.join(DATA_DIR, "pg11.txt"), "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def pg11():
    return _pg11()


@functools.lru_cache(maxsize=None)
def jax_one_shot(kind: str, length: int | None = None) -> bytes:
    data = _pg11()[:length]
    return {"raw": dj.deflate_bytes, "zlib": dj.deflate_bytes_zlib,
            "gzip": dj.deflate_bytes_gzip}[kind](data)


@functools.lru_cache(maxsize=None)
def port_one_shot(kind: str, length: int | None = None) -> bytes:
    data = _pg11()[:length]
    return {"raw": dt.deflate_bytes, "zlib": dt.deflate_bytes_zlib,
            "gzip": dt.deflate_bytes_gzip}[kind](data, **CPU)


def stream_compress(data, chunk_size, cls=DeflateEncoder, **kw):
    sink = io.BytesIO()
    enc = cls(sink, **CPU, **kw)
    for off in range(0, len(data), chunk_size):
        assert enc.write(data[off : off + chunk_size]) == len(data[off : off + chunk_size])
    enc.finish()
    return sink.getvalue()


def test_write_namespace():
    assert dt.write.DeflateEncoder is DeflateEncoder
    assert dt.write.gzip.GzEncoder is GzEncoder is dt.write.GzEncoder


# The reference's own split list (lib.rs:408-433) and the sizes around a chunk.
@pytest.mark.parametrize(
    "chunk_size",
    [50, 400, 1_000, 32_768, 50_000, 65_536, 65_537, 65_794, 131_072, 500_000],
)
def test_chunk_determinism(pg11, chunk_size):
    """Streaming output equals one-shot output, the port's and the JAX
    package's, for every split (lib.rs:408-433)."""
    streamed = stream_compress(pg11, chunk_size)
    assert streamed == port_one_shot("raw")
    assert streamed == jax_one_shot("raw")


def test_chunk_determinism_tiny_writes(pg11):
    data = pg11[:3000]
    assert stream_compress(data, 1) == jax_one_shot("raw", 3000)
    assert stream_compress(data, 7) == port_one_shot("raw", 3000)


def test_small_vs_full_tier_identical(pg11, monkeypatch):
    """The small-input tier gives the same bits as the full tier, one-shot
    and streamed; the tier sizes are read at call time."""
    from deflate_rs_tpu_torch.models import deflate as d

    data = pg11[:4000]
    small = dt.deflate_bytes(data, **CPU)  # the 4 KiB tier
    assert stream_compress(data, 999) == small
    monkeypatch.setattr(d, "SMALL_EMIT", 0)  # force the full tier
    assert dt.deflate_bytes(data, **CPU) == small
    assert stream_compress(data, 999) == small


def test_zlib_streaming(pg11):
    out = stream_compress(pg11, 50_000, cls=ZlibEncoder)
    assert zlib.decompress(out) == pg11
    assert out == port_one_shot("zlib") == jax_one_shot("zlib")


def test_gzip_streaming(pg11):
    out = stream_compress(pg11, 50_000, cls=GzEncoder)
    assert gzip.decompress(out) == pg11
    assert out == port_one_shot("gzip") == jax_one_shot("gzip")


def _jax_flush_stream(cls, data, cuts):
    """The JAX encoder's bytes for writes between ``cuts`` with a flush after each."""
    sink = io.BytesIO()
    enc = cls(sink)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        enc.write(data[lo:hi])
        enc.flush()
    enc.finish()
    return sink.getvalue()


def test_sync_flush_marker(pg11):
    """flush() ends byte-aligned with 00 00 FF FF (writer.rs:571-595)."""
    sink = io.BytesIO()
    enc = ZlibEncoder(sink, **CPU)
    enc.write(pg11[:10_000])
    enc.flush()
    flushed = sink.getvalue()
    assert flushed[-4:] == b"\x00\x00\xff\xff"
    d = zlib.decompressobj()
    assert d.decompress(flushed) == pg11[:10_000]  # recoverable right now
    enc.write(pg11[10_000:20_000])
    enc.flush()
    enc.finish()
    assert zlib.decompress(sink.getvalue()) == pg11[:20_000]
    assert sink.getvalue() == _jax_flush_stream(jwrite.ZlibEncoder, pg11, [0, 10_000, 20_000])


def test_flush_then_write(pg11):
    """The reference's flush-then-write regression: interleave flushes and writes (test.rs:114-136)."""
    sink = io.BytesIO()
    enc = DeflateEncoder(sink, **CPU)
    for i in range(5):
        enc.write(pg11[i * 7000 : (i + 1) * 7000])
        enc.flush()
    enc.finish()
    assert zlib.decompress(sink.getvalue(), wbits=-15) == pg11[:35_000]
    assert sink.getvalue() == _jax_flush_stream(jwrite.DeflateEncoder, pg11,
                                                [7000 * i for i in range(6)])


def test_flush_across_batched_and_single_encodes(pg11):
    """Writes large enough for the batched path between flushes: the device
    tail carried between batched encodes is dropped by the single-chunk
    encodes that every flush makes."""
    cuts = [0, 150_000, 150_001, len(pg11)]
    sink = io.BytesIO()
    enc = DeflateEncoder(sink, **CPU)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        enc.write(pg11[lo:hi])
        enc.flush()
    enc.finish()
    assert zlib.decompress(sink.getvalue(), wbits=-15) == pg11
    assert sink.getvalue() == _jax_flush_stream(jwrite.DeflateEncoder, pg11, cuts)


def test_flush_empty_then_finish():
    sink = io.BytesIO()
    enc = ZlibEncoder(sink, **CPU)
    enc.flush()
    enc.write(b"hello")
    enc.finish()
    assert zlib.decompress(sink.getvalue()) == b"hello"
    ref = io.BytesIO()
    j = jwrite.ZlibEncoder(ref)
    j.flush()
    j.write(b"hello")
    j.finish()
    assert sink.getvalue() == ref.getvalue()


@pytest.mark.parametrize("cls,jcls", [(DeflateEncoder, jwrite.DeflateEncoder),
                                      (ZlibEncoder, jwrite.ZlibEncoder),
                                      (GzEncoder, jwrite.GzEncoder)])
def test_finish_empty(cls, jcls):
    sink, ref = io.BytesIO(), io.BytesIO()
    cls(sink, **CPU).finish()
    jcls(ref).finish()
    out = sink.getvalue()
    assert out == ref.getvalue()
    if cls is DeflateEncoder:
        assert zlib.decompress(out, wbits=-15) == b""
    elif cls is ZlibEncoder:
        assert zlib.decompress(out) == b""
    else:
        assert gzip.decompress(out) == b""


def test_reset_determinism(pg11):
    """reset() gives identical fresh streams (writer.rs:539-568)."""
    data = pg11[:30_000]
    sink1 = io.BytesIO()
    enc = ZlibEncoder(sink1, **CPU)
    enc.write(data)
    enc.finish()
    sink2 = io.BytesIO()
    old = enc.reset(sink2)
    assert old is sink1
    enc.write(data)
    enc.finish()
    assert sink1.getvalue() == sink2.getvalue() == jax_one_shot("zlib", 30_000)
    assert zlib.decompress(sink2.getvalue()) == data


def test_write_after_finish_raises():
    enc = DeflateEncoder(io.BytesIO(), **CPU)
    enc.finish()
    with pytest.raises(ValueError):
        enc.write(b"x")


def test_zeros_through_writer():
    """61,000 zeros via the writer (#18, writer.rs:599-609)."""
    data = b"\x00" * 61_000
    out = stream_compress(data, 10_000, cls=ZlibEncoder, options=CompressionOptions.rle())
    assert zlib.decompress(out) == data
    assert out == dj.deflate_bytes_zlib_conf(data, dj.CompressionOptions.rle())


def test_compression_level_is_resolved(pg11):
    out = stream_compress(pg11[:20_000], 3_000, options=dt.Compression.Fast)
    assert out == dj.deflate_bytes_conf(pg11[:20_000], dj.Compression.Fast)


class ShortWriter:
    """Partial-write fault injection (the reference's SmallWriter mock,
    test.rs:175-199)."""

    def __init__(self):
        self.buf = bytearray()

    def write(self, b):
        b = bytes(b)[:3]  # accept at most 3 bytes per call
        self.buf += b
        return len(b)

    def flush(self):
        pass


def test_short_writes(pg11):
    w = ShortWriter()
    enc = ZlibEncoder(w, **CPU)
    enc.write(pg11[:20_000])
    enc.finish()
    assert bytes(w.buf) == jax_one_shot("zlib", 20_000)


class NoneWriter(ShortWriter):
    """A raw writer under backpressure: every other call accepts nothing and
    says so with None."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def write(self, b):
        self.calls += 1
        return None if self.calls % 2 else super().write(b)


def test_none_means_nothing_written(pg11):
    w = NoneWriter()
    enc = ZlibEncoder(w, **CPU)
    enc.write(pg11[:2_000])
    enc.finish()
    assert bytes(w.buf) == jax_one_shot("zlib", 2_000)


def test_context_manager(pg11):
    sink = io.BytesIO()
    with ZlibEncoder(sink, **CPU) as enc:
        enc.write(pg11[:1000])
    assert zlib.decompress(sink.getvalue()) == pg11[:1000]
    sink2 = io.BytesIO()
    with pytest.raises(RuntimeError):
        with ZlibEncoder(sink2, **CPU) as enc:
            enc.write(pg11[:1000])
            raise RuntimeError("abandon")
    assert sink2.getvalue() == b"x\x9c"  # the header alone: an exception skips finish()


class ZeroWriter:
    """A writer that never makes progress (the reference's zero-write bug class)."""

    def write(self, b):
        return 0


def test_zero_progress_writer_raises(pg11):
    """A writer that reports 0 bytes written raises instead of spinning
    forever (WriteZero analogue, test.rs:163-200)."""
    enc = ZlibEncoder(ZeroWriter(), **CPU)
    with pytest.raises(OSError):
        enc.write(pg11[:200_000])  # more than one chunk, so bytes must be emitted
    enc._finished = True  # nothing more can reach this writer: spare the finalizer


class StutterWriter:
    """Zero progress a few times, then accepts bytes (must NOT raise)."""

    def __init__(self):
        self.buf = bytearray()
        self._stall = 0

    def write(self, b):
        self._stall += 1
        if self._stall % 4 != 0:
            return 0
        b = bytes(b)[:7]
        self.buf += b
        return len(b)

    def flush(self):
        pass


def test_stuttering_writer_completes(pg11):
    w = StutterWriter()
    enc = ZlibEncoder(w, **CPU)
    enc.write(pg11[:20_000])
    enc.finish()
    assert bytes(w.buf) == jax_one_shot("zlib", 20_000)


def test_running_checksum_accessor(pg11):
    """checksum() exposes the running checksum over consumed bytes
    (writer.rs:248, writer.rs:429)."""
    enc = ZlibEncoder(io.BytesIO(), **CPU)
    assert enc.checksum() == 1  # Adler-32 of the empty string
    enc.write(pg11[:10_000])
    assert enc.checksum() == zlib.adler32(pg11[:10_000])
    enc.write(pg11[10_000:30_000])
    assert enc.checksum() == zlib.adler32(pg11[:30_000])
    enc.finish()

    g = GzEncoder(io.BytesIO(), **CPU)
    assert g.checksum() == 0
    g.write(pg11[:7_000])
    assert g.checksum() == zlib.crc32(pg11[:7_000])
    g.finish()


def test_reset_after_failed_finish_drains_to_old_writer(pg11):
    """If finish() staged the trailer but the writer failed mid-drain,
    reset() retries the drain into the OLD writer and never leaks the stale
    tail into the next stream."""

    class FlakyWriter:
        def __init__(self):
            self.buf = bytearray()
            self.fail = False

        def write(self, b):
            if self.fail:
                raise OSError("disk full")
            self.buf += bytes(b)
            return len(b)

    w1 = FlakyWriter()
    enc = ZlibEncoder(w1, **CPU)
    enc.write(pg11[:50_000])
    w1.fail = True
    with pytest.raises(OSError):
        enc.finish()
    w1.fail = False

    w2 = FlakyWriter()
    old = enc.reset(w2)
    assert old is w1
    assert bytes(w1.buf) == jax_one_shot("zlib", 50_000)
    enc.write(pg11[:10_000])
    enc.finish()
    assert zlib.decompress(bytes(w2.buf)) == pg11[:10_000]


def test_drop_skipped_during_exception_unwind(pg11):
    """Finalizing an encoder while an exception is active does not write to
    the (possibly repurposed) writer: the analogue of the reference's
    thread::panicking() guard (writer.rs:148)."""
    sink = io.BytesIO()
    enc = ZlibEncoder(sink, **CPU)
    enc.write(pg11[:90_000])
    before = sink.getvalue()
    try:
        raise RuntimeError("abort mid-stream")
    except RuntimeError:
        enc.__del__()  # finalizer with an active exception: a no-op
        assert sink.getvalue() == before
    enc.__del__()  # no active exception: best-effort finish completes it
    assert sink.getvalue() == jax_one_shot("zlib", 90_000)


def test_drop_finishes_best_effort(pg11):
    """Dropping an unfinished encoder completes the stream best-effort,
    like the reference's Drop impl (writer.rs:139-152)."""
    sink = io.BytesIO()
    enc = ZlibEncoder(sink, **CPU)
    enc.write(pg11[:90_000])
    del enc
    gc.collect()
    assert zlib.decompress(sink.getvalue()) == pg11[:90_000]


def test_gz_reset_uses_blank_builder():
    """GzEncoder.reset reverts to a blank header (writer.rs:394-399);
    reset_with_builder installs the provided one (writer.rs:401-407)."""
    s1, s2, s3 = io.BytesIO(), io.BytesIO(), io.BytesIO()
    enc = GzEncoder(s1, builder=GzBuilder().with_filename(b"a.txt"), **CPU)
    enc.write(b"first")
    old = enc.reset(s2)
    assert old is s1
    enc.write(b"second")
    enc.reset_with_builder(s3, GzBuilder().with_comment(b"hello"))
    enc.write(b"third")
    enc.finish()

    r1, r2, r3 = io.BytesIO(), io.BytesIO(), io.BytesIO()
    ref = jwrite.GzEncoder(r1, builder=dj.GzBuilder().with_filename(b"a.txt"))
    ref.write(b"first")
    ref.reset(r2)
    ref.write(b"second")
    ref.reset_with_builder(r3, dj.GzBuilder().with_comment(b"hello"))
    ref.write(b"third")
    ref.finish()

    for got, want, data in ((s1, r1, b"first"), (s2, r2, b"second"), (s3, r3, b"third")):
        assert got.getvalue() == want.getvalue()
        assert gzip.decompress(got.getvalue()) == data
    assert b"a.txt" in s1.getvalue() and b"a.txt" not in s2.getvalue()
    assert b"hello" in s3.getvalue()


def test_debug_accounting(pg11, monkeypatch):
    """DEFLATE_TPU_DEBUG=1 reconciles bytes consumed with bytes encoded over
    both the single-chunk and the batched path."""
    monkeypatch.setenv("DEFLATE_TPU_DEBUG", "1")
    sink = io.BytesIO()
    enc = DeflateEncoder(sink, **CPU)
    assert enc._core.accountant is not None
    enc.write(pg11[:140_000])
    enc.write(pg11[140_000:])
    enc.finish()
    assert enc._core.accountant.consumed == enc._core.accountant.accounted == len(pg11)
    assert sink.getvalue() == port_one_shot("raw")
    enc._core.accountant.consume(1)
    with pytest.raises(AssertionError):
        enc._core.accountant.reconcile()


# ---------------------------------------------------------------------------
# Random write splits and flush points.  Both packages read their chunk size
# when called, so a 4 KiB chunk makes a short input a stream of several
# chunks.
# ---------------------------------------------------------------------------

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

SHORT = 11_000


@settings(max_examples=15, deadline=None, derandomize=True,
          suppress_health_check=list(HealthCheck))
@given(cuts=st.lists(st.tuples(st.integers(0, SHORT), st.booleans()), max_size=7))
def test_random_splits_and_flushes(cuts):
    """Any split of the writes gives the JAX encoder's bytes under the same
    writes and flushes, and without a flush the one-shot bytes."""
    from deflate_rs_tpu.models import deflate as jd
    from deflate_rs_tpu_torch.models import deflate as td

    data = _pg11()[:SHORT]
    ops = sorted(cuts) + [(SHORT, False)]
    saved = jd.FULL_EMIT, td.FULL_EMIT
    jd.FULL_EMIT = td.FULL_EMIT = 4096
    try:
        outs = []
        for cls, kw in ((ZlibEncoder, CPU), (jwrite.ZlibEncoder, {})):
            sink = io.BytesIO()
            enc = cls(sink, **kw)
            at = 0
            for cut, flush in ops:
                enc.write(data[at:cut])
                at = cut
                if flush:
                    enc.flush()
            enc.finish()
            outs.append(sink.getvalue())
        assert outs[0] == outs[1]
        assert zlib.decompress(outs[0]) == data
        if not any(flush for _, flush in ops):
            assert outs[0] == dt.deflate_bytes_zlib(data, **CPU)
    finally:
        jd.FULL_EMIT, td.FULL_EMIT = saved
