"""The port's corpus engine against the JAX engine's bytes.

The four cases of ``tests/test_corpus.py`` (a mix across block types, empty
and small inputs, the compaction's edge shapes, 256 KiB chunks), each held
byte for byte against ``deflate_rs_tpu.parallel.corpus`` and against the
port's own chunk-batch engine; then ``packed=False`` and the two engines of
``compress_stream``.  Tolerance: exact equality.  Every JAX stream is computed
once per module.  ``tests/test_torch_corpus_options.py`` has the engine's
other options.  Last, the checksums that run on threads of their own beside
the encode: zlib's values, no thread left after a call that raises, and
calls on two threads at once (huffman_only, the fastest preset on the CPU:
the checksums do not depend on the preset).
"""

import gzip
import threading
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch.models.deflate import compress_stream  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from deflate_rs_tpu_torch.utils.mix import mix  # noqa: E402
from torch_corpus_data import inputs as _inputs, jax_stream as _jax_stream  # noqa: E402

CPU = {"device": "cpu"}


def test_corpus_matches_oneshot_and_jax():
    data = _inputs("mix")
    z = tcorpus.compress_corpus_zlib(data, batch_size=3, **CPU)
    assert zlib.decompress(z) == data
    assert z == jcorpus.compress_corpus_zlib(data, batch_size=3)
    legacy = compress_stream(data, dt.CompressionOptions.default(), pipelined=False, **CPU)
    assert z[2:-4] == legacy.deflate
    assert z == dt.deflate_bytes_zlib(data, **CPU)  # above four chunks: the corpus engine
    g = tcorpus.compress_corpus_gzip(data, batch_size=5, **CPU)
    assert gzip.decompress(g) == data
    assert g == jcorpus.compress_corpus_gzip(data, batch_size=5)
    builder = dt.GzBuilder().with_filename("a.txt").with_mtime(7)
    g2 = tcorpus.compress_corpus_gzip(data, builder=builder, batch_size=5, **CPU)
    assert g2 == jcorpus.compress_corpus_gzip(
        data, builder=dj.GzBuilder().with_filename("a.txt").with_mtime(7), batch_size=5)


@pytest.mark.parametrize("data", [b"", b"hi"])
def test_corpus_empty_and_small(data):
    z = tcorpus.compress_corpus_zlib(data, **CPU)
    assert zlib.decompress(z) == data
    assert z == jcorpus.compress_corpus_zlib(data)


@pytest.mark.parametrize("name,batch_size", [("all_stored", 3), ("dense", 4), ("mixed_tail", 4)])
def test_corpus_compaction_paths(name, batch_size):
    data = _inputs(name)
    res = tcorpus.compress_corpus(data, batch_size=batch_size, **CPU)
    assert zlib.decompress(res.deflate, wbits=-15) == data
    assert res.crc32 == zlib.crc32(data) and res.adler == zlib.adler32(data)
    assert res.deflate == _jax_stream(name, batch_size)
    fetched = res.fetched["words_bytes"]
    if name == "all_stored":
        assert fetched == 0
    if name == "dense":
        assert len(res.deflate) > 0.5 * len(data)
        assert len(res.deflate) <= fetched <= len(res.deflate) + 4 * 4
    if name == "mixed_tail":
        assert res.deflate == dt.deflate_bytes(data, **CPU)


def test_corpus_large_chunks():
    """256 KiB chunks: the JAX engine's bytes, and a ratio no worse than at 64 KiB."""
    data = _inputs("repeated_text")
    big = tcorpus.compress_corpus(data, batch_size=2, chunk_size=262_144, **CPU)
    assert zlib.decompress(big.deflate, wbits=-15) == data
    assert big.adler == zlib.adler32(data)
    assert big.deflate == _jax_stream("repeated_text", 2, 262_144)
    small = tcorpus.compress_corpus(data, batch_size=2, **CPU)
    assert small.deflate == _jax_stream("repeated_text", 2)
    assert len(big.deflate) <= len(small.deflate) + 64


@pytest.mark.parametrize("name,batch_size", [("mix", 3), ("mixed_tail", 4)])
def test_corpus_unpacked_equals_jax(name, batch_size):
    data = _inputs(name)
    res = tcorpus.compress_corpus(data, batch_size=batch_size, packed=False, **CPU)
    assert zlib.decompress(res.deflate, wbits=-15) == data
    assert res.deflate == _jax_stream(name, batch_size, packed=False)
    legacy = compress_stream(data, dt.CompressionOptions.default(), packed=False, **CPU)
    assert res.deflate == legacy.deflate
    assert len(res.deflate) > len(_jax_stream(name, batch_size))  # the sync markers


@pytest.mark.parametrize("pipelined", [True, False, None])
def test_both_engines_give_the_same_bytes(pipelined):
    data = _inputs("mixed_tail")  # four chunks: the default routing keeps the old engine
    res = compress_stream(data, dt.CompressionOptions.default(), pipelined=pipelined, **CPU)
    assert res.deflate == _jax_stream("mixed_tail", 4)


# The checksum threads.

HUFF = dt.CompressionOptions.huffman_only()


def _checksum_threads():
    return [t for t in threading.enumerate() if t.name.startswith(tcorpus.CHECKSUM_THREADS)]


@pytest.mark.parametrize("n,chunk_size,batch_size,packed", [
    (0, 4096, 2, True),  # empty
    (1, 4096, 2, True),  # one byte
    (2 * 4096 + 100, 4096, 8, True),  # a partial last chunk in one batch
    (5 * 4096 + 100, 4096, 2, True),  # three batches
    (5 * 4096 + 100, 4096, 2, False),  # three batches, byte-aligned
], ids=["empty", "one_byte", "partial_last_chunk", "batches", "batches_unpacked"])
def test_checksums_equal_zlibs(n, chunk_size, batch_size, packed):
    data = mix(n)
    res = tcorpus.compress_corpus(data, HUFF, batch_size=batch_size, chunk_size=chunk_size,
                                  packed=packed, **CPU)
    assert zlib.decompress(res.deflate, wbits=-15) == data
    assert (res.adler, res.crc32, res.isize) == (zlib.adler32(data), zlib.crc32(data), n)
    assert not _checksum_threads()


@pytest.mark.parametrize("step", ["submit", "fetch_next"])
def test_an_encode_that_raises_leaves_no_checksum_thread(monkeypatch, step):
    """The call raises the encode's error, and only once the checksum
    threads, alive when it raised, have ended."""
    running = []

    def fail(*args, **kwargs):
        running.extend(_checksum_threads())
        raise RuntimeError("planted encode failure")

    monkeypatch.setattr(tcorpus.BatchPipeline, step, fail)
    with pytest.raises(RuntimeError, match="planted encode failure"):
        tcorpus.compress_corpus(mix(3 * 4096), HUFF, batch_size=1, chunk_size=4096, **CPU)
    assert running
    assert not any(t.is_alive() for t in running) and not _checksum_threads()


def test_a_checksum_that_raises_raises_at_the_join(monkeypatch):
    def fail(data, value=0):
        raise ValueError("planted checksum failure")

    monkeypatch.setattr(tcorpus.native, "crc32", fail)
    with pytest.raises(ValueError, match="planted checksum failure"):
        tcorpus.compress_corpus(mix(3 * 4096), HUFF, batch_size=2, chunk_size=4096, **CPU)
    assert not _checksum_threads()


def test_two_threads_at_once_get_their_own_checksums():
    inputs = [mix(3 * 4096 + 7), bytes(reversed(mix(4 * 4096 + 11)))]
    results = [None] * len(inputs)
    barrier = threading.Barrier(len(inputs))

    def run(i):
        barrier.wait(timeout=30)
        results[i] = tcorpus.compress_corpus(inputs[i], HUFF, batch_size=1, chunk_size=4096,
                                             **CPU)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for data, res in zip(inputs, results):
        assert zlib.decompress(res.deflate, wbits=-15) == data
        assert (res.adler, res.crc32) == (zlib.adler32(data), zlib.crc32(data))
    assert not _checksum_threads()
