"""The corpus engine's options against the JAX engine's bytes: chunk sizes
other than 64 and 256 KiB, batch sizes and queue depths, other presets, the
chunk-size rule at the entry, and the pg11 size pin.  The chunk sizes above
256 KiB and below 32 KiB that are no multiples of 256 are in
``tests/test_torch_chunk_sizes.py`` and ``tests/test_torch_chunk_grid*.py``.  Tolerance: exact
equality.  The engine's main cases are in ``tests/test_torch_corpus.py``.
"""

import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.parallel import corpus as jcorpus  # noqa: E402
from deflate_rs_tpu_torch.parallel import corpus as tcorpus  # noqa: E402
from torch_corpus_data import inputs as _inputs, jax_stream as _jax_stream  # noqa: E402
from torch_corpus_data import pg11 as _pg11  # noqa: E402

CPU = {"device": "cpu"}


@pytest.mark.parametrize("chunk_size", [131_072, 16_384])
def test_corpus_other_chunk_sizes(chunk_size):
    """Two windows of the parse kernel, and chunks shorter than the 32 KiB of
    history (a chunk's history then spans several chunks before it)."""
    data = _inputs("repeated_text")[:300_000]
    res = tcorpus.compress_corpus(data, batch_size=3, chunk_size=chunk_size, **CPU)
    assert zlib.decompress(res.deflate, wbits=-15) == data
    want = jcorpus.compress_corpus(data, batch_size=3, chunk_size=chunk_size).deflate
    assert res.deflate == want


@pytest.mark.parametrize("batch_size,queue_depth", [(1, 1), (2, 3), (5, 1), (32, 3)])
def test_batching_and_queue_depth_do_not_change_bytes(batch_size, queue_depth):
    data = _inputs("mix")
    res = tcorpus.compress_corpus(data, batch_size=batch_size, queue_depth=queue_depth, **CPU)
    assert res.deflate == _jax_stream("mix", 3)


@pytest.mark.parametrize("preset", ["fast", "rle"])
def test_corpus_presets_equal_jax(preset):
    data = _inputs("mixed_tail")
    got = tcorpus.compress_corpus(data, getattr(dt.CompressionOptions, preset)(),
                                  batch_size=4, **CPU)
    want = jcorpus.compress_corpus(data, getattr(dj.CompressionOptions, preset)(), batch_size=4)
    assert got.deflate == want.deflate
    assert zlib.decompress(got.deflate, wbits=-15) == data


@pytest.mark.parametrize("chunk_size,match", [
    (0, "positive multiple of 16"), (-256, "positive multiple of 16"),
    (100, "positive multiple of 16"),
    # Default's long-range pass: a chunk and its 32 KiB of history in 64
    # segments of whole 4-byte words.
    (65536 + 16, "must divide by 256"), (4096 + 128, "must divide by 256"),
    (4112, "must divide by 256"),
    (16_777_216 + 256, "at most 16777216")])
def test_bad_chunk_size_raises_at_the_entry(chunk_size, match):
    with pytest.raises(ValueError, match=match):
        tcorpus.compress_corpus(b"abc", chunk_size=chunk_size, **CPU)


def test_bad_batching_raises():
    with pytest.raises(ValueError):
        tcorpus.compress_corpus(b"abc", batch_size=0, **CPU)
    with pytest.raises(ValueError):
        tcorpus.compress_corpus(b"abc", queue_depth=0, **CPU)


def test_pg11_size_pin_through_the_corpus_engine():
    res = tcorpus.compress_corpus(_pg11(), **CPU)
    assert len(res.deflate) == 60196
    assert res.deflate == dt.deflate_bytes(_pg11(), **CPU)


def test_high_py_source_512k_known_gap_through_the_corpus_engine():
    """The high preset's known gap against zlib -9 on 512 KiB of Python
    source (``tests/test_corpora_ratio.py``), through the port's corpus
    engine: the JAX package's bytes, under the same pinned ceiling."""
    import glob

    npdir = os.path.dirname(np.__file__)
    py = []
    for p in sorted(glob.glob(os.path.join(npdir, "**", "*.py"), recursive=True)):
        with open(p, "rb") as f:
            py.append(f.read())
        if sum(map(len, py)) > 512 * 1024:
            break
    data = b"".join(py)[: 512 * 1024]
    got = tcorpus.compress_corpus(data, dt.CompressionOptions.high(), batch_size=8, **CPU).deflate
    assert got == dj.deflate_bytes_conf(data, dj.CompressionOptions.high())
    assert zlib.decompress(got, wbits=-15) == data
    z9 = len(zlib.compress(data, 9)) - 6
    z6 = len(zlib.compress(data, 6)) - 6
    assert len(got) <= z6
    assert len(got) <= z9 * 1.0012
