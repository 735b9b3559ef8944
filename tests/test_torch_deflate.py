"""The whole ported slice, byte for byte against the JAX package, in all
three framings, plus a stdlib round trip of every output."""

import glob
import gzip
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
from deflate_rs_tpu.models.deflate import compress_stream as j_compress_stream  # noqa: E402
from deflate_rs_tpu_torch.models.deflate import compress_stream  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
AFL = sorted(glob.glob(os.path.join(DATA, "afl", "*")))[:6]


def _read(name):
    with open(os.path.join(DATA, name), "rb") as f:
        return f.read()


def _inputs():
    pg = _read("pg11.txt")
    rng = np.random.default_rng(4)
    cases = {
        "pg11": pg,
        "issue_18": _read("issue_18_201911.bin"),
        "short": _read("short.bin"),
        "empty": b"",
        "one_byte": b"\x7f",
        "tier_edge_4096": pg[:4096],
        "tier_edge_4097": pg[:4097],
        "random_64k": rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),
        "zeros": bytes(150_000),
        # One chunk whose block split turns on the exact power-of-two ratios
        # where the JAX package's float32 proxy rounds up (ops/proxy.py).
        "pg11_proxy_roundup": pg[49822 : 49822 + 65536],
    }
    for p in AFL:
        with open(p, "rb") as f:
            cases["afl_" + os.path.basename(p)[:9]] = f.read()
    return cases


CASES = _inputs()


@pytest.mark.parametrize("name", list(CASES))
def test_deflate_bytes_equal(name):
    data = CASES[name]
    got = dt.deflate_bytes(data, device="cpu")
    assert got == dj.deflate_bytes(data)
    assert zlib.decompress(got, -15) == data
    if name == "pg11":
        assert len(got) == 60196


@pytest.mark.parametrize("name", ["pg11", "short", "empty", "tier_edge_4097"])
def test_zlib_and_gzip_equal(name):
    data = CASES[name]
    z = dt.deflate_bytes_zlib(data, device="cpu")
    g = dt.deflate_bytes_gzip(data, device="cpu")
    assert z == dj.deflate_bytes_zlib(data)
    assert g == dj.deflate_bytes_gzip(data)
    assert zlib.decompress(z) == data
    assert gzip.decompress(g) == data
    builder = dt.GzBuilder().with_filename("a.txt").with_mtime(7)
    g2 = dt.deflate_bytes_gzip_conf(data, builder, dt.CompressionOptions.default(), device="cpu")
    assert g2 == dj.deflate_bytes_gzip_conf(
        data, dj.GzBuilder().with_filename("a.txt").with_mtime(7),
        dj.CompressionOptions.default())


def test_six_chunk_mix_across_batch_seam():
    """Six chunks encoded four per batch (the seam falls between chunks 3
    and 4) equal the JAX chunk-by-chunk engine's stream."""
    pg = CASES["pg11"]
    rng = np.random.default_rng(3)
    mix = pg[:150_000] + rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes() \
        + bytes(60_000) + pg[:113_216]
    assert -(-len(mix) // 65536) == 6
    got = compress_stream(mix, dt.CompressionOptions.default(), device="cpu", batch_chunks=4)
    want = j_compress_stream(mix, dj.CompressionOptions.default(), pipelined=False)
    assert got.deflate == want.deflate
    assert (got.adler, got.crc32, got.isize) == (want.adler, want.crc32, want.isize)
    assert zlib.decompress(got.deflate, -15) == mix
