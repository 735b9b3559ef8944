"""The port's host inflate (``deflate_rs_tpu_torch.models.inflate``) against
the JAX package's, on the same bytes.

The port's streams of every preset in raw, zlib and gzip framing; stdlib
``zlib`` streams at levels 1, 6 and 9; ``tests/data/issue_44.zlib``; the
corrupt streams, each raising what the reference raises; the public surface.
Tolerance: exact equality of the decoded bytes and of the exceptions.
"""

import functools
import os
import zlib

import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.models import inflate as jinf  # noqa: E402
from deflate_rs_tpu_torch.models import inflate as tinf  # noqa: E402
from torch_corpus_data import DATA, pg11  # noqa: E402

CPU = {"device": "cpu"}
PRESETS = ["default", "high", "fast", "rle", "huffman_only", "turbo", "ForceFixed",
           "ForceStored"]
DECODERS = {"raw": "inflate", "zlib": "inflate_zlib", "gzip": "inflate_gzip"}


def _options(name):
    O = dt.CompressionOptions
    if name.startswith("Force"):
        return O(special=getattr(dt.SpecialOptions, name))
    return getattr(O, name)()


@functools.lru_cache(maxsize=None)
def _stream(preset: str, framing: str) -> bytes:
    data, o = pg11()[:20_000], _options(preset)
    if framing == "raw":
        return dt.deflate_bytes_conf(data, o, **CPU)
    if framing == "zlib":
        return dt.deflate_bytes_zlib_conf(data, o, **CPU)
    builder = dt.GzBuilder().with_filename("pg11.txt").with_mtime(7)
    return dt.deflate_bytes_gzip_conf(data, builder, o, **CPU)


def _both(name: str, stream: bytes) -> bytes:
    """Decode with the port and the reference; they must agree."""
    got = getattr(tinf, name)(stream)
    assert got == getattr(jinf, name)(stream)
    return got


@pytest.mark.parametrize("framing", list(DECODERS))
@pytest.mark.parametrize("preset", PRESETS)
def test_decodes_the_ports_streams(preset, framing):
    assert _both(DECODERS[framing], _stream(preset, framing)) == pg11()[:20_000]


@pytest.mark.parametrize("level", [1, 6, 9])
def test_decodes_stdlib_zlib_streams(level):
    data = pg11()[:60_000]
    z = zlib.compress(data, level)
    assert _both("inflate_zlib", z) == data
    assert _both("inflate", z[2:-4]) == data


def test_decodes_issue_44_stream():
    with open(os.path.join(DATA, "issue_44.zlib"), "rb") as f:
        ref = f.read()
    assert _both("inflate_zlib", ref) == zlib.decompress(ref)


@functools.lru_cache(maxsize=None)
def _corrupt_cases():
    good = dt.deflate_bytes_zlib(pg11()[:5_000], **CPU)
    gz = dt.deflate_bytes_gzip(pg11()[:5_000], **CPU)
    stored = dt.deflate_bytes_conf(b"abc", dt.CompressionOptions(
        special=dt.SpecialOptions.ForceStored), **CPU)
    return {
        "bad_adler": ("inflate_zlib", good[:-1] + bytes([good[-1] ^ 0xFF])),
        "bad_header_check": ("inflate_zlib", b"\x79" + good[1:]),
        "fdict": ("inflate_zlib", b"\x78\xbb" + good[2:]),
        "too_short": ("inflate_zlib", good[:5]),
        "btype_3": ("inflate", b"\x07\x00\x00"),
        "len_nlen": ("inflate", stored[:3] + bytes([stored[3] ^ 1]) + stored[4:]),
        "gzip_trailer": ("inflate_gzip", gz[:-5] + bytes([gz[-5] ^ 1]) + gz[-4:]),
        "gzip_header": ("inflate_gzip", b"\x1f\x8c" + gz[2:]),
    }


@pytest.mark.parametrize("case", ["bad_adler", "bad_header_check", "fdict", "too_short",
                                  "btype_3", "len_nlen", "gzip_trailer", "gzip_header"])
def test_corrupt_streams_raise_what_the_reference_raises(case):
    name, stream = _corrupt_cases()[case]
    with pytest.raises(ValueError) as want:
        getattr(jinf, name)(stream)
    with pytest.raises(ValueError) as got:
        getattr(tinf, name)(stream)
    assert str(got.value) == str(want.value)


def test_inflate_public_surface():
    payload = pg11()[:3_000] * 7
    assert dt.inflate(dt.deflate_bytes(payload, **CPU)) == payload
    assert dt.inflate_zlib(dt.deflate_bytes_zlib(payload, **CPU)) == payload
    assert dt.inflate_gzip(dt.deflate_bytes_gzip(payload, **CPU)) == payload
    assert dt.inflate_zlib(zlib.compress(payload, 6)) == payload
    for name in ("inflate", "inflate_zlib", "inflate_gzip"):
        assert name in dt.__all__
        assert getattr(dt, name) is getattr(tinf, name)
    assert set(dj.__all__) <= set(dt.__all__)
