"""The port's device inflate validator (``ops/inflate_device.py``) against
the JAX package's, on the CPU.

Every case of ``tests/test_inflate_device.py`` through the port, the decoded
bytes equal to the input and to what the JAX ``inflate_device`` returns (each
JAX result computed once per module); malformed and bit-flipped streams raise
the same error or return the same bytes; one dynamic block's
``(lit, src, known, meta)`` equal the JAX decoder's array for array; and the
dynamic-header parse equals the JAX loop on 200 seeded bit-flipped headers.
Tolerance: exact equality.
"""

import functools
import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu import constants as JC  # noqa: E402
from deflate_rs_tpu.ops import inflate_device as J  # noqa: E402
from deflate_rs_tpu_torch.ops import inflate_device as T  # noqa: E402
from torch_corpus_data import DATA, pg11  # noqa: E402

CPU = {"device": "cpu"}


def _cap(n):
    return max(4096, (n + 4095) & ~4095)


@functools.lru_cache(maxsize=None)
def _jax_result(stream: bytes, cap: int):
    """The JAX decoder's bytes, or its ValueError's message."""
    try:
        return J.inflate_device(stream, cap)
    except ValueError as e:
        return ("ValueError", str(e))


def _port_result(stream: bytes, cap: int):
    try:
        return T.inflate_device(stream, cap, **CPU)
    except ValueError as e:
        return ("ValueError", str(e))


def _check(stream: bytes, data: bytes, cap: int | None = None):
    cap = cap or _cap(len(data))
    got = _port_result(stream, cap)
    assert got == data
    assert got == _jax_result(stream, cap)


def _ours(data: bytes, options) -> bytes:
    return dt.deflate_bytes_conf(data, options, **CPU)


def test_len_dist_attr_formulas_match_tables():
    e, b = T._len_attrs(torch.arange(29))
    np.testing.assert_array_equal(e.numpy(), JC.LENGTH_EXTRA_BITS)
    np.testing.assert_array_equal(b.numpy(), JC.LENGTH_BASE)
    e, b = T._dist_attrs(torch.arange(30))
    np.testing.assert_array_equal(e.numpy(), JC.DIST_EXTRA_BITS)
    np.testing.assert_array_equal(b.numpy(), JC.DIST_BASE)


@pytest.mark.parametrize("preset", ["default", "fast", "rle", "huffman_only"])
def test_decode_our_text(preset):
    data = pg11()[:16384]
    _check(_ours(data, getattr(dt.CompressionOptions, preset)()), data)


def test_decode_our_fixed_block():
    data = b"Deflate late"
    _check(_ours(data, dt.CompressionOptions.default()), data)


def test_decode_our_stored_random():
    data = np.random.default_rng(3).integers(0, 256, 50000, dtype=np.uint8).tobytes()
    _check(_ours(data, dt.CompressionOptions.default()), data)


def test_decode_our_rle_runs():
    data = b"\x00" * 9000 + b"ab" * 700 + b"\xff" * 3000
    _check(_ours(data, dt.CompressionOptions.rle()), data)


def test_decode_our_multichunk_with_sync_markers():
    data = pg11()[:80000]  # two chunks, a sync marker between them
    _check(_ours(data, dt.Compression.Default), data)


def test_decode_our_structured_binary():
    with open(os.path.join(DATA, "issue_18_201911.bin"), "rb") as f:
        data = f.read()
    _check(_ours(data, dt.CompressionOptions.default()), data)


@pytest.mark.parametrize("level", [1, 6, 9])
def test_decode_zlib_streams(level):
    data = pg11()[:20000]
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    _check(co.compress(data) + co.flush(), data)


def test_decode_zlib_mixed_content():
    rng = np.random.default_rng(9)
    data = (b"A" * 5000 + rng.integers(0, 256, 8000, dtype=np.uint8).tobytes()
            + b"the quick brown fox " * 400)
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    _check(co.compress(data) + co.flush(), data)


@pytest.mark.parametrize("data", [b"", b"x", b"ab" * 3])
def test_decode_empty_and_tiny(data):
    _check(dt.deflate_bytes(data, **CPU), data, 4096)


def _fixed_match_before_output() -> bytes:
    """A fixed block whose first token is a match at distance 1: its source
    lies before the output."""
    bits = [1, 1, 0]  # BFINAL, BTYPE = 1 (fixed)
    bits += [0, 0, 0, 0, 0, 0, 1]  # length code 257 (length 3), 7 bits
    bits += [0, 0, 0, 0, 0]  # distance code 0 (distance 1), 5 bits
    bits += [0] * 7  # end of block
    bits += [0] * (-len(bits) % 8)
    return np.packbits(np.array(bits, np.uint8), bitorder="little").tobytes()


def _flipped(seed: int) -> bytes:
    stream = bytearray(dt.deflate_bytes(pg11()[:3000], **CPU))
    rng = np.random.default_rng(seed)
    for bit in rng.integers(0, 8 * len(stream), 3):
        stream[bit >> 3] ^= 1 << (bit & 7)
    return bytes(stream)


@pytest.mark.parametrize("case", ["all_ones", "match_before_output", "truncated",
                                  "flipped_0", "flipped_1", "flipped_2", "flipped_3"])
def test_malformed_streams_agree_with_the_reference(case):
    if case == "all_ones":
        stream = b"\xff" * 64
    elif case == "match_before_output":
        stream = _fixed_match_before_output()
    elif case == "truncated":
        stream = dt.deflate_bytes(pg11()[:3000], **CPU)[:-40]
    else:
        stream = _flipped(int(case[-1]))
    got = _port_result(stream, 4096)
    assert got == _jax_result(stream, 4096)
    if case in ("all_ones", "truncated"):
        assert got[0] == "ValueError"


def test_decode_block_matches_reference_array_for_array():
    data = pg11()[:60000]
    stream = dt.deflate_bytes(data, **CPU)
    dec = T.BlockDecoder(stream, 65536, **CPU)
    lit = torch.zeros(dec.OUT, dtype=torch.int64)
    src = torch.arange(dec.OUT)
    known = torch.zeros(dec.OUT, dtype=torch.bool)
    got = dec.decode(0, 0, lit, src, known)
    jdec = J._block_decoder(dec.NB, dec.OUT, dec.W)
    want = jdec(jnp.asarray(np.frombuffer(stream.ljust(dec.NB, b"\0"), np.uint8)),
                jnp.int32(0), jnp.int32(0), jnp.zeros(dec.OUT, jnp.int32),
                jnp.arange(dec.OUT, dtype=jnp.int32), jnp.zeros(dec.OUT, jnp.bool_))
    assert int(want[3][4]) == JC.BTYPE_DYNAMIC and int(want[3][3]) == 1
    for g, w, name in zip(got, want, ("lit", "src", "known", "meta")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _headers(n: int, nbits: int = 6000):
    """``n`` header bit arrays: a real dynamic header of pg11 with 1-8
    random bits flipped in its first 700 bits, every fifth one all random."""
    stream = dt.deflate_bytes(pg11()[:60000], **CPU)
    real = np.unpackbits(np.frombuffer(stream, np.uint8), bitorder="little")[:nbits]
    real = np.pad(real, (0, nbits - len(real)))
    rng = np.random.default_rng(2024)
    out = []
    for k in range(n):
        if k % 5 == 4:
            bits = rng.integers(0, 2, nbits).astype(np.uint8)
        else:
            bits = real.copy()
            bits[rng.integers(3, 700, rng.integers(1, 9))] ^= 1
        out.append(bits)
    return np.stack(out)


def test_dynamic_header_parse_matches_reference_on_flipped_headers():
    bits = _headers(200)
    parse = jax.jit(jax.vmap(J._parse_dynamic_header, in_axes=(0, None)))
    want = [np.asarray(a) for a in parse(jnp.asarray(bits, jnp.int32), 3)]
    for k in range(len(bits)):
        got = T._parse_dynamic_header(torch.from_numpy(bits[k]), 3)
        for g, w, name in zip(got, want, ("litlen", "dist", "pos")):
            np.testing.assert_array_equal(g.numpy(), w[k], err_msg=f"header {k}: {name}")

