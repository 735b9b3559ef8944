"""The port's device checksums against the JAX package's and ``zlib``.

Exact equality everywhere (integers).  Inputs come from numpy with a seed or
from ``tests/data``.  The JAX device functions take one row padded to a power
of two; the port's take a batch ``[B, P]``.
"""

import functools
import os
import zlib

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
# The suite runs several workers on one machine: one intra-op thread per
# worker keeps the port's many small ops from oversubscribing the cores.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deflate_rs_tpu as dj  # noqa: E402
import deflate_rs_tpu_torch as dt  # noqa: E402
from deflate_rs_tpu.ops import checksum as jcs  # noqa: E402
from deflate_rs_tpu.ops.chunk_encode import encode_chunk  # noqa: E402
from deflate_rs_tpu_torch.ops import checksum as tcs  # noqa: E402
from deflate_rs_tpu_torch.ops.chunk_encode import HALO, PAD, ChunkEncoder  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")


def _pg11():
    with open(os.path.join(DATA, "pg11.txt"), "rb") as f:
        return f.read()


def _tables(P):
    return (torch.from_numpy(tcs.CRC_TABLE.astype(np.int64)),
            torch.from_numpy(tcs.shift_byte_tables(P)))


def test_host_constants_equal_jax():
    np.testing.assert_array_equal(tcs.CRC_TABLE, jcs.CRC_TABLE)
    assert len(tcs.SHIFT_MATRICES) == len(jcs.SHIFT_MATRICES)
    for a, b in zip(tcs.SHIFT_MATRICES, jcs.SHIFT_MATRICES):
        np.testing.assert_array_equal(a, b)
    assert tcs.ADLER_INIT == jcs.ADLER_INIT


@pytest.mark.parametrize("P,lengths", [
    (4096, (0, 1, 4095)),            # a non-power-of-two batch of three
    (65536, (65536, 4095, 1, 0, 40000)),
    (4096, (4096,)),
    (1000, (0, 1, 999, 1000, 513)),  # a row that is no power of two (front-padded)
])
def test_device_partials_equal_jax_and_zlib(P, lengths):
    rng = np.random.default_rng(P + len(lengths))
    data = rng.integers(0, 256, (len(lengths), P), dtype=np.uint8)
    n = np.array(lengths, np.int32)
    crc = tcs.crc32_raw_device(torch.from_numpy(data), torch.from_numpy(n), *_tables(P))
    s1, s2 = tcs.adler32_parts_device(torch.from_numpy(data), torch.from_numpy(n))
    assert crc.shape == s1.shape == s2.shape == (len(lengths),)
    P2 = 1 << (P - 1).bit_length()
    j_crc = jax.jit(jcs.crc32_raw_device)
    j_adler = jax.jit(jcs.adler32_parts_device)
    for b, ln in enumerate(lengths):
        row = data[b, :ln].tobytes()
        padded = np.zeros(P2, np.uint8)
        padded[:P] = data[b]
        assert int(crc[b]) == int(j_crc(jnp.asarray(padded), jnp.int32(ln)))
        w1, w2 = j_adler(jnp.asarray(data[b]), jnp.int32(ln))
        assert (int(s1[b]), int(s2[b])) == (int(w1), int(w2))
        assert tcs.crc32_from_raw(int(crc[b]), ln) == zlib.crc32(row)
        state = tcs.adler32_combine(tcs.ADLER_INIT, int(s1[b]), int(s2[b]), ln)
        assert tcs.adler32_value(state) == zlib.adler32(row)


def test_shift_tables_too_short_raise():
    crc_table, _ = _tables(16)
    with pytest.raises(ValueError):
        tcs.crc32_raw_device(torch.zeros((1, 64), dtype=torch.uint8), torch.tensor([3]),
                             crc_table, torch.from_numpy(tcs.shift_byte_tables(16)))


@pytest.mark.parametrize("seed", range(4))
def test_combine_identities_equal_jax_and_zlib(seed):
    rng = np.random.default_rng(seed)
    parts = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(0, 70000, 5)]
    parts.insert(2, b"")
    raw_t = raw_j = 0
    st_t, st_j = tcs.ADLER_INIT, jcs.ADLER_INIT
    for p in parts:
        raw_p = zlib.crc32(p) ^ 0xFFFFFFFF ^ tcs.crc_shift(0xFFFFFFFF, len(p))
        assert tcs.crc32_from_raw(raw_p, len(p)) == zlib.crc32(p)
        assert tcs.crc_shift(raw_p, 12345) == jcs.crc_shift(raw_p, 12345)
        raw_t = tcs.crc32_combine_raw(raw_t, raw_p, len(p))
        raw_j = jcs.crc32_combine_raw(raw_j, raw_p, len(p))
        a = np.frombuffer(p, np.uint8).astype(np.int64)
        s1 = int(a.sum() % 65521)
        s2 = int((a * np.arange(len(p), 0, -1)).sum() % 65521)
        st_t = tcs.adler32_combine(st_t, s1, s2, len(p))
        st_j = jcs.adler32_combine(st_j, s1, s2, len(p))
    whole = b"".join(parts)
    assert raw_t == raw_j and st_t == st_j
    assert tcs.crc32_from_raw(raw_t, len(whole)) == jcs.crc32_from_raw(raw_j, len(whole)) \
        == zlib.crc32(whole)
    assert tcs.adler32_value(st_t) == jcs.adler32_value(st_j) == zlib.adler32(whole)


# ---------------------------------------------------------------------------
# ChunkEncoder(with_checksums=True) and stored_payload_fields=False against
# encode_chunk, in the 4 KiB tier: a text chunk, a short one, an empty one and
# one of random bytes (stored).
# ---------------------------------------------------------------------------

EMIT = 4096


def _chunks():
    pg = _pg11()
    rng = np.random.default_rng(5)
    payloads = [pg[:EMIT], pg[5000:5000 + 1234], b"", rng.integers(0, 256, EMIT, dtype=np.uint8).tobytes(),
                pg[9000:9000 + EMIT]]
    hists = [b"", pg[:5000], b"", b"", pg[:9000]]
    lasts = [False, True, True, False, False]
    B = len(payloads)
    bufs = np.zeros((B, HALO + EMIT + PAD), np.uint8)
    for i, (p, h) in enumerate(zip(payloads, hists)):
        h = h[-HALO:]
        bufs[i, HALO - len(h) : HALO] = np.frombuffer(h, np.uint8)
        bufs[i, HALO : HALO + len(p)] = np.frombuffer(p, np.uint8)
    return (payloads, bufs, np.array([len(h[-HALO:]) for h in hists], np.int64),
            np.array([len(p) for p in payloads], np.int64), np.array(lasts))


@functools.lru_cache(maxsize=None)
def _both(with_checksums: bool, stored_payload_fields: bool):
    payloads, bufs, hist, ns, lasts = _chunks()
    enc = ChunkEncoder(dt.CompressionOptions.default(), EMIT, with_checksums=with_checksums,
                       stored_payload_fields=stored_payload_fields)
    with torch.no_grad():
        got = enc(torch.from_numpy(bufs), torch.from_numpy(hist), torch.from_numpy(ns),
                  torch.from_numpy(lasts))
    fn = jax.jit(functools.partial(
        encode_chunk, emit_size=EMIT, options=dj.CompressionOptions.default(),
        with_checksums=with_checksums, stored_payload_fields=stored_payload_fields))
    want = [fn(bufs[i], np.int32(hist[i]), np.int32(ns[i]), np.bool_(lasts[i]))
            for i in range(len(payloads))]
    return payloads, got, want


@pytest.mark.parametrize("stored_payload_fields", [True, False])
@pytest.mark.parametrize("with_checksums", [True, False])
def test_chunk_encoder_options_equal_encode_chunk(with_checksums, stored_payload_fields):
    payloads, got, want = _both(with_checksums, stored_payload_fields)
    assert ("crc_raw" in got) == with_checksums
    stored_seen = False
    for i, w in enumerate(want):
        for key in ("total_bits", "data_bits", "btype", "ntokens"):
            assert int(got[key][i]) == int(w[key]), (key, i)
        stored = int(w["btype"]) == dj.constants.BTYPE_STORED
        stored_seen |= stored
        # Words are compared on the bits that are read: all of total_bits
        # where the fields were packed, data_bits of a Huffman chunk otherwise
        # (a stored chunk's words are never read then).
        bits = int(w["total_bits"]) if stored_payload_fields else (
            0 if stored else int(w["data_bits"]))
        gw = got["words"][i].numpy().astype(np.uint32)
        ww = np.asarray(w["words"]).astype(np.uint32)
        full = bits // 32
        np.testing.assert_array_equal(gw[:full], ww[:full])
        if bits % 32:
            mask = (1 << (bits % 32)) - 1
            assert int(gw[full]) & mask == int(ww[full]) & mask
        if with_checksums:
            for key in ("s1", "s2", "crc_raw"):
                assert int(got[key][i]) == int(w[key]), (key, i)
    assert stored_seen


def test_encoder_partials_combine_to_zlib_checksums():
    payloads, got, _ = _both(True, True)
    state, raw = tcs.ADLER_INIT, 0
    for i, p in enumerate(payloads):
        state = tcs.adler32_combine(state, int(got["s1"][i]), int(got["s2"][i]), len(p))
        raw = tcs.crc32_combine_raw(raw, int(got["crc_raw"][i]), len(p))
    whole = b"".join(payloads)
    assert tcs.adler32_value(state) == zlib.adler32(whole)
    assert tcs.crc32_from_raw(raw, len(whole)) == zlib.crc32(whole)
